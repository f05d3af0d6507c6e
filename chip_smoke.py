#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (coskad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line before the last:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; builds every kernel of the port from csrc/ with nvcc,
     one process per source, all at once.
  2. kernel: K1 (eval encoder) against its plain PyTorch version on the
     card, in fp32 and in float64, at the serving path's shapes (full
     width, B=2048, a ragged B=2047 and a batch of one block and one
     window more), on a one-layer identity-residual stack and on a stack
     whose last layer narrows (16 -> 8 channels, 35 nodes); each case
     launched twice gives the same bits; times kernel and plain version,
     and each flagship layer alone with its windows a block, shared bytes
     and blocks an SM (the `K1 layers` line); STSE.forward(train=False)
     with grad mode on raises (K1 has no backward). The route for a layout
     K1's planner refuses (28 frames at 18 joints): the model's own layers
     on the card, no K1 launch, no raise with grad mode on, the CPU module
     path's latent. K1's bf16 form at the HR-STC widths (17 joints, the MLP
     head, compute dtype bfloat16; B=2048, a ragged 2047 and a block and a
     window more) against its plain version on the card and the model's
     module route within the bf16 band, the same bits twice, one
     `bf16_launches` a call, the latent of STSE.forward against the module
     route's; timed beside its plain version and the module route's hidden
     state and forward, in turns, with its bound (bf16 FLOPs at 989 TFLOP/s
     or bytes at 3.35 TB/s; the `K1 bf16` line). `--only k1` runs just the
     environment and this phase.
  3. train kernels: K2 (ghost-BN forward), K3 (a lower layer's backward)
     and K4 (the top layer's backward with the projector's) against their
     plain versions on the card: full width at B=2048 ghost 64, B=96 ghost
     32, a one-layer identity-residual stack, a stack whose last layer
     narrows with 35 nodes. Times each kernel and its plain version; K2,
     K4 and K3 launched twice on the same inputs give the same bits; per
     flagship layer the device ms of the per-window passes bwd_pre and
     bwd_dx (a profiler trace of one K3/K4 call) and each pass's shared
     bytes and blocks an SM (the top layer's bwd_dx needs two); likewise
     K2's passes fwd_pre, fwd_stats, fwd_sums, fwd_apply and the
     projector's (a trace of one K2 call). Product
     check: each of the 13 batch-reduction products of a step (dW, dW_res,
     dM a layer, dwp), alone through stse_train.product, at B=2048 and at
     K5's 128-window chunk, against float64 einsum on the card, with its
     ms, its bound (3xTF32 on the tensor cores, or bytes) and the time of
     one fp32 torch.mm / einsum call (TF32 off); `--only products` runs
     just this check.
  3a. bf16 kernels: K2, K4, K3 and K5 in each bf16 compute_dtype form
     ("bfloat16", "bfloat16_f32store": bf16 operands, f32 sums, values
     stored at bf16 or f32) against their plain versions in the same form
     (float64 between the rounding points) at B=2048 ghost 64 and on the
     identity-residual stack, K5 also against K4 + K3; the "bfloat16" form
     timed beside its plain version, its bound at the bf16 tensor-core peak
     and bytes at the store dtype; K2, K4 and K3 launched twice at bf16 give
     the same bits; under "bfloat16" the windows, every activation and dx
     are bf16 tensors (z, sums and statistics float32); per flagship layer
     the device ms of the bf16 form's bwd_pre, bwd_dx, projector_dy and
     products (a trace of one K3/K4 call) and of K2's passes (a trace of one
     K2 call, the graph operand's too) with shared bytes and blocks an SM,
     no fewer than float32's; and
     the product check at bf16 (the scratch operands as bf16 tensors, as
     K3-K5 keep them, against float64 of the rounded operands, with ms,
     bound and one bf16 torch.mm / einsum call's time).
  3b. mono: K5 (the mono backward, from x and dz alone) against its plain
     version in float64 and against the split kernels (K4, then K3) on the
     same inputs, in float32 and both bf16 forms, on the train-kernel cases
     plus a batch whose last chunk is ragged and chunks of one ghost block,
     each at its schedule with two chunks in flight and with one (the same
     bits); K5's time beside K2 and K4 + K3 and its plain version's; K5 over
     (chunk, chunks in flight) in float32 and "bfloat16", with each one's
     footprint against K2's forward allocation (the byte budget that picks
     the chunk). Then the mono path: 20 steps of fused_stse_apply(bwd_mode=
     "mono") + Adam at B=2048 ghost 64 against 20 split steps from the same
     weights (per-step losses, K5 launched once a step, K3/K4 never); the
     step time of each mode, in turns; the peak memory of one step of each
     (mono also at K5's schedule before the budget, 128 windows one at a
     time, which it must not exceed; both also at bf16) beside K2's forward
     allocation, and the bytes it saves for backward. Then 5 counted mono
     steps at compute_dtype bfloat16 (K2 and K5 launched once a step)
     against 5 split steps.
  3c. probe: the bf16 operand probes (P), one kernel per job of
     scripts/probe_mosaic.py, each against its plain version and twice for
     the same bits; each job's device time from torch.profiler (the
     median over PROBE_CALLS calls, inputs warm in L2, and with L2
     scrubbed) by kernel (by CUDA events around calls queued behind a
     device-side sleep where TRACE_TRIES traces held too few whole calls,
     with the host's gaps where a call waits; `timed_by` says which), its time by CUDA events around Python calls
     (the wrapper's host cost), its plain version's, and that of one
     PyTorch call computing the same function (`library_call`), against
     its bound; `--only probe` runs just this check.
  4. slice (serving): the serving path at the flagship width (sts_gcn
     2->32->16->32->64, latent 16, windows [2, 12, 18], 5 transforms, batch
     2048, fp32) with random weights from a seed: Trainer.initialize_center
     and score_all over 40,000 resident windows x 5 transforms, validate's
     frame AUC on synthetic ground truth, AnomalyScorer.score_clip_json on
     an AlphaPose clip. Launch counts, scores against the plain CPU path on
     a subset, a per-stage breakdown and a profiler trace.
  5. train (training): Trainer.fit for 3 epochs with fused_train='on',
     ghost 64, batch 2048 over the same 40,000 windows x 5 transforms, with
     validation; steady train windows/s, launch counts (K2/K3/K4 97/291/97
     an epoch, K1 in validate), finite losses and running statistics; three
     steps of a 256-window subset against the plain CPU path; a per-stage
     breakdown of one step, the live-BN (fused_train='off') step for
     context, and the profiler's idle share over one epoch, flagged where
     its K2-K4 kernel time is more than 10% off their CUDA-event times.
  5b. train bf16: the same fit at compute_dtype bfloat16 (bench.py's fused
     configuration), 2 epochs, counted: K2/K3/K4 97/291/97 an epoch, K1's
     bf16 form in the center init and validation; the bf16 kernels with one
     ghost block of the whole batch against the module path at bf16 from the
     same weights (per-step losses within 2^-5); the fp32 and bf16 fused
     steps' time in turns and peak memory (the bf16 peak beside PR 11's,
     whose backward scratch was fp32, and below the peak with fp32
     activations and K2 scratch), and the bf16 step's idle share.
  5c. pipeline (the device-resident trajectory store, the JAX package's
     headline train path): 50 AlphaPose clip JSONs x 2 actors x 412 frames
     of 17 keypoints written to a temporary directory (bench.py's store: 100
     persons, 18 joints after the 17 -> 18 conversion, stride 1, 40,000
     windows x 5 transforms). The native parser must be available and
     parse every clip to the json.load path's bits (both timed, in turns);
     load_alphapose_store on the card, load_alphapose_split of the same
     directory; 2048 logical indices gathered from the store on the card
     against the store's CPU plain path and against gather_batch of the
     windows, rtol 1e-5 / atol 1e-6. Then the flagship (sts_gcn
     2-32-16-32-64, linear projector, latent 16, batch 2048,
     fused_train 'on', ghost 64) fits 2 epochs through the store at float32
     and at bf16, counted: K2/K3/K4 97/291/97 an epoch, K1 in the float32
     center init; the same-weights fit on the windows in turns, per-step
     losses within the train phase's band (bf16: 2^-5), train windows/s
     both ways. score_all through the store, counted (K1 98 launches), its
     scores within SCORE_TOL of the windows pipeline's from the same state,
     scoring windows/s both ways in turns, and the resident bytes of each.
     One epoch with the contrastive view (contrastive_weight 0.5), counted:
     K2 twice a step, K3/K4 likewise; finite contrastive losses; then an
     epoch past freeze_bn_after leaves the running statistics unchanged.
     `--only pipeline` runs just this after the build.
  6. cli (the command-line path): a synthetic AlphaPose tree (4 training
     clips x 2 actors x 1,100 frames, 8,704 stride-1 windows; 2 test
     clips with <scene>_<clip>.npy ground truth) and a reference-key config
     written as JSON at the flagship width (fused_train 'on', ghost 64,
     batch 2048, validation on); cli.train for 2 epochs, then --resume to
     epoch 3 (best.ckpt, last.ckpt, the config snapshot and metrics.jsonl
     written, last.ckpt's epochs_done 3, finite losses), cli.eval on
     best.ckpt (finite AUC) and AnomalyScorer.from_checkpoint scoring
     4,096 test windows to the eval's bits: K1-K4 launch counts over that
     run. Then, not counted: a straight 3-epoch run, whose third-epoch loss
     must be the resumed run's within rtol 1e-5, and a save / restore into
     a fresh Trainer whose score_all gives the same bits. The `cli` line
     has windows, the JSON parse time, per-epoch train windows/s,
     checkpoint bytes and save / restore ms, eval's wall breakdown and AUC.
  7. paper (the paper's own configurations): every encoder-only file,
     config/{HR-STC,HR-Avenue,UBnormal}/{hyperbolic,euclidean}_encoder.yaml,
     read from the checkout with the port's YAML reader (pyyaml is never
     imported) and written to a temporary directory with only the four
     paths replaced, so at their compute_dtype bfloat16, over an
     HR-STC-shaped AlphaPose tree (markovitz) and a Morais-CSV tree (the
     robust HR-Avenue and UBnormal files) of 17-keypoint clips, the cli
     phase's test clips and 2 of its 4 training clips (4,352 training
     windows, to keep the whole run's time): the MLP projector at 17
     joints, each file's batch, 5 transforms, validation on. For each, cli.train for 2 epochs, --resume
     to 3, cli.eval, from_checkpoint, counted: K1's bf16 form as predicted
     from the windows, K2-K5 none (an MLP projector trains on the module
     path, as in JAX); then a straight 3-epoch run, which the resumed run
     must equal to the bit (losses, weights, center), and a save / restore
     round trip.
     A copy of HR-STC/hyperbolic_encoder.yaml at float32 runs the same
     counted path (K1 as predicted from the windows), and K1 is timed at 204
     nodes on its trained weights; the bf16 file's eval of 2048 windows is
     timed against it (K1's bf16 form and the module route against K1's;
     the bf16 form's latent within the bf16 band of the module route's).
     The hyperbolic
     center must stay inside the ball at every epoch. The kernel check
     (phase 2) also holds K1 at 17 joints with the MLP head (B=2048 and a
     ragged 2047) to its plain version.
  7b. variants (the decoder variants): the two files of the autoencoder
     and the spherical VAE, config/UBnormal/{euclidean_autoencoder,
     spherical_vae}.yaml, with only the paths replaced, so at bfloat16
     (K1's bf16 form as the eval encoder, K2-K5 none), over the paper
     phase's Morais-CSV tree:
     cli.train for 2 epochs, --resume to 3 (resumed = straight to the bit:
     losses, weights, center, the VAE's anchor), cli.eval (the
     autoencoder's in each --rec-weight mode: 0, 50, 1000), from_checkpoint
     scoring cli.eval's test windows to its bits. A float32 copy of each
     runs the same counted path with K1 as its eval encoder (center init,
     validation, each eval, from_checkpoint; K1 as the windows predict);
     on its trained weights at batch 2048 K1's route (two launches a batch:
     the encoder, then the decoder) against the module route on the card
     (the AE's z and reconstruction, the VAE's z_mean, z_var and
     reconstruction on its mean path) within K1's band, and the eval
     forward timed by part (K1, head, rev_btlnk, K1 on the decoder, the
     module decoder) against the module route, with the decoder's K1
     launch timed alone beside the module decoder's 2.900 ms of an earlier
     measurement (DECODER_MODULES_MS); the
     files as written hold K1's bf16 route to the module route's bf16 band.
     Both report the share of reconstruction values that are the module
     route's bits and the error against a float64 module route over the
     module route's (RECON_VS_F64). The peak memory above resident of one step of each run,
     and PowerSpherical.rsample with a CUDA generator (65,536 samples on
     the sphere, the mean of loc . x within 4 standard errors, one seed's
     bits twice). `--only variants` runs just this after the build.
  7c. encoders (the other encoders and train-mode dropout): float32 copies
     of config/HR-STC/euclidean_encoder.yaml at its full widths (MLP
     projector, batch 2048, 17 joints) with only the paths, the dtype and
     encoder_type (st_gcn, learnable_gcn, static_gcn, cnn) or dropout (0.1,
     sts_gcn) replaced, and the file as written (bf16) with st_gcn, over the
     paper phase's 17-keypoint AlphaPose tree: cli.train for 2 epochs, then
     cli.eval, counted: K1 none for the other encoders (they have no kernel,
     nor in JAX), the dropout copy's K1 as the windows predict (center init,
     each validation, the eval), K2-K5 none. Train and scoring windows/s,
     AUC, a step's peak above resident; each trained model's eval latent on
     the card against the same weights on the CPU; the dropout copy's K1
     route against its module route at batch 2048, both timed; the bf16
     st_gcn model's latent the float32 model's bits (the other encoders
     compute in float32 at bf16, as in JAX); dropout's mask on the card (a
     CUDA generator): the kept share within 4 standard deviations, kept
     values exactly x / (1 - rate), one seed's mask twice; st_gcn's 9x1
     temporal conv (64 -> 64 channels) on the card at PyTorch's default TF32
     flags, values and gradients within 2e-5 of float64's scale, timed beside
     cuDNN's conv2d. `--only encoders` runs just this after the build.
  7d. streaming (the operators' path): a float32 flagship checkpoint
     (cli.train, one epoch over the cli phase's tree: sts_gcn, linear
     projector, 18 joints), then, counted: a written clip of 3 actors over
     2,400 frames pushed frame by frame through StreamingScorer at
     min_batch 256, whose flush must match score_clip_json on the card
     (scores rtol 1e-3, atol 1e-6; the largest difference and whether it is
     0 reported), again with horizon 512 against the unbounded stream; then
     the HTTP server on loopback in a thread: 2048 windows (an .npy body)
     and the clip, each the library's bits, and a stream session pushed 64
     frames a request; frames/s, request latency p50 / p99. K1 launches as
     the traffic predicts (one a batch of the config's size in each scoring
     call: the offline clip, each drain of each stream, each request), each
     stream's drains scoring the clip's windows once, K2-K5 none. The
     clip request is timed by part (spooling the body, the parse, the
     scoring) with COSKAD_NATIVE on and off in turns.
     `--only streaming` runs just this after the build.
  8. export: a 1-epoch float32 flagship checkpoint (the streaming phase's)
     exported by `export_hlo.export_scorer` on the card, whose encoder step
     must be K1's custom op (meta encoder_route "K1"); 40,000 windows
     scored through the loaded artifact, counted: K1 launched once a chunk
     and nothing else, the scores within rtol 5e-6 / atol 1e-6 of
     `AnomalyScorer.score_windows` and the same bits again; a 2048-window
     chunk through the artifact and through the library in turns (host
     clock), the export's and the load's seconds and the artifact's bytes;
     the float32 copy of config/UBnormal/spherical_vae.yaml (seeded weights,
     a drawn anchor) through its sampled two-program artifact against the
     library in the same band; an artifact written on the CPU (module
     route) scoring on the card, and the card's moved to the CPU (K1's op
     on its plain version), each against the card's library within
     SCORE_TOL; one /v1/score/windows request through
     `ScoringService(artifact=...)`, the artifact's bits. `--only export`
     runs just this after the build.
  8b. parallel (data parallelism, `coskad_tpu_torch/parallel/mesh.py`):
     (a) a group of two ranks on the one card over gloo on CUDA tensors
     (NCCL refuses two ranks on one GPU), started by torch.multiprocessing
     spawn, each counted: the flagship fused fit (batch 2048 = 1,024
     windows a rank, ghost 64, the slice phase's 40,000 windows, 2 epochs,
     then score_all) and a float32 copy of config/HR-STC/euclidean_encoder
     .yaml (the MLP head, on the module path, 1 epoch), both under SGD,
     against the same fits in one process (losses and center rtol 1e-3,
     scores rtol 1e-3 / atol 1e-6), the ranks' weights, statistics, center
     and scores the same bits, K1-K4 launched on every rank of the flagship
     fit and K1 on every rank of the MLP fit; (b) cli.train and cli.eval on
     the cli phase's tree with `--distributed localhost:<port>,1,0` (NCCL
     at world 1) against the same commands without it: the checkpoints,
     losses, window scores and AUC the same bits; (c) the flagship fit's
     train windows/s without a process group and in an NCCL group of one,
     one epoch a side in turns. The two ranks share one card: their times
     are no scaling figure. `--only parallel` runs just this after the
     build.
  8c. model_parallel (`run.model_parallel` 2): four gloo ranks on the one
     card as a 2 x 2 (data, model) mesh, spawned as in 8b, each counted:
     the flagship at fused_train 'auto' (the module path under a model
     axis; the slice phase's windows, 1 epoch, then score_all) and a
     float32 copy of config/UBnormal/euclidean_autoencoder.yaml (the MLP
     head and rev_btlnk split, 1 epoch), both under SGD, against the same
     fits in one process (losses and center rtol 1e-3, scores rtol 1e-3 /
     atol 1e-6); every rank's whole model, center and scores the same
     bits, and the two model ranks of a data block the same replicated
     weights and statistics; each split kernel 1/2 of the whole; the
     gathered checkpoint restored in one process to the same weights bit
     for bit, its latents no further from a float64 evaluation than twice
     the one process's; K1 on every rank, K2-K5 on none. `--only
     model_parallel` runs just this after the build.
  8d. tooling: `utils/profiling.trace` around one flagship score_all
     batch: the first trace of a freshly spawned process must hold K1's
     kernel, and one in the smoke's own process is recorded (after many
     profiler sessions it may hold no device event; `trace` must then
     warn); `device_memory_stats`
     allocated bytes; `debug_nans` raising at NaNs made on the card in a
     forward and a backward; `MobiusLinear` / `MobiusDist2Hyperplane`
     values and gradients on the card against the CPU (rtol 1e-4, atol
     1e-6 of the scale). `--only tooling` runs just this after the build.
  9. a line of each phase's wall time, a JSON line of every kernel
     (launches on the main paths, error, times, bound), then the last line
     {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX or of the JAX package. It leaves PyTorch's TF32
flags at their defaults (off in matmuls, on in cuDNN): the port calls no
cuDNN routine, and a matmul is float32 at that default, so every float32
check holds the package as a user runs it. Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # tensor cores: the least time for the bf16 probes
PEAK_BYTES_PER_S = 3.35e12
# TF32 on the tensor cores, dense: the batch-reduction products run as 3xTF32
# (three TF32 products for each fp32 one), so their least time is 3 FLOPs
# over this rate
PEAK_TF32_FLOPS = 495e12
TOL = dict(rtol=2e-4, atol=2e-5)  # kernel vs plain: fp32 reassociation
# K2 vs plain (tests/test_fused_train_kernel.py:50-58): ghost statistics sum
# 13,824 rows per channel in another order
TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)
# K3/K4 gradients vs plain: err < 1e-3 * max(scale, 1) + 1e-6
# (test_fused_train_kernel.py:84-91, fp32 reassociation through the BN
# backward's 1/cnt cancellations)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
LOSS_RTOL = 1e-3  # per-step losses vs the CPU path (test_lockstep_parity.py:538)
TRAIN_EPOCHS = 3
TRAIN_BATCH = 2048
FULL = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64, latent_dim=16,
            n_frames=12, n_joints=18)
# (label, model, batch, ghost) of the K2-K4 checks; the first is timed
TRAIN_KERNEL_CASES = (
    ("full_B2048_ghost64", FULL, 2048, 64),
    ("full_B96_ghost32", FULL, 96, 32),
    ("identity_residual_B64_ghost16", dict(input_dim=8, layer_channels=(), hidden_dimension=8,
                                           latent_dim=4, n_frames=6, n_joints=5), 64, 16),
    ("narrowing_last_layer_B64_ghost16", dict(input_dim=2, layer_channels=(16,),
                                              hidden_dimension=8, latent_dim=4, n_frames=5,
                                              n_joints=7), 64, 16),
)
# (label, model, batch, ghost, chunk windows) of K5's own extra checks
MONO_EXTRA_CASES = (
    ("full_B320_ghost64_ragged_last_chunk", FULL, 320, 64, 128),  # chunks 128, 128, 64
    ("full_B256_ghost64_one_block_chunks", FULL, 256, 64, 64),  # 4 chunks of one block
)
# batch sizes of the product check: the training step's and K5's default chunk
MONO_STEPS = 20
# K5's chunks (windows) swept at B=2048 ghost 64, each at one and two chunks
# in flight, beside the byte budget's chunk at each
MONO_CHUNK_SWEEP = (64, 128, 256, 512, 1024, 2048)
# K5's schedule before its byte budget: a mono step's peak is also taken at it
MONO_PARENT_SCHEDULE = dict(chunk_windows=128, in_flight=1)
# probes: elementwise jobs are exact; sums of up to 16,384 exact bf16
# products in f32, in another order than the plain version's
PROBE_SUM_TOL = dict(rtol=1e-5, atol=2e-3)
PROBE_CALLS = 30  # calls a probe job's times are taken over
PROBE_MIN_CALLS = 20  # of them traced whole (the profiler drops an event now and then)
CALL_GAP_S = 1e-3  # idle between two traced calls, which marks where a call ends
# torch.profiler now and then returns a trace with no device events at all, or
# too few whole calls: a trace is taken again up to this many times in all,
# and a probe time then falls back to CUDA events (queued_ms)
TRACE_TRIES = 3
# a device-side sleep (~10 ms at the H100's clock) that queued_ms's calls are
# queued behind, so the host's launch cost is hidden from the CUDA events
QUEUE_LEAD_CYCLES = 20_000_000
QUEUE_TIMED = "every kernel of a call, by CUDA events (queued_ms)"
QUEUE_TIMED_GAPS = "every kernel of a call and the host's gaps, by CUDA events (queued_ms)"
TIMED_BY = {QUEUE_TIMED: "cuda_events", QUEUE_TIMED_GAPS: "cuda_events_with_host_gaps"}
L2_SCRUB_BYTES = 128 << 20  # written between calls to take inputs out of the 50 MB L2
SCORE_TOL = dict(rtol=1e-3, atol=1e-6)  # scores square latent differences
REFUSED_FRAMES = 28  # at 18 joints K1's planner takes up to 27 frames
BF16_FORMS = ("bfloat16", "bfloat16_f32store")
# kernel vs its plain version in the same bf16 form: the two round at the same
# points, but a value the kernel sums in fp32 and the plain version in float64
# can land on the other side of a rounding boundary: 1 ulp, <= 2^-7 of it
BF16_BAND = 2.0 ** -7
BF16_COSINE = 0.98  # K5 vs its plain version (tests/test_fused_train_kernel.py:226-233)
# (label, model, batch, ghost) of the bf16 form checks; the first is timed
BF16_KERNEL_CASES = (TRAIN_KERNEL_CASES[0], TRAIN_KERNEL_CASES[2])
# the bf16 fit against the module path at bf16 (per-step losses): two bf16
# functions that round at other points, each 2^-8 a rounding point
BF16_LOSS_BAND = 2.0 ** -5
BF16_EPOCHS = 2
BF16_BAND_STEPS = 3
MONO_BF16_STEPS = 5
# the bf16 fused step's peak above resident with fp32 backward scratch (PERF.md
# section 5, PR 11's chip run 2), printed beside this run's
BF16_PEAK_PR11 = 778_605_568
# the same with bf16 backward scratch but fp32 activations and K2 t/r scratch
# (PERF.md section 5, NVIDIA H100 80GB HBM3 at 700 W): this run's, with bf16
# activations and K2 scratch, must be lower
BF16_PEAK_F32_ACTS = 553_161_728
DEVICE = "cuda"
# csrc/stse_train.cu's kernels, as the profiler names them: K2-K4's device time
# in an epoch trace
FORWARD_PASSES = ("fwd_pre_kernel", "fwd_stats_kernel", "fwd_sums_kernel", "fwd_apply_kernel",
                  "projector_z_kernel", "projector_sum_kernel")
TRAIN_KERNELS = (*FORWARD_PASSES, "graph_operand_kernel", "projector_dy_kernel", "bwd_pre_kernel",
                 "bwd_consts_kernel", "bwd_reduce_kernel", "bwd_dx_kernel", "product_rows_kernel",
                 "product_windows_kernel", "sum_splits_kernel")
TRAIN_CLIPS, VAL_CLIPS = 100, 20  # x 2 actors x 200 windows: 40,000 and 8,000 windows
# the cli phase's AlphaPose tree: clips x 2 actors x (frames - 11) stride-1 windows
CLI_TRAIN_CLIPS, CLI_TEST_CLIPS, CLI_FRAMES = 4, 2, 1100
# the paper phase's training clips, half the cli phase's: at 4, its 7 fits took 97.4 s of a
# 387.7 s run on an NVIDIA H100 80GB HBM3 at 700.00 W
PAPER_TRAIN_CLIPS = 2
# the variants phase's training clips, the paper phase's 2 (at the cli tree's 4 the phase
# took 53.4 s of a 317.2 s run on an NVIDIA H100 80GB HBM3 at 700.00 W)
VARIANTS_TRAIN_CLIPS = 2
CLI_ANOMALY = (400, 550)  # frames where actor 1 of each test clip scatters
CLI_MIN_WINDOWS = 8192
CLI_SERVED = 4096  # test windows from_checkpoint scores against cli.eval's scores
RESUME_RTOL = 1e-5  # third-epoch loss, resumed against straight, on the card
# the pipeline phase's tree: bench.py's store of 100 persons x 412 frames
PIPE_CLIPS, PIPE_ACTORS, PIPE_FRAMES = 50, 2, 412
PIPE_EPOCHS = 2
PIPE_INDICES = 2048  # logical indices of the batch check
PIPE_BATCH_TOL = dict(rtol=1e-5, atol=1e-6)  # float32 normalization vs the host's float64
PIPE_TURNS = 2  # parse and scoring passes a side, in turns
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def launch_counters() -> dict:
    """K1-K5's launch counters by kernel name: each wrapper adds one where
    it launches its kernel and nowhere else."""
    from coskad_tpu_torch.kernels import stse_fused
    from coskad_tpu_torch.kernels import stse_train as st

    return dict(stse_fused=stse_fused.launches, stse_train_forward=st.forward_launches,
                stse_train_layer_backward=st.layer_backward_launches,
                stse_train_top_backward=st.top_backward_launches,
                stse_train_mono_backward=st.mono_backward_launches)


def zero(counters: dict):
    for c in counters.values():
        c.value = 0


def read(counters: dict) -> dict:
    return {k: c.value for k, c in counters.items()}


def within(a, b, rtol, atol) -> bool:
    import torch

    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_of(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    """(bound ms, what bounds it): the larger of operations over the peak
    rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def seeded_train_stse(gen, device, **kw):
    """STSE with torch-default weights from `gen`, BN affines and PReLU
    slopes jittered (`jitter_affine`), on `device`."""
    from coskad_tpu_torch.models import STSE

    model = STSE(**kw)
    model.reset_parameters(gen)
    jitter_affine(model, gen)
    return model.to(device)


def seeded_stse(gen, device, **kw):
    """STSE with torch-default weights from `gen` and non-trivial running
    BatchNorm statistics, in eval mode on `device`."""
    import torch
    from coskad_tpu_torch.models import STSE

    model = STSE(**kw)
    model.reset_parameters(gen)
    jitter_bn(model, gen)
    return model.to(device).eval()


def jitter_bn(model, gen):
    import torch

    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.empty(buf.shape).uniform_(-0.5, 0.5, generator=gen))
            elif name.endswith(".var"):
                buf.copy_(torch.empty(buf.shape).uniform_(0.5, 2.0, generator=gen))


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"device 0 {torch.cuda.get_device_name(0)}; TF32 allowed in matmuls "
          f"{torch.backends.cuda.matmul.allow_tf32}, in cuDNN {torch.backends.cudnn.allow_tf32} "
          "(PyTorch's defaults, left as they are)")

    from coskad_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    regs = [line.strip() for k in build.KERNELS for line in build.ptxas_report(k).splitlines()
            if "registers" in line or "spill" in line]
    print(f"build: {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} in "
          f"{build_s:.1f} s; ptxas: {' | '.join(regs)}")
    return card, build_s


def folded_f64(folded):
    """The folded weights in float64, for the plain version's float64 run."""
    from coskad_tpu_torch.kernels import stse_fused

    f64 = lambda t: None if t is None else t.double()  # noqa: E731
    return stse_fused.FoldedSTSE(
        [stse_fused.FoldedLayer(*(t.double() for t in lay)) for lay in folded.layers],
        f64(folded.w_proj), f64(folded.b_proj))


def phase_kernel(card):
    """K1 against its plain version on the card, in fp32 and float64, and
    launched twice for the same bits; each flagship layer's time alone with
    its windows a block, shared bytes and blocks an SM. Returns its kernel
    record."""
    import torch
    from coskad_tpu_torch.kernels import stse_fused

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1234)
    full = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
                latent_dim=16, n_frames=12, n_joints=18)
    model = seeded_stse(gen, dev, **full)
    folded, packed = model.folded()
    occupancy = stse_fused.occupancy(packed)
    wb = occupancy["windows_per_block"]
    cases = []
    x_main = None
    # the paper's configs: 17 joints (204 nodes, 13 tiles, the last of 12),
    # the MLP projector; the latent is K1 then the head in eval mode
    paper = dict(full, n_joints=17, projector="mlp")
    for label, kw, batch in (("full_B2048", full, 2048), ("full_B2047", full, 2047),
                             (f"full_B{wb + 1}_ragged_block", full, wb + 1),
                             ("paper_V17_mlp_B2048", paper, 2048),
                             ("paper_V17_mlp_B2047", paper, 2047),
                             ("identity_residual_B64",
                              dict(input_dim=8, layer_channels=(8,), hidden_dimension=8,
                                   latent_dim=4, n_frames=6, n_joints=5), 64),
                             ("narrowing_last_layer_B64",
                              dict(input_dim=2, layer_channels=(16,), hidden_dimension=8,
                                   latent_dim=4, n_frames=5, n_joints=7), 64)):
        m = model if kw is full else seeded_stse(gen, dev, **kw)
        f, p = m.folded()
        x = torch.randn(batch, kw["input_dim"], kw["n_frames"], kw["n_joints"],
                        generator=gen).to(dev)
        with torch.no_grad():
            h_k = stse_fused.fused_stse_hidden(x, f, p)
            h_again = stse_fused.fused_stse_hidden(x, f, p)
            h_r = stse_fused.fused_stse_hidden_reference(x, f)
            h_64 = stse_fused.fused_stse_hidden_reference(x.double(), folded_f64(f))
            if f.w_proj is None:  # the MLP head: STSE.forward's CUDA route
                z_k, z_r = m(x), m._project(h_r, train=False)
            else:
                z_k = stse_fused.fused_stse_forward(x, f, p)
                z_r = stse_fused.fused_stse_forward_reference(x, f)
        torch.cuda.synchronize()
        err_h = float((h_k - h_r).abs().max())
        err_64 = float((h_k.double() - h_64).abs().max())
        err_z = float((z_k - z_r).abs().max())
        same_bits = torch_equal(h_k, h_again)
        ok = (within(h_k, h_r, **TOL) and within(h_k.double(), h_64, **TOL)
              and within(z_k, z_r, **TOL) and bool(torch.isfinite(h_k).all()))
        cases.append(dict(case=label, batch=batch, max_abs_err_hidden=err_h,
                          max_abs_err_hidden_f64=err_64, max_abs_err_latent=err_z,
                          same_bits_twice=same_bits, ok=ok))
        check(ok, f"stse_fused {label}: kernel vs plain max abs err hidden {err_h:.3e} "
                  f"(float64 {err_64:.3e}), latent {err_z:.3e} outside rtol {TOL['rtol']} "
                  f"atol {TOL['atol']}")
        check(same_bits, f"stse_fused {label}: two launches gave different bits")
        if label == "full_B2048":
            x_main = x
        if label == "paper_V17_mlp_B2048":
            x_paper, f_paper, p_paper = x, f, p

    # K1 has no backward: the eval forward on the card raises where autograd
    # would record it, rather than return a latent cut from the graph.
    try:
        model(x_main[:4])
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check("no_grad" in raised, "STSE.forward(train=False) with grad mode on did not raise on the "
                               "card")
    refused = refused_route(gen, dev)
    bf16 = k1_bf16(gen, dev, card)
    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: stse_fused.fused_stse_hidden(x_main, folded, packed))
        plain_ms = cuda_ms(lambda: stse_fused.fused_stse_hidden_reference(x_main, folded))
        kernel_ms_2 = cuda_ms(lambda: stse_fused.fused_stse_hidden(x_main, folded, packed))
        plain_ms_2 = cuda_ms(lambda: stse_fused.fused_stse_hidden_reference(x_main, folded))
        per_layer_ms, layers = {}, {}
        for lay in folded.layers:  # each layer alone, as a one-layer stack
            one = folded._replace(layers=[lay])
            one_packed = stse_fused.pack_folded(one)
            x1 = torch.randn(2048, lay.w.shape[0], 12, 18, generator=gen).to(dev)
            name = "{}->{}".format(*lay.w.shape)
            per_layer_ms[name] = cuda_ms(lambda: stse_fused.fused_stse_hidden(x1, one, one_packed))
            layers[name] = dict(ms=per_layer_ms[name], **stse_fused.occupancy(one_packed))
    flops, nbytes = stse_fused.work(folded, 2048)
    # every FLOP runs on the tensor cores as 3xTF32: three TF32 products for each
    bound_ms, bound_by = bound_of(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    paper_v17 = k1_timing(x_paper, f_paper, p_paper)
    rec = dict(
        name="stse_fused", route="cuda", source=stse_fused.SOURCE,
        replaces=stse_fused.REPLACES, launches=None,
        max_abs_err=max(c["max_abs_err_hidden"] for c in cases),
        tolerance=TOL, ms=min(kernel_ms, kernel_ms_2), kernel_ms=min(kernel_ms, kernel_ms_2),
        plain_ms=min(plain_ms, plain_ms_2), bound_ms=bound_ms, bound_by=bound_by,
        bound_fp32_ms=bound_of(flops, nbytes)[0], library_ms=None,
        batch=2048, flops=flops, bytes=nbytes, cases=cases, per_layer_ms=per_layer_ms,
        layers=layers, occupancy=occupancy, paper_v17=paper_v17, refused_layout_route=refused,
        timing_runs_ms=dict(kernel=[kernel_ms, kernel_ms_2], plain=[plain_ms, plain_ms_2]),
        bf16=bf16,
    )
    print("kernel check: " + json.dumps(dict(
        name="stse_fused", cases=cases, eval_forward_with_grad_raises=True,
        refused_layout_route=refused, kernel_ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        bound_fp32_ms=rec["bound_fp32_ms"], paper_v17=paper_v17, card=card)))
    print("K1 layers: " + json.dumps(dict(stack=occupancy, layers=layers, card=card)))
    return rec


def k1_bf16(gen, dev, card) -> dict:
    """K1's bf16 form at the HR-STC widths (sts_gcn 2->32->16->32->64, 17
    joints, the MLP head, compute dtype bfloat16) on the card: against its
    plain version there (the module path's operations and rounding points,
    summed in cuBLAS's order) and the model's module route, within the bf16
    band (values on the two sides of a rounding boundary: 2^-5 of the scale,
    as tests/test_torch_bf16.py) with most values the same bits; launched
    twice for the same bits; one `bf16_launches` a call; STSE.forward's
    latent against the module route's. Then, at 2048 windows, in turns: the
    kernel, its plain version, the module route's hidden state
    (`STSE.encode`) and STSE.forward on either route (CUDA events over the
    calls: the module route's host enqueue shows), beside its bound."""
    import torch
    from coskad_tpu_torch.kernels import stse_fused

    kw = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64, latent_dim=16,
              n_frames=12, n_joints=17, projector="mlp", dtype=torch.bfloat16)
    model = seeded_stse(gen, dev, **kw)
    check(model.kernel_takes(), "K1's bf16 form does not take the HR-STC layout")
    folded, packed = model.folded()
    occupancy = stse_fused.occupancy(packed)
    cases, x_main = [], None
    for batch in (2048, 2047, occupancy["windows_per_block"] + 1):
        x = torch.randn(batch, 2, 12, 17, generator=gen).to(dev)
        with torch.no_grad():
            before = stse_fused.bf16_launches.value
            h_k = stse_fused.fused_stse_hidden(x, folded, packed)
            h_again = stse_fused.fused_stse_hidden(x, folded, packed)
            launched = stse_fused.bf16_launches.value - before
            h_r = stse_fused.fused_stse_hidden_bf16_reference(x, folded)
            z_m, h_m = model.encode(x)
            h_m = h_m.reshape(h_k.shape)
            z_k = model(x)
        torch.cuda.synchronize()
        band = 2.0 ** -5 * max(float(h_r.abs().max()), 1.0)
        err_r = float((h_k - h_r).abs().max())
        err_m = float((h_k - h_m).abs().max())
        err_z = float((z_k - z_m).abs().max())
        same = float((h_k == h_m).float().mean())
        ok = (bool(torch.isfinite(h_k).all()) and err_r <= band and err_m <= band
              and err_z <= 2.0 ** -5 * max(float(z_m.abs().max()), 1.0) and same > 0.9)
        cases.append(dict(batch=batch, max_abs_err_plain=err_r, max_abs_err_module=err_m,
                          max_abs_err_latent=err_z, share_same_bits_module=same,
                          same_bits_twice=torch_equal(h_k, h_again), bf16_launches=launched,
                          ok=ok))
        check(ok, f"K1 bf16 B={batch}: err vs plain {err_r:.3e}, vs module route {err_m:.3e} "
                  f"(band {band:.3e}), latent {err_z:.3e}, same bits {same:.4f}")
        check(cases[-1]["same_bits_twice"], f"K1 bf16 B={batch}: two launches, other bits")
        check(launched == 2, f"K1 bf16 B={batch}: {launched} bf16 launches for 2 calls")
        if x_main is None:
            x_main = x

    def module_forward():
        with module_route(model):
            return model(x_main)

    calls = dict(kernel=lambda: stse_fused.fused_stse_hidden(x_main, folded, packed),
                 plain=lambda: stse_fused.fused_stse_hidden_bf16_reference(x_main, folded),
                 module_hidden=lambda: model.encode(x_main)[1],
                 forward_k1=lambda: model(x_main), forward_module=module_forward)
    with torch.inference_mode():
        runs = {k: [] for k in calls}
        for _ in range(2):
            for k, fn in calls.items():
                runs[k].append(cuda_ms(fn))
    flops, nbytes = stse_fused.work(folded, 2048)
    bound_ms, bound_by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
    rec = dict(name="stse_fused_bf16", source=stse_fused.SOURCE, batch=2048,
               nodes=packed.n_nodes, kernel_ms=min(runs["kernel"]),
               plain_ms=min(runs["plain"]), module_hidden_ms=min(runs["module_hidden"]),
               forward_k1_ms=min(runs["forward_k1"]),
               forward_module_ms=min(runs["forward_module"]), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes, occupancy=occupancy,
               cases=cases, runs_ms=runs)
    print("K1 bf16: " + json.dumps(dict(rec, card=card)))
    return rec


def refused_route(gen, dev) -> dict:
    """The eval route for a layout K1's planner refuses (the flagship's
    channels over 28 frames at 18 joints: its activations pass a block's
    shared memory): STSE.forward(train=False) on the card takes the model's
    own layers, launches no K1, does not raise with grad mode on, and its
    latent is the CPU module path's on the same weights."""
    import torch
    from coskad_tpu_torch.kernels import stse_fused

    kw = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64, latent_dim=16,
              n_frames=REFUSED_FRAMES, n_joints=18)
    model = seeded_stse(gen, dev, **kw)
    check(not model.kernel_takes(), f"K1's planner takes {REFUSED_FRAMES} frames at 18 joints")
    x = torch.randn(256, 2, REFUSED_FRAMES, 18, generator=gen).to(dev)
    before = stse_fused.launches.value
    z = model(x)  # grad mode on: the module route is differentiable and does not raise
    torch.cuda.synchronize()
    check(stse_fused.launches.value == before, "the refused layout launched K1")
    cpu = seeded_stse(torch.Generator(), "cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        z_cpu = cpu(x.cpu())
    err = float((z.detach().cpu() - z_cpu).abs().max())
    check(bool(torch.isfinite(z).all()) and within(z.detach().cpu(), z_cpu, **TOL),
          f"refused layout: card module route vs CPU max abs err {err:.3e}")
    return dict(frames=REFUSED_FRAMES, joints=18, batch=256, kernel_takes=False,
                k1_launches=0, max_abs_err_vs_cpu=err, requires_grad=z.requires_grad)


def k1_timing(x, folded, packed) -> dict:
    """K1's time on x against its plain version's, in turns, and its bound
    for this batch (3xTF32 on the tensor cores, or bytes)."""
    import torch
    from coskad_tpu_torch.kernels import stse_fused

    with torch.no_grad():
        runs = [cuda_ms(lambda: fn(x, folded, packed)) for _ in range(2) for fn in (
            stse_fused.fused_stse_hidden,
            lambda a, b, _: stse_fused.fused_stse_hidden_reference(a, b))]
    flops, nbytes = stse_fused.work(folded, x.shape[0])
    bound_ms, bound_by = bound_of(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    return dict(batch=x.shape[0], nodes=packed.n_nodes, kernel_ms=min(runs[0::2]),
                plain_ms=min(runs[1::2]), bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, bytes=nbytes)


def synthetic_windows(rng, n_clips, n_actors, n_windows, seg_len, n_joints,
                      anomalous=None):
    """Random-walk skeletons windowed at stride 1: data [N, 3, T, V] (x, y,
    confidence), meta [N, 4], frame_ids [N, T], and per-clip ground truth.
    With `anomalous` = (lo, hi), actor 1 of every clip jumps in frames lo..hi."""
    n_frames = n_windows + seg_len - 1
    steps = rng.normal(scale=0.02, size=(n_clips, n_actors, n_frames, n_joints, 2))
    traj = rng.normal(scale=0.3, size=(n_clips, n_actors, 1, n_joints, 2)) + steps.cumsum(2)
    gt = np.zeros(n_frames, np.int64)
    if anomalous is not None:
        lo, hi = anomalous
        gt[lo:hi] = 1
        traj[:, 0, lo:hi] += rng.normal(scale=0.5, size=(n_clips, hi - lo, n_joints, 2))
    conf = rng.uniform(0.5, 1.0, size=traj.shape[:-1] + (1,))
    frames = np.concatenate([traj, conf], axis=-1)  # [clips, actors, F, V, 3]
    starts = np.arange(n_windows)
    win = frames[:, :, starts[:, None] + np.arange(seg_len)]  # [clips, actors, W, T, V, 3]
    data = win.reshape(-1, seg_len, n_joints, 3).transpose(0, 3, 1, 2).astype(np.float32)
    clip, actor, start = np.meshgrid(np.arange(1, n_clips + 1), np.arange(1, n_actors + 1),
                                     starts, indexing="ij")
    meta = np.stack([np.ones_like(clip), clip, actor, start + 1], -1).reshape(-1, 4)
    frame_ids = (meta[:, 3:4] + np.arange(seg_len)).astype(np.int32)
    gts = {(1, c): gt for c in range(1, n_clips + 1)}
    return data, meta.astype(np.int64), frame_ids, gts


def write_clip_json(path, rng, n_frames, n_joints=17, n_actors=2, anomalous=None):
    """An AlphaPose clip of random-walk actors; with `anomalous` = (lo, hi),
    actor 1 scatters over the frame in frames lo..hi (1-based: lo+1..hi)."""
    clip = {}
    for pid in range(1, n_actors + 1):
        base = rng.uniform(150, 500, size=(n_joints, 2))
        frames = {}
        for f in range(1, n_frames + 1):
            base = base + rng.normal(scale=1.5, size=(n_joints, 2))
            pos = base
            if anomalous is not None and pid == 1 and anomalous[0] < f <= anomalous[1]:
                pos = rng.uniform(0, 856, size=(n_joints, 2))
            kp = np.concatenate([pos, rng.uniform(0.5, 1.0, size=(n_joints, 1))], -1)
            frames[f"{f:04d}"] = {"keypoints": kp.reshape(-1).tolist()}
        clip[str(pid)] = frames
    with open(path, "w") as f:
        json.dump(clip, f)


def phase_slice(card):
    import torch
    from coskad_tpu_torch.config import Config, DataConfig, ModelConfig, RunConfig
    from coskad_tpu_torch.data.windows import SegmentDataset
    from coskad_tpu_torch.kernels import stse_fused
    from coskad_tpu_torch.serve import AnomalyScorer
    from coskad_tpu_torch.train.loop import Trainer

    cfg = Config(
        model=ModelConfig(variant="euclidean_static", channels=(32, 16, 32), h_dim=64,
                          latent_dim=16, projector="linear"),
        data=DataConfig(seg_len=12, kp18_format=True, num_transform=5, batch_size=2048),
        run=RunConfig(seed=0),
    )
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    data, meta, fids, _ = synthetic_windows(rng, TRAIN_CLIPS, 2, 200, 12, 18)
    train_ds = SegmentDataset(data, meta, fids, num_transform=5)
    vdata, vmeta, vfids, gts = synthetic_windows(rng, VAL_CLIPS, 2, 200, 12, 18,
                                                 anomalous=(80, 130))
    val_ds = SegmentDataset(vdata, vmeta, vfids, num_transform=5)
    check(train_ds.num_windows == TRAIN_CLIPS * 400, "resident set is 400 windows a clip")
    trainer = Trainer(cfg, train_ds, val_ds=val_ds, ground_truths=gts, device=DEVICE)
    jitter_bn(trainer.model, torch.Generator().manual_seed(7))
    scorer = AnomalyScorer(cfg, None, trainer=trainer)
    clip_dir = tempfile.mkdtemp(prefix="coskad_clip_")
    clip_path = os.path.join(clip_dir, "01_0001_tracked.json")
    write_clip_json(clip_path, rng, n_frames=300)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the main path, counted ---
    stse_fused.launches.value = 0
    t0 = time.perf_counter()
    state = trainer.initialize_center(trainer.init_state())
    torch.cuda.synchronize()
    center_s = time.perf_counter() - t0
    scorer.state = state
    t0 = time.perf_counter()
    scores, _ = trainer.score_all(state, train_ds, trainer.train_data)
    torch.cuda.synchronize()
    first_score_s = time.perf_counter() - t0
    result = trainer.validate(state)
    clip_scores = scorer.score_clip_json(clip_path)
    launches = {"stse_fused": stse_fused.launches.value}
    # --- end of the counted run ---

    n_items = len(train_ds)
    check(scores.shape == (n_items,) and bool(np.isfinite(scores).all())
          and bool((scores >= 0).all()), "score_all gives finite non-negative scores")
    check(bool(torch.isfinite(state.center).all()), "center is finite")
    check(result is not None and np.isfinite(result.auc) and 0.0 <= result.auc <= 1.0,
          f"validation AUC finite in [0, 1], got {None if result is None else result.auc}")
    check(clip_scores.ndim == 1 and len(clip_scores) > 0,
          "score_clip_json gives one score per frame")
    check(bool(np.isfinite(clip_scores).all()), "clip scores are finite")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the slice's main path")

    # The same scores from the plain CPU path on a subset (not counted).
    sub = SegmentDataset(data[:400], meta[:400], fids[:400], num_transform=5)
    cpu = Trainer(cfg, sub, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    cpu_state = cpu.init_state().replace(center=state.center.cpu())
    s_gpu, _ = trainer.score_all(state, sub, trainer._device_data(sub))
    s_cpu, _ = cpu.score_all(cpu_state, sub, cpu.train_data)
    ref_err = float(np.abs(s_gpu - s_cpu).max())
    check(np.allclose(s_gpu, s_cpu, **SCORE_TOL),
          f"CUDA scores vs plain CPU path: max abs err {ref_err:.3e}")

    # Steady state: the first pass above also pays each kernel's first-launch
    # cost (lazy module loading), so throughput is the best of two more.
    steady = []
    for _ in range(2):
        t0 = time.perf_counter()
        trainer.score_all(state, train_ds, trainer.train_data)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    score_s = min(steady)
    wps = n_items / score_s
    breakdown = stage_breakdown(trainer, state, train_ds)
    breakdown["score_all_batch_host_clock"] = score_s * 1e3 / -(-n_items // cfg.data.batch_size)
    trace = device_profile(lambda: trainer.score_all(state, train_ds, trainer.train_data))
    summary = dict(
        windows=train_ds.num_windows, items=n_items, batch=cfg.data.batch_size,
        setup_s=setup_s, initialize_center_s=center_s, score_all_first_s=first_score_s,
        score_all_steady_s=steady, windows_per_s=wps, auc=result.auc,
        clip_frames=int(clip_scores.shape[0]), launches=launches,
        cpu_subset_max_abs_err=ref_err, breakdown_ms=breakdown, trace=trace, card=card,
    )
    print(f"slice: score_all {n_items} items in {score_s:.4f} s = {wps:.0f} windows/s "
          f"(steady, best of {[round(t, 4) for t in steady]} s; first pass "
          f"{first_score_s:.4f} s) on {card}; initialize_center {center_s:.3f} s; "
          f"validation AUC {result.auc:.4f}; clip frames {clip_scores.shape[0]}; "
          f"launches {launches}; CPU-subset max abs err {ref_err:.2e}")
    print("slice breakdown per 2048-window batch (ms; stages by CUDA events, batch by host "
          "clock): " + json.dumps(breakdown))
    print("slice trace of one score_all pass (torch.profiler): " + json.dumps(trace))
    return summary


def device_profile(fn):
    """Device busy time, span and idle share of one call of fn, and the
    share of device time in the port's kernels, from torch.profiler."""
    from torch.profiler import ProfilerActivity

    events = device_events(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    busy = sum(e.time_range.elapsed_us() for e in events)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    k1 = sum(e.time_range.elapsed_us() for e in events if "stse_fused_kernel" in e.name)
    by_name = ms_by_kernel(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    return dict(device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
                idle_share=1.0 - busy / span, stse_fused_share_of_busy=k1 / busy,
                device_events=len(events), top_device_ms={k: v for k, v in top},
                train_kernels_ms=sum(v for k, v in by_name.items() if k in TRAIN_KERNELS))


def kernel_name(e) -> str:
    """A profiler event's kernel name, namespace and arguments cut off."""
    name = e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name[len("void "):] if name.startswith("void ") else name


def ms_by_kernel(events) -> dict:
    """Device ms of profiler events summed by kernel name."""
    out = {}
    for e in events:
        out[kernel_name(e)] = out.get(kernel_name(e), 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def device_events(fn, activities) -> list:
    """The device events of one call of fn, from torch.profiler. A trace
    with none is one the profiler lost (every caller's fn launches
    kernels): fn is called and traced again, up to TRACE_TRIES calls."""
    import torch
    from torch.profiler import profile

    for _ in range(TRACE_TRIES):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        print(f"torch.profiler recorded no device activity in a trace (of {TRACE_TRIES} tries)")
    raise RuntimeError(f"chip_smoke check failed: torch.profiler recorded no device activity in "
                       f"{TRACE_TRIES} traces")


def traced_spans(fn) -> list:
    """(kernel name, start us, end us) of each device event in one call of
    fn, in the order they ran, from torch.profiler."""
    from torch.profiler import ProfilerActivity

    events = sorted(device_events(fn, [ProfilerActivity.CUDA]), key=lambda e: e.time_range.start)
    return [(kernel_name(e), e.time_range.start, e.time_range.end) for e in events]


def traced_launches(fn) -> list:
    """(kernel name, device ms) of each launch in one call of fn, in the
    order they ran, from torch.profiler."""
    return [(name, (end - start) / 1e3) for name, start, end in traced_spans(fn)]


def traced_ms(fn) -> dict:
    """Device ms by kernel name of one call of fn, from torch.profiler."""
    out = {}
    for name, ms in traced_launches(fn):
        out[name] = out.get(name, 0.0) + ms
    return out


def stage_breakdown(trainer, state, ds):
    """Device time of each stage of one scoring batch (CUDA events)."""
    import torch
    from coskad_tpu_torch.geometry import euclidean
    from coskad_tpu_torch.kernels import stse_fused

    idx, _ = trainer._chunked_indices(len(ds))
    ws = trainer._window_shape_of(ds)
    folded, packed = trainer.model.folded()
    with torch.inference_mode():
        batch = trainer._gather(trainer.train_data, idx[0], ws)
        hidden = stse_fused.fused_stse_hidden(batch, folded, packed)
        flat = hidden.reshape(hidden.shape[0], -1)
        z = flat @ folded.w_proj + folded.b_proj
        out = dict(
            gather=cuda_ms(lambda: trainer._gather(trainer.train_data, idx[0], ws)),
            encoder_kernel=cuda_ms(lambda: stse_fused.fused_stse_hidden(batch, folded, packed)),
            projector_matmul=cuda_ms(lambda: flat @ folded.w_proj + folded.b_proj),
            distance=cuda_ms(lambda: euclidean.mse_to_center(z, state.center)),
        )
    return out


def jitter_affine(model, gen):
    """BN affines away from (1, 0) and PReLU slopes away from 0.25, so the
    ghost-BN backward has no trivial terms."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_bn.scale"):
                p.copy_(torch.empty(p.shape).uniform_(0.5, 1.5, generator=gen))
            elif name.endswith("_bn.bias"):
                p.copy_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen))
            elif name.endswith("alpha"):
                p.fill_(float(torch.empty(()).uniform_(0.1, 0.4, generator=gen)))


def grad_err(got, want) -> tuple:
    """(max abs err, whether it is inside err < GRAD_RTOL * max(scale, 1) + GRAD_ATOL)."""
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    return err, err < GRAD_RTOL * max(scale, 1.0) + GRAD_ATOL


def products_bound(flops, prod_flops, nbytes):
    """(bound ms, what bounds it) of work whose `prod_flops` run as 3xTF32
    on the tensor cores and the rest as fp32 outside them."""
    t_ops = ((flops - prod_flops) / PEAK_FP32_FLOPS + 3.0 * prod_flops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_products(card, ops, compute_dtype="float32"):
    """Each batch-reduction product of a split backward step (dW, dW_res and
    dM a layer, dwp), alone through stse_train.product at the flagship
    width, at B=2048 and at K5's chunk at that batch, in `compute_dtype`: error
    against float64 einsum (of the bf16-rounded operands under a bf16 form)
    on the card, kernel ms, library_ms (the same product as one torch.mm /
    torch.einsum call, fp32 with TF32 off, or under "bfloat16" of the bf16
    operands; timed only, never called by the port) and the bound (3xTF32
    FLOPs on the tensor cores, or bf16 FLOPs at 989 TFLOP/s, or bytes).
    Under "bfloat16" the operands K3-K5 keep in scratch (g, dt, dr, dg) are
    bf16 tensors, as the kernels hand them over, the others float32. The
    operands are random: a product's cost does not depend on its values."""
    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    dgen = torch.Generator(device=dev).manual_seed(97)
    bf16 = compute_dtype == "bfloat16"

    def library(form, a, b):
        if bf16:
            a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        return torch.mm(a.t(), b) if form == "rows" else torch.einsum("wpk,wqk->pq", a, b)

    results = []
    for batch in (TRAIN_BATCH, st.mono_chunk(ops, TRAIN_BATCH, 64, compute_dtype)):
        for pr in st.products(ops, batch):
            form, p, q, n, k = (pr[f] for f in ("form", "p", "q", "n", "k"))
            a = torch.randn(*((n, p) if form == "rows" else (n, p, k)), generator=dgen,
                            device=dev)
            b = torch.randn(*((n, q) if form == "rows" else (n, q, k)), generator=dgen,
                            device=dev)
            if bf16:  # the scratch operands as K3-K5 store them
                a = a.to(st.scratch_dtype(compute_dtype)) if pr["a_scratch"] else a
                b = b.to(st.scratch_dtype(compute_dtype)) if pr["b_scratch"] else b
            got = st.product(form, a, b, compute_dtype)
            want = st.product_reference(form, a.double(), b.double(), compute_dtype).float()
            torch.cuda.synchronize()
            err, ok = grad_err(got, want)
            check(ok and bool(torch.isfinite(got).all()),
                  f"product {pr['name']} at B={batch}: max abs err {err:.3e} vs float64 einsum, "
                  f"scale {float(want.abs().max()):.3e}")
            del want
            runs = dict(kernel=[], library=[])
            for _ in range(2):
                runs["kernel"].append(cuda_ms(lambda: st.product(form, a, b, compute_dtype),
                                              iters=10, warmup=2))
                runs["library"].append(cuda_ms(lambda: library(form, a, b), iters=10, warmup=2))
            # each operand read once at its stored size, the output written once
            nbytes = n * k * (p * a.element_size() + q * b.element_size()) + 4.0 * p * q
            if bf16:
                bound_ms, bound_by = bound_of(pr["flops"], nbytes, PEAK_BF16_FLOPS)
            else:
                bound_ms, bound_by = products_bound(pr["flops"], pr["flops"], nbytes)
            results.append(dict(
                name=pr["name"], kernel=pr["key"], batch=batch, form=form, p=p, q=q, n=n, k=k,
                splits=st.product_splits(form, p, q, n, k), max_abs_err=err,
                ms=min(runs["kernel"]), library_ms=min(runs["library"]), bound_ms=bound_ms,
                bound_by=bound_by, flops=pr["flops"], bytes=nbytes, timing_runs_ms=runs,
                operand_dtypes=[str(a.dtype), str(b.dtype)]))
            del a, b, got
    torch.cuda.empty_cache()
    label = "product check" + ("" if compute_dtype == "float32" else f" {compute_dtype}")
    print(f"{label}: " + json.dumps(dict(card=card, products=[
        {k: r[k] for k in ("name", "batch", "splits", "max_abs_err", "ms", "library_ms",
                           "bound_ms", "bound_by")} for r in results])))
    return results


def phase_train_kernels(card):
    """K2, K3 and K4 against their plain versions on the card; returns their
    kernel records (launches filled in by the training phase)."""
    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(4321)
    errs = {"K2": [], "K3": [], "K4": []}
    results, timing, work, timed = [], {}, {}, TRAIN_KERNEL_CASES[0]
    for label, kw, batch, ghost in TRAIN_KERNEL_CASES:
        model = seeded_train_stse(gen, dev, **kw)
        ops = st.detached(st.encoder_ops(model))
        # The plain versions run in float64: a channel whose spread is small
        # against its mean (layer 0 mixes only 2 input channels) loses more
        # to fp32 rounding in the plain E[t^2] - E[t]^2 than the tolerance.
        ops64 = st.detached(ops, torch.float64)
        n = kw["n_frames"] * kw["n_joints"]
        x = torch.randn(batch, n, kw["input_dim"], generator=gen).to(dev)
        dz = torch.randn(batch, kw["latent_dim"], generator=gen).to(dev)
        z, sums, acts, stats = st.ghost_forward(x, ops, ghost)
        ref = st.ghost_forward_reference(x.double(), ops64, ghost)
        z_r, sums_r, acts_r, stats_r = (ref[0].float(), *([t.float() for t in r] for r in ref[1:]))
        torch.cuda.synchronize()
        # The full-batch sums are compared as moments (sum / count), what the
        # running statistics take from them: a sum over 442,368 rows has an
        # absolute rounding error no fixed atol fits.
        cnt = batch * n
        outs = dict(z=(z, z_r), **{f"sums{l}": (a / cnt, b / cnt) for l, (a, b) in
                                   enumerate(zip(sums, sums_r))},
                    **{f"act{l}": p for l, p in enumerate(zip(acts, acts_r))},
                    **{f"stats{l}": p for l, p in enumerate(zip(stats, stats_r))})
        fwd = {k: float((a - b).abs().max()) for k, (a, b) in outs.items()}
        bad = [f"{k} err {fwd[k]:.3e}" for k, (a, b) in outs.items()
               if not (within(a, b, **TRAIN_TOL) and bool(torch.isfinite(a).all()))]
        fwd_err = max(fwd.values())
        errs["K2"].append(fwd_err)
        check(not bad, f"stse_train forward (K2) {label}: outside rtol {TRAIN_TOL['rtol']} "
                       f"atol {TRAIN_TOL['atol']}: " + "; ".join(bad))
        # Each backward kernel starts from K2's activations and statistics
        # (what the training path hands it) and the float64 cotangent of the
        # layer above, so each is held alone. The float64 reference takes
        # PReLU's branch where K2 took it (the sign of its output): a
        # pre-activation within rounding of 0 would otherwise flip between
        # the two (5 of 28 M in the top layer at B=2048), which moves dW and
        # dM by up to 0.5 without any fault in either.
        top = len(ops.layers) - 1
        x_in = [x, *acts[:-1]]
        g, dwp, dbp, dy = st.top_backward(x_in[top], acts[top], dz, ops.layers[top], stats[top],
                                          ops.wp, ops.bp, ghost, need_dx=top > 0)
        w, dwp_r, dbp_r, dy_r = st.top_backward_reference(
            x_in[top].double(), dz.double(), ops64.layers[top], ops64.wp, ops64.bp, ghost,
            need_dx=top > 0, positive=acts[top] >= 0)
        pairs = [("K4", "dwp", dwp, dwp_r), ("K4", "dbp", dbp, dbp_r)]
        if top > 0:
            pairs.append(("K4", "dx", dy, dy_r))
        pairs += [("K4", f"layer{top}.d{f}", getattr(g, f), getattr(w, f))
                  for f in st.LayerOps._fields if getattr(w, f) is not None]
        for l in reversed(range(top)):
            g, dx = st.layer_backward(x_in[l], acts[l], dy_r.float(), ops.layers[l], stats[l],
                                      ghost, need_dx=l > 0)
            w, dx_r = st.layer_backward_reference(x_in[l].double(), dy_r, ops64.layers[l], ghost,
                                                  need_dx=l > 0, positive=acts[l] >= 0)
            pairs += [("K3", f"layer{l}.d{f}", getattr(g, f), getattr(w, f))
                      for f in st.LayerOps._fields if getattr(w, f) is not None]
            if l > 0:
                pairs.append(("K3", f"layer{l}.dx", dx, dx_r))
                dy_r = dx_r
        pairs = [(k, name, a, b.float()) for k, name, a, b in pairs]
        torch.cuda.synchronize()
        bad = []
        for k, name, a, b in pairs:
            err, ok = grad_err(a, b)
            errs[k].append(err)
            if not ok or not bool(torch.isfinite(a).all()):
                bad.append(f"{k} {name} err {err:.3e} scale {float(b.abs().max()):.3e}")
        check(not bad, f"stse_train backward {label}: " + "; ".join(bad))
        results.append(dict(case=label, batch=batch, ghost=ghost, forward_max_abs_err=fwd_err,
                            forward_max_abs_err_by_output=fwd,
                            backward_max_abs_err=max(e for _, _, a, b in pairs
                                                     for e in [float((a - b).abs().max())])))
        if label == timed[0]:
            timing = time_train_kernels(st, ops, x, dz, acts_r, stats_r, ghost)
            work = st.work(ops, batch, ghost)
            repeat = repeat_bits(st, ops, x, dz, acts, stats, ghost)
            passes = pass_report(st, ops, x, dz, acts, stats, ghost)
            forward = forward_report(st, ops, x, ghost)
            timed_ops = ops
    products = phase_products(card, timed_ops)
    records = []
    for key, name in (("K2", "stse_train_forward"), ("K3", "stse_train_layer_backward"),
                      ("K4", "stse_train_top_backward")):
        parts = [k for k in work if k.startswith(key)]
        flops = sum(work[k][0] for k in parts)
        nbytes = sum(work[k][1] for k in parts)
        # K3's and K4's products, per window and batch-reduction, run on the tensor cores
        bound_ms, bound_by = products_bound(flops, sum(work[k][2] + work[k][3] for k in parts),
                                            nbytes)
        t = timing[key]
        own = [r for r in products if r["batch"] == timed[2] and r["kernel"] in parts]
        records.append(dict(
            name=name, route="cuda", source=st.SOURCE, replaces=st.REPLACES[name], launches=None,
            max_abs_err=max(errs[key]),
            tolerance=(TRAIN_TOL if key == "K2" else
                       dict(rule="err < rtol * max(max|plain|, 1) + atol", rtol=GRAD_RTOL,
                            atol=GRAD_ATOL)),
            ms=t["kernel_ms"], kernel_ms=t["kernel_ms"], plain_ms=t["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, batch=timed[2], ghost=timed[3], flops=flops, bytes=nbytes,
            per_layer_ms=t.get("per_layer"), timing_runs_ms=t["runs"],
            per_layer_bound_ms={k: products_bound(work[k][0], work[k][2] + work[k][3],
                                                  work[k][1])[0] for k in parts},
            # the bound with the per-window FLOPs at fp32 outside the tensor cores, as
            # before the per-window passes ran on them
            bound_fp32_window_ms=products_bound(flops, sum(work[k][2] for k in parts),
                                                nbytes)[0],
            repeats_bit_for_bit=repeat[key],
            **(dict(product_ms=sum(r["ms"] for r in own),
                    product_library_ms=sum(r["library_ms"] for r in own),
                    product_bound_ms=sum(r["bound_ms"] for r in own)) if own else {})))
    for r in records:
        if r["name"] == "stse_train_forward":
            r["passes"] = forward
        else:
            r["passes"] = {k: v for k, v in passes.items()
                           if v["kernel"] == ("K4" if "top" in r["name"] else "K3")}
    print("train kernel check: " + json.dumps(dict(
        cases=results, card=card, repeats_bit_for_bit=repeat,
        times={r["name"]: dict(kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                               bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                               product_ms=r.get("product_ms"), per_layer_ms=r["per_layer_ms"],
                               bound_fp32_window_ms=r.get("bound_fp32_window_ms"))
               for r in records})))
    print("per-window passes (one K3/K4 call each, torch.profiler; blocks an SM by "
          "cudaOccupancyMaxActiveBlocksPerMultiprocessor): " + json.dumps(dict(card=card, **{
              k: {f: v[f] for f in v if f != "traced_ms"} for k, v in passes.items()})))
    print("forward passes (one K2 call, torch.profiler; blocks an SM by "
          "cudaOccupancyMaxActiveBlocksPerMultiprocessor): " + json.dumps(dict(card=card,
                                                                               **forward)))
    return records, products


def repeat_bits(st, ops, x, dz, acts, stats, ghost, compute_dtype="float32"):
    """K2, K4 and K3 (each layer) launched twice on the same inputs in
    `compute_dtype` give the same bits: no sum depends on the order blocks
    run in."""
    top = len(ops.layers) - 1
    x_of = [x] + list(acts[:-1])
    cd = dict(compute_dtype=compute_dtype)
    runs = {
        "K2": lambda: st.ghost_forward(x, ops, ghost, **cd),
        "K4": lambda: st.top_backward(x_of[top], acts[top], dz, ops.layers[top], stats[top],
                                      ops.wp, ops.bp, ghost, need_dx=top > 0, **cd),
        **{f"K3_layer{l}": (lambda l=l: st.layer_backward(x_of[l], acts[l], acts[l],
                                                          ops.layers[l], stats[l], ghost,
                                                          need_dx=l > 0, **cd))
           for l in range(top)}}
    out = {}
    for key, fn in runs.items():
        first, second = flat_tensors(fn()), flat_tensors(fn())
        same = all(torch_equal(a, b) for a, b in zip(first, second))
        check(same, f"{key} ({compute_dtype}): two launches on the same inputs differ")
        out[key] = same
    return dict(K2=out["K2"], K4=out["K4"],
                K3=all(v for k, v in out.items() if k.startswith("K3")))


def pass_report(st, ops, x, dz, acts, stats, ghost, compute_dtype="float32"):
    """Per flagship layer in `compute_dtype`: the device ms of bwd_pre and
    bwd_dx (and K4's projector_dy), and of the batch-reduction products
    (product_rows / product_windows / sum_splits launches), in one K4 or K3
    call, from a torch.profiler trace of it after a warm-up call; each
    pass's shared bytes a block and blocks an SM (stse_train.pass_occupancy
    in the form). The top layer's bwd_dx must fit two blocks an SM."""
    import torch

    top = len(ops.layers) - 1
    x_of = [x] + list(acts[:-1])
    lib = st._library()
    cd = dict(compute_dtype=compute_dtype)
    out = {}
    for l, lay in enumerate(ops.layers):
        if l == top:
            fn = lambda: st.top_backward(x_of[top], acts[top], dz, lay, stats[top], ops.wp, ops.bp,
                                         ghost, need_dx=top > 0, **cd)
        else:
            fn = lambda l=l: st.layer_backward(x_of[l], acts[l], acts[l], ops.layers[l], stats[l],
                                               ghost, need_dx=l > 0, **cd)
        fn()
        torch.cuda.synchronize()
        ms = traced_ms(fn)
        ci, co = lay.w.shape
        occ = st.pass_occupancy(lib, x.shape[1], ci, co, compute_dtype)
        out[f"layer{l}"] = dict(
            kernel="K4" if l == top else "K3", ci=ci, co=co, bwd_pre_ms=ms.get("bwd_pre_kernel"),
            bwd_dx_ms=ms.get("bwd_dx_kernel"), projector_dy_ms=ms.get("projector_dy_kernel"),
            products_ms=sum(v for k, v in ms.items() if k.startswith(("product_", "sum_splits"))),
            traced_ms=ms, **{k: v for k, v in occ.items() if k.startswith("bwd")})
    check(out[f"layer{top}"]["bwd_dx_blocks_per_sm"] >= 2,
          f"the top layer's bwd_dx runs {out[f'layer{top}']['bwd_dx_blocks_per_sm']} block(s) an "
          "SM, not 2")
    return out


def forward_report(st, ops, x, ghost, compute_dtype="float32"):
    """Per flagship layer in `compute_dtype`: the device ms of each of K2's
    passes in one K2 call, from a torch.profiler trace of it after a warm-up
    call (a pass's l-th launch is layer l's; the projector's kernels are the
    top layer's), and each pass's shared bytes a block and blocks an SM (the
    forward fields of stse_train.pass_occupancy in the form)."""
    import torch

    fn = lambda: st.ghost_forward(x, ops, ghost, compute_dtype=compute_dtype)
    fn()
    torch.cuda.synchronize()
    launches = traced_launches(fn)
    top = len(ops.layers) - 1
    out = {f"layer{l}": {} for l in range(top + 1)}
    seen = {}
    for name, ms in launches:
        l = top if name.startswith("projector") else seen.get(name, 0)
        seen[name] = seen.get(name, 0) + 1
        layer = out.setdefault(f"layer{l}", {})
        key = name.replace("_kernel", "_ms")
        layer[key] = layer.get(key, 0.0) + ms
    lib = st._library()
    for l, lay in enumerate(ops.layers):
        ci, co = lay.w.shape
        occ = st.pass_occupancy(lib, x.shape[1], ci, co, compute_dtype)
        keep = ("fwd", "projector") if l == top else ("fwd",)
        out[f"layer{l}"].update(ci=ci, co=co, **{k: v for k, v in occ.items()
                                                 if k.startswith(keep)})
    out["k2_traced_ms"] = sum(ms for _, ms in launches)
    return out


def flat_tensors(out) -> list:
    """A wrapper's returns, lists and the gradients of LayerOps spread out."""
    return [t for item in out for t in (item if isinstance(item, (tuple, list)) else (item,))]


def torch_equal(a, b) -> bool:
    import torch

    return (a is None and b is None) or bool(torch.equal(a, b))


def time_train_kernels(st, ops, x, dz, acts, stats, ghost, compute_dtype="float32"):
    """Kernel and plain-version times of K2, K3 (each lower layer) and K4 at
    the flagship shapes in `compute_dtype`, each measured twice, in turns;
    x and acts in the form's activation dtype (the plain versions take them
    widened to float32)."""
    top = len(ops.layers) - 1
    x_of = [x] + list(acts[:-1])
    dys = {l: acts[l] for l in range(top)}  # any [B, N, C_out] cotangent times the same
    xf = [t.float() for t in x_of]
    cd = dict(compute_dtype=compute_dtype)
    fns = {
        "K2": (lambda: st.ghost_forward(x, ops, ghost, **cd),
               lambda: st.ghost_forward_reference(xf[0], ops, ghost, **cd)),
        "K4": (lambda: st.top_backward(x_of[top], acts[top], dz, ops.layers[top], stats[top],
                                       ops.wp, ops.bp, ghost, need_dx=True, **cd),
               lambda: st.top_backward_reference(xf[top], dz, ops.layers[top], ops.wp, ops.bp,
                                                 ghost, need_dx=True, **cd)),
    }
    for l in range(top):
        fns[f"K3_layer{l}"] = (
            lambda l=l: st.layer_backward(x_of[l], acts[l], dys[l], ops.layers[l], stats[l],
                                          ghost, need_dx=l > 0, **cd),
            lambda l=l: st.layer_backward_reference(xf[l], dys[l].float(), ops.layers[l], ghost,
                                                    need_dx=l > 0, **cd))
    runs = {}
    for key, (kern, plain) in fns.items():
        a = cuda_ms(kern, iters=5, warmup=2)
        b = cuda_ms(plain, iters=5, warmup=2)
        c = cuda_ms(kern, iters=5, warmup=1)
        d = cuda_ms(plain, iters=5, warmup=1)
        runs[key] = dict(kernel=[a, c], plain=[b, d])
    out = {}
    for key in ("K2", "K4"):
        out[key] = dict(kernel_ms=min(runs[key]["kernel"]), plain_ms=min(runs[key]["plain"]),
                        runs=runs[key])
    k3 = [k for k in runs if k.startswith("K3")]
    out["K3"] = dict(kernel_ms=sum(min(runs[k]["kernel"]) for k in k3),
                     plain_ms=sum(min(runs[k]["plain"]) for k in k3),
                     per_layer={k: dict(kernel_ms=min(runs[k]["kernel"]),
                                        plain_ms=min(runs[k]["plain"])) for k in k3},
                     runs={k: runs[k] for k in k3})
    return out


def bf16_err(got, want, cosine=False) -> tuple:
    """(max abs err, whether it is inside err <= BF16_BAND * max(scale, 1));
    with `cosine`, whether the cosine of got and want is above BF16_COSINE
    (or both vanish)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(got.isfinite().all()):
        return err, False
    if not cosine:
        return err, err <= BF16_BAND * max(scale, 1.0)
    a, b = got.double().flatten(), want.double().flatten()
    denom = float(a.norm() * b.norm())
    return err, denom <= 1e-10 or float(a @ b) / denom > BF16_COSINE


def phase_bf16_kernels(card):
    """K2, K4, K3 and K5 in each bf16 form (stse_train.COMPUTE_DTYPES)
    against their plain versions in the same form on the card, float64
    between the rounding points, PReLU's branches where K2 took them: K2,
    K4 and K3 within BF16_BAND, each backward from the same input as its
    plain version; K5 within BF16_BAND of K4 + K3 in the form, the same
    arithmetic, and against its plain version, which recomputes the whole
    forward from x, by the JAX package's bf16 gradient check (each leaf's
    cosine above BF16_COSINE): the two chains round at the same points, but
    a value that lands on the other side of a bf16 rounding boundary in one
    of them moves everything above it, and a sum with cancellation (dalpha,
    a sum of dy pre over millions of elements) moves by more than 2^-7 of
    its own size. The "bfloat16" form timed at the
    flagship shapes beside its plain version (in turns) and its bound (bf16
    tensor-core peak, bytes at the store dtype); K2, K4 and K3 launched twice
    give the same bits in it; its per-window passes a layer (pass_report:
    device ms, shared bytes, blocks an SM, no fewer than float32's) and its
    batch-reduction products alone (phase_products). Returns the records of
    the "bfloat16" form (launches filled in by the bf16 train and mono runs)."""
    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(8642)
    errs = {(k, f): [] for k in ("K2", "K3", "K4", "K5") for f in BF16_FORMS}
    cases, timing = [], None
    for label, kw, batch, ghost in BF16_KERNEL_CASES:
        model = seeded_train_stse(gen, dev, **kw)
        ops = st.detached(st.encoder_ops(model))
        ops64 = st.detached(ops, torch.float64)
        n = kw["n_frames"] * kw["n_joints"]
        # bf16 windows, as fused_stse_apply hands them over: a bf16 tensor under
        # "bfloat16", float32 under "bfloat16_f32store"
        x_bf16 = torch.randn(batch, n, kw["input_dim"], generator=gen).to(dev).to(torch.bfloat16)
        dz = torch.randn(batch, kw["latent_dim"], generator=gen).to(dev)
        top = len(ops.layers) - 1
        for form in BF16_FORMS:
            cd = dict(compute_dtype=form)
            act = st.activation_dtype(form)
            x = x_bf16.to(act)
            out = st.ghost_forward(x, ops, ghost, **cd)
            z, sums, acts, stats = out
            ref = st.ghost_forward_reference(x.double(), ops64, ghost, **cd)
            # the full-batch sums as moments (sum / count), as the fp32 check takes them
            cnt = batch * n
            pairs = [("K2", "z", z, ref[0])]
            pairs += [("K2", f"sums{l}", a / cnt, b / cnt) for l, (a, b) in
                      enumerate(zip(sums, ref[1]))]
            for name, got, want in zip(("act", "stats"), out[2:], ref[2:]):
                pairs += [("K2", f"{name}{l}", a, b) for l, (a, b) in enumerate(zip(got, want))]
            x_in = [x, *acts[:-1]]
            g, dwp, dbp, dy = st.top_backward(x_in[top], acts[top], dz, ops.layers[top],
                                              stats[top], ops.wp, ops.bp, ghost,
                                              need_dx=top > 0, **cd)
            w, dwp_r, dbp_r, dy_r = st.top_backward_reference(
                x_in[top].double(), dz.double(), ops64.layers[top], ops64.wp, ops64.bp, ghost,
                need_dx=top > 0, positive=acts[top] >= 0, **cd)
            pairs += [("K4", "dwp", dwp, dwp_r), ("K4", "dbp", dbp, dbp_r)]
            if top > 0:
                pairs.append(("K4", "dx", dy, dy_r))
            pairs += [("K4", f"layer{top}.d{f}", getattr(g, f), getattr(w, f))
                      for f in st.LayerOps._fields if getattr(w, f) is not None]
            dxs = [dy] if top > 0 else []  # every dx a kernel hands back
            for l in reversed(range(top)):
                g, dx = st.layer_backward(x_in[l], acts[l], dy_r.to(act), ops.layers[l],
                                          stats[l], ghost, need_dx=l > 0, **cd)
                dxs += [dx] if l > 0 else []
                w, dx_r = st.layer_backward_reference(x_in[l].double(), dy_r, ops64.layers[l],
                                                      ghost, need_dx=l > 0,
                                                      positive=acts[l] >= 0, **cd)
                pairs += [("K3", f"layer{l}.d{f}", getattr(g, f), getattr(w, f))
                          for f in st.LayerOps._fields if getattr(w, f) is not None]
                if l > 0:
                    pairs.append(("K3", f"layer{l}.dx", dx, dx_r))
                    dy_r = dx_r
            mono = st.mono_backward(x, dz, ops, ghost, **cd)
            split = st.split_backward(x, dz, ops, acts, stats, ghost, **cd)
            mono_r = st.mono_backward_reference(x.double(), dz.double(), ops64, ghost,
                                                positive=[a >= 0 for a in acts], **cd)
            for name, a, b, c in zip(
                    [f"layer{l}.d{f}" for l in range(top + 1) for f in st.LayerOps._fields]
                    + ["dwp", "dbp"], st._flatten(mono), st._flatten(mono_r),
                    st._flatten(split)):
                if b is not None:
                    pairs += [("K5", f"{name} vs plain (cosine)", a, b),
                              ("K5", f"{name} vs split", a, c.double())]
            torch.cuda.synchronize()
            bad, case_err = [], {}
            for k, name, a, b in pairs:
                err, ok = bf16_err(a.double(), b.double(), cosine=name.endswith("(cosine)"))
                errs[k, form].append(err)
                case_err[k] = max(case_err.get(k, 0.0), err)
                if not ok:
                    bad.append(f"{k} {name} err {err:.3e} scale {float(b.abs().max()):.3e}")
            check(not bad, f"stse_train {form} {label}: " + "; ".join(bad))
            # the interface in the form's activation dtype: bf16 tensors under
            # "bfloat16"; z, the sums and statistics float32 in every form
            check(x.dtype == act and all(t.dtype == act for t in acts + dxs)
                  and all(t.dtype == torch.float32 for t in [z, *sums, *stats]),
                  f"{form} {label}: activations / dx {[str(t.dtype) for t in acts + dxs]}, "
                  f"expected {act}")
            cases.append(dict(case=label, form=form, batch=batch, ghost=ghost,
                              max_abs_err=case_err))
            if label == BF16_KERNEL_CASES[0][0] and form == "bfloat16":
                acts_r, stats_r = [t.to(act) for t in ref[2]], [t.float() for t in ref[3]]
                timing = time_train_kernels(st, ops, x, dz, acts_r, stats_r, ghost, form)
                runs = [cuda_ms(fn, iters=5, warmup=1) for _ in range(2) for fn in (
                    lambda: st.mono_backward(x, dz, ops, ghost, **cd),
                    lambda: st.mono_backward_reference(x.float(), dz, ops, ghost, **cd))]
                timing["K5"] = dict(kernel_ms=min(runs[0::2]), plain_ms=min(runs[1::2]),
                                    runs=dict(kernel=runs[0::2], plain=runs[1::2]))
                work = st.work(ops, batch, ghost, form)
                main = (batch, ghost)
                repeat = repeat_bits(st, ops, x, dz, acts, stats, ghost, form)
                passes = pass_report(st, ops, x, dz, acts, stats, ghost, form)
                forward = forward_report(st, ops, x, ghost, form)
                print("forward passes bfloat16 (one K2 call, torch.profiler; blocks an SM by "
                      "cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
                      + json.dumps(dict(card=card, **forward)))
                lib = st._library()
                # no fewer blocks an SM than the float32 form, backward and forward passes
                layers = [(layer, ("bwd_pre_blocks_per_sm", "bwd_dx_blocks_per_sm"))
                          for layer in passes.values()]
                layers += [(forward[f"layer{l}"], [k for k in forward[f"layer{l}"]
                                                   if k.endswith("_blocks_per_sm")])
                           for l in range(top + 1)]
                for layer, keys in layers:
                    f32 = st.pass_occupancy(lib, n, layer["ci"], layer["co"])
                    for k in keys:
                        check(layer[k] >= f32[k], f"{form} {k} {layer[k]} < float32's {f32[k]} "
                                                  f"at C_in {layer['ci']}, C_out {layer['co']}")
                timed_ops = ops
    products = phase_products(card, timed_ops, "bfloat16")
    records = []
    for key, name in (("K2", "stse_train_forward"), ("K3", "stse_train_layer_backward"),
                      ("K4", "stse_train_top_backward"), ("K5", "stse_train_mono_backward")):
        parts = [k for k in work if k.startswith(key)]
        flops = sum(work[k][0] for k in parts)
        nbytes = sum(work[k][1] for k in parts)
        bound_ms, bound_by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
        t = timing[key]
        records.append(dict(
            name=f"{name}.bfloat16", route="cuda", source=st.SOURCE, replaces=st.REPLACES[name],
            compute_dtype="bfloat16", launches=None, max_abs_err=max(errs[key, "bfloat16"]),
            max_abs_err_f32store=max(errs[key, "bfloat16_f32store"]),
            tolerance=dict(rule="err <= band * max(max|plain|, 1), plain in the same form" + (
                "; K5: that vs K4 + K3, each leaf's cosine > 0.98 vs plain" if key == "K5"
                else ""), band=BF16_BAND),
            ms=t["kernel_ms"], kernel_ms=t["kernel_ms"], plain_ms=t["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None, batch=main[0],
            ghost=main[1], flops=flops, bytes=nbytes, timing_runs_ms=t["runs"],
            per_layer_ms=t.get("per_layer")))
        own = [r for r in products if r["batch"] == main[0] and r["kernel"] in parts]
        if key == "K2":
            records[-1].update(repeats_bit_for_bit=repeat[key], passes=forward)
        if key == "K5":
            records[-1].update(chunk=st.mono_chunk(timed_ops, main[0], main[1], "bfloat16"),
                               in_flight=st.MONO_IN_FLIGHT)
        if key in ("K3", "K4"):
            records[-1].update(
                repeats_bit_for_bit=repeat[key],
                passes={k: v for k, v in passes.items() if v["kernel"] == key},
                product_ms=sum(r["ms"] for r in own),
                product_library_ms=sum(r["library_ms"] for r in own),
                product_bound_ms=sum(r["bound_ms"] for r in own))
    print("bf16 kernel check: " + json.dumps(dict(card=card, band=BF16_BAND, cases=cases,
                                                  repeats_bit_for_bit=repeat, times={
        r["name"]: {k: r[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                      "max_abs_err", "max_abs_err_f32store", "product_ms")
                    if k in r}
        for r in records})))
    print("per-window passes bfloat16 (one K3/K4 call each, torch.profiler; blocks an SM by "
          "cudaOccupancyMaxActiveBlocksPerMultiprocessor): " + json.dumps(dict(card=card, **{
              k: {f: v[f] for f in v if f != "traced_ms"} for k, v in passes.items()})))
    return records


def phase_mono(card, checks_only=False):
    """K5 against its float64 plain version and the split kernels (K4 + K3)
    on every case, in float32 and both bf16 forms, and at the case's
    schedule with two chunks in flight against one (the same bits); its
    times beside K2 and K4 + K3; the (chunk, in flight) sweep in float32 and
    "bfloat16"; then (unless checks_only) the mono path against the split
    path. Returns (K5's kernel record, summary)."""
    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(2468)
    cases, errs = [], []
    timed = None
    all_cases = [(*c, None) for c in TRAIN_KERNEL_CASES] + list(MONO_EXTRA_CASES)
    for label, kw, batch, ghost, chunk in all_cases:
        model = seeded_train_stse(gen, dev, **kw)
        ops = st.detached(st.encoder_ops(model))
        n = kw["n_frames"] * kw["n_joints"]
        x = torch.randn(batch, n, kw["input_dim"], generator=gen).to(dev)
        dz = torch.randn(batch, kw["latent_dim"], generator=gen).to(dev)
        for form in ("float32", *BF16_FORMS):
            res = mono_case(st, ops, x, dz, ghost, chunk, form, label)
            cases.append(dict(case=label, form=form, batch=batch, ghost=ghost, **res))
            if form == "float32":
                errs.append(res["max_abs_err_vs_plain"])
        if timed is None:
            timed = (ops, x, dz, ghost)
    ops, x, dz, ghost = timed
    _, _, acts, stats = st.ghost_forward(x, ops, ghost)
    timing = time_mono(st, ops, x, dz, acts, stats, ghost)
    sweeps = {form: mono_sweep(st, ops, x if form == "float32" else
                               x.to(torch.bfloat16).to(st.activation_dtype(form)), dz, ghost, form)
              for form in ("float32", "bfloat16")}
    flops, nbytes, prod_flops, window_flops = st.work(ops, x.shape[0], ghost)["K5"]
    bound_ms, bound_by = products_bound(flops, prod_flops + window_flops, nbytes)
    rec = dict(
        name="stse_train_mono_backward", route="cuda", source=st.SOURCE,
        replaces=st.REPLACES["stse_train_mono_backward"], launches=None, max_abs_err=max(errs),
        tolerance=dict(rule="err < rtol * max(max|plain|, 1) + atol, vs the float64 plain "
                            "version and vs K4 + K3", rtol=GRAD_RTOL, atol=GRAD_ATOL),
        ms=timing["kernel_ms"], kernel_ms=timing["kernel_ms"], plain_ms=timing["plain_ms"],
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, batch=x.shape[0], ghost=ghost,
        bound_fp32_window_ms=products_bound(flops, prod_flops, nbytes)[0],
        chunk=st.mono_chunk(ops, x.shape[0], ghost), in_flight=st.MONO_IN_FLIGHT, flops=flops,
        bytes=nbytes, cases=cases, timing=timing, sweep=sweeps)
    bits = all(c["in_flight_same_bits"] for c in cases)
    print("mono kernel check: " + json.dumps(dict(cases=cases, card=card, **{
        k: rec[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "chunk",
                            "in_flight")}, in_flight_same_bits=bits, **{
        k: timing[k] for k in ("split_ms", "k2_ms", "kernel_footprint_bytes",
                               "kernel_peak_bytes")})))
    for form, sweep in sweeps.items():
        print(f"mono sweep {form} (B={x.shape[0]}, ghost {ghost}; K2's forward allocates "
              f"{sweep['budget_bytes']} B): " + json.dumps(dict(card=card, **sweep)))
    return rec, None if checks_only else mono_path(card)


def mono_case(st, ops, x, dz, ghost, chunk, form, label) -> dict:
    """K5 in `form` on one case at its schedule (`chunk` windows if given,
    else the budget's): within the band of K4 + K3 and of its plain version
    (float32: the gradient band against float64; a bf16 form: BF16_BAND
    against K4 + K3 in the form, by each leaf's cosine against plain, see
    phase_bf16_kernels), and the same bits with one and two chunks in
    flight."""
    import torch

    cd = dict(compute_dtype=form)
    if form != "float32":  # bf16 windows, as fused_stse_apply hands them over
        x = x.to(torch.bfloat16).to(st.activation_dtype(form))
    _, _, acts, stats = st.ghost_forward(x, ops, ghost, **cd)
    used = st.mono_chunk(ops, x.shape[0], ghost, form, chunk)
    one, two = (st.mono_backward(x, dz, ops, ghost, used, in_flight=k, **cd) for k in (1, 2))
    split = st.split_backward(x, dz, ops, acts, stats, ghost, **cd)
    # float64, PReLU's branch where K2 took it (see phase_train_kernels)
    want = st.mono_backward_reference(x.double(), dz.double(), st.detached(ops, torch.float64),
                                      ghost, positive=[a >= 0 for a in acts], **cd)
    torch.cuda.synchronize()
    names = [f"layer{l}.d{f}" for l in range(len(ops.layers)) for f in st.LayerOps._fields]
    bad, err_plain, err_split = [], 0.0, 0.0
    for name, a, w, s in zip(names + ["dwp", "dbp"], st._flatten(two), st._flatten(want),
                             st._flatten(split)):
        if w is None:
            check(a is None and s is None, f"K5 {label} {name}: a gradient of no operand")
            continue
        if form == "float32":
            (e_p, ok_p), (e_s, ok_s) = grad_err(a, w.float()), grad_err(a, s)
        else:
            (e_p, ok_p), (e_s, ok_s) = (bf16_err(a.double(), w, cosine=True),
                                        bf16_err(a.double(), s.double()))
        err_plain, err_split = max(err_plain, e_p), max(err_split, e_s)
        if not (ok_p and ok_s and bool(torch.isfinite(a).all())):
            bad.append(f"{name} err vs plain {e_p:.3e} (scale {float(w.abs().max()):.3e}), "
                       f"vs split {e_s:.3e}")
    check(not bad, f"stse_train mono backward (K5) {form} {label}: " + "; ".join(bad))
    same = all(torch_equal(a, b) for a, b in zip(st._flatten(one), st._flatten(two)))
    check(same, f"K5 {form} {label}: two chunks in flight differ from one at chunk {used}")
    return dict(chunk=used, n_chunks=-(-x.shape[0] // used), max_abs_err_vs_plain=err_plain,
                max_abs_err_vs_split=err_split, in_flight_same_bits=same)


def time_mono(st, ops, x, dz, acts, stats, ghost):
    """K5 at its schedule, the split backward (K4 + K3) and K2 at the
    flagship shapes, each twice, in turns; K5's plain version; K5's own
    peak memory beyond its inputs against its footprint."""
    import torch

    fns = dict(kernel=lambda: st.mono_backward(x, dz, ops, ghost),
               split=lambda: st.split_backward(x, dz, ops, acts, stats, ghost),
               k2=lambda: st.ghost_forward(x, ops, ghost),
               plain=lambda: st.mono_backward_reference(x, dz, ops, ghost))
    runs = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            runs[k].append(cuda_ms(fn, iters=5, warmup=2))
    b = x.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = st.mono_backward(x, dz, ops, ghost)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads
    return dict(kernel_ms=min(runs["kernel"]), plain_ms=min(runs["plain"]),
                split_ms=min(runs["split"]), k2_ms=min(runs["k2"]), runs_ms=runs,
                kernel_footprint_bytes=st.mono_footprint(ops, b, st.mono_chunk(ops, b, ghost),
                                                         ghost),
                kernel_peak_bytes=peak)


def mono_sweep(st, ops, x, dz, ghost, form) -> dict:
    """K5 in `form` over (chunk windows, chunks in flight): MONO_CHUNK_SWEEP,
    and at one and at two in flight the budget's chunk and the largest
    chunk under the budget (two in flight only where there are two chunks),
    each timed twice in turns; with each its footprint and whether that
    fits K2's forward allocation (the budget)."""
    b = x.shape[0]
    budget = st.buffer_bytes(st.forward_buffers(ops, b, ghost, form))
    picked = {k: st.mono_chunk(ops, b, ghost, form, in_flight=k) for k in (1, 2)}
    largest = {k: max([ghost] + [c for c in range(ghost, b + 1, ghost)
                                 if st.mono_footprint(ops, b, c, ghost, form, k) <= budget])
               for k in (1, 2)}
    chunks = sorted({st.mono_chunk(ops, b, ghost, form, c) for c in MONO_CHUNK_SWEEP}
                    | set(picked.values()) | set(largest.values()))
    grid = [(c, k) for c in chunks for k in (1, 2) if k == 1 or -(-b // c) > 1]
    ms = {key: [] for key in grid}
    for _ in range(2):
        for c, k in grid:
            ms[c, k].append(cuda_ms(lambda: st.mono_backward(x, dz, ops, ghost, c, form,
                                                             in_flight=k), iters=5, warmup=1))
    entries = []
    for c, k in grid:
        foot = st.mono_footprint(ops, b, c, ghost, form, k)
        entries.append(dict(chunk=c, in_flight=k, n_chunks=-(-b // c), ms=min(ms[c, k]),
                            runs_ms=ms[c, k], footprint_bytes=foot, fits_budget=foot <= budget,
                            budget_pick=picked[k] == c, largest_under_budget=largest[k] == c,
                            default=(c, k) == (st.mono_chunk(ops, b, ghost, form),
                                               min(st.MONO_IN_FLIGHT, -(-b // c))),
                            parent=(c, k) == (MONO_PARENT_SCHEDULE["chunk_windows"],
                                              MONO_PARENT_SCHEDULE["in_flight"])))
    return dict(form=form, budget_bytes=budget, entries=entries)


def mono_path(card):
    """MONO_STEPS steps of fused_stse_apply(bwd_mode="mono") + Adam at the
    flagship width, B=2048, ghost 64, against as many split steps from the
    same weights (bench_fused.py's `tm:` job, with Adam); step times in
    turns; peak memory and saved-for-backward bytes of one step of each,
    also at compute_dtype bfloat16."""
    import copy

    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1357)
    model0 = seeded_train_stse(gen, dev, **FULL)
    center = torch.randn(FULL["latent_dim"], generator=gen).to(dev)
    dgen = torch.Generator(device=dev).manual_seed(9)
    xs = [torch.randn(TRAIN_BATCH, FULL["input_dim"], FULL["n_frames"], FULL["n_joints"],
                      generator=dgen, device=dev) for _ in range(MONO_STEPS)]

    def steps(mode, model, opt, count, saved=None, compute_dtype="float32"):
        """`count` train steps; `saved` (a dict) collects the bytes of every
        tensor the step keeps for its backward, once per storage."""

        def pack(t):
            if saved is not None:
                saved[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
            return t

        losses = []
        for i in range(count):
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                z = st.fused_stse_apply(model, xs[i % MONO_STEPS], ghost_size=64, bwd_mode=mode,
                                        compute_dtype=compute_dtype)
                loss = torch.mean((z - center) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return losses

    runs = {}
    counters = launch_counters()
    for mode in ("mono", "split"):
        model = copy.deepcopy(model0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        if mode == "mono":  # --- the mono path, counted ---
            zero(counters)
        losses = torch.stack(steps(mode, model, opt, MONO_STEPS)).cpu().numpy()
        torch.cuda.synchronize()
        if mode == "mono":
            launches = read(counters)
            # --- end of the counted run ---
        runs[mode] = dict(model=model, opt=opt, losses=losses)
    want = dict(stse_fused=0, stse_train_forward=MONO_STEPS, stse_train_layer_backward=0,
                stse_train_top_backward=0, stse_train_mono_backward=MONO_STEPS)
    check(launches == want, f"mono path launches {launches}, expected {want}")
    mono, split = runs["mono"]["losses"], runs["split"]["losses"]
    rel = float(np.max(np.abs(mono - split) / np.abs(split)))
    check(bool(np.isfinite(mono).all()) and np.allclose(mono, split, rtol=LOSS_RTOL, atol=0.0),
          f"mono vs split per-step losses: {mono} vs {split}")
    bn = {k: (a, b) for (k, a), b in zip(runs["mono"]["model"].named_buffers(),
                                          runs["split"]["model"].buffers())}
    bad = [k for k, (a, b) in bn.items() if not within(a, b, **TRAIN_TOL)]
    check(not bad, f"running statistics after {MONO_STEPS} mono vs split steps: {bad}")

    # --- the mono path at compute_dtype bfloat16 (K2 and K5's bf16 form), counted ---
    bf16, bf16_runs = {}, {}
    for mode in ("mono", "split"):
        model = copy.deepcopy(model0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        if mode == "mono":
            zero(counters)
        bf16[mode] = torch.stack(steps(mode, model, opt, MONO_BF16_STEPS,
                                       compute_dtype="bfloat16")).cpu().numpy()
        torch.cuda.synchronize()
        bf16_runs[mode] = dict(model=model, opt=opt)
        if mode == "mono":
            launches_bf16 = read(counters)
            # --- end of the counted bf16 run ---
    want_bf16 = dict(stse_fused=0, stse_train_forward=MONO_BF16_STEPS,
                     stse_train_layer_backward=0, stse_train_top_backward=0,
                     stse_train_mono_backward=MONO_BF16_STEPS)
    check(launches_bf16 == want_bf16, f"bf16 mono path launches {launches_bf16}, expected "
                                      f"{want_bf16}")
    check(bool(np.isfinite(bf16["mono"]).all())
          and np.allclose(bf16["mono"], bf16["split"], rtol=LOSS_RTOL, atol=0.0),
          f"bf16 mono vs split per-step losses: {bf16['mono']} vs {bf16['split']}")

    def step_ms(mode, count=10):
        r = runs[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(mode, r["model"], r["opt"], count)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / count

    times = {"split": [], "mono": []}
    for mode in ("split", "mono", "mono", "split"):
        times[mode].append(step_ms(mode))
    memory = {}
    default_k5 = st.mono_backward
    # One step of each; mono also at K5's schedule before the byte budget
    # (MONO_PARENT_SCHEDULE), whose peak K2's forward set; both at bf16 too.
    for key, mode, schedule, dtype in (
            ("split", "split", None, "float32"), ("mono", "mono", None, "float32"),
            ("mono_parent_schedule", "mono", MONO_PARENT_SCHEDULE, "float32"),
            ("split_bf16", "split", None, "bfloat16"), ("mono_bf16", "mono", None, "bfloat16"),
            ("mono_bf16_parent_schedule", "mono", MONO_PARENT_SCHEDULE, "bfloat16")):
        r, saved = (runs if dtype == "float32" else bf16_runs)[mode], {}
        if schedule:  # FusedGhostEncode.backward calls st.mono_backward
            st.mono_backward = functools.partial(default_k5, **schedule)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            steps(mode, r["model"], r["opt"], 1, saved, compute_dtype=dtype)
            torch.cuda.synchronize()
        finally:
            st.mono_backward = default_k5
        memory[key] = dict(peak_bytes_above_resident=torch.cuda.max_memory_allocated() - base,
                           resident_bytes=base, saved_for_backward_bytes=sum(saved.values()),
                           saved_tensors=len(saved))
    ops = st.encoder_ops(runs["mono"]["model"])
    k2_bytes = {dtype: st.buffer_bytes(st.forward_buffers(ops, TRAIN_BATCH, 64, dtype))
                for dtype in ("float32", "bfloat16")}
    for key, dtype in (("mono", "float32"), ("mono_bf16", "bfloat16")):
        peak = memory[key]["peak_bytes_above_resident"]
        parent = memory[f"{key}_parent_schedule"]["peak_bytes_above_resident"]
        memory[key]["k2_forward_bytes"] = k2_bytes[dtype]
        print(f"mono path {dtype} step peak above resident {peak} B (K5 at chunk "
              f"{st.mono_chunk(ops, TRAIN_BATCH, 64, dtype)}, {st.MONO_IN_FLIGHT} in flight), "
              f"at the parent schedule {parent} B; K2's forward allocates {k2_bytes[dtype]} B "
              f"at B={TRAIN_BATCH}")
        check(peak <= parent, f"the mono step's {dtype} peak {peak} B is above the parent "
                              f"schedule's {parent} B")
    summary = dict(steps=MONO_STEPS, batch=TRAIN_BATCH, ghost=64, launches=launches,
                   launches_bf16=launches_bf16, losses_bf16_mono=bf16["mono"].tolist(),
                   losses_bf16_split=bf16["split"].tolist(),
                   losses_mono=mono.tolist(), losses_split=split.tolist(),
                   loss_max_rel_err=rel, step_ms=times, memory=memory, card=card)
    print(f"mono path: {MONO_STEPS} steps of fused_stse_apply(bwd_mode='mono') + Adam at B="
          f"{TRAIN_BATCH}, ghost 64 on {card}: launches {launches}; losses vs split max rel err "
          f"{rel:.2e}; step ms (host clock, 10 steps, in turns) mono {times['mono']} split "
          f"{times['split']}; memory " + json.dumps(memory) + f"; bf16: {MONO_BF16_STEPS} "
          f"steps, launches {launches_bf16}, losses {bf16['mono'].tolist()}")
    return summary


def traced_calls(fn, calls: int, skip: int = 0):
    """(the device ms of each kernel of each traced call of fn, the kernel
    names of a call), from one torch.profiler trace of `calls` calls: the
    calls run apart (a synchronize and CALL_GAP_S of idle after each), so a
    call's kernels are those between two gaps, less its first `skip`. The
    profiler may drop an event: a call whose kernels are not the most
    common list is left out. None when fewer than PROBE_MIN_CALLS are left."""
    import torch

    def run():
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
            time.sleep(CALL_GAP_S)

    events = traced_spans(run)
    groups, last_end = [], None
    for name, start, end in events:
        if last_end is None or start - last_end > CALL_GAP_S * 1e6 / 2:
            groups.append([])
        groups[-1].append((name, (end - start) / 1e3))
        last_end = end
    lists = [tuple(n for n, _ in g) for g in groups]
    names = max(set(lists), key=lists.count)
    kept = [g for g, n in zip(groups, lists) if n == names]
    if len(kept) < PROBE_MIN_CALLS or len(names) <= skip:
        print(f"torch.profiler traced {len(kept)} of {calls} calls whole ({len(names)} kernels "
              f"a call, {len(set(lists))} kernel lists)")
        return None
    return [[ms for _, ms in g[skip:]] for g in kept], list(names[skip:])


def queued_ms(fn, calls: int) -> tuple:
    """(device ms of a call of fn by CUDA events, whether the host's launch
    cost stayed out): `calls` calls queued behind a device-side sleep of
    QUEUE_LEAD_CYCLES, so the device runs them back to back; the median of
    three such runs. Where the host had not queued every call by the time
    the sleep ended (a call that waits on the device, as a copy from
    pageable host memory does), the events also hold the host's gaps."""
    import statistics

    import torch

    def run():
        begin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        begin.record()
        torch.cuda._sleep(QUEUE_LEAD_CYCLES)
        start.record()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / calls, host_ms < begin.elapsed_time(start)

    runs = [run() for _ in range(3)]
    return statistics.median(ms for ms, _ in runs), all(ahead for _, ahead in runs)


def device_ms(fn, calls: int = PROBE_CALLS, warmup: int = 3, scrub=None) -> tuple:
    """(the median device ms of a call of fn over the traced calls, [(each
    kernel of a call, its median ms)]). With `scrub` (a tensor larger than
    L2), each call first fills it, so fn finds its inputs in device memory;
    the fill's time is left out. When no trace of TRACE_TRIES holds
    PROBE_MIN_CALLS whole calls, the time is queued_ms's, the fill's own
    queued_ms taken off, and the one kernel entry is named QUEUE_TIMED, or
    QUEUE_TIMED_GAPS where the host's gaps are in it."""
    import statistics

    import torch

    call = fn if scrub is None else lambda: (scrub.fill_(0.0), fn())
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        traced = traced_calls(call, calls, skip=0 if scrub is None else 1)
        if traced is not None:
            per_call, names = traced
            return statistics.median(sum(c) for c in per_call), [
                (name, statistics.median(c[i] for c in per_call)) for i, name in enumerate(names)]
    ms, ahead = queued_ms(call, calls)
    if scrub is not None:
        ms -= queued_ms(lambda: scrub.fill_(0.0), calls)[0]
    how = QUEUE_TIMED if ahead else QUEUE_TIMED_GAPS
    print(f"no trace of {TRACE_TRIES} held {PROBE_MIN_CALLS} whole calls: {ms:.6f} ms a call, "
          f"{how}")
    return ms, [(how, ms)]


def probe_library(job, a, b):
    """(the call's text, a function making that one PyTorch call on
    operands prepared here, the call's result as the job's output), or
    (why there is none, None, None). Operands hold bf16 values in float32
    where the output is float32, so each call writes what the job writes;
    float32 products run with TF32 off (PyTorch's default, checked), so a
    product sums exact bf16 products in float32, as the job does."""
    import torch
    from coskad_tpu_torch.kernels import probe

    c, bb, n = probe.SHAPE
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    a32 = a16.float()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on in float32 matmuls")
    if job.startswith("dot0"):
        rows = a32.reshape(c * bb, n)
        lhs, rhs = rows[:, :c].t(), rows[:, :bb]
        return ("torch.mm(A[:, :32].t(), A[:, :64]), A = bf16(a) as [2048, 256] held in "
                "float32, TF32 off; r only, the [32, 64, 256] broadcast is a view",
                lambda: torch.mm(lhs, rhs), lambda r: r[:, :, None].expand(c, bb, n))
    if job == "dotg_bf16":
        w, rhs = torch.ones((c, c), device=a.device), a32.reshape(c, bb * n)
        return ("torch.mm(w, A), w = ones [32, 32], A = bf16(a) as [32, 16384] held in "
                "float32, TF32 off", lambda: torch.mm(w, rhs), lambda r: r.reshape(c, bb, n))
    if job.startswith("where"):
        alpha = (torch.tensor(0.25, device=a.device) if job in ("where_mixed", "where_const_scalar")
                 else a[0, 0, 0]).to(torch.bfloat16)
        mask = (a if job == "where_f32pred" else a16) < 0
        hi, lo = (alpha * b16).float(), b16.float()
        return ("torch.where(mask, alpha * b, b) on a prepared bool mask and float32 branches",
                lambda: torch.where(mask, hi, lo), lambda r: r)
    if job in ("transpose_bf16", "transpose_pure"):
        view = a32.transpose(1, 2)
        return ("bf16(a).transpose(1, 2).contiguous(), the bf16 values held in float32",
                view.contiguous, lambda r: r.reshape(c, bb, n) if job == "transpose_bf16" else r)
    if job == "transpose_merge":
        view = a32[0, :, :c].t()[:, :, None].expand(c, bb, n)
        return ("bf16(a)[0, :, :32].t()[:, :, None].expand(32, 64, 256).contiguous(), the bf16 "
                "values held in float32: one copy", view.contiguous, lambda r: r)
    return ("none: a product, a sum over (q, n) and a broadcast write; no one PyTorch call "
            "computes them", None, None)


def phase_probe(card):
    """P: each probe job's kernel against its plain version (elementwise
    exactly, sums within PROBE_SUM_TOL), launched once each in a counted
    run, then again for the same bits; each job's device time (the
    profiler's kernel durations of a call, the median over PROBE_CALLS
    calls) beside its plain version's and one PyTorch call's that computes
    the same function, and the host-clock time of a call (`call_ms`: CUDA
    events around PROBE_CALLS Python calls, the wrapper's host cost
    included). The inputs (4 MB) stay in L2 from call to call; `cold_ms`
    and `library_cold_ms` are the device times with L2 scrubbed before each
    call. Returns the kernel records."""
    import torch
    from coskad_tpu_torch.kernels import probe

    a, b = probe.inputs(DEVICE)
    scrub = torch.empty((L2_SCRUB_BYTES // 4,), device=DEVICE)
    zero(probe.launches)  # --- the probe run, counted ---
    outs = {job: probe.run(job, a, b) for job in probe.JOBS}
    torch.cuda.synchronize()
    launches = read(probe.launches)  # --- end ---
    records = []
    for job, out in outs.items():
        want = probe.plain(job, a, b)
        err = float((out - want).abs().max())
        sums = job.startswith(("dot0", "dotg", "min"))
        ok = within(out, want, **PROBE_SUM_TOL) if sums else torch.equal(out, want)
        check(ok and launches[job] == 1, f"probe {job}: max abs err {err:.3e} "
                                         f"(launches {launches[job]})")
        check(torch.equal(probe.run(job, a, b), out), f"probe {job}: two runs, other bits")
        timed = {}

        def timed_ms(key, fn, **k):
            ms, kernels = device_ms(fn, **k)
            timed[key] = TIMED_BY.get(kernels[0][0], "profiler")
            return ms, kernels

        kernel_ms, kernels = timed_ms("ms", lambda: probe.run(job, a, b))
        cold_ms, _ = timed_ms("cold_ms", lambda: probe.run(job, a, b), scrub=scrub)
        plain_ms, _ = timed_ms("plain_ms", lambda: probe.plain(job, a, b))
        call_ms = min(cuda_ms(lambda: probe.run(job, a, b), PROBE_CALLS) for _ in range(2))
        library_call, library, as_out = probe_library(job, a, b)
        library_ms = library_cold_ms = library_err = None
        if library is not None:
            library_ms, _ = timed_ms("library_ms", library)
            library_cold_ms, _ = timed_ms("library_cold_ms", library, scrub=scrub)
            got = as_out(library())
            library_err = float((got - want).abs().max())
            check(within(got, want, **PROBE_SUM_TOL) if sums else torch.equal(got, want),
                  f"probe {job}: the library call {library_call!r} is not the job's function "
                  f"(max abs err {library_err:.3e})")
        ops, nbytes = probe.work(job)
        bound_ms, bound_by = bound_of(ops, nbytes, PEAK_BF16_FLOPS)
        replaces, what = probe.JOBS[job]
        records.append(dict(
            name=f"probe_bf16.{job}", route="cuda", source=probe.SOURCE, replaces=replaces,
            launches=launches[job], max_abs_err=err,
            tolerance=PROBE_SUM_TOL if sums else "exact", ms=kernel_ms, kernel_ms=kernel_ms,
            cold_ms=cold_ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            library_cold_ms=library_cold_ms, library_call=library_call,
            library_max_abs_err=library_err,
            x_bound=kernel_ms / bound_ms,
            x_library=None if library_ms is None else kernel_ms / library_ms,
            kernels_ms=kernels, timed_by=timed, probes=what, flops=ops, bytes=nbytes))
    print("probe check: " + json.dumps(dict(card=card, jobs={
        r["name"]: {k: r[k] for k in ("max_abs_err", "kernel_ms", "cold_ms", "call_ms",
                                      "plain_ms", "library_ms", "library_cold_ms", "bound_ms",
                                      "x_bound", "x_library", "kernels_ms", "timed_by")}
        for r in records})))
    return records


def train_config(fused: str, batch: int = None, compute_dtype: str = "float32",
                 ghost: int = 64):
    from coskad_tpu_torch.config import Config, DataConfig, ModelConfig, OptConfig, RunConfig

    return Config(
        model=ModelConfig(variant="euclidean_dynamic", channels=(32, 16, 32), h_dim=64,
                          latent_dim=16, projector="linear"),
        data=DataConfig(seg_len=12, kp18_format=True, num_transform=5,
                        batch_size=batch or TRAIN_BATCH),
        opt=OptConfig(lr=1e-4, epochs=TRAIN_EPOCHS, validation=True),
        run=RunConfig(seed=0, fused_train=fused, ghost_size=ghost, compute_dtype=compute_dtype),
    )


class QuietLogger:
    """A MetricLogger that keeps every per-step metric instead of printing."""

    every_n_steps = 1

    def __init__(self):
        self.steps = []

    def log(self, metrics, step, force=False):
        if "loss" in metrics:
            self.steps.append(dict(metrics))

    @property
    def losses(self):
        return [float(m["loss"]) for m in self.steps]


def phase_train(card):
    import copy

    import torch
    from coskad_tpu_torch.data.windows import SegmentDataset
    from coskad_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    data, meta, fids, _ = synthetic_windows(rng, TRAIN_CLIPS, 2, 200, 12, 18)
    train_ds = SegmentDataset(data, meta, fids, num_transform=5)
    vdata, vmeta, vfids, gts = synthetic_windows(rng, VAL_CLIPS, 2, 200, 12, 18,
                                                 anomalous=(80, 130))
    val_ds = SegmentDataset(vdata, vmeta, vfids, num_transform=5)
    cfg = train_config("on")
    log = QuietLogger()
    trainer = Trainer(cfg, train_ds, val_ds=val_ds, ground_truths=gts, device=DEVICE, logger=log)
    gen = torch.Generator().manual_seed(11)
    jitter_affine(trainer.model, gen)
    init_weights = copy.deepcopy(trainer.model.state_dict())
    epoch_s = []
    inner = trainer.train_epoch

    def timed_epoch(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t)
        return out

    trainer.train_epoch = timed_epoch
    bn_before = {k: b.clone() for k, b in trainer.model.named_buffers()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the training path, counted ---
    counters = launch_counters()
    zero(counters)
    t0 = time.perf_counter()
    state = trainer.initialize_center(trainer.init_state())
    history = {"loss": [], "validation_auc": []}
    for _ in range(TRAIN_EPOCHS):
        state, hist = trainer.fit(state, epochs=1)
        for k in history:
            history[k] += hist[k]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read(counters)
    # --- end of the counted run ---

    n_items = len(train_ds)
    steps = n_items // cfg.data.batch_size
    want = dict(stse_train_forward=steps * TRAIN_EPOCHS,
                stse_train_layer_backward=3 * steps * TRAIN_EPOCHS,
                stse_train_top_backward=steps * TRAIN_EPOCHS, stse_train_mono_backward=0)
    for k, v in want.items():
        check(launches[k] == v, f"{k} launched {launches[k]} times in {TRAIN_EPOCHS} epochs, "
                                f"expected {v} ({steps} steps an epoch)")
    check(launches["stse_fused"] > 0, "K1 was not launched by initialize_center / validate")
    check(len(log.losses) == steps * TRAIN_EPOCHS and all(np.isfinite(log.losses)),
          "every train step logs a finite loss")
    check(len(history["validation_auc"]) == TRAIN_EPOCHS
          and all(0.0 <= a <= 1.0 for a in history["validation_auc"]),
          f"validation AUC each epoch in [0, 1]: {history['validation_auc']}")
    changed = [k for k, b in trainer.model.named_buffers() if not torch.equal(b, bn_before[k])]
    check(all(bool(torch.isfinite(b).all()) for b in trainer.model.buffers()),
          "running statistics are finite")
    check(len(changed) == len(bn_before), f"every BN buffer changed: {len(changed)} of "
                                          f"{len(bn_before)}")
    check(bool(torch.isfinite(state.center).all()), "center is finite")
    items_per_epoch = steps * cfg.data.batch_size
    steady_s = min(epoch_s[1:])
    train_wps = items_per_epoch / steady_s

    # Three steps of a 256-window subset on the card and on the CPU (not counted).
    sub_err = cpu_subset_check(Trainer, SegmentDataset, data, meta, fids, init_weights)

    breakdown = train_breakdown(trainer, state)
    breakdown["train_step_host_clock"] = steady_s * 1e3 / steps
    off_ms = live_bn_step_ms(Trainer, cfg, train_ds, init_weights)
    idx = torch.arange(steps * cfg.data.batch_size, device=trainer.device).reshape(steps, -1)
    trainer.model.train()
    trace = device_profile(lambda: inner(state, trainer.train_data, idx))
    trainer.model.eval()
    # The trace's time in K2-K4's kernels against the same epoch from their
    # CUDA-event times (K2, K3 a layer, K4 in the breakdown: back-to-back
    # launches, so no host gap inside them): a trace that lost events (one
    # held half the device time) is flagged.
    events_ms = steps * sum(v for k, v in breakdown.items() if k.startswith(("K2", "K3", "K4")))
    trace["train_kernels_cuda_event_epoch_ms"] = events_ms
    trace["train_kernels_over_cuda_events"] = trace["train_kernels_ms"] / events_ms
    trace["flagged"] = abs(trace["train_kernels_over_cuda_events"] - 1.0) > 0.10
    if trace["flagged"]:
        print(f"train trace FLAGGED: K2-K4's kernels {trace['train_kernels_ms']:.1f} ms against "
              f"{events_ms:.1f} ms from their CUDA-event times: read it with care")
    summary = dict(
        windows=train_ds.num_windows, items=n_items, batch=cfg.data.batch_size, ghost=64,
        steps_per_epoch=steps, epochs=TRAIN_EPOCHS, setup_s=setup_s, fit_s=fit_s,
        train_epoch_s=epoch_s, train_windows_per_s=train_wps, losses_per_epoch=history["loss"],
        validation_auc=history["validation_auc"], launches=launches,
        cpu_subset_loss_max_rel_err=sub_err, breakdown_ms=breakdown,
        live_bn_step_ms=off_ms, trace=trace, card=card)
    print(f"train: fit {TRAIN_EPOCHS} epochs x {steps} steps of {cfg.data.batch_size} "
          f"(ghost 64, fused_train='on'): {train_wps:.0f} train windows/s (steady, best of "
          f"epochs 2-{TRAIN_EPOCHS}; train_epoch {[round(t, 4) for t in epoch_s]} s) on {card}; "
          f"losses {[round(v, 6) for v in history['loss']]}; validation AUC "
          f"{[round(a, 4) for a in history['validation_auc']]}; launches {launches}; "
          f"CPU-subset loss max rel err {sub_err:.2e}")
    print("train breakdown per 2048-window step (ms; stages by CUDA events, step by host "
          "clock): " + json.dumps(breakdown) + f"; live-BN (fused_train='off') step "
          f"{off_ms:.3f} ms host clock")
    print("train trace of one epoch (torch.profiler): " + json.dumps(trace))
    return summary


def phase_train_bf16(card):
    """The flagship fused step at compute_dtype bfloat16 (bench.py's fused
    configuration): Trainer.fit for BF16_EPOCHS with fused_train 'on', ghost
    64, batch 2048 over the train phase's windows, with validation (the bf16
    eval takes K1's bf16 form). Counted: K2/K3/K4 launch steps/3 steps/steps
    an epoch, K1 in the center init and validation. Then, not counted: the kernels at
    bf16 with one ghost block of the whole batch (whole-batch BatchNorm)
    against the module path at bf16, fused_train 'off', from the same
    weights over the same batches (per-step losses within BF16_LOSS_BAND);
    the fp32 and bf16 fused steps' time (host clock, in turns) and peak
    memory above resident."""
    import copy

    import torch
    from coskad_tpu_torch.data.windows import SegmentDataset
    from coskad_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(1)
    data, meta, fids, _ = synthetic_windows(rng, TRAIN_CLIPS, 2, 200, 12, 18)
    train_ds = SegmentDataset(data, meta, fids, num_transform=5)
    vdata, vmeta, vfids, gts = synthetic_windows(rng, VAL_CLIPS, 2, 200, 12, 18,
                                                 anomalous=(80, 130))
    val_ds = SegmentDataset(vdata, vmeta, vfids, num_transform=5)
    cfg = train_config("on", compute_dtype="bfloat16")
    log = QuietLogger()
    trainer = Trainer(cfg, train_ds, val_ds=val_ds, ground_truths=gts, device=DEVICE, logger=log)
    check(trainer.model.dtype == torch.bfloat16 and trainer._fused_compat,
          "the bf16 flagship config did not build a bf16 fused trainer")
    jitter_affine(trainer.model, torch.Generator().manual_seed(11))
    weights = copy.deepcopy(trainer.model.state_dict())

    # --- the bf16 training path, counted ---
    counters = launch_counters()
    zero(counters)
    t0 = time.perf_counter()
    state, history = trainer.fit(trainer.initialize_center(trainer.init_state()),
                                 epochs=BF16_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read(counters)
    # --- end of the counted run ---
    steps = len(train_ds) // cfg.data.batch_size
    want = dict(stse_fused=launches["stse_fused"], stse_train_forward=steps * BF16_EPOCHS,
                stse_train_layer_backward=3 * steps * BF16_EPOCHS,
                stse_train_top_backward=steps * BF16_EPOCHS, stse_train_mono_backward=0)
    check(launches == want and launches["stse_fused"] > 0,
          f"bf16 fit launches {launches}, expected {want} and K1's bf16 form in the center "
          "init and validation")
    check(len(log.losses) == steps * BF16_EPOCHS and all(np.isfinite(log.losses)),
          f"bf16 fit: every step logs a finite loss ({len(log.losses)})")
    check(all(0.0 <= a <= 1.0 for a in history["validation_auc"])
          and all(bool(torch.isfinite(b).all()) for b in trainer.model.buffers())
          and bool(torch.isfinite(state.center).all()),
          f"bf16 fit: validation AUC {history['validation_auc']}, running statistics or center "
          "not finite")

    band = bf16_module_band(Trainer, train_ds, weights)
    step = bf16_step_cost(Trainer, train_ds, weights)
    summary = dict(card=card, epochs=BF16_EPOCHS, steps_per_epoch=steps, fit_s=fit_s,
                   launches=launches, losses_per_epoch=history["loss"],
                   validation_auc=history["validation_auc"], module_band=band, step=step)
    print(f"train bf16: fit {BF16_EPOCHS} epochs x {steps} steps of {cfg.data.batch_size} at "
          f"compute_dtype bfloat16 (fused_train 'on', ghost 64) on {card}: launches {launches}; "
          f"losses {[round(v, 6) for v in history['loss']]}; validation AUC "
          f"{[round(a, 4) for a in history['validation_auc']]}; kernels (ghost = batch) vs the "
          f"module path at bf16, per-step losses max rel err {band['loss_max_rel_err']:.2e} "
          f"(band {BF16_LOSS_BAND}); step (host clock, in turns) " + json.dumps(step))
    return summary


def phase_pipeline(card):
    with tempfile.TemporaryDirectory() as root:
        return pipeline_run(card, root)


def in_turns(fns: dict, turns: int) -> dict:
    """Best host-clock seconds of each fn over `turns` rounds, the fns taking
    turns within a round; each call synchronizes the card on both sides."""
    import torch

    best = {k: float("inf") for k in fns}
    for _ in range(turns):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best[k] = min(best[k], time.perf_counter() - t)
    return best


def add_launches(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in more.items()}


def pipeline_fits(store, host, compute_dtype, counters):
    """PIPE_EPOCHS of the flagship fit through the store and, from the same
    weights, through the windows, epoch by epoch in turns. Returns the store
    trainer, its state, its launches (each store call counted alone) and the
    report."""
    import torch
    from coskad_tpu_torch.train.loop import Trainer

    cfg = train_config("on", compute_dtype=compute_dtype)
    logs = dict(store=QuietLogger(), windows=QuietLogger())
    trainers = dict(store=Trainer(cfg, store, device=DEVICE, logger=logs["store"]),
                    windows=Trainer(cfg, host, device=DEVICE, logger=logs["windows"]))
    check(trainers["store"]._pipeline == "store" and trainers["store"]._fused_compat,
          "the pipeline trainer is not a fused store trainer")
    jitter_affine(trainers["store"].model, torch.Generator().manual_seed(11))
    trainers["windows"].model.load_state_dict(trainers["store"].model.state_dict())
    launches = {}
    zero(counters)
    states = dict(store=trainers["store"].initialize_center(trainers["store"].init_state()))
    torch.cuda.synchronize()
    launches = add_launches(launches, read(counters))
    states["windows"] = trainers["windows"].initialize_center(trainers["windows"].init_state())
    epoch_s = dict(store=[], windows=[])
    for _ in range(PIPE_EPOCHS):
        for kind in ("store", "windows"):
            zero(counters)
            torch.cuda.synchronize()
            t = time.perf_counter()
            states[kind], _ = trainers[kind].fit(states[kind], epochs=1)
            torch.cuda.synchronize()
            epoch_s[kind].append(time.perf_counter() - t)
            if kind == "store":
                launches = add_launches(launches, read(counters))
    steps = len(store) // cfg.data.batch_size
    want = dict(stse_train_forward=steps * PIPE_EPOCHS,
                stse_train_layer_backward=3 * steps * PIPE_EPOCHS,
                stse_train_top_backward=steps * PIPE_EPOCHS, stse_train_mono_backward=0)
    for k, v in want.items():
        check(launches[k] == v, f"pipeline {compute_dtype}: {k} launched {launches[k]} times "
                                f"through the store, expected {v} ({steps} steps an epoch)")
    check(launches["stse_fused"] > 0,
          f"pipeline {compute_dtype}: K1 launches {launches['stse_fused']} in the store's center "
          "init (K1's bf16 form at bf16)")
    ls, lw = (np.asarray(logs[k].losses) for k in ("store", "windows"))
    check(len(ls) == len(lw) == steps * PIPE_EPOCHS and np.isfinite(ls).all(),
          f"pipeline {compute_dtype}: {len(ls)} store and {len(lw)} windows step losses")
    band = LOSS_RTOL if compute_dtype == "float32" else BF16_LOSS_BAND
    loss_err = float(np.max(np.abs(ls - lw) / np.abs(lw)))
    check(loss_err <= band, f"pipeline {compute_dtype}: store vs windows per-step losses max rel "
                            f"err {loss_err:.3e} (band {band})")
    items = steps * cfg.data.batch_size
    report = dict(compute_dtype=compute_dtype, steps_per_epoch=steps, launches=launches,
                  losses_per_epoch=[float(ls[i * steps:(i + 1) * steps].mean())
                                    for i in range(PIPE_EPOCHS)],
                  loss_max_rel_err_vs_windows=loss_err, loss_band=band, epoch_s=epoch_s,
                  train_windows_per_s={k: items / min(v[1:] or v) for k, v in epoch_s.items()})
    return trainers, states, launches, report


def pipeline_run(card, root):
    import dataclasses

    import torch
    from coskad_tpu_torch.data import native
    from coskad_tpu_torch.data.alphapose import (load_alphapose_split, load_alphapose_store,
                                                 parse_clip_json)
    from coskad_tpu_torch.data.device_pipeline import gather_batch_from_store
    from coskad_tpu_torch.data.transforms import canonical_transforms, gather_batch
    from coskad_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(19)
    t0 = time.perf_counter()
    for c in range(1, PIPE_CLIPS + 1):
        write_clip_json(os.path.join(root, f"01_{c:04d}_tracked.json"), rng, PIPE_FRAMES,
                        n_actors=PIPE_ACTORS)
    write_s = time.perf_counter() - t0
    files = sorted(os.path.join(root, f) for f in os.listdir(root))
    json_bytes = sum(os.path.getsize(f) for f in files)

    # --- the native parser at the store's scale ---
    check(native.native_available(), "the native clip parser did not build on this machine")
    parsed = {}

    def parse(kind):
        def run():
            os.environ["COSKAD_NATIVE"] = "0" if kind == "json" else "1"
            try:
                parsed[kind] = [parse_clip_json(f) for f in files]
            finally:
                os.environ.pop("COSKAD_NATIVE", None)
        return run

    parse_s = in_turns(dict(native=parse("native"), json=parse("json")), PIPE_TURNS)
    persons = [t for clip in parsed["native"] for t in clip]
    plain = [t for clip in parsed["json"] for t in clip]
    check(len(persons) == len(plain) == PIPE_CLIPS * PIPE_ACTORS
          and all(a.person_id == b.person_id and a.frame_keys == b.frame_keys
                  and np.array_equal(a.keypoints, b.keypoints) for a, b in zip(persons, plain)),
          "the native parse differs from the json.load parse")

    # --- the store and the windows of the same directory ---
    kw = dict(seg_len=12, seg_stride=1, num_transform=5)
    t0 = time.perf_counter()
    store = load_alphapose_store(root, device=DEVICE, **kw)
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = load_alphapose_split(root, **kw)
    host_s = time.perf_counter() - t0
    n_windows = PIPE_CLIPS * PIPE_ACTORS * (PIPE_FRAMES - 12)
    check(store.num_windows == host.num_windows == n_windows and store.kp_shape == (18, 3)
          and np.array_equal(store.meta, host.meta)
          and np.array_equal(store.frame_ids, host.frame_ids),
          f"store {store.num_windows} windows, host {host.num_windows}, expected {n_windows}")
    check(store.traj.is_cuda and tuple(store.traj.shape) == (PIPE_CLIPS * PIPE_ACTORS,
                                                             PIPE_FRAMES, 54),
          f"store trajectories {tuple(store.traj.shape)} on {store.traj.device}")
    idx = torch.as_tensor(np.random.default_rng(3).choice(len(store), PIPE_INDICES,
                                                          replace=False))
    table = torch.as_tensor(canonical_transforms(5))

    def tables(st, dev):
        return (st.traj.to(dev),
                torch.as_tensor(st.window_person, dtype=torch.int64, device=dev),
                torch.as_tensor(st.window_start, dtype=torch.int64, device=dev))

    on_card = gather_batch_from_store(store, *tables(store, DEVICE), idx.to(DEVICE),
                                      table.to(DEVICE)).cpu()
    cpu_store = dataclasses.replace(store, traj=store.traj.cpu())
    on_cpu = gather_batch_from_store(cpu_store, *tables(cpu_store, "cpu"), idx, table)
    windows = gather_batch(torch.from_numpy(host.data), idx, table)
    batch_err = dict(vs_cpu_store=float((on_card - on_cpu).abs().max()),
                     vs_windows=float((on_card - windows).abs().max()))
    check(on_card.shape == (PIPE_INDICES, 2, 12, 18) and bool(torch.isfinite(on_card).all())
          and within(on_card, on_cpu, **PIPE_BATCH_TOL)
          and within(on_card, windows, **PIPE_BATCH_TOL),
          f"the store's batch on the card vs its CPU path and the windows: {batch_err}")

    # --- training through the store, float32 and bf16, counted ---
    counters = launch_counters()
    trainers, states, launches, fit32 = pipeline_fits(store, host, "float32", counters)
    _, _, launches_bf16, fit16 = pipeline_fits(store, host, "bfloat16", counters)

    # --- scoring through the store, counted, from the float32 fit's state ---
    trainers["windows"].model.load_state_dict(trainers["store"].model.state_dict())
    state = states["store"]
    zero(counters)
    scores, _ = trainers["store"].score_all(state, store, trainers["store"].train_data)
    torch.cuda.synchronize()
    score_launches = read(counters)
    launches = add_launches(launches, score_launches)
    want_k1 = -(-len(store) // TRAIN_BATCH)
    check(score_launches == dict(stse_fused=want_k1, stse_train_forward=0,
                                 stse_train_layer_backward=0, stse_train_top_backward=0,
                                 stse_train_mono_backward=0),
          f"score_all through the store launched {score_launches}, expected K1 {want_k1}")
    by_windows, _ = trainers["windows"].score_all(state, host, trainers["windows"].train_data)
    s_store, s_win = torch.from_numpy(scores), torch.from_numpy(by_windows)
    score_err = float((s_store - s_win).abs().max())
    check(bool(torch.isfinite(s_store).all()) and within(s_store, s_win, **SCORE_TOL),
          f"store scores vs the windows pipeline's: max abs {score_err:.3e}")
    score_s = in_turns({k: functools.partial(trainers[k].score_all, state, ds,
                                             trainers[k].train_data)
                        for k, ds in (("store", store), ("windows", host))}, PIPE_TURNS)
    traj, persons_dev, starts_dev = trainers["store"].train_data
    resident = dict(store=traj.numel() * traj.element_size()
                    + persons_dev.numel() * persons_dev.element_size()
                    + starts_dev.numel() * starts_dev.element_size(),
                    windows=trainers["windows"].train_data.numel()
                    * trainers["windows"].train_data.element_size())

    # --- the contrastive view through the store, counted ---
    cfg = train_config("on")
    cfg = dataclasses.replace(
        cfg, opt=dataclasses.replace(cfg.opt, contrastive_weight=0.5),
        run=dataclasses.replace(cfg.run, freeze_bn_after=1))
    log = QuietLogger()
    tr = Trainer(cfg, store, device=DEVICE, logger=log)
    jitter_affine(tr.model, torch.Generator().manual_seed(12))
    cstate = tr.initialize_center(tr.init_state())
    steps = len(store) // TRAIN_BATCH
    con_s = []
    con_launches = []
    for epoch in range(2):  # epoch 1 >= freeze_bn_after: both views frozen
        bn_before = {k: b.clone() for k, b in tr.model.named_buffers()}
        zero(counters)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cstate, _ = tr.fit(cstate, epochs=1)
        torch.cuda.synchronize()
        con_s.append(time.perf_counter() - t)
        con_launches.append(read(counters))
        unchanged = all(torch.equal(b, bn_before[k]) for k, b in tr.model.named_buffers())
        check(unchanged == (epoch == 1),
              f"contrastive epoch {epoch}: running statistics {'un' if unchanged else ''}changed "
              f"(freeze_bn_after 1)")
    launches = add_launches(launches, con_launches[0])
    check(con_launches[0] == dict(stse_fused=0, stse_train_forward=2 * steps,
                                  stse_train_layer_backward=6 * steps,
                                  stse_train_top_backward=2 * steps, stse_train_mono_backward=0),
          f"contrastive epoch launches {con_launches[0]}: K2 must run twice a step "
          f"({steps} steps)")
    check(con_launches[1]["stse_train_forward"] == 0,
          f"the frozen contrastive epoch launched K2: {con_launches[1]}")
    con_losses = np.asarray([m["contrastive_loss"] for m in log.steps])
    check(len(con_losses) == 2 * steps and np.isfinite(con_losses).all()
          and np.isfinite(log.losses).all(),
          f"contrastive losses: {len(con_losses)} of {2 * steps}, finite "
          f"{bool(np.isfinite(con_losses).all())}")

    summary = dict(
        card=card, clips=PIPE_CLIPS, actors=PIPE_ACTORS, frames=PIPE_FRAMES, windows=n_windows,
        items=len(store), json_bytes=json_bytes, write_s=write_s,
        parse_s=parse_s, native_speedup=parse_s["json"] / parse_s["native"],
        load_store_s=store_s, load_windows_s=host_s, batch_err=batch_err,
        fit_float32=fit32, fit_bfloat16=fit16, score_err=score_err,
        scoring_windows_per_s={k: len(store) / v for k, v in score_s.items()},
        resident_bytes=resident, contrastive=dict(
            epoch_s=con_s, launches=con_launches,
            contrastive_loss_per_epoch=[float(con_losses[:steps].mean()),
                                        float(con_losses[steps:].mean())],
            loss_per_epoch=[float(np.mean(log.losses[:steps])),
                            float(np.mean(log.losses[steps:]))]),
        launches=launches, launches_bf16=launches_bf16)
    print(f"pipeline: {PIPE_CLIPS} clips x {PIPE_ACTORS} actors x {PIPE_FRAMES} frames "
          f"({json_bytes} bytes of JSON), parse s native {parse_s['native']:.3f} json.load "
          f"{parse_s['json']:.3f} (best of {PIPE_TURNS} in turns, same bits); store "
          f"{store_s:.2f} s, windows {host_s:.2f} s to load; {n_windows} windows x 5; batch of "
          f"{PIPE_INDICES} max abs vs CPU store {batch_err['vs_cpu_store']:.2e}, vs windows "
          f"{batch_err['vs_windows']:.2e}; on {card}")
    for r in (fit32, fit16):
        print(f"pipeline fit {r['compute_dtype']}: {PIPE_EPOCHS} epochs x "
              f"{r['steps_per_epoch']} steps, train windows/s store "
              f"{r['train_windows_per_s']['store']:.0f} windows "
              f"{r['train_windows_per_s']['windows']:.0f} (epoch 2, in turns; epochs "
              f"{ {k: [round(t, 3) for t in v] for k, v in r['epoch_s'].items()} } s); store "
              f"launches {r['launches']}; losses {[round(v, 6) for v in r['losses_per_epoch']]},"
              f" vs windows max rel {r['loss_max_rel_err_vs_windows']:.2e} (band "
              f"{r['loss_band']})")
    print(f"pipeline scoring: windows/s store "
          f"{summary['scoring_windows_per_s']['store']:.0f} windows "
          f"{summary['scoring_windows_per_s']['windows']:.0f} (best of {PIPE_TURNS} in turns); "
          f"scores max abs vs windows {score_err:.2e}; K1 {score_launches['stse_fused']}; "
          f"resident bytes {resident}")
    print(f"pipeline contrastive: epochs {[round(t, 3) for t in con_s]} s (the second past "
          f"freeze_bn_after, running statistics unchanged); launches {con_launches}; "
          f"contrastive loss {summary['contrastive']['contrastive_loss_per_epoch']}, loss "
          f"{summary['contrastive']['loss_per_epoch']}")
    return summary


def bf16_module_band(Trainer, train_ds, weights) -> dict:
    """The bf16 kernels with one ghost block of the whole batch (BatchNorm
    over the batch, the module path's semantics) against the module path at
    bf16, from the same weights and center over the same BF16_BAND_STEPS
    batches: per-step losses within BF16_LOSS_BAND relative."""
    import torch

    idx = np.random.default_rng(6).permutation(len(train_ds))[:BF16_BAND_STEPS * TRAIN_BATCH]
    losses = {}
    for key, cfg in (("kernels", train_config("on", compute_dtype="bfloat16",
                                              ghost=TRAIN_BATCH)),
                     ("module", train_config("off", compute_dtype="bfloat16"))):
        tr = Trainer(cfg, train_ds, device=DEVICE)
        tr.model.load_state_dict(weights)
        state = tr.initialize_center(tr.init_state())
        tr.model.train()
        out = []
        for i in range(BF16_BAND_STEPS):
            batch = torch.as_tensor(idx[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH], device=DEVICE)
            state, m = tr.train_step(state, tr.train_data, batch)
            out.append(float(m["loss"]))
        losses[key] = np.asarray(out)
    rel = float(np.max(np.abs(losses["kernels"] - losses["module"]) / np.abs(losses["module"])))
    check(bool(np.isfinite(losses["kernels"]).all()) and rel <= BF16_LOSS_BAND,
          f"bf16 kernels (ghost = batch) vs the bf16 module path: losses {losses['kernels']} vs "
          f"{losses['module']}")
    return dict(losses_kernels=losses["kernels"].tolist(), losses_module=losses["module"].tolist(),
                loss_max_rel_err=rel, band=BF16_LOSS_BAND, steps=BF16_BAND_STEPS)


def bf16_step_cost(Trainer, train_ds, weights, count=10) -> dict:
    """The fused train step (ghost 64, batch 2048) at float32 and at bf16
    from the same weights: host-clock ms over `count` steps, in turns (f32,
    bf16, bf16, f32), one step's peak memory above resident (beside the bf16
    step's at PR 11, whose backward scratch was fp32), and the device idle
    share of `count` bf16 steps (torch.profiler)."""
    import torch

    trainers = {}
    for dtype in ("float32", "bfloat16"):
        tr = Trainer(train_config("on", compute_dtype=dtype), train_ds, device=DEVICE)
        tr.model.load_state_dict(weights)
        tr.model.train()
        trainers[dtype] = [tr, tr.init_state()]
    idx = (torch.arange((count + 2) * TRAIN_BATCH, device=DEVICE) % len(train_ds)).reshape(
        count + 2, -1)

    def run(dtype, rows):
        tr, state = trainers[dtype]
        for i in rows:
            state, _ = tr.train_step(state, tr.train_data, idx[i])
        trainers[dtype][1] = state

    for dtype in trainers:  # warm-up
        run(dtype, range(2))
    ms = {"float32": [], "bfloat16": []}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(dtype, range(2, count + 2))
        torch.cuda.synchronize()
        ms[dtype].append((time.perf_counter() - t0) * 1e3 / count)
    peak = {}
    for dtype in trainers:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run(dtype, range(1))
        torch.cuda.synchronize()
        peak[dtype] = torch.cuda.max_memory_allocated() - base
    check(peak["bfloat16"] < BF16_PEAK_F32_ACTS,
          f"the bf16 step's peak above resident {peak['bfloat16']} B is not below "
          f"{BF16_PEAK_F32_ACTS} B, the peak with fp32 activations")
    prof = device_profile(lambda: run("bfloat16", range(2, count + 2)))
    return dict(step_ms=ms, peak_bytes_above_resident=peak,
                bf16_peak_bytes_above_resident_pr11=BF16_PEAK_PR11,
                bf16_peak_bytes_above_resident_f32_acts=BF16_PEAK_F32_ACTS,
                bf16_idle_share=prof["idle_share"], bf16_device_busy_ms=prof["device_busy_ms"],
                bf16_device_span_ms=prof["device_span_ms"])


def cpu_subset_check(Trainer, SegmentDataset, data, meta, fids, weights, n_win=256, steps=3):
    """The fused train step on the card and the plain one on the CPU, from
    the same weights over the same index batches: per-step losses agree."""
    import torch

    sub = (data[:n_win], meta[:n_win], fids[:n_win])
    cfg = train_config("on", batch=n_win)
    losses = {}
    idx = np.random.default_rng(5).permutation(n_win * 5)[:steps * n_win].reshape(steps, n_win)
    for dev in (DEVICE, "cpu"):
        tr = Trainer(cfg, SegmentDataset(*sub, num_transform=5), device=dev)
        tr.model.load_state_dict({k: v.to(dev) for k, v in weights.items()})
        state = tr.initialize_center(tr.init_state())
        tr.model.train()
        out = []
        for i in range(steps):
            state, m = tr.train_step(state, tr.train_data, torch.as_tensor(idx[i], device=dev))
            out.append(float(m["loss"]))
        losses[dev] = np.asarray(out)
    err = float(np.max(np.abs(losses[DEVICE] - losses["cpu"]) / np.abs(losses["cpu"])))
    check(np.allclose(losses[DEVICE], losses["cpu"], rtol=LOSS_RTOL, atol=0.0),
          f"fused train steps on the card vs the plain CPU path: losses {losses[DEVICE]} vs "
          f"{losses['cpu']}")
    return err


def train_breakdown(trainer, state):
    """Device time of each stage of one 2048-window train step (CUDA events):
    gather, K2, K3 per layer, K4, and loss + backward into the weights + Adam
    (on a copy of the model, so the trainer's weights stay as they are)."""
    import copy

    import torch
    from coskad_tpu_torch.kernels import stse_train as st
    from coskad_tpu_torch.train import objectives

    cfg = trainer.cfg
    idx = torch.arange(cfg.data.batch_size, device=trainer.device)
    model = copy.deepcopy(trainer.model)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.opt.lr)
    batch = trainer._gather(trainer.train_data, idx)
    b, c, t, v = batch.shape
    x = batch.permute(0, 2, 3, 1).reshape(b, t * v, c).contiguous()
    ops = st.encoder_ops(model)
    det = st.EncoderOps(tuple(st.LayerOps(*(None if a is None else a.detach() for a in lay))
                              for lay in ops.layers), ops.wp.detach(), ops.bp.detach())
    g = cfg.run.ghost_size
    z, _, acts, stats = st.ghost_forward(x, det, g)
    dz = torch.randn_like(z)
    top = len(det.layers) - 1
    x_of = [x] + list(acts[:-1])
    out = dict(gather=cuda_ms(lambda: trainer._gather(trainer.train_data, idx), iters=10),
               K2=cuda_ms(lambda: st.ghost_forward(x, det, g), iters=10))
    for l in range(top):
        out[f"K3_layer{l}"] = cuda_ms(lambda l=l: st.layer_backward(
            x_of[l], acts[l], acts[l], det.layers[l], stats[l], g, need_dx=l > 0), iters=10)
    out["K4"] = cuda_ms(lambda: st.top_backward(x_of[top], acts[top], dz, det.layers[top],
                                                stats[top], det.wp, det.bp, g), iters=10)

    def loss_adam():
        zl = z.detach().requires_grad_(True)
        loss, _ = objectives.compute_loss(cfg, zl, batch, model, state.center, state.inv_cov)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    out["loss_backward_adam"] = cuda_ms(loss_adam, iters=10)
    return out


def live_bn_step_ms(Trainer, cfg, train_ds, weights, steps=10):
    """Host-clock time of one train step of the fused_train='off' path (live
    BatchNorm through the plain module path), for context."""
    import dataclasses

    import torch

    off = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, fused_train="off"))
    tr = Trainer(off, train_ds, device=DEVICE)
    tr.model.load_state_dict(weights)
    state = tr.init_state()
    idx = torch.arange(cfg.data.batch_size * (steps + 2), device=tr.device).reshape(steps + 2, -1)
    tr.model.train()
    for i in range(2):
        state, _ = tr.train_step(state, tr.train_data, idx[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, steps + 2):
        state, _ = tr.train_step(state, tr.train_data, idx[i])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def write_cli_tree(root, rng):
    """The cli phase's AlphaPose tree under root and two flagship configs
    (as JSON, reference keys) that differ only in their checkpoint folder."""
    pose = {split: os.path.join(root, "pose", split) for split in ("training", "testing")}
    gt_dir = os.path.join(root, "gt")
    for d in (*pose.values(), gt_dir):
        os.makedirs(d, exist_ok=True)
    for i in range(1, CLI_TRAIN_CLIPS + 1):
        write_clip_json(os.path.join(pose["training"], f"01_{i:04d}_tracked.json"), rng,
                        CLI_FRAMES)
    for i in range(1, CLI_TEST_CLIPS + 1):
        write_clip_json(os.path.join(pose["testing"], f"02_{i:04d}_tracked.json"), rng,
                        CLI_FRAMES, anomalous=CLI_ANOMALY)
        gt = np.zeros(CLI_FRAMES, np.int64)
        gt[CLI_ANOMALY[0]:CLI_ANOMALY[1]] = 1
        np.save(os.path.join(gt_dir, f"02_{i:04d}.npy"), gt)
    paths = {}
    for name in ("resumed", "straight"):
        raw = dict(
            dataset_choice="Synthetic", data_dir=root, gt_path=gt_dir,
            exp_dir=os.path.join(root, "checkpoints"), dir_name=name, seed=0, validation=True,
            use_decoder=False, use_vae=False, hyperbolic=False, static_center=True,
            num_coords=2, channels=[32, 16, 32], h_dim=64, latent_dim=16, projector="linear",
            dropout=0, distance="euclidean", dataset_seg_len=12, dataset_seg_stride=1,
            dataset_num_transform=5, dataset_vid_res=[856, 480], dataset_kp18_format=True,
            dataset_normalization_strategy="markovitz", dataset_batch_size=TRAIN_BATCH,
            ae_epochs=TRAIN_EPOCHS, opt_lr=1e-4, fused_train="on", ghost_size=64,
            pad_size=-1, split="test")
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(raw, f)
    return paths


def phase_cli(card):
    """cli.train, --resume, cli.eval and AnomalyScorer.from_checkpoint over
    an AlphaPose tree at the flagship width, in a temporary directory
    removed afterwards."""
    root = tempfile.mkdtemp(prefix="coskad_cli_")
    t0 = time.perf_counter()
    try:
        summary = cli_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"cli phase: {summary['phase_s']:.1f} s")
    return summary


def cli_run(card, root):
    import torch
    from coskad_tpu_torch.cli import eval as eval_cli
    from coskad_tpu_torch.cli import train as train_cli
    from coskad_tpu_torch.cli.common import load_config, load_split
    from coskad_tpu_torch.interop import flatten_tree, to_jax_variables
    from coskad_tpu_torch.serve import AnomalyScorer
    from coskad_tpu_torch.train import checkpoint
    from coskad_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    configs = write_cli_tree(root, np.random.default_rng(3))
    write_s = time.perf_counter() - t0
    cfg = load_config(configs["resumed"])
    ckpt_dir = cfg.ckpt_dir
    t0 = time.perf_counter()
    windows = load_split(cfg, "train").num_windows
    parse_s = time.perf_counter() - t0
    check(windows >= CLI_MIN_WINDOWS,
          f"the training tree gives {windows} windows, fewer than {CLI_MIN_WINDOWS}")
    steps = windows * cfg.data.num_transform // cfg.data.batch_size

    epoch_s = []
    inner = Trainer.train_epoch

    def timed_epoch(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(self, *args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t)
        return out

    dev = ["--device", DEVICE]
    counters = launch_counters()
    Trainer.train_epoch = timed_epoch
    try:
        # --- the command-line path, counted ---
        zero(counters)
        first = train_cli.main(["--config", configs["resumed"], "--epochs", "2", *dev])
        resumed = train_cli.main(["--config", configs["resumed"], "--epochs", "3", "--resume",
                                  *dev])
        train_launches = read(counters)
        best = os.path.join(ckpt_dir, "best.ckpt")
        ev = eval_cli.main(["--config", configs["resumed"], "--ckpt", best, *dev])
        t0 = time.perf_counter()
        scorer = AnomalyScorer.from_checkpoint(best, device=DEVICE)
        load_ms = (time.perf_counter() - t0) * 1e3
        served = scorer.score_windows(resumed.trainer.val_ds.data[:CLI_SERVED])
        launches = read(counters)
        # --- end of the counted run ---
        straight = train_cli.main(["--config", configs["straight"], *dev])
    finally:
        Trainer.train_epoch = inner

    want = dict(stse_train_forward=3 * steps, stse_train_layer_backward=3 * 3 * steps,
                stse_train_top_backward=3 * steps, stse_train_mono_backward=0)
    for k, v in want.items():
        check(train_launches[k] == v, f"cli.train launched {k} {train_launches[k]} times in 2 + 1 "
                                      f"epochs, expected {v} ({steps} steps an epoch)")
    check(train_launches["stse_fused"] > 0, "K1 was not launched by cli.train's validation")
    check(launches["stse_fused"] > train_launches["stse_fused"],
          "K1 was not launched by cli.eval / from_checkpoint")
    for name in ("best.ckpt", "last.ckpt", "best.ckpt.config.json", "metrics.jsonl"):
        check(os.path.exists(os.path.join(ckpt_dir, name)), f"cli.train wrote no {name}")
    last_extra = checkpoint.read_payload(os.path.join(ckpt_dir, "last.ckpt"))["extra"]
    check(last_extra.get("epochs_done") == 3, f"last.ckpt's extra: {last_extra}")
    losses = first.loss + resumed.loss
    check(len(losses) == 3 and all(np.isfinite(losses)), f"epoch losses {losses}")
    check(len(straight.loss) == 3 and all(np.isfinite(straight.loss)),
          f"straight epoch losses {straight.loss}")
    loss_diff = abs(resumed.loss[0] - straight.loss[2])
    check(loss_diff <= RESUME_RTOL * abs(straight.loss[2]),
          f"third-epoch loss resumed {resumed.loss[0]!r} vs straight {straight.loss[2]!r}")
    want_p = flatten_tree(to_jax_variables(straight.trainer.model)[0])
    param_diff = max(float(np.abs(v - want_p[k]).max())
                     for k, v in flatten_tree(to_jax_variables(resumed.trainer.model)[0]).items())
    check(np.isfinite(ev.result.auc) and 0.0 <= ev.result.auc <= 1.0,
          f"cli.eval AUC {ev.result.auc}")
    served_diff = float(np.abs(served - ev.window_scores[:CLI_SERVED]).max())
    check(served.shape == (CLI_SERVED,) and served_diff == 0.0,
          f"from_checkpoint's scores of {CLI_SERVED} test windows differ from cli.eval's: "
          f"max abs {served_diff:.3e}")

    # Round trip: save, restore into a fresh Trainer, the same bits (not counted).
    tr, state = resumed.trainer, resumed.state
    path = os.path.join(root, "roundtrip.ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, tr, state, tr.cfg)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = Trainer(tr.cfg, tr.val_ds, device=DEVICE)
    t0 = time.perf_counter()
    fstate, _, _ = checkpoint.restore(path, fresh)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    s_before, _ = tr.score_all(state, tr.val_ds, tr.val_data)
    s_after, _ = fresh.score_all(fstate, tr.val_ds, fresh.train_data)
    check(np.array_equal(s_before, s_after), "score_all after a save / restore differs: max abs "
                                             f"{float(np.abs(s_before - s_after).max()):.3e}")
    ckpt_bytes = os.path.getsize(path)
    items = steps * cfg.data.batch_size
    wps = [items / t for t in epoch_s]
    summary = dict(
        windows=windows, items_per_epoch=items, steps_per_epoch=steps, write_tree_s=write_s,
        parse_train_s=parse_s, train_epoch_s=epoch_s, train_windows_per_s=wps,
        losses_resumed=losses, losses_straight=straight.loss, resume_loss_abs_diff=loss_diff,
        resume_param_max_abs_diff=param_diff, checkpoint_bytes=ckpt_bytes, save_ms=save_ms,
        restore_ms=restore_ms, from_checkpoint_ms=load_ms, eval_wall_s=ev.wall_s,
        auc=ev.result.auc, validation_auc=first.validation_auc + resumed.validation_auc,
        launches=launches, train_launches=train_launches, card=card)
    print(f"cli: {windows} windows (parse {parse_s:.2f} s); train windows/s by epoch "
          f"{[round(v) for v in wps]} (epochs 1-2, resumed 3, straight 1-3); losses {losses}, "
          f"straight {straight.loss}, resumed vs straight: loss diff {loss_diff:.3e}, max param "
          f"diff {param_diff:.3e}; checkpoint {ckpt_bytes} bytes, save {save_ms:.1f} ms, restore "
          f"{restore_ms:.1f} ms, from_checkpoint {load_ms:.1f} ms; eval wall "
          + " ".join(f"{k}={v:.2f}s" for k, v in ev.wall_s.items())
          + f"; AUC {ev.result.auc:.4f}; launches {launches}; on {card}")
    return summary


# config/<dataset>/<name>.yaml: every encoder-only file the repo ships, run as written
PAPER_CONFIGS = tuple(f"{d}/{n}" for d in ("HR-STC", "HR-Avenue", "UBnormal")
                      for n in ("hyperbolic_encoder", "euclidean_encoder"))
# a copy of this one with compute_dtype float32: K1's route with the MLP head
PAPER_FLOAT32 = "HR-STC/hyperbolic_encoder"
# the lines of a shipped file the paper phase replaces: the four paths
PAPER_EDITS = ("data_dir", "dataset_path_to_robust", "test_path", "exp_dir")
CSV_FIRST_TEST_CLIP = 4  # HR-Avenue masks its clips 1, 2, 3, 6 and 16 with the real frames


def write_paper_trees(root, rng, train_clips=CLI_TRAIN_CLIPS):
    """The paper phase's data under root, the cli phase's clips with
    train_clips training clips, 17 keypoints: an HR-STC-shaped AlphaPose
    tree (pose/{training,testing}/<scene>_<clip>_alphapose_tracked_person.json,
    ground truth in testing/test_frame_mask/<scene>_<clip>.npy) for the
    markovitz file, and a
    Morais-CSV tree (csv/{training,testing,validating}/trajectories/
    <scene>-<clip>/<person>.csv: a frame column, then x, y of each joint) for
    the robust HR-Avenue and UBnormal files, the test clips' ground truth
    both in csv/testing (HR-Avenue's test_path) and csv/testing/
    test_frame_mask (UBnormal's); UBnormal validates on the validating
    split, here the test clips again. The CSV test clips are numbered from
    CSV_FIRST_TEST_CLIP, past HR-Avenue's masked clips 1-3 (its HR masks
    are the real clips' frames). Returns the two roots."""
    pose = {split: os.path.join(root, "pose", split) for split in ("training", "testing")}
    gt_dir = os.path.join(root, "testing", "test_frame_mask")
    for d in (*pose.values(), gt_dir):
        os.makedirs(d, exist_ok=True)
    name = "01_{:04d}_alphapose_tracked_person.json"
    for i in range(1, train_clips + 1):
        write_clip_json(os.path.join(pose["training"], name.format(i)), rng, CLI_FRAMES)
    for i in range(1, CLI_TEST_CLIPS + 1):
        write_clip_json(os.path.join(pose["testing"], name.format(i)), rng, CLI_FRAMES,
                        anomalous=CLI_ANOMALY)
        np.save(os.path.join(gt_dir, f"01_{i:04d}.npy"), clip_labels())
    csv = os.path.join(root, "csv")
    tests = range(CSV_FIRST_TEST_CLIP, CSV_FIRST_TEST_CLIP + CLI_TEST_CLIPS)
    for split, clips, anomalous in (("training", range(1, train_clips + 1), None),
                                    ("testing", tests, CLI_ANOMALY),
                                    ("validating", tests, CLI_ANOMALY)):
        for i in clips:
            write_clip_csv(os.path.join(csv, split, "trajectories", f"1-{i}"), rng, CLI_FRAMES,
                           anomalous=anomalous)
    for d in (os.path.join(csv, "testing"), os.path.join(csv, "testing", "test_frame_mask")):
        os.makedirs(d, exist_ok=True)
        for i in tests:
            np.save(os.path.join(d, f"01_{i:04d}.npy"), clip_labels())
    return root, csv


def clip_labels():
    gt = np.zeros(CLI_FRAMES, np.int64)
    gt[CLI_ANOMALY[0]:CLI_ANOMALY[1]] = 1
    return gt


def write_clip_csv(folder, rng, n_frames, n_joints=17, n_actors=2, anomalous=None):
    """One clip's Morais-CSV trajectories: random-walk actors in a 640 x 360
    frame (HR-Avenue's, the smaller resolution); with `anomalous` = (lo, hi),
    actor 1 scatters in frames lo+1..hi."""
    os.makedirs(folder, exist_ok=True)
    frames = np.arange(1, n_frames + 1)
    for pid in range(1, n_actors + 1):
        walk = rng.uniform(100, 260, size=(1, n_joints, 2)) + np.cumsum(
            rng.normal(scale=0.5, size=(n_frames, n_joints, 2)), axis=0)
        if anomalous is not None and pid == 1:
            lo, hi = anomalous
            walk[lo:hi] = rng.uniform(20, 340, size=(hi - lo, n_joints, 2))
        rows = np.concatenate([frames[:, None], np.clip(walk, 1, 359).reshape(n_frames, -1)], 1)
        np.savetxt(os.path.join(folder, f"{pid:04d}.csv"), rows, delimiter=",", fmt="%.3f")


def paper_config(config, trees, run_dir, float32=False, changes=None):
    """config/<config>.yaml (<dataset>/<name>) read from the checkout with the port's
    reader, then written under run_dir with only PAPER_EDITS's lines
    replaced (and compute_dtype with float32, for the float32 copy; and the
    keys of `changes`, each line replaced, or added where the file has
    none; the rest of the file as shipped, comments included); checks that
    the edited file reads as the shipped one but for those keys."""
    from coskad_tpu_torch.config import parse_reference_yaml

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", f"{config}.yaml")
    with open(src) as f:
        text = f.read()
    shipped = parse_reference_yaml(text, src)
    pose_root, csv_root = trees
    tests = dict(dataset_path_to_robust=csv_root)
    tests["test_path"] = (os.path.join(pose_root, "testing", "test_frame_mask")
                          if shipped["dataset_normalization_strategy"] != "robust"
                          else os.path.join(csv_root, "testing")
                          if shipped["test_path"].endswith("/testing")
                          else os.path.join(csv_root, "testing", "test_frame_mask"))
    edits = dict(data_dir=pose_root, exp_dir=run_dir, **tests)
    if float32:
        edits["compute_dtype"] = "float32"
    added = {k: v for k, v in (changes or {}).items() if k not in shipped}
    edits.update({k: v for k, v in (changes or {}).items() if k in shipped})
    lines = text.splitlines()
    for key, value in edits.items():
        at = [i for i, line in enumerate(lines) if line.startswith(f"{key}:")]
        check(len(at) == 1, f"{src}: {len(at)} lines set {key}")
        lines[at[0]] = f"{key}: {value}"
    lines += [f"{key}: {value}" for key, value in added.items()]
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"{config.replace('/', '_')}.yaml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(path) as f:
        edited = parse_reference_yaml(f.read(), path)
    check(sorted(edited) == sorted([*shipped, *added]) and all(
        edited[k] == shipped[k] for k in shipped if k not in edits),
        f"{path} does not read as {src} apart from {sorted([*edits, *added])}")
    return path, shipped


def phase_paper(card):
    """The paper's own configurations, every encoder-only config/*/*.yaml,
    through cli.train, --resume, cli.eval and from_checkpoint over
    HR-STC-shaped AlphaPose and Morais-CSV trees, in a temporary directory
    removed afterwards."""
    root = tempfile.mkdtemp(prefix="coskad_paper_")
    t0 = time.perf_counter()
    try:
        summary = paper_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"paper phase: {summary['phase_s']:.1f} s")
    return summary


def eval_route_timing(tr, x) -> dict:
    """A 2048-window eval forward of the trained bf16 model on K1's bf16
    form and on the module route (`module_route`), against the same weights
    at float32 (K1, then the head), in turns, CUDA events; the bf16 form's
    latent against the module route's."""
    import dataclasses

    import torch
    from coskad_tpu_torch.models import build_model
    from coskad_tpu_torch.train.loop import model_kwargs_from_config

    cfg = dataclasses.replace(tr.cfg, run=dataclasses.replace(tr.cfg.run,
                                                             compute_dtype="float32"))
    f32 = build_model(**model_kwargs_from_config(cfg)).to(DEVICE).eval()
    f32.load_state_dict(tr.model.state_dict())
    check(f32.kernel_takes() and tr.model.kernel_takes(), "eval routes: float32 K1, bf16 "
                                                         "K1's bf16 form")

    def module(m=tr.model):
        with module_route(m):
            return m(x)

    with torch.inference_mode():
        z_k1, z_mod = tr.model(x), module()
        runs = [cuda_ms(fn, iters=10, warmup=2) for _ in range(2)
                for fn in (lambda: tr.model(x), module, lambda: f32(x))]
    err = float((z_k1 - z_mod).abs().max())
    check(err <= 2.0 ** -5 * max(float(z_mod.abs().max()), 1.0),  # the bf16 band of the tests
          f"bf16 eval: K1's bf16 form vs the module route max abs err {err:.3e}")
    return dict(batch=x.shape[0], k1_bf16_ms=min(runs[0::3]), module_route_bf16_ms=min(runs[1::3]),
                k1_route_f32_ms=min(runs[2::3]), runs_ms=runs, k1_bf16_vs_module_err=err)


def paper_run(card, root):
    import torch
    from coskad_tpu_torch.cli import eval as eval_cli
    from coskad_tpu_torch.cli import train as train_cli
    from coskad_tpu_torch.cli.common import load_config, load_split
    from coskad_tpu_torch.geometry import poincare
    from coskad_tpu_torch.interop import flatten_tree, to_jax_variables
    from coskad_tpu_torch.serve import AnomalyScorer
    from coskad_tpu_torch.train import checkpoint
    from coskad_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    trees = write_paper_trees(root, np.random.default_rng(5), PAPER_TRAIN_CLIPS)
    write_s = time.perf_counter() - t0
    runs_of = {key: ("resumed", "straight") for key in PAPER_CONFIGS}
    runs_of["float32_copy"] = ("resumed",)
    configs = {key: {run: paper_config(PAPER_FLOAT32 if key == "float32_copy" else key, trees,
                                       os.path.join(root, "runs", key.replace("/", "_"), run),
                                       float32=key == "float32_copy")[0]
                     for run in runs}
               for key, runs in runs_of.items()}
    check("yaml" not in sys.modules, "reading the shipped configs imported yaml")

    epoch_s, centers = [], []
    inner_epoch, inner_updates = Trainer.train_epoch, Trainer.apply_epoch_updates

    def timed_epoch(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_epoch(self, *args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append((self.cfg.ckpt_dir, time.perf_counter() - t))
        return out

    def kept_center(self, state):
        state = inner_updates(self, state)
        if self.cfg.model.variant == "hyperbolic":
            c = state.center
            centers.append((float(torch.linalg.vector_norm(c)), float(poincare.dist0(c))))
        return state

    dev = ["--device", DEVICE]
    counters = launch_counters()
    runs, launches = {}, {}
    Trainer.train_epoch, Trainer.apply_epoch_updates = timed_epoch, kept_center
    try:
        for key in runs_of:
            # --- one configuration through the command line, counted ---
            zero(counters)
            path = configs[key]["resumed"]
            first = train_cli.main(["--config", path, "--epochs", "2", *dev])
            resumed = train_cli.main(["--config", path, "--epochs", "3", "--resume", *dev])
            best = os.path.join(load_config(path).ckpt_dir, "best.ckpt")
            ev = eval_cli.main(["--config", path, "--ckpt", best, *dev])
            t0 = time.perf_counter()
            scorer = AnomalyScorer.from_checkpoint(best, device=DEVICE)
            load_ms = (time.perf_counter() - t0) * 1e3
            # cli.eval's first test windows (its batches: CLI_SERVED is a multiple of each
            # file's batch, so the module route sums them in the same shapes)
            windows = load_split(scorer.cfg, "test", stride=1, scaler=scorer.scaler).data
            served = scorer.score_windows(windows[:CLI_SERVED])
            launches[key] = read(counters)
            # --- end of the counted run ---
            runs[key] = dict(first=first, resumed=resumed, ev=ev, served=served,
                             load_ms=load_ms, epochs=len(epoch_s))
            if "straight" in configs[key]:
                runs[key]["straight"] = train_cli.main(
                    ["--config", configs[key]["straight"], "--epochs", "3", *dev])
    finally:
        Trainer.train_epoch, Trainer.apply_epoch_updates = inner_epoch, inner_updates

    # K1 (center init, each validation, eval and from_checkpoint): the
    # float32 copy's, the bf16 files' bf16 form; K2-K5 never
    summary = dict(card=card, write_trees_s=write_s, launches=launches, predicted_launches={},
                   configs={})
    for key in runs_of:
        r = runs[key]
        first, resumed, ev = r["first"], r["resumed"], r["ev"]
        tr = resumed.trainer
        cfg = tr.cfg
        batches = lambda n: -(-n // cfg.data.batch_size)  # noqa: E731
        n_train, n_val = len(tr.train_ds), len(tr.val_ds)
        k1 = (batches(n_train) + 3 * batches(n_val) + batches(len(ev.window_scores))
              + batches(CLI_SERVED))
        want = dict(stse_fused=k1, stse_train_forward=0, stse_train_layer_backward=0,
                    stse_train_top_backward=0, stse_train_mono_backward=0)
        summary["predicted_launches"][key] = want
        check(launches[key] == want, f"paper {key}: launches {launches[key]}, predicted {want}")
        bf16 = key != "float32_copy"
        check(cfg.model.projector == "mlp" and cfg.data.n_joints == 17 and not tr._fused_compat
              and cfg.run.compute_dtype == ("bfloat16" if bf16 else "float32")
              and tr.model.dtype == (torch.bfloat16 if bf16 else torch.float32),
              f"{key}: not the paper's MLP model at 17 joints at its compute dtype")
        losses = first.loss + resumed.loss
        check(len(losses) == 3 and all(np.isfinite(losses)), f"{key}: losses {losses}")
        check(np.isfinite(ev.result.auc) and 0.0 <= ev.result.auc <= 1.0,
              f"{key}: cli.eval AUC {ev.result.auc}")
        served_diff = float(np.abs(r["served"] - ev.window_scores[:CLI_SERVED]).max())
        check(served_diff == 0.0, f"{key}: from_checkpoint's scores differ from cli.eval's: "
                                  f"max abs {served_diff:.3e}")
        rec = dict(dataset=cfg.data.dataset_choice, variant=cfg.model.variant,
                   compute_dtype=cfg.run.compute_dtype, batch=cfg.data.batch_size,
                   normalization=cfg.data.normalization_strategy, train_items=n_train,
                   val_items=n_val, losses_resumed=losses, auc=ev.result.auc,
                   validation_auc=first.validation_auc + resumed.validation_auc,
                   scoring_windows_per_s=len(ev.window_scores) / ev.wall_s["scoring"],
                   eval_wall_s=ev.wall_s, from_checkpoint_ms=r["load_ms"],
                   train_windows_per_s=[(n_train // cfg.data.batch_size) * cfg.data.batch_size
                                        / t for d, t in epoch_s if d == cfg.ckpt_dir][:3])
        if "straight" in r:
            straight = r["straight"]
            check(len(straight.loss) == 3 and resumed.loss[0] == straight.loss[2],
                  f"{key}: third-epoch loss resumed {resumed.loss[0]!r} vs straight "
                  f"{straight.loss}: not the same bits")
            want_p = flatten_tree(to_jax_variables(straight.trainer.model)[0])
            same = all(np.array_equal(v, want_p[k])
                       for k, v in flatten_tree(to_jax_variables(tr.model)[0]).items())
            check(same and torch.equal(resumed.state.center, straight.state.center),
                  f"{key}: resumed weights or center differ from the straight run's")
            rec["losses_straight"] = straight.loss
        # save / restore round trip into a fresh Trainer: the same bits
        path = os.path.join(root, f"{cfg.data.dataset_choice}_{cfg.model.variant}_rt.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(path, tr, resumed.state, cfg)
        rec["save_ms"] = (time.perf_counter() - t0) * 1e3
        fresh = Trainer(cfg, tr.val_ds, device=DEVICE)
        t0 = time.perf_counter()
        fstate, _, _ = checkpoint.restore(path, fresh)
        torch.cuda.synchronize()
        rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
        rec["checkpoint_bytes"] = os.path.getsize(path)
        s_before, _ = tr.score_all(resumed.state, tr.val_ds, tr.val_data)
        s_after, _ = fresh.score_all(fstate, tr.val_ds, fresh.train_data)
        check(np.array_equal(s_before, s_after), f"{key}: score_all after a save / restore "
                                                 "differs")
        x = tr._gather(tr.val_data, torch.arange(min(TRAIN_BATCH, len(tr.val_ds)), device=DEVICE))
        if bf16 and key == PAPER_FLOAT32:
            rec["eval_routes"] = eval_route_timing(tr, x)
        if not bf16:  # K1 at 204 nodes on the trained weights, and its bound
            folded, packed = tr.model.folded()
            rec["k1"] = k1_timing(x, folded, packed)
        summary["configs"][key] = rec
    # a hyperbolic center each epoch: 2 + 1 resumed, and 3 straight
    n_hyp = sum(3 * len(r) for k, r in runs_of.items()
                if "hyperbolic" in (PAPER_FLOAT32 if k == "float32_copy" else k))
    check(len(centers) == n_hyp and all(np.isfinite(c[0]) and c[0] < 1.0 for c in centers),
          f"hyperbolic centers (norm, distance from 0) by epoch: {centers}")
    summary["hyperbolic_centers"] = centers
    for key, c in summary["configs"].items():
        extra = ""
        if "k1" in c:
            extra = (f"; K1 {c['k1']['kernel_ms']:.3f} ms at {c['k1']['nodes']} nodes, B="
                     f"{c['k1']['batch']} (plain {c['k1']['plain_ms']:.3f}, bound "
                     f"{c['k1']['bound_ms']:.3f} ms, {c['k1']['bound_by']})")
        if "eval_routes" in c:
            e = c["eval_routes"]
            extra = (f"; eval of {e['batch']} windows: bf16 K1 route {e['k1_bf16_ms']:.3f} "
                     f"ms, bf16 module route {e['module_route_bf16_ms']:.3f} ms, float32 K1 "
                     f"route {e['k1_route_f32_ms']:.3f} ms")
        print(f"paper {key} ({c['compute_dtype']}, batch {c['batch']}, {c['normalization']}): "
              f"train windows/s by epoch {[round(v) for v in c['train_windows_per_s']]}; scoring "
              f"windows/s {c['scoring_windows_per_s']:.0f}; AUC {c['auc']:.4f}; losses "
              f"{c['losses_resumed']}" + (" = straight's to the bit" if "losses_straight" in c
                                          else "") + f"; checkpoint {c['checkpoint_bytes']} "
              f"bytes, save {c['save_ms']:.1f} ms, restore {c['restore_ms']:.1f} ms{extra}; on "
              f"{card}")
    summary["launches_total"] = {k: sum(v[k] for v in launches.values()) for k in counters}
    print(f"paper: launches {launches} (as predicted); hyperbolic center |c| by epoch "
          f"{[round(c[0], 6) for c in centers]}")
    return summary


VARIANT_CONFIGS = ("UBnormal/euclidean_autoencoder", "UBnormal/spherical_vae")
AE_REC_WEIGHTS = ("0", "50", "1000")  # cli.eval's three autoencoder modes
PS_SAMPLES = 65536
PS_KAPPAS = (2.0, 32.0)
# K1's reconstruction error against float64 over the module route's: the ratio
# of a 3xTF32 product's rounding (2^-21) to a plain float32 one's (2^-24)
RECON_VS_F64 = 8.0
# the module decoder's part of a float32 eval forward of 2048 windows, as measured
# before the decoder ran on K1
DECODER_MODULES_MS = 2.900


def phase_variants(card):
    """The decoder variants' shipped files, config/UBnormal/{euclidean_autoencoder,
    spherical_vae}.yaml, as written (bf16, the module path) and as float32
    copies (K1 as their eval encoder), through cli.train, --resume, cli.eval
    and from_checkpoint over the paper phase's trees, in a temporary
    directory removed afterwards; then K1's route against the module route,
    the eval forward's split, the step's peak memory and PowerSpherical's
    sampler on the card."""
    root = tempfile.mkdtemp(prefix="coskad_variants_")
    t0 = time.perf_counter()
    try:
        summary = variants_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"variants phase: {summary['phase_s']:.1f} s")
    return summary


@contextlib.contextmanager
def module_route(model):
    """Within the block the model's eval forward takes the module path on
    the card (K1's planner answers set to no, the decoder's too), as for a
    layout K1 refuses."""
    takes = model.kernel_takes()
    decoder_takes = model.decoder_kernel_takes() if hasattr(model, "decoder") else None
    model._kernel_takes = False
    if decoder_takes is not None:
        model._decoder_kernel_takes = False
    try:
        yield model
    finally:
        model._kernel_takes = takes
        if decoder_takes is not None:
            model._decoder_kernel_takes = decoder_takes


def eval_outputs(model, x):
    """The AE's (z, recon) or the VAE's (z_mean, z_var, recon) on its mean
    path, eval mode."""
    from coskad_tpu_torch.models import STSVAE

    if not isinstance(model, STSVAE):
        return model(x)
    _, recon, (mean, var) = model(x, sample=False)
    return mean, var, recon


def k1_against_module_route(tr, x) -> dict:
    """At one batch on the trained weights: K1's route (the encoder and the
    decoder, two launches) against the module route on the card, and the
    eval forward timed by part (K1 on the encoder, head, rev_btlnk, K1 on
    the decoder, and the module decoder it replaces) against the module
    route's. At float32 the latents and heads within K1's band and the
    reconstruction within RECON_VS_F64 of a float64 module route; at bf16
    (K1's bf16 form on both stacks) every output within the bf16 band of
    the module route's, which rounds at the same points. Both report the
    share of the reconstruction's values that are the module route's bits
    and its error against the float64 module route over the module
    route's."""
    import copy

    import torch
    from coskad_tpu_torch.kernels import stse_fused

    model, variant = tr.model, tr.cfg.model.variant
    vae = variant == "vae"
    bf16 = tr.cfg.run.compute_dtype == "bfloat16"
    check(model.kernel_takes() and model.decoder_kernel_takes(),
          f"{variant}: K1 does not take both stacks of the {tr.cfg.run.compute_dtype} model")
    m64 = copy.deepcopy(model).double()
    m64.apply(lambda m: setattr(m, "dtype", torch.float64) if hasattr(m, "dtype") else None)
    with torch.inference_mode():
        before = stse_fused.launches.value, stse_fused.decoder_launches.value
        got = eval_outputs(model, x)
        after = stse_fused.launches.value, stse_fused.decoder_launches.value
        check(after == (before[0] + 2, before[1] + 1), "the K1 route launched K1 "
              f"{after[0] - before[0]} times, on the decoder {after[1] - before[1]}, for one "
              "batch (2 and 1 expected)")
        with module_route(model):
            want = eval_outputs(model, x)
        with module_route(m64):
            exact = eval_outputs(m64, x.double())
        check((stse_fused.launches.value, stse_fused.decoder_launches.value) == after,
              "the module route launched K1")
    torch.cuda.synchronize()
    names = ("z_mean", "z_var", "recon") if vae else ("z", "recon")
    errs = {}
    for name, g, w, e in zip(names, got, want, exact):
        outside = (g - w).abs() > TOL["atol"] + TOL["rtol"] * w.abs()
        err = errs[name] = dict(
            max_abs=float((g - w).abs().max()), k1_vs_f64=float((g - e).abs().max()),
            module_vs_f64=float((w - e).abs().max()), scale=float(e.abs().max()),
            outside_elementwise=int(outside.sum()), elements=g.numel(),
            same_bits=float((g == w).double().mean()))
        err["k1_over_module_vs_f64"] = err["k1_vs_f64"] / max(err["module_vs_f64"], 1e-30)
        if bf16:  # the bf16 band of tests/test_torch_bf16.py against the module route
            limit = 2.0 ** -5 * max(float(w.abs().max()), 1.0)
            ok, band = err["max_abs"] <= limit, f"|K1 - modules| <= {limit:.3e}"
        # The latents and heads: K1's band element by element. The
        # reconstruction passes the decoder's layers, now on K1 too, which
        # carry K1's 3xTF32 rounding (~2^-21 a product, plain fp32's 2^-24) to
        # a few near-zero elements just past that band; it is held as the CPU
        # tests hold live-BN outputs: its error against float64 at most
        # RECON_VS_F64 (2^-21 / 2^-24) times the module route's, plus 1e-6
        # of its scale
        elif name == "recon":
            bound = RECON_VS_F64 * err["module_vs_f64"] + 1e-6 * err["scale"]
            ok, band = err["k1_vs_f64"] <= bound, f"K1 vs float64 <= {bound:.3e}"
        else:
            ok, band = err["outside_elementwise"] == 0, f"rtol {TOL['rtol']} atol {TOL['atol']}"
        check(ok and bool(torch.isfinite(g).all()),
              f"{variant}: K1 route vs module route, {name}: {err}, outside {band}")

    folded, packed = model.folded()
    d_folded, d_packed = model.decoder_folded()
    with torch.inference_mode():
        h = stse_fused.fused_stse_hidden(x, folded, packed)

        def head():  # the projector, and the VAE's mean and concentration heads
            feat = model._project(h, False)
            return (model.fc_mean(feat), model.fc_var(feat)) if vae else feat

        z = got[0]
        hd, hc = model.rev_btlnk(z), model.rev_btlnk.channel_major(z)
        parts = dict(k1=lambda: stse_fused.fused_stse_hidden(x, folded, packed), head=head,
                     rev_btlnk=lambda: model.rev_btlnk.channel_major(z),
                     k1_decoder=lambda: stse_fused.fused_stse_hidden(hc, d_folded, d_packed),
                     decoder_modules=lambda: model.decoder(hd))
        forward = lambda: eval_outputs(model, x)  # noqa: E731
        runs = {}
        for _ in range(2):  # in turns
            for name, fn in parts.items():
                runs.setdefault(name, []).append(cuda_ms(fn, iters=10, warmup=2))
            runs.setdefault("k1_route", []).append(cuda_ms(forward, iters=10, warmup=2))
            with module_route(model):
                runs.setdefault("module_route", []).append(cuda_ms(forward, iters=10, warmup=2))
    return dict(batch=x.shape[0], errors=errs, tolerance=TOL,
                ms={k: min(v) for k, v in runs.items()}, runs_ms=runs)


def step_peak_bytes(tr, state) -> int:
    """Device bytes one train step allocates above what is resident before
    it (the model, the optimizer, the data), after a warm-up step."""
    import torch

    idx = torch.arange(tr.batch_size, device=DEVICE)
    tr.model.train()
    try:
        state, _ = tr.train_step(state, tr.train_data, idx)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(state, tr.train_data, idx)
        torch.cuda.synchronize()
    finally:
        tr.model.eval()
    return torch.cuda.max_memory_allocated() - resident


def power_spherical_on_card() -> dict:
    """PowerSpherical.rsample with a CUDA generator at D = 16: samples on the
    sphere, the mean of loc . x within 4 standard errors of (alpha - beta) /
    (alpha + beta), and one seed's bits twice."""
    import torch
    from coskad_tpu_torch.geometry.sphere import PowerSpherical

    out = {}
    d = 16
    loc = torch.randn(d, generator=torch.Generator().manual_seed(3))
    loc = (loc / loc.norm()).to(DEVICE).expand(PS_SAMPLES, d)
    for kappa in PS_KAPPAS:
        dist = PowerSpherical(loc, torch.full((PS_SAMPLES,), kappa, device=DEVICE))
        draw = lambda: dist.rsample(torch.Generator(device=DEVICE).manual_seed(11))  # noqa: E731
        x, again = draw(), draw()
        norm_err = float((x.norm(dim=-1) - 1).abs().max())
        t = (loc * x).sum(-1).double()
        beta = (d - 1) / 2.0
        want = kappa / (2 * beta + kappa)
        mean, se = float(t.mean()), float(t.std()) / PS_SAMPLES ** 0.5
        same = torch_equal(x, again)
        check(x.is_cuda and norm_err < 1e-5 and abs(mean - want) < 4 * se and same,
              f"PowerSpherical on the card, kappa {kappa}: | |x| - 1 | {norm_err:.2e}, mean "
              f"{mean:.5f} vs {want:.5f} (se {se:.2e}), same bits {same}")
        out[str(kappa)] = dict(norm_err=norm_err, mean=mean, want=want, se=se, same_bits=same)
    return out


def variants_run(card, root):
    import torch
    from coskad_tpu_torch.cli import eval as eval_cli
    from coskad_tpu_torch.cli import train as train_cli
    from coskad_tpu_torch.cli.common import load_config, load_split
    from coskad_tpu_torch.interop import flatten_tree, to_jax_variables
    from coskad_tpu_torch.kernels import stse_fused
    from coskad_tpu_torch.serve import AnomalyScorer
    from coskad_tpu_torch.train.loop import Trainer

    trees = write_paper_trees(root, np.random.default_rng(6), VARIANTS_TRAIN_CLIPS)
    runs_of = {key: ("resumed", "straight") for key in VARIANT_CONFIGS}
    runs_of.update({f"{key}.float32": ("resumed",) for key in VARIANT_CONFIGS})
    configs = {key: {run: paper_config(key.split(".")[0], trees,
                                       os.path.join(root, "runs", key.replace("/", "_"), run),
                                       float32=key.endswith(".float32"))[0]
                     for run in runs}
               for key, runs in runs_of.items()}
    epoch_s = []
    inner_epoch = Trainer.train_epoch

    def timed_epoch(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_epoch(self, *args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append((self.cfg.ckpt_dir, time.perf_counter() - t))
        return out

    dev = ["--device", DEVICE]
    counters = dict(launch_counters(), stse_fused_decoder=stse_fused.decoder_launches)
    runs, launches = {}, {}
    Trainer.train_epoch = timed_epoch
    try:
        for key in runs_of:
            # --- one file through the command line, counted ---
            zero(counters)
            path = configs[key]["resumed"]
            first = train_cli.main(["--config", path, "--epochs", "2", *dev])
            resumed = train_cli.main(["--config", path, "--epochs", "3", "--resume", *dev])
            best = os.path.join(load_config(path).ckpt_dir, "best.ckpt")
            weights = AE_REC_WEIGHTS if "autoencoder" in key else ("0",)
            evals = {w: eval_cli.main(["--config", path, "--ckpt", best, "--rec-weight", w, *dev])
                     for w in weights}
            scorer = AnomalyScorer.from_checkpoint(best, device=DEVICE)
            windows = load_split(scorer.cfg, "test", stride=1, scaler=scorer.scaler).data
            served = scorer.score_windows(windows[:CLI_SERVED])
            launches[key] = read(counters)
            # --- end of the counted run ---
            runs[key] = dict(first=first, resumed=resumed, evals=evals, served=served)
            if "straight" in configs[key]:
                runs[key]["straight"] = train_cli.main(
                    ["--config", configs[key]["straight"], "--epochs", "3", *dev])
    finally:
        Trainer.train_epoch = inner_epoch

    summary = dict(card=card, launches=launches, predicted_launches={}, configs={})
    for key in runs_of:
        r = runs[key]
        first, resumed, evals = r["first"], r["resumed"], r["evals"]
        tr = resumed.trainer
        cfg = tr.cfg
        f32 = key.endswith(".float32")
        batches = lambda n: -(-n // cfg.data.batch_size)  # noqa: E731
        n_train, n_val = len(tr.train_ds), len(tr.val_ds)
        n_test = len(evals["0"].window_scores)
        # K1 a batch on the encoder and one on the decoder: center init, 3
        # validations, each cli.eval and from_checkpoint (the bf16 files on its
        # bf16 form)
        k1 = (batches(n_train) + 3 * batches(n_val) + len(evals) * batches(n_test)
              + batches(CLI_SERVED))
        want = dict(stse_fused=2 * k1, stse_train_forward=0, stse_train_layer_backward=0,
                    stse_train_top_backward=0, stse_train_mono_backward=0,
                    stse_fused_decoder=k1)
        summary["predicted_launches"][key] = want
        check(launches[key] == want, f"variants {key}: launches {launches[key]}, predicted "
                                     f"{want}")
        variant = "autoencoder" if "autoencoder" in key else "vae"
        check(cfg.model.variant == variant and cfg.model.projector == "mlp"
              and cfg.data.n_joints == 17 and cfg.data.batch_size == TRAIN_BATCH
              and not tr._fused_compat and tr.model.kernel_takes()
              and tr.model.decoder_kernel_takes()
              and cfg.run.compute_dtype == ("float32" if f32 else "bfloat16"),
              f"{key}: not the shipped {variant} at 17 joints, batch 2048, its compute dtype")
        losses = first.loss + resumed.loss
        check(len(losses) == 3 and all(np.isfinite(losses)), f"{key}: losses {losses}")
        aucs = {w: ev.result.auc for w, ev in evals.items()}
        check(all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs.values()),
              f"{key}: cli.eval AUC {aucs}")
        served_diff = float(np.abs(r["served"] - evals["0"].window_scores[:CLI_SERVED]).max())
        check(served_diff == 0.0, f"{key}: from_checkpoint's scores differ from cli.eval's: "
                                  f"max abs {served_diff:.3e}")
        if variant == "vae":
            check(float(resumed.state.mean_vector.norm()) > 0, f"{key}: no anchor")
        rec = dict(variant=variant, compute_dtype=cfg.run.compute_dtype, train_items=n_train,
                   val_items=n_val, test_items=n_test, losses_resumed=losses, auc=aucs,
                   validation_auc=first.validation_auc + resumed.validation_auc,
                   scoring_windows_per_s={w: n_test / ev.wall_s["scoring"]
                                          for w, ev in evals.items()},
                   eval_wall_s={w: ev.wall_s for w, ev in evals.items()},
                   train_windows_per_s=[(n_train // cfg.data.batch_size) * cfg.data.batch_size
                                        / t for d, t in epoch_s if d == cfg.ckpt_dir][:3])
        if "straight" in r:
            straight = r["straight"]
            check(len(straight.loss) == 3 and resumed.loss[0] == straight.loss[2],
                  f"{key}: third-epoch loss resumed {resumed.loss[0]!r} vs straight "
                  f"{straight.loss}: not the same bits")
            want_p = flatten_tree(to_jax_variables(straight.trainer.model)[0])
            same = all(np.array_equal(v, want_p[k])
                       for k, v in flatten_tree(to_jax_variables(tr.model)[0]).items())
            check(same and torch.equal(resumed.state.center, straight.state.center)
                  and torch.equal(resumed.state.mean_vector, straight.state.mean_vector),
                  f"{key}: resumed weights, center or anchor differ from the straight run's")
            rec["losses_straight"] = straight.loss
        x = tr._gather(tr.val_data, torch.arange(cfg.data.batch_size, device=DEVICE))
        # after the counted runs: these launches are not the main path's
        rec["k1_route"] = k1_against_module_route(tr, x)
        if f32:
            rec["k1"] = k1_timing(x, *tr.model.folded())
            with torch.inference_mode():
                hc = tr.model.rev_btlnk.channel_major(eval_outputs(tr.model, x)[0])
            rec["k1_decoder"] = dict(k1_timing(hc, *tr.model.decoder_folded()),
                                     modules_ms_before=DECODER_MODULES_MS)
        rec["step_peak_bytes"] = step_peak_bytes(tr, resumed.state)
        summary["configs"][key] = rec
    summary["power_spherical"] = power_spherical_on_card()
    summary["launches_total"] = {k: sum(v[k] for v in launches.values()) for k in counters}
    for key, c in summary["configs"].items():
        extra = ""
        if "k1_route" in c:
            e = c["k1_route"]
            extra = (f"; K1 route vs module route {e['errors']}; eval of "
                     f"{e['batch']} windows (ms): " + ", ".join(
                         f"{k} {v:.3f}" for k, v in e["ms"].items()))
        if "k1_decoder" in c:
            d = c["k1_decoder"]
            extra += (f"; K1 on the decoder alone {d['kernel_ms']:.3f} ms a {d['batch']} "
                      f"batch (its plain version {d['plain_ms']:.3f}, bound {d['bound_ms']:.3f}"
                      f" by {d['bound_by']}; the module decoder {DECODER_MODULES_MS} ms before it "
                      "ran on K1)")
        print(f"variants {key} ({c['compute_dtype']}): train windows/s by epoch "
              f"{[round(v) for v in c['train_windows_per_s']]}; scoring windows/s "
              f"{ {w: round(v) for w, v in c['scoring_windows_per_s'].items()} }; AUC "
              f"{c['auc']}; losses {c['losses_resumed']}"
              + (" = straight's to the bit" if "losses_straight" in c else "")
              + f"; step peak above resident {c['step_peak_bytes']} B{extra}; on {card}")
    print(f"variants: launches {launches} (as predicted); PowerSpherical on the card "
          + json.dumps(summary["power_spherical"]) + f"; on {card}")
    return summary


# config/HR-STC/euclidean_encoder.yaml with only the paths (and the dtype, and
# these keys) replaced: (label, float32, changes)
ENCODER_FILE = "HR-STC/euclidean_encoder"
ENCODER_VARIANTS = (
    ("st_gcn", True, dict(encoder_type="st_gcn")),
    ("learnable_gcn", True, dict(encoder_type="learnable_gcn")),
    ("static_gcn", True, dict(encoder_type="static_gcn")),
    ("cnn", True, dict(encoder_type="cnn")),
    ("sts_gcn.dropout", True, dict(dropout=0.1)),
    ("st_gcn.bfloat16", False, dict(encoder_type="st_gcn")),
)
ENCODER_EPOCHS = 2
DROPOUT_SAMPLES = 1 << 22  # elements of the mask check on the card
CPU_CHECK_WINDOWS = 256  # eval latents on the card against the CPU's


def phase_encoders(card):
    """The other encoders and train-mode dropout: float32 copies of
    config/HR-STC/euclidean_encoder.yaml with each encoder_type, and the
    sts_gcn file with dropout 0.1, plus the file as written (bf16) with
    st_gcn, through cli.train and cli.eval over the paper phase's
    17-keypoint tree, in a temporary directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="coskad_encoders_")
    t0 = time.perf_counter()
    try:
        summary = encoders_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"encoders phase: {summary['phase_s']:.1f} s")
    return summary


def latent_on_cpu(tr, x) -> dict:
    """The trained model's eval latent on the card against the same weights
    on the CPU (the module path), rtol 2e-4, atol 2e-5."""
    import torch
    from coskad_tpu_torch.models import build_model
    from coskad_tpu_torch.train.loop import model_kwargs_from_config

    cpu = build_model(**model_kwargs_from_config(tr.cfg)).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in tr.model.state_dict().items()})
    with torch.inference_mode():
        z = tr.model(x).cpu()
        want = cpu(x.cpu())
    err = float((z - want).abs().max())
    check(bool(torch.isfinite(z).all()) and within(z, want, **TOL),
          f"{tr.cfg.model.encoder_type}: eval latent on the card vs the CPU, max abs {err:.3e}")
    return dict(windows=x.shape[0], max_abs_err=err)


def k1_route_vs_module(tr, x) -> dict:
    """The dropout copy's eval on the card: K1's route (one launch) against
    the module route on the same weights, rtol 2e-4, atol 2e-5 element by
    element, and each route's time."""
    import torch
    from coskad_tpu_torch.kernels import stse_fused

    model = tr.model
    check(model.kernel_takes(), "K1 does not take the dropout copy")
    with torch.inference_mode():
        before = stse_fused.launches.value
        got = model(x)
        check(stse_fused.launches.value == before + 1, "the K1 route launched K1 "
              f"{stse_fused.launches.value - before} times for one batch")
        with module_route(model):
            want = model(x)
        check(stse_fused.launches.value == before + 1, "the module route launched K1")
        err = float((got - want).abs().max())
        check(within(got, want, **TOL), f"dropout copy: K1 route vs module route max abs "
                                        f"{err:.3e}")
        runs = {}
        for _ in range(2):  # in turns
            runs.setdefault("k1_route", []).append(cuda_ms(lambda: model(x), iters=10, warmup=2))
            with module_route(model):
                runs.setdefault("module_route", []).append(
                    cuda_ms(lambda: model(x), iters=10, warmup=2))
    return dict(batch=x.shape[0], max_abs_err=err, ms={k: min(v) for k, v in runs.items()},
                runs_ms=runs)


TCONV_REL_TOL = 2e-5  # of the float64 output's scale: float32 sums; TF32 errs ~1e-3


def temporal_conv_on_card(batch: int = 256) -> dict:
    """st_gcn's 9x1 temporal convolution (models/encoders.py::TemporalConv)
    at the file's widest layer, 64 -> 64 channels over 12 frames x 17 joints,
    on the card at PyTorch's default flags: values and gradients of `batch`
    windows against float64 on the CPU, each error over the float64 value's
    largest magnitude within TCONV_REL_TOL; cuDNN's conv2d on the same inputs
    at the default flags (TF32) for comparison, reported only. At B=2048 the
    forward and the forward + backward (every gradient), CUDA events, of the
    module, of cuDNN's conv2d at the default flags and of cuDNN's conv2d with
    TF32 off for the timing alone (the flag restored after it): timed only,
    never called by the port."""
    import copy

    import torch
    import torch.nn.functional as F
    from coskad_tpu_torch.models.encoders import TemporalConv

    gen = torch.Generator().manual_seed(17)
    conv = TemporalConv(64, 64)
    conv.reset_parameters(gen)
    with torch.no_grad():
        conv.bias.uniform_(-0.5, 0.5, generator=gen)
    h = torch.randn(TRAIN_BATCH, 12, 17, 64, generator=gen)
    r = torch.randn(batch, 12, 17, 64, generator=gen)

    def cudnn(x):
        return F.conv2d(x.permute(0, 3, 1, 2), card.kernel.permute(3, 2, 0, 1), card.bias,
                        padding=(4, 0)).permute(0, 2, 3, 1)

    def run(fn, params, x, rr):
        x = x.clone().requires_grad_(True)
        out = fn(x)
        grads = torch.autograd.grad((out * rr).sum(), [x, *params])
        return [t.detach() for t in (out, *grads)]

    card = copy.deepcopy(conv).to(DEVICE)
    params = [card.kernel, card.bias]
    f64 = copy.deepcopy(conv).double()
    want = run(f64, [f64.kernel, f64.bias], h[:batch].double(), r.double())
    got = run(card, params, h[:batch].to(DEVICE), r.to(DEVICE))
    names = ("out", "d_input", "d_kernel", "d_bias")
    rel = {n: float((g.cpu().double() - w).abs().max() / w.abs().max())
           for n, g, w in zip(names, got, want)}
    check(all(np.isfinite(v) and v <= TCONV_REL_TOL for v in rel.values()),
          f"TemporalConv on the card vs float64: relative errors {rel} (limit {TCONV_REL_TOL})")
    with torch.no_grad():
        lib = cudnn(h[:batch].to(DEVICE)).cpu().double()
    x = h.to(DEVICE)
    rr = torch.randn(x.shape, generator=gen).to(DEVICE)
    tf32_default = torch.backends.cudnn.allow_tf32
    ms = {}
    for name, fn in (("module", card), ("cudnn_default", cudnn), ("cudnn_fp32", cudnn)):
        torch.backends.cudnn.allow_tf32 = tf32_default and name != "cudnn_fp32"
        try:
            with torch.no_grad():
                fwd = cuda_ms(lambda: fn(x), iters=10, warmup=2)
            ms[name] = dict(forward=fwd, forward_backward=cuda_ms(
                lambda: run(fn, params, x, rr), iters=10, warmup=2))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32_default
    return dict(batch=batch, rel_err=rel, tol=TCONV_REL_TOL, cudnn_allow_tf32=tf32_default,
                cudnn_rel_err=float((lib - want[0]).abs().max() / want[0].abs().max()),
                ms_at_2048=ms)


def dropout_on_card() -> dict:
    """models/stsgcn.py::dropout on a CUDA tensor with a CUDA generator, at
    rates 0.1 and 0.5: the kept share within 4 standard deviations of
    1 - rate, each kept value exactly x / (1 - rate), one seed's mask twice."""
    import torch
    from coskad_tpu_torch.models.stsgcn import dropout

    x = torch.randn(DROPOUT_SAMPLES, generator=torch.Generator().manual_seed(12)).to(DEVICE)
    out = {}
    for rate in (0.1, 0.5):
        def draw():
            return dropout(x, rate, True, torch.Generator(device=DEVICE).manual_seed(13))

        y, again = draw(), draw()
        keep = y != 0
        kept, n = int(keep.sum()), x.numel()
        keep_prob = 1.0 - rate
        sigma = (n * keep_prob * rate) ** 0.5
        exact = torch_equal(y[keep], x[keep] / np.float32(keep_prob))
        check(y.is_cuda and abs(kept - n * keep_prob) <= 4 * sigma and exact
              and torch_equal(y, again),
              f"dropout on the card, rate {rate}: kept {kept} of {n} (mean {n * keep_prob:.0f}, "
              f"sigma {sigma:.0f}), kept values exact {exact}")
        out[str(rate)] = dict(kept=kept, n=n, sigmas_off=(kept - n * keep_prob) / sigma)
    return out


def encoders_run(card, root):
    import dataclasses

    import torch
    from coskad_tpu_torch.cli import eval as eval_cli
    from coskad_tpu_torch.cli import train as train_cli
    from coskad_tpu_torch.cli.common import load_config
    from coskad_tpu_torch.models import build_model
    from coskad_tpu_torch.train.loop import Trainer, model_kwargs_from_config

    trees = write_paper_trees(root, np.random.default_rng(8))
    configs = {key: paper_config(ENCODER_FILE, trees, os.path.join(root, "runs", key),
                                 float32=f32, changes=changes)[0]
               for key, f32, changes in ENCODER_VARIANTS}
    epoch_s = []
    inner_epoch = Trainer.train_epoch

    def timed_epoch(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_epoch(self, *args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append((self.cfg.ckpt_dir, time.perf_counter() - t))
        return out

    dev = ["--device", DEVICE]
    counters = dict(launch_counters(), stse_fused_decoder=stse_fused.decoder_launches)
    runs, launches = {}, {}
    Trainer.train_epoch = timed_epoch
    try:
        for key, path in configs.items():
            # --- one variant through the command line, counted ---
            zero(counters)
            trained = train_cli.main(["--config", path, "--epochs", str(ENCODER_EPOCHS), *dev])
            best = os.path.join(load_config(path).ckpt_dir, "best.ckpt")
            ev = eval_cli.main(["--config", path, "--ckpt", best, *dev])
            launches[key] = read(counters)
            # --- end of the counted run ---
            runs[key] = dict(trained=trained, ev=ev)
    finally:
        Trainer.train_epoch = inner_epoch

    summary = dict(card=card, launches=launches, predicted_launches={}, configs={})
    for key, f32, changes in ENCODER_VARIANTS:
        trained, ev = runs[key]["trained"], runs[key]["ev"]
        tr = trained.trainer
        cfg = tr.cfg
        batches = lambda n: -(-n // cfg.data.batch_size)  # noqa: E731
        n_train, n_val, n_test = len(tr.train_ds), len(tr.val_ds), len(ev.window_scores)
        sts = cfg.model.encoder_type == "sts_gcn"
        # K1: the dropout copy's center init, each validation and cli.eval; the
        # other encoders have no kernel (nor in JAX); no variant trains on K2-K5
        k1 = batches(n_train) + ENCODER_EPOCHS * batches(n_val) + batches(n_test) if sts else 0
        want = dict(stse_fused=k1, stse_train_forward=0, stse_train_layer_backward=0,
                    stse_train_top_backward=0, stse_train_mono_backward=0)
        summary["predicted_launches"][key] = want
        check(launches[key] == want, f"encoders {key}: launches {launches[key]}, predicted {want}")
        check(cfg.model.encoder_type == changes.get("encoder_type", "sts_gcn")
              and cfg.model.dropout == changes.get("dropout", 0.0)
              and cfg.model.projector == "mlp" and cfg.data.n_joints == 17
              and cfg.data.batch_size == TRAIN_BATCH and not tr._fused_compat
              and tr.model.kernel_takes() == sts
              and cfg.run.compute_dtype == ("float32" if f32 else "bfloat16"),
              f"{key}: not the HR-STC euclidean file at 17 joints with its encoder and dtype")
        check(len(trained.loss) == ENCODER_EPOCHS and all(np.isfinite(trained.loss)),
              f"{key}: losses {trained.loss}")
        check(np.isfinite(ev.result.auc) and 0.0 <= ev.result.auc <= 1.0,
              f"{key}: cli.eval AUC {ev.result.auc}")
        x = tr._gather(tr.val_data, torch.arange(TRAIN_BATCH, device=DEVICE))
        rec = dict(encoder_type=cfg.model.encoder_type, dropout=cfg.model.dropout,
                   compute_dtype=cfg.run.compute_dtype, train_items=n_train, val_items=n_val,
                   test_items=n_test, losses=trained.loss, auc=ev.result.auc,
                   validation_auc=trained.validation_auc,
                   scoring_windows_per_s=n_test / ev.wall_s["scoring"], eval_wall_s=ev.wall_s,
                   train_windows_per_s=[(n_train // cfg.data.batch_size) * cfg.data.batch_size
                                        / t for d, t in epoch_s if d == cfg.ckpt_dir],
                   card_vs_cpu=latent_on_cpu(tr, x[:CPU_CHECK_WINDOWS]))
        if sts:  # after the counted runs: these launches are not the path's
            rec["k1_route"] = k1_route_vs_module(tr, x)
        if not f32:  # the other encoders stay float32 at bf16: the float32 model's bits
            f32_model = build_model(**model_kwargs_from_config(dataclasses.replace(
                cfg, run=dataclasses.replace(cfg.run, compute_dtype="float32"))))
            f32_model = f32_model.to(DEVICE).eval()
            f32_model.load_state_dict(tr.model.state_dict())
            with torch.inference_mode():
                same = torch_equal(tr.model(x), f32_model(x))
            check(tr.model.dtype == torch.bfloat16 and same,
                  f"{key}: the bf16 config's st_gcn model is not the float32 model's bits")
            rec["bf16_equals_float32"] = same
        rec["step_peak_bytes"] = step_peak_bytes(tr, trained.state)
        summary["configs"][key] = rec
    summary["dropout"] = dropout_on_card()
    summary["temporal_conv"] = temporal_conv_on_card()
    summary["launches_total"] = {k: sum(v[k] for v in launches.values()) for k in counters}
    for key, c in summary["configs"].items():
        extra = ""
        if "k1_route" in c:
            e = c["k1_route"]
            extra = (f"; K1 route vs module route max abs {e['max_abs_err']:.3e}, eval of "
                     f"{e['batch']} windows K1 route {e['ms']['k1_route']:.3f} ms, module route "
                     f"{e['ms']['module_route']:.3f} ms")
        print(f"encoders {key} ({c['compute_dtype']}): train windows/s by epoch "
              f"{[round(v) for v in c['train_windows_per_s']]}; scoring windows/s "
              f"{c['scoring_windows_per_s']:.0f}; AUC {c['auc']:.4f}; losses {c['losses']}; "
              f"step peak above resident {c['step_peak_bytes']} B; card vs CPU latent max abs "
              f"{c['card_vs_cpu']['max_abs_err']:.3e}; K1 launches "
              f"{launches[key]['stse_fused']}{extra}; on {card}")
    print(f"encoders: launches {launches} (as predicted); dropout on the card "
          + json.dumps(summary["dropout"]) + f"; on {card}")
    print("encoders: st_gcn's temporal conv on the card vs float64 "
          + json.dumps(summary["temporal_conv"]) + f"; on {card}")
    return summary


STREAM_FRAMES, STREAM_ACTORS = 2400, 3
STREAM_MIN_BATCH = 256
STREAM_HORIZON = 512  # frames: past the emission lag of 256-window batches over 3 actors
STREAM_FRAMES_A_REQUEST = 64
CLIP_TURNS = (True, False, True, False)  # the clip requests: COSKAD_NATIVE on, off, on, off


def phase_streaming(card):
    """The streaming scorer and the HTTP server over a float32 flagship
    checkpoint (cli.train, one epoch over the cli phase's tree), in a
    temporary directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="coskad_streaming_")
    t0 = time.perf_counter()
    try:
        summary = streaming_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"streaming phase: {summary['phase_s']:.1f} s")
    return summary


def clip_frames(path):
    """{frame key: {person: [V, 3]}} of a clip JSON, the frames a camera's
    tracker hands over one at a time."""
    with open(path) as f:
        clip = json.load(f)
    by_frame = {}
    for pid, traj in clip.items():
        for fk, entry in traj.items():
            by_frame.setdefault(int(fk), {})[int(pid)] = np.asarray(
                entry["keypoints"], np.float64).reshape(-1, 3)
    return dict(sorted(by_frame.items()))


def http_json(url, method="GET", body=None, ctype="application/json"):
    import urllib.request

    data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.status == 200, f"{method} {url}: HTTP {resp.status}")
        return json.loads(resp.read())


def streaming_run(card, root):
    import io
    import threading

    import torch
    from coskad_tpu_torch.cli import train as train_cli
    from coskad_tpu_torch import serve
    from coskad_tpu_torch.cli.common import load_config
    from coskad_tpu_torch.data import native
    from coskad_tpu_torch.data.alphapose import parse_clip_json
    from coskad_tpu_torch.data.windows import segment_clip
    from coskad_tpu_torch.http_server import ScoringService, build_server
    from coskad_tpu_torch.serve import AnomalyScorer
    from coskad_tpu_torch.streaming import StreamingScorer

    # the clip request is timed with the native parser on and off
    check(native.native_available(), "the native clip parser did not build on this machine")
    configs = write_cli_tree(root, np.random.default_rng(9))
    train_cli.main(["--config", configs["resumed"], "--epochs", "1", "--device", DEVICE])
    ckpt = os.path.join(load_config(configs["resumed"]).ckpt_dir, "best.ckpt")
    clip = os.path.join(root, "stream_clip.json")
    write_clip_json(clip, np.random.default_rng(10), STREAM_FRAMES, n_actors=STREAM_ACTORS,
                    anomalous=(1200, 1400))
    frames = clip_frames(clip)
    counters = launch_counters()

    drains = []  # (stream, windows scored, seconds) of every drain, the server's too
    inner_drain = StreamingScorer._drain

    def timed_drain(self):  # preprocessing and scoring of the buffered windows
        n = len(self._pending_raw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        inner_drain(self)
        torch.cuda.synchronize()
        drains.append((self, n, time.perf_counter() - t))

    def stream(horizon=None):
        s = StreamingScorer(scorer, min_batch=STREAM_MIN_BATCH, horizon=horizon)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for fk, poses in frames.items():
            s.push(fk, poses)
        out = s.flush()
        torch.cuda.synchronize()
        return s, out, time.perf_counter() - t

    # --- the serving path, counted ---
    inner_parse = serve.parse_clip_json
    zero(counters)
    StreamingScorer._drain = timed_drain
    try:
        scorer = AnomalyScorer.from_checkpoint(ckpt, device=DEVICE)
        cfg = scorer.cfg
        check(cfg.model.encoder_type == "sts_gcn" and cfg.model.projector == "linear"
              and cfg.data.n_joints == 18 and cfg.run.compute_dtype == "float32"
              and cfg.eval.pad_size == -1 and scorer.trainer.model.kernel_takes(),
              "the streaming model is not the float32 flagship at 18 joints on K1")
        offline = scorer.score_clip_json(clip)
        unbounded, online, stream_s = stream()
        rolled, rolled_out, rolled_s = stream(STREAM_HORIZON)

        service = ScoringService(scorer=scorer, source=ckpt)
        # the clip request by part: the service's spool + parse + scoring,
        # score_clip_json's parse + scoring, and the parse alone
        parts = []
        inner_score_clip, inner_clip_json = service.score_clip, scorer.score_clip_json

        def part(name, fn):
            def timed(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                parts[-1][name] = (time.perf_counter() - t) * 1e3
                return out
            return timed

        service.score_clip = part("service", inner_score_clip)
        scorer.score_clip_json = part("score_clip_json", inner_clip_json)
        serve.parse_clip_json = part("parse", inner_parse)
        server = build_server(service, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            windows = np.random.default_rng(11).normal(
                size=(TRAIN_BATCH, 3, cfg.data.seg_len, cfg.data.n_joints)).astype(np.float32)
            buf = io.BytesIO()
            np.save(buf, windows)
            windows_ms, clip_ms = [], []
            for _ in range(3):  # the first request also starts the handler thread's libraries
                t = time.perf_counter()
                by_http = http_json(url + "/v1/score/windows", "POST", buf.getvalue(),
                                    "application/x-npy")["scores"]
                windows_ms.append((time.perf_counter() - t) * 1e3)
            with open(clip, "rb") as f:
                body = f.read()
            for native_on in CLIP_TURNS:  # COSKAD_NATIVE on and off, in turns
                os.environ["COSKAD_NATIVE"] = "1" if native_on else "0"
                parts.append(dict(native=native_on))
                t = time.perf_counter()
                clip_http = http_json(url + "/v1/score/clip", "POST", body)["scores"]
                clip_ms.append((time.perf_counter() - t) * 1e3)
                parts[-1]["request"] = clip_ms[-1]
                check(np.array_equal(clip_http, offline),
                      f"clip request (COSKAD_NATIVE {int(native_on)}): not the library's bits")
            os.environ.pop("COSKAD_NATIVE", None)
            sid = http_json(url + "/v1/streams", "POST",
                            {"min_batch": STREAM_MIN_BATCH})["stream_id"]
            keys = list(frames)
            latency_ms = []
            t0 = time.perf_counter()
            for i in range(0, len(keys), STREAM_FRAMES_A_REQUEST):
                chunk = [{"frame": fk,
                          "poses": {str(p): kp.tolist() for p, kp in frames[fk].items()}}
                         for fk in keys[i:i + STREAM_FRAMES_A_REQUEST]]
                t = time.perf_counter()
                resp = http_json(url + f"/v1/streams/{sid}/frames", "POST", {"frames": chunk})
                latency_ms.append((time.perf_counter() - t) * 1e3)
                check(resp["applied"] == len(chunk), f"stream request {i}: {resp}")
            t = time.perf_counter()
            session = http_json(url + f"/v1/streams/{sid}/flush", "POST")["scores"]
            latency_ms.append((time.perf_counter() - t) * 1e3)
            session_s = time.perf_counter() - t0
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        torch.cuda.synchronize()
        launches = read(counters)
    finally:
        StreamingScorer._drain = inner_drain
        serve.parse_clip_json = inner_parse
        os.environ.pop("COSKAD_NATIVE", None)
    # --- end of the counted run ---
    check(not thread.is_alive(), "the server thread did not stop")

    # K1: one launch a batch of the config's size (Trainer._chunked_indices) in
    # each scoring call: the offline clip and the clip requests, the 3
    # window requests, every drain that had windows (the two streams', the
    # session's); each stream scores each of the clip's windows once
    d = cfg.data
    n_clip = len(segment_clip(parse_clip_json(clip, d.kp_threshold), 0, 0, d.start_offset, 1,
                              d.seg_len)[1])
    batches = lambda n: -(-n // d.batch_size)  # noqa: E731
    sizes = {}
    for owner, n, _ in drains:
        label = ("unbounded" if owner is unbounded else "horizon" if owner is rolled
                 else "session")
        sizes.setdefault(label, []).append(n)
    k1 = ((1 + len(CLIP_TURNS)) * batches(n_clip) + 3 * batches(TRAIN_BATCH)
          + sum(batches(n) for v in sizes.values() for n in v if n))
    want = dict(stse_fused=k1, stse_train_forward=0, stse_train_layer_backward=0,
                stse_train_top_backward=0, stse_train_mono_backward=0)
    check(launches == want, f"streaming: launches {launches}, predicted {want} (the clip's "
                            f"{n_clip} windows; drains {sizes})")
    check(len(sizes) == 3 and all(sum(v) == n_clip for v in sizes.values()),
          f"streaming: the three streams' drains scored {[sum(v) for v in sizes.values()]} "
          f"windows, the clip has {n_clip}")
    drain_s = [s for owner, _, s in drains if owner is unbounded]

    def diff(a, b):
        a, b = np.asarray(a), np.asarray(b)
        check(a.shape == b.shape, f"shapes {a.shape} and {b.shape}")
        return float(np.abs(a - b).max())

    def close(a, b):
        return bool(np.allclose(np.asarray(a), np.asarray(b), **SCORE_TOL))

    errs = dict(flush_vs_offline=diff(online, offline),
                rolled_vs_unbounded=diff(rolled_out, online),
                http_windows_vs_library=diff(by_http, scorer.score_windows(windows)),
                http_clip_vs_library=diff(clip_http, offline),
                http_stream_vs_library=diff(session, online))
    check(online.shape == offline.shape and np.isfinite(online).all() and close(online, offline),
          f"stream flush vs score_clip_json on the card: max abs {errs['flush_vs_offline']:.3e}")
    check(rolled._frozen_upto > STREAM_FRAMES // 2 and close(rolled_out, online),
          f"rolling GC (horizon {STREAM_HORIZON}) vs the unbounded stream: max abs "
          f"{errs['rolled_vs_unbounded']:.3e}, frozen up to {rolled._frozen_upto}")
    check(errs["http_windows_vs_library"] == 0.0 and errs["http_clip_vs_library"] == 0.0,
          f"the server's scores differ from the library's: {errs}")
    check(close(session, online), f"the server's stream vs the library's: {errs}")
    n_windows = unbounded.n_windows_scored
    lat = np.asarray(latency_ms)
    clip_split = []  # the request by part (ms): spool, parse, scoring and the rest
    for p in parts:
        check(set(p) == {"native", "request", "service", "score_clip_json", "parse"},
              f"a clip request's parts were not all timed: {p}")
        clip_split.append(dict(native=p["native"], request_ms=p["request"],
                               spool_ms=p["service"] - p["score_clip_json"],
                               parse_ms=p["parse"],
                               scoring_ms=p["score_clip_json"] - p["parse"],
                               http_and_json_ms=p["request"] - p["service"]))
    summary = dict(
        card=card, frames=len(frames), actors=STREAM_ACTORS, windows=n_windows,
        min_batch=STREAM_MIN_BATCH, horizon=STREAM_HORIZON, errors=errs,
        flush_exact=errs["flush_vs_offline"] == 0.0,
        rolled_exact=errs["rolled_vs_unbounded"] == 0.0,
        stream_frames_per_s=len(frames) / stream_s, rolled_frames_per_s=len(frames) / rolled_s,
        stream_s=stream_s, drains=len(drain_s), drain_s=sum(drain_s),
        http_windows_ms=windows_ms, http_clip_ms=clip_ms, http_clip_split=clip_split,
        http_stream_frames_per_s=len(frames) / session_s,
        http_request_ms_p50=float(np.percentile(lat, 50)),
        http_request_ms_p99=float(np.percentile(lat, 99)), http_requests=len(lat),
        launches=launches, predicted_launches=want, clip_windows=n_clip, drain_windows=sizes)
    print(f"streaming: {len(frames)} frames x {STREAM_ACTORS} actors, {n_windows} windows at "
          f"min_batch {STREAM_MIN_BATCH}: {summary['stream_frames_per_s']:.0f} frames/s "
          f"({len(drain_s)} drains {sum(drain_s):.3f} s of {stream_s:.3f} s; horizon "
          f"{STREAM_HORIZON}: {summary['rolled_frames_per_s']:.0f}); flush vs "
          f"score_clip_json max abs {errs['flush_vs_offline']:.3e} (exact "
          f"{summary['flush_exact']}), rolled vs unbounded {errs['rolled_vs_unbounded']:.3e}; "
          f"server: {TRAIN_BATCH} windows {[round(v, 1) for v in windows_ms]} ms, a clip "
          f"{[round(v, 1) for v in clip_ms]} ms, a stream of {STREAM_FRAMES_A_REQUEST} frames "
          f"a request {summary['http_stream_frames_per_s']:.0f} frames/s, request p50 "
          f"{summary['http_request_ms_p50']:.2f} ms p99 {summary['http_request_ms_p99']:.2f} ms; "
          f"errors {errs}; launches {launches} (as predicted; drains of "
          f"{ {k: len(v) for k, v in sizes.items()} }, the clip {n_clip} windows); on {card}")
    print("streaming clip request by part (ms; COSKAD_NATIVE on / off in turns): "
          + json.dumps([{k: round(v, 2) if isinstance(v, float) else v for k, v in p.items()}
                        for p in clip_split]))
    return summary


ARTIFACT_WINDOWS = 40000
ARTIFACT_TOL = dict(rtol=5e-6, atol=1e-6)  # artifact vs library: tests/test_export_hlo.py's band
ARTIFACT_TIMED = 10  # 2048-window chunks timed a side, in turns
MOVED_WINDOWS = 512  # scored by the artifact moved to the CPU (K1's plain version)


def phase_export(card):
    """The scoring artifact (export_hlo) on the card, in a temporary
    directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="coskad_export_")
    t0 = time.perf_counter()
    try:
        summary = export_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"export phase: {summary['phase_s']:.1f} s")
    return summary


def export_run(card, root):
    import io
    import threading

    import torch
    from coskad_tpu_torch.cli import train as train_cli
    from coskad_tpu_torch.cli.common import load_config
    from coskad_tpu_torch.data.windows import SegmentDataset
    from coskad_tpu_torch.export_hlo import export_scorer, load_artifact
    from coskad_tpu_torch.http_server import ScoringService, build_server
    from coskad_tpu_torch.serve import AnomalyScorer
    from coskad_tpu_torch.train.loop import Trainer

    marks = [("start", time.perf_counter())]

    def mark(name):  # the phase's wall by step
        marks.append((name, time.perf_counter()))

    configs = write_cli_tree(root, np.random.default_rng(9))
    train_cli.main(["--config", configs["resumed"], "--epochs", "1", "--device", DEVICE])
    ckpt = os.path.join(load_config(configs["resumed"]).ckpt_dir, "best.ckpt")
    mark("checkpoint")
    scorer = AnomalyScorer.from_checkpoint(ckpt, device=DEVICE)
    cfg = scorer.cfg
    check(cfg.run.compute_dtype == "float32" and scorer.trainer.model.kernel_takes(),
          "the export phase's model is not the float32 flagship on K1")
    art_path = os.path.join(root, "flagship.zip")
    torch.cuda.synchronize()
    t = time.perf_counter()
    meta = export_scorer(scorer, art_path)
    export_s = time.perf_counter() - t
    check(meta["encoder_route"] == "K1" and meta["device"] == "cuda",
          f"the flagship artifact's encoder route is {meta['encoder_route']}, not K1")
    t = time.perf_counter()
    art = load_artifact(art_path, device=DEVICE)
    load_s = time.perf_counter() - t
    shape = (3, cfg.data.seg_len, cfg.data.n_joints)
    windows = np.random.default_rng(12).normal(size=(ARTIFACT_WINDOWS, *shape)).astype(np.float32)
    chunks = -(-ARTIFACT_WINDOWS // cfg.data.batch_size)
    counters = launch_counters()

    # --- the artifact's scoring path, counted ---
    zero(counters)
    got = art.score_windows(windows)
    torch.cuda.synchronize()
    launches = read(counters)
    # --- end of the counted run ---
    want = dict(stse_fused=chunks, stse_train_forward=0, stse_train_layer_backward=0,
                stse_train_top_backward=0, stse_train_mono_backward=0)
    check(launches == want, f"export: launches {launches}, predicted {want} ({chunks} chunks "
                            f"of {cfg.data.batch_size})")
    library = scorer.score_windows(windows)
    err = float(np.abs(got - library).max())
    check(got.shape == library.shape and np.isfinite(got).all()
          and np.allclose(got, library, **ARTIFACT_TOL),
          f"the artifact's scores vs the library's: max abs {err:.3e}")
    check(np.array_equal(got, art.score_windows(windows)), "the artifact's scores repeat "
                                                            "with other bits")

    chunk = windows[:TRAIN_BATCH]
    for _ in range(2):  # warm both paths
        art.score_windows(chunk)
        scorer.score_windows(chunk)
    art_ms, lib_ms = [], []
    for _ in range(ARTIFACT_TIMED):
        for fn, out in ((art.score_windows, art_ms), (scorer.score_windows, lib_ms)):
            t = time.perf_counter()
            fn(chunk)
            out.append((time.perf_counter() - t) * 1e3)
    mark("flagship")

    # the float32 copy of the spherical VAE: a sampled artifact of two programs
    trees = (os.path.join(root, "pose"), os.path.join(root, "csv"))
    vae_cfg = load_config(paper_config("UBnormal/spherical_vae", trees,
                                       os.path.join(root, "vae"), float32=True)[0])
    rng = np.random.default_rng(13)
    c = vae_cfg.model.num_coords + 1
    vae_shape = (c, vae_cfg.data.seg_len, vae_cfg.data.n_joints)
    train_ds = SegmentDataset(
        data=rng.normal(size=(64, *vae_shape)).astype(np.float32),
        meta=np.zeros((64, 4), np.int64), frame_ids=np.zeros((64, vae_shape[1]), np.int32),
        num_transform=vae_cfg.data.num_transform)
    tr = Trainer(vae_cfg, train_ds, device=DEVICE)
    anchor = rng.normal(size=vae_cfg.model.latent_dim)
    state = tr.init_state().replace(step=3, mean_vector=torch.as_tensor(
        anchor / np.linalg.norm(anchor), dtype=torch.float32, device=tr.device))
    vae_scorer = AnomalyScorer(vae_cfg, state, trainer=tr)
    check(vae_cfg.model.variant == "vae" and tr.model.kernel_takes(),
          "the float32 spherical VAE does not take K1")
    vae_path = os.path.join(root, "vae.zip")
    vae_meta = export_scorer(vae_scorer, vae_path)
    check(vae_meta["vae_sample"] and vae_meta["encoder_route"] == "K1",
          f"the VAE artifact: sampled {vae_meta['vae_sample']}, route {vae_meta['encoder_route']}")
    vae_art = load_artifact(vae_path, device=DEVICE)
    vae_windows = rng.normal(size=(2 * vae_cfg.data.batch_size + 100, *vae_shape)).astype(
        np.float32)
    vae_got = vae_art.score_windows(vae_windows)
    vae_want = vae_scorer.score_windows(vae_windows)
    vae_err = float(np.abs(vae_got - vae_want).max())
    check(np.isfinite(vae_got).all() and np.allclose(vae_got, vae_want, **ARTIFACT_TOL),
          f"the sampled VAE artifact vs the library: max abs {vae_err:.3e}")
    check(np.array_equal(vae_got, vae_art.score_windows(vae_windows)),
          "the VAE artifact's scores repeat with other bits")
    mark("vae")

    # an artifact written on the CPU (module route) scoring on the card, and
    # the card's moved to the CPU (K1's op on its plain version)
    cpu_path = os.path.join(root, "cpu.zip")
    cpu_meta = export_scorer(AnomalyScorer.from_checkpoint(ckpt, device="cpu"), cpu_path)
    check(cpu_meta["encoder_route"] == "modules" and cpu_meta["device"] == "cpu",
          f"the CPU artifact: {cpu_meta['encoder_route']} on {cpu_meta['device']}")
    cross = windows[:2 * TRAIN_BATCH]
    zero(counters)
    cpu_on_card = load_artifact(cpu_path, device=DEVICE).score_windows(cross)
    moved = load_artifact(art_path, device="cpu")
    on_cpu = moved.score_windows(windows[:MOVED_WINDOWS])
    cross_launches = read(counters)
    cross_errs = dict(cpu_artifact_on_card=float(np.abs(cpu_on_card - library[:len(cross)]).max()),
                      card_artifact_on_cpu=float(np.abs(on_cpu - got[:MOVED_WINDOWS]).max()))
    check(cross_launches["stse_fused"] == 0, f"K1 launched {cross_launches} by the module-route "
                                             "artifact on the card or the moved one on the CPU")
    check(np.allclose(cpu_on_card, library[:len(cross)], **SCORE_TOL)
          and np.allclose(on_cpu, got[:MOVED_WINDOWS], **SCORE_TOL),
          f"artifacts across devices vs the card's library: {cross_errs}")
    mark("cross_device")

    # one request through the artifact backend
    service = ScoringService(artifact=art, source=art_path)
    server = build_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.save(buf, chunk)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        info = http_json(url + "/v1/model")
        by_http = np.float32(http_json(url + "/v1/score/windows", "POST", buf.getvalue(),
                                       "application/x-npy")["scores"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "the server thread did not stop")
    check(info["backend"] == "artifact" and np.array_equal(by_http, art.score_windows(chunk)),
          "the artifact backend's /v1/score/windows differs from the artifact's bits")
    mark("http")
    step_s = {name: t - prev for (_, prev), (name, t) in zip(marks, marks[1:])}

    summary = dict(
        card=card, windows=ARTIFACT_WINDOWS, chunks=chunks, launches=launches,
        predicted_launches=want, encoder_route=meta["encoder_route"],
        max_abs_err=err, repeat_exact=True, artifact_bytes=os.path.getsize(art_path),
        export_s=export_s, load_s=load_s, artifact_chunk_ms=art_ms, library_chunk_ms=lib_ms,
        artifact_chunk_ms_median=float(np.median(art_ms)),
        library_chunk_ms_median=float(np.median(lib_ms)),
        vae=dict(route=vae_meta["encoder_route"], windows=len(vae_windows), max_abs_err=vae_err,
                 bytes=os.path.getsize(vae_path)),
        cross_device=dict(cross_errs, launches=cross_launches, cpu_windows=MOVED_WINDOWS),
        http_exact=True, step_s=step_s)
    print(f"export: flagship artifact ({meta['encoder_route']}, {summary['artifact_bytes']} B, "
          f"export {export_s:.2f} s, load {load_s:.2f} s): {ARTIFACT_WINDOWS} windows in "
          f"{chunks} chunks, launches {launches}, max abs vs library {err:.3e}, repeat exact; "
          f"a {TRAIN_BATCH}-window chunk {summary['artifact_chunk_ms_median']:.3f} ms artifact "
          f"vs {summary['library_chunk_ms_median']:.3f} ms library (host clock, median of "
          f"{ARTIFACT_TIMED} in turns); sampled VAE ({vae_meta['encoder_route']}) max abs "
          f"{vae_err:.3e} over {len(vae_windows)} windows; across devices {cross_errs}; "
          f"/v1/score/windows = the artifact's bits; steps s "
          f"{ {k: round(v, 2) for k, v in step_s.items()} }; on {card}")
    return summary


# The parallel phase: a two-rank group on the one card, over gloo on CUDA tensors
# (NCCL refuses two ranks on one GPU), started with torch.multiprocessing spawn
PARALLEL_RANKS = 2
# (case, epochs): the flagship fused fit on the slice phase's windows (1,024 a rank
# of each 2,048 batch) and a float32 copy of HR-STC's MLP-head file on the module path
PARALLEL_CASES = (("flagship_fused", 2), ("hr_stc_mlp_float32", 1))
PARALLEL_MLP_CONFIG = "HR-STC/euclidean_encoder"
PARALLEL_MLP_CLIPS = 20  # x 2 actors x 200 windows at 17 joints: 8,000 windows
# both cases train with SGD, as the CPU tests of the ranks do: Adam divides the gradient
# by its own scale, so a gradient off by a factor of the world size would pass; and on
# the module path Adam turns the rounding noise of the pre-BN biases' zero gradient into
# +-lr steps that move the scores past their band between any two summation orders
PARALLEL_SGD_LR = 1e-3
PARALLEL_TURNS = 2  # the world-1 overhead: epochs a side, in turns
PARALLEL_TIMEOUT_S = 600


def parallel_case(name):
    """(config, train dataset) of a parallel-phase case, the same in every
    process."""
    import dataclasses

    from coskad_tpu_torch.config import from_reference_yaml
    from coskad_tpu_torch.data.windows import SegmentDataset

    epochs = dict(PARALLEL_CASES)[name]
    if name == "flagship_fused":
        data, meta, fids, _ = synthetic_windows(np.random.default_rng(1), TRAIN_CLIPS, 2, 200,
                                                12, 18)
        cfg = train_config("on")
    else:
        data, meta, fids, _ = synthetic_windows(np.random.default_rng(2), PARALLEL_MLP_CLIPS, 2,
                                                200, 12, 17)
        cfg = from_reference_yaml(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                               "config", f"{PARALLEL_MLP_CONFIG}.yaml"))
        cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, compute_dtype="float32"))
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, validation=False,
                                                           epochs=epochs))
    return cfg, SegmentDataset(data, meta, fids, num_transform=5)


def parallel_fit(name, counters) -> dict:
    """A case's fit and score_all in this process (a rank of the group, or
    one process), counted: per-step and epoch losses, center, scores, the
    model's state, launches and seconds."""
    import torch
    from coskad_tpu_torch.train.loop import Trainer

    cfg, ds = parallel_case(name)
    log = QuietLogger()
    tr = Trainer(cfg, ds, device=DEVICE, logger=log)
    tr.optimizer = torch.optim.SGD(tr.model.parameters(), lr=PARALLEL_SGD_LR)
    torch.cuda.synchronize()
    # --- the parallel path, counted ---
    zero(counters)
    t0 = time.perf_counter()
    state, hist = tr.fit(epochs=cfg.opt.epochs)
    scores, _ = tr.score_all(state, ds, tr.train_data)
    torch.cuda.synchronize()
    launches = read(counters)
    # --- end of the counted run ---
    return dict(step_losses=np.asarray(log.losses), epoch_losses=np.asarray(hist["loss"]),
                center=state.center.cpu().numpy(), scores=scores, fit_s=time.perf_counter() - t0,
                launches=launches, world=tr.layout.world, steps=int(state.step),
                model={k: v.cpu().numpy() for k, v in tr.model.state_dict().items()})


def parallel_rank(rank, world, port, out_dir):
    """One rank of the parallel phase's group: joins it over gloo on the card
    and runs every case, writing its results to out_dir."""
    import pickle

    from coskad_tpu_torch.parallel import mesh

    mesh.initialize_distributed(f"localhost:{port}", world, rank, backend="gloo", device=DEVICE)
    counters = launch_counters()
    for name, _ in PARALLEL_CASES:
        out = parallel_fit(name, counters)
        with open(os.path.join(out_dir, f"{name}.rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    mesh.barrier()
    mesh.destroy()


def max_rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def parallel_nccl_world1(root, counters) -> dict:
    """cli.train then cli.eval on the cli phase's tree, with --distributed
    at world 1 over NCCL and without: the same checkpoint bits and AUC."""
    from coskad_tpu_torch.cli import eval as eval_cli
    from coskad_tpu_torch.cli import train as train_cli
    from coskad_tpu_torch.cli.common import load_config
    from coskad_tpu_torch.interop import flatten_tree
    from coskad_tpu_torch.parallel import mesh
    from coskad_tpu_torch.train import checkpoint
    from coskad_tpu_torch.utils.net import free_port

    configs = write_cli_tree(root, np.random.default_rng(3))
    dev = ["--device", DEVICE]
    zero(counters)
    runs = {}
    for side, config in (("plain", configs["straight"]), ("nccl_world1", configs["resumed"])):
        def group():
            return ["--distributed", f"localhost:{free_port('localhost')},1,0"] if (
                side == "nccl_world1") else []

        train = train_cli.main(["--config", config, "--epochs", "2", *dev, *group()])
        check(side == "plain" or train.trainer.layout == mesh.Layout(
            world=1, rank=0, local_device=0, backend="nccl"),
              f"cli.train --distributed ran at {train.trainer.layout}")
        ev = eval_cli.main(["--config", config, *dev, *group()])
        check(mesh.layout() == mesh.Layout(), "the CLIs left their process group")
        runs[side] = (load_config(config).ckpt_dir, train, ev)
    launches = read(counters)
    same = {}
    for name in ("last.ckpt", "best.ckpt"):
        a, b = (flatten_tree(checkpoint.read_payload(os.path.join(runs[s][0], name))["state"])
                for s in ("plain", "nccl_world1"))
        same[name] = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    auc = {s: runs[s][2].result.auc for s in runs}
    same["auc"] = auc["plain"] == auc["nccl_world1"]
    same["window_scores"] = bool(np.array_equal(runs["plain"][2].window_scores,
                                                runs["nccl_world1"][2].window_scores))
    same["losses"] = runs["plain"][1].loss == runs["nccl_world1"][1].loss
    check(all(same.values()), f"cli.train/cli.eval at NCCL world 1 differ from the run without "
                              f"--distributed: {same}")
    return dict(same_bits=same, auc=auc, launches=launches)


def parallel_overhead(counters) -> dict:
    """The flagship fit's train windows/s without a process group and in an
    NCCL group of one rank, one epoch a side, in turns (no group, group,
    group, no group, ...): at world 1 the Trainer runs no collective."""
    import torch
    from coskad_tpu_torch.parallel import mesh
    from coskad_tpu_torch.train.loop import Trainer
    from coskad_tpu_torch.utils.net import free_port

    cfg, ds = parallel_case("flagship_fused")
    trainers, states, wps = {}, {}, {"no_group": [], "nccl_world1": []}
    zero(counters)
    order = ["no_group", "nccl_world1"]
    for turn in range(PARALLEL_TURNS):
        for side in order if turn % 2 == 0 else order[::-1]:
            if side == "nccl_world1":
                mesh.initialize_distributed(f"localhost:{free_port('localhost')}", 1, 0,
                                            device=DEVICE)
            try:
                if side not in trainers:
                    trainers[side] = Trainer(cfg, ds, device=DEVICE, logger=QuietLogger())
                    states[side] = trainers[side].initialize_center(trainers[side].init_state())
                tr = trainers[side]
                steps = len(ds) // cfg.data.batch_size
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[side], _ = tr.fit(states[side], epochs=1)
                torch.cuda.synchronize()
                wps[side].append(steps * cfg.data.batch_size / (time.perf_counter() - t0))
            finally:
                if side == "nccl_world1":
                    mesh.barrier()
                    mesh.destroy()
    launches = read(counters)
    best = {k: max(v) for k, v in wps.items()}
    return dict(train_windows_per_s=wps, best=best,
                group_over_no_group=best["nccl_world1"] / best["no_group"], launches=launches)


def phase_parallel(card):
    """Data parallelism on the card: (a) a two-rank gloo group on the one
    card against one process, (b) the CLIs at NCCL world 1 against the CLIs
    without a group, (c) the flagship fit's speed with and without a group
    of one, in a temporary directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="coskad_parallel_")
    t0 = time.perf_counter()
    try:
        summary = parallel_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"parallel phase: {summary['phase_s']:.1f} s")
    return summary


def parallel_run(card, root):
    import pickle

    import torch.multiprocessing as mp
    from coskad_tpu_torch.utils.net import free_port

    counters = launch_counters()
    os.makedirs(os.path.join(root, "ranks"))
    t0 = time.perf_counter()
    group = mp.start_processes(parallel_rank, args=(PARALLEL_RANKS, free_port("localhost"),
                                                    os.path.join(root, "ranks")),
                               nprocs=PARALLEL_RANKS, join=False, start_method="spawn")
    # while the ranks run: the one-process references (not counted), then (b)
    one = {name: parallel_fit(name, counters) for name, _ in PARALLEL_CASES}
    nccl = parallel_nccl_world1(os.path.join(root, "cli"), counters)
    while not group.join(timeout=PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)):
        check(time.perf_counter() - t0 < PARALLEL_TIMEOUT_S, "the parallel group timed out")
    group_s = time.perf_counter() - t0
    cases, launches = {}, dict(nccl["launches"])
    for name, _ in PARALLEL_CASES:
        ranks = []
        for rank in range(PARALLEL_RANKS):
            with open(os.path.join(root, "ranks", f"{name}.rank{rank}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        want, got = one[name], ranks[0]
        check(want["world"] == 1 and all(r["world"] == PARALLEL_RANKS for r in ranks),
              f"{name}: worlds {want['world']} / {[r['world'] for r in ranks]}")
        check(got["steps"] == want["steps"] and len(got["step_losses"]) == want["steps"],
              f"{name}: {got['steps']} steps on the group, {want['steps']} in one process")
        finite = all(np.isfinite(r[k]).all() for r in ranks for k in
                     ("step_losses", "center", "scores"))
        check(finite, f"{name}: non-finite losses, center or scores on a rank")
        err = dict(step_losses=max_rel(got["step_losses"], want["step_losses"]),
                   center=max_rel(got["center"], want["center"]),
                   scores=float(np.max(np.abs(got["scores"] - want["scores"])
                                       - SCORE_TOL["rtol"] * np.abs(want["scores"]))))
        check(np.allclose(got["step_losses"], want["step_losses"], rtol=LOSS_RTOL, atol=0.0),
              f"{name}: two-rank losses vs one process, max rel {err['step_losses']:.3e}")
        check(np.allclose(got["center"], want["center"], rtol=LOSS_RTOL, atol=1e-6),
              f"{name}: two-rank center vs one process, max rel {err['center']:.3e}")
        check(np.allclose(got["scores"], want["scores"], **SCORE_TOL),
              f"{name}: two-rank scores vs one process past rtol 1e-3 / atol 1e-6")
        same = all(np.array_equal(r["model"][k], got["model"][k]) and
                   np.array_equal(r[x], got[x])
                   for r in ranks[1:] for k in got["model"] for x in ("center", "scores"))
        check(same, f"{name}: the ranks' weights, BN statistics, center or scores differ")
        if name == "flagship_fused":
            for r, rec in enumerate(ranks):
                check(all(rec["launches"][k] > 0 for k in (
                    "stse_fused", "stse_train_forward", "stse_train_layer_backward",
                    "stse_train_top_backward")), f"rank {r} launches {rec['launches']}: K1-K4 "
                                                  "must each run on every rank")
        else:
            check(all(rec["launches"]["stse_fused"] > 0 for rec in ranks),
                  f"{name}: K1 did not run on every rank")
        for rec in ranks:
            launches = add_launches(launches, rec["launches"])
        cases[name] = dict(errors=err, ranks_same_bits=same,
                           launches_by_rank=[r["launches"] for r in ranks],
                           fit_s_by_rank=[r["fit_s"] for r in ranks], one_process_fit_s=want["fit_s"],
                           steps=want["steps"], epoch_losses=got["epoch_losses"].tolist())
    overhead = parallel_overhead(counters)
    launches = add_launches(launches, overhead["launches"])
    summary = dict(ranks=PARALLEL_RANKS, backend="gloo on CUDA tensors", cases=cases,
                   group_s=group_s, nccl_world1=nccl, overhead=overhead, launches=launches,
                   card=card)
    print(f"parallel: {PARALLEL_RANKS} ranks on one card over gloo (CUDA tensors; the ranks "
          "share the card, so no scaling figure): " + "; ".join(
              f"{n} {c['steps']} steps, max rel err losses {c['errors']['step_losses']:.2e} "
              f"center {c['errors']['center']:.2e}, scores past rtol 1e-3 by "
              f"{c['errors']['scores']:.2e} (atol 1e-6), ranks same bits {c['ranks_same_bits']}, "
              f"launches by rank {c['launches_by_rank']}, fit s by rank "
              f"{[round(t, 2) for t in c['fit_s_by_rank']]} vs one process "
              f"{c['one_process_fit_s']:.2f}" for n, c in cases.items())
          + f"; NCCL world 1 cli.train/cli.eval same bits {nccl['same_bits']} (AUC "
          f"{nccl['auc']['nccl_world1']:.6f}); world-1 overhead: train windows/s by turn "
          f"{ {k: [round(v) for v in w] for k, w in overhead['train_windows_per_s'].items()} }, "
          f"group / no group {overhead['group_over_no_group']:.4f}; launches {launches}; "
          f"on {card}")
    return summary


# The model_parallel phase: a 2 x 2 (data, model) mesh of four gloo ranks on the one
# card, run.model_parallel 2, started as the parallel phase starts its group
MP_RANKS, MP_MODEL = 4, 2
# (case, epochs): the flagship (linear projector, fused_train 'auto', which takes the
# module path under a model axis) on the slice phase's windows, and a float32 copy of
# UBnormal's autoencoder file (the MLP head and rev_btlnk split)
MP_CASES = (("flagship_auto", 1), ("ubnormal_ae_float32", 1))
MP_AE_CONFIG = "UBnormal/euclidean_autoencoder"
MP_AE_CLIPS = 8  # x 2 actors x 200 windows at 17 joints: 3,200 windows, 7 steps an epoch
# a restored checkpoint's latents: the mesh's no further from a float64 evaluation of the
# same weights than MP_F64_RATIO x the one process's, plus MP_F64_ATOL (the mesh sums the
# projector's 13,824-term product in two halves, and cuBLAS sums each shape in its own
# order, so a fixed band on the difference would be set by the shapes, not the port)
MP_F64_RATIO, MP_F64_ATOL = 2.0, 1e-7
# JAX's test holds its 4 x 2 mesh's latents to one device's within MP_LATENT_TOL
# (tests/test_cli_e2e.py:376-402); on the card one process's own latents are further
# than that from float64, so how far each side lies past it is recorded, not checked
MP_LATENT_TOL = dict(rtol=2e-5, atol=1e-6)
MP_EMBED_WINDOWS = 4096  # windows the restored checkpoint embeds on both sides
MP_TIMEOUT_S = 600


def mp_case(name, model_parallel):
    """(config, train dataset) of a model_parallel-phase case, at
    `model_parallel` model ranks; the one-process side (1) takes the module
    path that 'auto' takes on the mesh."""
    import dataclasses

    from coskad_tpu_torch.config import from_reference_yaml
    from coskad_tpu_torch.data.windows import SegmentDataset

    epochs = dict(MP_CASES)[name]
    if name == "flagship_auto":
        data, meta, fids, _ = synthetic_windows(np.random.default_rng(1), TRAIN_CLIPS, 2, 200,
                                                12, 18)
        cfg = train_config("auto" if model_parallel > 1 else "off")
    else:
        data, meta, fids, _ = synthetic_windows(np.random.default_rng(2), MP_AE_CLIPS, 2, 200,
                                                12, 17)
        cfg = from_reference_yaml(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                               "config", f"{MP_AE_CONFIG}.yaml"))
        cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, compute_dtype="float32",
                                                               freeze_bn_after=-1))
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, validation=False,
                                                           epochs=epochs, lr_schedule=""),
                              run=dataclasses.replace(cfg.run, model_parallel=model_parallel))
    return cfg, SegmentDataset(data, meta, fids, num_transform=5)


def mp_embed_set(ds):
    from coskad_tpu_torch.data.windows import SegmentDataset

    n = MP_EMBED_WINDOWS
    return SegmentDataset(ds.data[:n], ds.meta[:n], ds.frame_ids[:n], num_transform=1)


def mp_fit(name, counters, model_parallel, ckpt=None) -> dict:
    """A case's fit and score_all in this process (a rank of the mesh, or
    one process), counted; then, uncounted, the whole model (gathered on a
    mesh), a checkpoint to `ckpt` (rank 0 writes) and latents of
    MP_EMBED_WINDOWS windows."""
    import torch
    from coskad_tpu_torch.interop import flatten_tree, to_jax_variables
    from coskad_tpu_torch.train import checkpoint
    from coskad_tpu_torch.train.loop import Trainer

    cfg, ds = mp_case(name, model_parallel)
    log = QuietLogger()
    tr = Trainer(cfg, ds, device=DEVICE, logger=log)
    tr.optimizer = torch.optim.SGD(tr.model.parameters(), lr=PARALLEL_SGD_LR)
    torch.cuda.synchronize()
    # --- the model-parallel path, counted ---
    zero(counters)
    t0 = time.perf_counter()
    state, hist = tr.fit(epochs=cfg.opt.epochs)
    scores, rec = tr.score_all(state, ds, tr.train_data)
    torch.cuda.synchronize()
    launches = read(counters)
    # --- end of the counted run ---
    fit_s = time.perf_counter() - t0
    params, stats = to_jax_variables(tr.model)
    out = dict(step_losses=np.asarray(log.losses), epoch_losses=np.asarray(hist["loss"]),
               center=state.center.cpu().numpy(), scores=scores, rec=rec, fit_s=fit_s,
               launches=launches, layout=(tr.layout.data_world, tr.layout.model_world,
                                          tr.layout.data_rank, tr.layout.model_rank),
               steps=int(state.step),
               local={k: v.cpu().numpy() for k, v in tr.model.state_dict().items()},
               whole={**flatten_tree(params), **flatten_tree(stats)})
    if ckpt is not None:  # Adam's state is what a checkpoint carries: a fresh one here
        tr.optimizer = torch.optim.Adam(tr.model.parameters(), lr=cfg.opt.lr)
        checkpoint.save(ckpt, tr, state, cfg)
        small = mp_embed_set(ds)
        out["z"] = tr.embed_all(state, small, tr._device_data(small))
    return out


def mp_rank(rank, world, port, out_dir):
    """One rank of the model_parallel phase's mesh: joins the group over gloo
    on the card and runs every case, writing its results to out_dir."""
    import pickle

    from coskad_tpu_torch.parallel import mesh

    mesh.initialize_distributed(f"localhost:{port}", world, rank, backend="gloo", device=DEVICE)
    counters = launch_counters()
    for name, _ in MP_CASES:
        out = mp_fit(name, counters, MP_MODEL, ckpt=os.path.join(out_dir, f"{name}.ckpt"))
        with open(os.path.join(out_dir, f"{name}.rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    mesh.barrier()
    mesh.destroy()


def mp_restored(name, ckpt):
    """The mesh's checkpoint restored in one process: (its model's state as
    flax-named numpy arrays, its latents, the same model's latents in
    float64 on the module path)."""
    import copy

    import torch
    from coskad_tpu_torch.interop import flatten_tree, to_jax_variables
    from coskad_tpu_torch.train import checkpoint
    from coskad_tpu_torch.train.loop import Trainer

    cfg, ds = mp_case(name, 1)
    tr = Trainer(cfg, ds, device=DEVICE, logger=QuietLogger())
    state, _, _ = checkpoint.restore(ckpt, tr)
    params, stats = to_jax_variables(tr.model)
    small = mp_embed_set(ds)
    data = tr._device_data(small)
    z = tr.embed_all(state, small, data)
    model64 = copy.deepcopy(tr.model).double()
    with torch.no_grad():
        z64 = torch.cat([model64.encode(tr._gather(data, idx).double())[0]
                         for idx in torch.arange(len(small), device=DEVICE).split(2048)])
    return {**flatten_tree(params), **flatten_tree(stats)}, z, z64.cpu().numpy()


def phase_model_parallel(card):
    """Model parallelism on the card: a 2 x 2 mesh of four gloo ranks on the
    one card against one process, in a temporary directory removed
    afterwards."""
    root = tempfile.mkdtemp(prefix="coskad_model_parallel_")
    t0 = time.perf_counter()
    try:
        summary = mp_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"model_parallel phase: {summary['phase_s']:.1f} s")
    return summary


def mp_run(card, root):
    import pickle

    import torch.multiprocessing as mp
    from coskad_tpu_torch.parallel import mesh
    from coskad_tpu_torch.utils.net import free_port

    counters = launch_counters()
    t0 = time.perf_counter()
    group = mp.start_processes(mp_rank, args=(MP_RANKS, free_port("localhost"), root),
                               nprocs=MP_RANKS, join=False, start_method="spawn")
    try:
        # while the ranks run: the one-process references (not counted)
        one = {name: mp_fit(name, counters, 1) for name, _ in MP_CASES}
        one_s = time.perf_counter() - t0
        while not group.join(timeout=MP_TIMEOUT_S - (time.perf_counter() - t0)):
            check(time.perf_counter() - t0 < MP_TIMEOUT_S, "the model_parallel mesh timed out")
    finally:  # a failed check or a dead rank leaves no rank running
        for proc in group.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    group_s = time.perf_counter() - t0
    cases, launches = {}, {k: 0 for k in counters}
    for name, _ in MP_CASES:
        ranks = []
        for rank in range(MP_RANKS):
            with open(os.path.join(root, f"{name}.rank{rank}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        want, got = one[name], ranks[0]
        check([r["layout"] for r in ranks] == [(MP_RANKS // MP_MODEL, MP_MODEL, r // MP_MODEL,
                                                r % MP_MODEL) for r in range(MP_RANKS)],
              f"{name}: mesh layouts {[r['layout'] for r in ranks]}")
        check(got["steps"] == want["steps"] and len(got["step_losses"]) == want["steps"],
              f"{name}: {got['steps']} steps on the mesh, {want['steps']} in one process")
        finite = all(np.isfinite(r[k]).all() for r in ranks for k in
                     ("step_losses", "center", "scores"))
        check(finite, f"{name}: non-finite losses, center or scores on a rank")
        err = dict(step_losses=max_rel(got["step_losses"], want["step_losses"]),
                   center=max_rel(got["center"], want["center"]),
                   scores=float(np.max(np.abs(got["scores"] - want["scores"])
                                       - SCORE_TOL["rtol"] * np.abs(want["scores"]))))
        check(np.allclose(got["step_losses"], want["step_losses"], rtol=LOSS_RTOL, atol=0.0),
              f"{name}: mesh losses vs one process, max rel {err['step_losses']:.3e}")
        check(np.allclose(got["center"], want["center"], rtol=LOSS_RTOL, atol=1e-6),
              f"{name}: mesh center vs one process, max rel {err['center']:.3e}")
        check(np.allclose(got["scores"], want["scores"], **SCORE_TOL),
              f"{name}: mesh scores vs one process past rtol 1e-3 / atol 1e-6")
        # the model ranks of a data block: the same replicated weights and statistics
        split = {k for k in got["local"] if mesh.split_dim(k, got["local"][k].ndim) is not None}
        check(split, f"{name}: no kernel is split")
        pairs_same = all(np.array_equal(ranks[d + 1]["local"][k], ranks[d]["local"][k])
                         for d in range(0, MP_RANKS, MP_MODEL) for k in got["local"]
                         if k not in split)
        whole_same = all(np.array_equal(r["whole"][k], got["whole"][k]) and
                         np.array_equal(r[x], got[x])
                         for r in ranks[1:] for k in got["whole"] for x in ("center", "scores"))
        check(pairs_same and whole_same, f"{name}: the model ranks' replicated weights or "
                                         "statistics, or the ranks' center or scores, differ")
        halves = all(
            r["local"][k].shape[mesh.split_dim(k, 2)] * MP_MODEL
            == want["local"][k].shape[mesh.split_dim(k, 2)] for r in ranks for k in split)
        check(halves, f"{name}: a rank's split kernel is not 1/{MP_MODEL} of the whole")
        restored, z_one, z64 = mp_restored(name, os.path.join(root, f"{name}.ckpt"))
        check(sorted(restored) == sorted(got["whole"]) and all(
            np.array_equal(restored[k], got["whole"][k]) for k in restored),
            f"{name}: the mesh's checkpoint restores in one process to other weights")
        z_err = dict(mesh_vs_one=float(np.max(np.abs(z_one - got["z"]))),
                     mesh_vs_one_past_band=float(np.max(
                         np.abs(got["z"] - z_one) - MP_LATENT_TOL["atol"]
                         - MP_LATENT_TOL["rtol"] * np.abs(z_one))),
                     one_vs_f64_past_band=float(np.max(
                         np.abs(z_one - z64) - MP_LATENT_TOL["atol"]
                         - MP_LATENT_TOL["rtol"] * np.abs(z64))),
                     max_abs_latent=float(np.max(np.abs(z_one))),
                     mesh_vs_f64=float(np.max(np.abs(got["z"] - z64))),
                     one_vs_f64=float(np.max(np.abs(z_one - z64))))
        check(z_err["mesh_vs_f64"] <= MP_F64_RATIO * z_err["one_vs_f64"] + MP_F64_ATOL,
              f"{name}: the mesh's latents are further from float64 than {MP_F64_RATIO}x the "
              f"one process's: {z_err}")
        for r, rec in enumerate(ranks):
            check(rec["launches"]["stse_fused"] > 0 and all(
                v == 0 for k, v in rec["launches"].items() if k != "stse_fused"),
                f"{name}: rank {r} launches {rec['launches']}: K1 must run on every rank "
                "and K2-K5 on none")
            launches = add_launches(launches, rec["launches"])
        cases[name] = dict(errors=err, ranks_same_bits=pairs_same and whole_same,
                           split=sorted(split), latent_err=z_err,
                           launches_by_rank=[r["launches"] for r in ranks],
                           fit_s_by_rank=[r["fit_s"] for r in ranks],
                           one_process_fit_s=want["fit_s"], steps=want["steps"],
                           epoch_losses=got["epoch_losses"].tolist())
    summary = dict(mesh=(MP_RANKS // MP_MODEL, MP_MODEL), backend="gloo on CUDA tensors",
                   cases=cases, group_s=group_s, one_process_s=one_s, launches=launches,
                   card=card)
    print(f"model_parallel: a {MP_RANKS // MP_MODEL} x {MP_MODEL} mesh on one card over gloo "
          "(CUDA tensors; the ranks share the card, so no scaling figure): " + "; ".join(
              f"{n} {c['steps']} steps, split {c['split']}, max rel err losses "
              f"{c['errors']['step_losses']:.2e} center {c['errors']['center']:.2e}, scores "
              f"past rtol 1e-3 by {c['errors']['scores']:.2e} (atol 1e-6), ranks same bits "
              f"{c['ranks_same_bits']}, the checkpoint restores in one process to the "
              f"gathered weights' bits, latents max abs err "
              f"{ {k: float(f'{v:.3g}') for k, v in c['latent_err'].items()} }, "
              f"launches by rank {c['launches_by_rank']}, "
              f"fit s by rank {[round(t, 2) for t in c['fit_s_by_rank']]} vs one process "
              f"{c['one_process_fit_s']:.2f}" for n, c in cases.items())
          + f"; launches {launches}; on {card}")
    return summary


# The tooling phase: `utils/profiling.py` and the Möbius layers on the card
TOOLING_WINDOWS = 2048  # one scoring batch of the flagship
TOOLING_TOL = dict(rtol=1e-4, atol=1e-6)  # card vs CPU float32: reductions' order, libm
TOOLING_TIMEOUT_S = 300


def tooling_trainer():
    """(trainer, state, dataset) of one flagship scoring batch, its K1 warm."""
    import dataclasses

    import torch
    from coskad_tpu_torch.data.windows import SegmentDataset
    from coskad_tpu_torch.train.loop import Trainer

    data, meta, fids, _ = synthetic_windows(np.random.default_rng(5), 6, 2, 200, 12, 18)
    n = TOOLING_WINDOWS
    ds = SegmentDataset(data[:n], meta[:n], fids[:n], num_transform=1)
    cfg = train_config("off")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_transform=1))
    tr = Trainer(cfg, ds, device=DEVICE, logger=QuietLogger())
    state = tr.init_state()
    tr.score_all(state, ds, tr.train_data)  # warm: K1's build and fold
    torch.cuda.synchronize()
    return tr, state, ds


def tooling_trace(tr, state, ds) -> dict:
    """profiling.trace around one score_all batch: the Chrome trace's event
    count, its device events and K1's, whether trace() warned of a lost
    device side, and the batch's launches."""
    from coskad_tpu_torch.utils import profiling

    counters = launch_counters()
    log_dir = tempfile.mkdtemp(prefix="coskad_trace_")
    try:
        zero(counters)
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            with profiling.trace(log_dir) as prof:
                tr.score_all(state, ds, tr.train_data)
        launches = read(counters)
        with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return dict(events=len(events), device_events=profiling.device_event_count(prof),
                k1_events=sum("stse_fused_kernel" in str(e.get("name", "")) for e in events),
                warned=any(issubclass(w.category, RuntimeWarning) for w in warned),
                launches=launches)


def tooling_trace_process(rank, out_path):
    """The first profiler session of a fresh process on the card: one
    tooling_trace, pickled to out_path."""
    import pickle

    with open(out_path, "wb") as f:
        pickle.dump(tooling_trace(*tooling_trainer()), f)


def phase_tooling(card):
    """profiling.trace around a score_all batch: the first trace of a fresh
    process must name K1's kernel, and a trace in this long process (after
    every earlier phase's profiler sessions) is recorded, not held to it;
    where either holds no device event, trace() must have warned.
    device_memory_stats, debug_nans on NaNs made on the card in a forward
    and a backward, and MobiusLinear / MobiusDist2Hyperplane's values and
    gradients on the card against the CPU's."""
    import pickle

    import torch
    import torch.multiprocessing as mp
    from coskad_tpu_torch.geometry import hyperbolic_nn as hnn
    from coskad_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="coskad_tooling_")
    try:
        group = mp.start_processes(tooling_trace_process,
                                   args=(os.path.join(root, "trace.pkl"),), nprocs=1,
                                   join=False, start_method="spawn")
        try:
            while not group.join(timeout=TOOLING_TIMEOUT_S - (time.perf_counter() - t0)):
                check(time.perf_counter() - t0 < TOOLING_TIMEOUT_S,
                      "the tooling phase's trace process timed out")
        finally:
            for proc in group.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join()
        with open(os.path.join(root, "trace.pkl"), "rb") as f:
            fresh = pickle.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tr, state, ds = tooling_trainer()  # held: device_memory_stats reads its tensors
    long_run = tooling_trace(tr, state, ds)
    for where, t in (("a fresh process", fresh), ("this process", long_run)):
        check(t["launches"]["stse_fused"] == 1, f"a score_all batch in {where} launched "
                                                f"{t['launches']}")
        check(t["warned"] == (t["device_events"] == 0),
              f"profiling.trace in {where}: warned {t['warned']} on a trace of "
              f"{t['device_events']} device events")
    check(fresh["k1_events"] >= 1, f"the first trace of a fresh process holds no event of "
                                   f"K1's kernel: {fresh}")
    launches = fresh["launches"]
    stats = profiling.device_memory_stats()
    allocated = stats.get("cuda:0", {}).get("allocated_bytes.all.current", 0)
    check(allocated > 0, f"device_memory_stats reports {allocated} bytes allocated")

    caught = {}
    x = torch.tensor([-1.0, 2.0], device=DEVICE)
    y = torch.tensor([0.0, 1.0], device=DEVICE, requires_grad=True)
    for where, fn in (("forward", lambda: torch.log(x)),
                      ("backward", lambda: torch.sum(torch.sqrt(y) * 0.0).backward())):
        with profiling.debug_nans():
            try:
                fn()
                caught[where] = None
            except FloatingPointError as e:
                caught[where] = str(e).splitlines()[0][:120]
    check(all(caught.values()), f"debug_nans let a NaN made on the card pass: {caught}")

    layers = {}
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(256, 16))
    xs = (xs / np.linalg.norm(xs, axis=1, keepdims=True)
          * rng.uniform(0.05, 0.8, size=(256, 1))).astype(np.float32)
    w = rng.normal(size=(256, 8)).astype(np.float32)
    for name, make in (("MobiusLinear", lambda g: hnn.MobiusLinear(16, 8, generator=g)),
                       ("MobiusDist2Hyperplane",
                        lambda g: hnn.MobiusDist2Hyperplane(16, 8, generator=g))):
        sides = {}
        for dev in ("cpu", DEVICE):
            layer = make(torch.Generator().manual_seed(7)).to(dev)
            xt = torch.from_numpy(xs).to(dev).requires_grad_()
            out = layer(xt)
            torch.sum(out * torch.from_numpy(w).to(dev)).backward()
            sides[dev] = [out.detach().cpu().numpy(), xt.grad.cpu().numpy(),
                          *(p.grad.cpu().numpy() for p in layer.parameters())]
        errs = []
        for got, want in zip(sides[DEVICE], sides["cpu"]):
            scale = max(1.0, float(np.max(np.abs(want))))
            errs.append(float(np.max(np.abs(got - want))))
            check(np.allclose(got, want, rtol=TOOLING_TOL["rtol"],
                              atol=TOOLING_TOL["atol"] * scale),
                  f"{name} on the card vs the CPU: max abs err {errs[-1]:.3e}")
        layers[name] = dict(max_abs_err_by_tensor=errs)
    summary = dict(trace_fresh_process=fresh, trace_this_process=long_run,
                   launches=launches, allocated_bytes=int(allocated), debug_nans=caught,
                   mobius=layers, phase_s=time.perf_counter() - t0, card=card)
    print(f"tooling: a score_all batch's Chrome trace, the first of a fresh process: "
          f"{fresh}; in this process after the earlier phases (recorded, not checked): "
          f"{long_run}; device_memory_stats allocated {allocated} B; "
          f"debug_nans on the card {caught}; Möbius layers card vs CPU max abs err "
          f"{ {k: max(v['max_abs_err_by_tensor']) for k, v in layers.items()} } (rtol 1e-4, "
          f"atol 1e-6 of the scale); {summary['phase_s']:.1f} s on {card}")
    return summary


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("k1", "kernels", "products", "probe", "cli", "paper",
                                       "bf16",
                                       "variants", "encoders", "streaming", "export",
                                       "pipeline", "parallel", "model_parallel", "tooling"),
                    default=None,
                    help="run only the environment and K1's phase (k1), or only the "
                         "environment and kernel phases, or only the product "
                         "check, or only the probe check, or only the cli, the paper, the bf16 (the bf16 kernel check "
                         "and the bf16 fit), the variants, the encoders, the streaming, the "
                         "export, the pipeline, the parallel, the model_parallel or the "
                         "tooling phase (no result line)")
    args = ap.parse_args(argv)
    card, build_s = phase_environment()
    import torch

    if args.only == "k1":
        phase_kernel(card)
        return 0
    if args.only == "products":
        from coskad_tpu_torch.kernels import stse_train as st

        model = seeded_train_stse(torch.Generator().manual_seed(4321), DEVICE, **FULL)
        phase_products(card, st.detached(st.encoder_ops(model)))
        return 0
    if args.only == "cli":
        phase_cli(card)
        return 0
    if args.only == "paper":
        phase_paper(card)
        return 0
    if args.only == "bf16":
        phase_bf16_kernels(card)
        phase_train_bf16(card)
        return 0
    if args.only in ("probe", "variants", "encoders", "streaming", "export", "pipeline",
                     "parallel", "model_parallel", "tooling"):
        phase = dict(probe=phase_probe, variants=phase_variants, encoders=phase_encoders,
                     streaming=phase_streaming, export=phase_export,
                     pipeline=phase_pipeline, parallel=phase_parallel,
                     model_parallel=phase_model_parallel, tooling=phase_tooling)[args.only]
        summary = phase(card)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"chip_smoke_{args.only}.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return 0

    wall = {}

    def timed(name, fn, *a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        wall[name] = round(time.perf_counter() - t, 1)
        return out

    kernel = timed("kernel", phase_kernel, card)
    train_kernels, products = timed("train_kernels", phase_train_kernels, card)
    bf16_kernels = timed("bf16_kernels", phase_bf16_kernels, card)
    mono_kernel, mono = timed("mono", phase_mono, card, checks_only=args.only == "kernels")
    probes = timed("probe", phase_probe, card)
    if args.only == "kernels":
        return 0
    summary = timed("slice", phase_slice, card)
    train = timed("train", phase_train, card)
    train_bf16 = timed("train_bf16", phase_train_bf16, card)
    pipeline = timed("pipeline", phase_pipeline, card)
    cli = timed("cli", phase_cli, card)
    paper = timed("paper", phase_paper, card)
    variants = timed("variants", phase_variants, card)
    encoders = timed("encoders", phase_encoders, card)
    streaming = timed("streaming", phase_streaming, card)
    export = timed("export", phase_export, card)
    parallel = timed("parallel", phase_parallel, card)
    model_parallel = timed("model_parallel", phase_model_parallel, card)
    tooling = timed("tooling", phase_tooling, card)
    print(f"phase wall s: {json.dumps(dict(build=round(build_s, 1), **wall))}")
    kernel["launches_by_path"] = dict(serving=summary["launches"]["stse_fused"],
                                      training=train["launches"]["stse_fused"],
                                      mono=mono["launches"]["stse_fused"],
                                      cli=cli["launches"]["stse_fused"],
                                      paper=paper["launches_total"]["stse_fused"],
                                      training_bf16=train_bf16["launches"]["stse_fused"],
                                      pipeline=pipeline["launches"]["stse_fused"],
                                      variants=variants["launches_total"]["stse_fused"],
                                      encoders=encoders["launches_total"]["stse_fused"],
                                      streaming=streaming["launches"]["stse_fused"],
                                      export=export["launches"]["stse_fused"],
                                      parallel=parallel["launches"]["stse_fused"],
                                      model_parallel=model_parallel["launches"]["stse_fused"])
    check(all(kernel["launches_by_path"][p] > 0
              for p in ("encoders", "streaming", "export", "pipeline", "parallel",
                        "model_parallel")),
          f"K1 by path {kernel['launches_by_path']}: none on the encoders, streaming, export, "
          "pipeline, parallel or model_parallel path")
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    for rec in train_kernels + [mono_kernel]:
        by_path = dict(serving=0, training=train["launches"][rec["name"]],
                       mono=mono["launches"][rec["name"]],
                       cli=cli["launches"][rec["name"]],
                       paper=paper["launches_total"][rec["name"]],
                       variants=variants["launches_total"][rec["name"]],
                       encoders=encoders["launches_total"][rec["name"]],
                       streaming=streaming["launches"][rec["name"]],
                       export=export["launches"][rec["name"]],
                       pipeline=pipeline["launches"][rec["name"]],
                       parallel=parallel["launches"][rec["name"]],
                       model_parallel=model_parallel["launches"][rec["name"]])
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    for rec in bf16_kernels:  # the bf16 form's own paths: the bf16 fit and mono run
        name = rec["name"].split(".")[0]
        by_path = dict(training_bf16=train_bf16["launches"][name],
                       mono_bf16=mono["launches_bf16"][name],
                       pipeline_bf16=pipeline["launches_bf16"][name])
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
        check(rec["launches"] > 0, f"{rec['name']} was not launched on its bf16 path")
    kernels = [kernel, *train_kernels, mono_kernel, *bf16_kernels, *probes]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, kernels=kernels, products=products,
                       slice=summary, train=train, train_bf16=train_bf16, pipeline=pipeline,
                       mono=mono, cli=cli,
                       paper=paper, variants=variants, encoders=encoders, streaming=streaming,
                       export=export, parallel=parallel, model_parallel=model_parallel,
                       tooling=tooling, phase_wall_s=wall), f, indent=1)
    keys = ("name", "route", "source", "replaces", "compute_dtype", "launches", "max_abs_err",
            "tolerance", "ms", "kernel_ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_call", "product_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
