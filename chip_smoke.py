#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. env     torch/CUDA versions and ``nvidia-smi`` name and power limit.
2. build   compile every ``viscy_tpu_torch/csrc/*.cu`` with nvcc and every
           ``*.cpp`` (host kernels H1 and H2) with the host compiler (one
           process per source, started together); print seconds and
           ``-Xptxas -v``.
           Phase 22 (a)-(b), which launch none of the port's kernels, run on
           the card meanwhile.
3. kernel  for every distinct (S, C, M) the flagship gives the fused
           ConvNeXt-v2 MLP+GRN forward (prep, pass A, glue, pass B) at tile
           320 and the slice's tile batch: kernels vs ``reference_mlp_grn``
           in f32 (TF32 off) and bf16, unmasked and masked, two runs
           bit-identical, and CUDA-event medians of kernels and plain; the
           same checks, times and bounds at the train step's shapes (batch
           16, 384^2); at the largest shape the median of each stage beside
           ``torch.matmul`` in bf16 on fc1's and fc2's (M, N, K), and a
           per-kernel profile of one call.
4. kernel-bwd  the fused MLP+GRN backward (passes C and D) at every (S, C, M)
           of the flagship train step at batch 16: all ten gradients against
           ``reference_mlp_grn_bwd`` in f32 (TF32 off) and bf16, one masked
           case, two runs bit-identical; CUDA-event medians of kernel and
           plain, the operation bound and a per-kernel profile of one call;
           at the largest shape the median of each stage (prep, front C,
           d fc2, glue, front D, d fc1, dln + LN backward) beside
           ``torch.matmul`` in bf16 on each product's (M, N, K).
5. warp    the affine-warp kernel at (16,3,20,600,600) -> (16,3,15,384,384)
           with the center-crop offset and production-range matrices,
           against the plain version in zeros, border and reflection modes,
           with flip signs, and as the affine member calls it (source and
           target keys, apply mask), two runs bit-identical, direct-path
           blocks against ``warp_plan``; medians of kernel, plain and
           ``F.affine_grid`` + ``F.grid_sample``, and of the whole affine
           member at the production draws; bounds from the full input and
           from the input voxels the maps touch, and the member's bound.
6. slice   the flagship VSUNet (FCMAE UNeXt2, dims 96-768, bf16, seeded
           weights with non-zero GRN gamma/beta) serves three 2048^2 x 15
           FOVs through ``Trainer.predict`` with YX tiling, in five timed
           rounds; checks shapes, finiteness and the kernel launch count
           over all rounds; prints each round's FOVs/s; profiles one more
           request (device time by kernel, device busy share); then one f32
           two-tile batch on the card (kernel) against the CPU (plain version).
7. train   the flagship VSCyto3D train step through ``Trainer.fit``: seeded
           (16,1,20,600,600) / (16,2,20,600,600) stacks in device memory, the
           production augmentation (affine warp kernel, center crop fused,
           intensity members), the bf16 model, ``MixedLoss(0.5, 0, 0.5)`` on
           bf16 inputs, the fused backward kernels, AdamW + WarmupCosine.
           One warm-up step, then five timed rounds of four steps (patches/s
           per round, step latency, peak memory); checks the loss at every
           step, that parameters moved and the launch counts per step; the
           warp's direct-path share; one profiled step; then one f32 step
           (batch 1, (20,160,160) -> (15,128,128), fixed draws) on the card
           against the CPU: the augmented batch, the loss and every
           parameter gradient.
8. fit     the VSCyto3D fit recipe as ``configs/vscyto3d_fit.yml`` runs it,
           at the flagship's full width: seeded (16,1,15,384,384) /
           (16,2,15,384,384) stacks on the card with seeded ``norm_meta``
           (standing in for the host weighted crop and the plate, which
           phase 9 runs),
           ``NormalizeSampled``, then flip, affine (in == out, no crop),
           contrast and noise; ``MixedLoss(0.5, 0, 0.5)``, AdamW +
           WarmupCosine; ``ModelCheckpoint(monitor="loss/validate", top 5,
           last)``, ``LearningRateMonitor`` and the CSV log. Two epochs of
           three steps and two validation batches, then a new trainer and
           engine resume from ``last`` for a third. Checks launch counts,
           finite losses, the loaded weights and AdamW state bit for bit
           against the saved ones, the resumed epoch and step, the CSV's keys
           and the checkpoints kept; prints patches/s per epoch, ms per
           validation batch, checkpoint save and load times and size and
           peak memory. Then the warp kernel as the recipe's affine member
           calls it (in == out (16,1+2,15,384,384), apply mask) against its
           plain version, as in phase 5, and its time beside its bound. The
           model trains with the recipe's ``encoder_drop_path_rate: 0.1``;
           then the cost of stochastic depth: CUDA-event medians of the
           forward + backward of one batch at rate 0.1 and at rate 0, in
           alternation on the same engine.
9. cli     the port's real entry points, in process through
           ``viscy_tpu_torch.training.cli.main(argv)``, at the flagship's
           full width. Writes a seeded fit plate (4 FOVs of (1, 3, 23,
           1024, 1024) f32: Phase3D, Nucleus, Membrane) and a predict plate
           (2 FOVs of (1, 1, 20, 2048, 2048)) with the port's
           ``build_hcs_plate``; copies the fit plate through the port's
           reader and writer (bit-exact round trip, write and read rates);
           ``preprocess`` both; ``fit -c configs/vscyto3d_fit.yml`` with
           overrides of the data path, ``num_workers``, the root dir and one
           epoch of 3 train and 2 validation batches (drop path, weighted
           crop, flip, affine, contrast and noise as configured); ``predict
           -c configs/vscyto3d_predict.yml`` from ``last`` into a new store.
           Checks launch counts of all five kernels over the two
           subcommands; the store's shape and channels; one FOV against
           ``VSUNet.predict_step`` on its six z-windows (same batches)
           blended with the plain ``blend_in`` (max|d| <= 1e-6 of range);
           then the forward kernels at the predict path's shapes (B = 2,
           full 2048^2 frames) against their plain version. Prints write
           and read rates, preprocess seconds, fit patches/s with the host
           crop, the loader-wait share, predict FOVs/s disk to disk and the
           writer's flush seconds.
10. stages the rest of the entry points, in process through ``cli.main``,
           on phase 9's fit plate and ``last``. Writes ground-truth masks
           for FOV A/1/0's nine z-windows as 16-bit grayscale PNGs (a zlib
           encoder here); ``test -c configs/vscyto3d_predict.yml`` with
           ``ground_truth_masks``: every regression and segmentation metric
           present and finite, the forward kernels' launches, one batch's
           regression metrics on the card (kernels) against the CPU
           (plain) in f32 (|d| <= 2e-3 relative); ``export`` of ``last``
           (``torch.export``, weights embedded): the loaded ``.pt2`` at two
           batch sizes and two YX extents against the eager
           ``VSUNet.forward`` (max|d| <= 1e-6 of range), the kernels'
           launch count showing the custom operator ran them;
           ``precompute`` of the plate: one FOV bit for bit against
           ``(x - mean) / (std + 1e-8)`` in numpy; the plate staged to a
           memmap (bit-exact) and ``fit`` with ``MmappedDataModule`` and
           phase 9's overrides, its ``prepare_data`` reusing the cache,
           launch counts of all five kernels; the TensorBoard event files
           of phase 9's fit and of the test parsed here (framing CRCs; their
           scalars equal the values of ``metrics.csv``); then the forward kernels at the test path's
           shapes (B = 1, full 1024^2 frames) against their plain version.
           Prints FOVs/s disk to metrics, the segmentation leg's host
           seconds per labeled batch, export seconds and MiB, CUDA-event
           medians of the program and the eager forward, precompute seconds
           and MB/s, staging seconds, and the memory-mapped fit's patches/s
           and loader-wait share beside phase 9's. Then the cached fit:
           ``fit`` with phase 9's overrides and ``data.init_args.caching:
           true`` (the FOVs preloaded, the weighted crop pushed down to the
           preloaded views and cut by host kernel H1,
           ``csrc/crop_norm.cpp``): launch counts of the five kernels and of
           H1, patches/s and the loader-wait share beside phase 9's and the
           memory-mapped fit's; one item's time split (the cached CDF, the
           origin draws, the crop, the sample assembly); on one batch's
           origins H1 against its plain version and the per-patch copies it
           replaces, bit for bit, ms per batch of each, its host bound
           (bytes read and written at one ``np.copyto``'s rate on one thread
           and on all), and its thread count a call (one a hardware thread,
           JAX's default, against ``max(1, cores // num_workers)``) with the
           loader's 8 threads cropping at once.
11. pretrain FCMAE masked pretraining and the encoder-only fine-tune at
           full width (``configs/fcmae_pretrain.yml``, then
           ``configs/vscyto2d_finetune.yml``). (a) The masked forward and
           backward kernels at the pretraining encoder's four (S, C, M) at
           batch 32 against their plain versions in f32 and bf16, two runs
           bit-identical, and their bf16 times per step beside the plain
           versions and the bounds. (b) One f32 pretraining step of the
           full-width model at batch 2 (256^2, mask ratio 0.5, drop path
           0.1), the card's kernels against the CPU's plain versions on the
           same weights, token mask and keep masks: the prediction, the loss
           and every parameter gradient (<= 2e-3 of range, r > 0.9999), the
           masked launches counted. (c) Phase 9's fit plate grown by four
           seeded FOVs and preprocessed again; ``fit -c
           configs/fcmae_pretrain.yml`` through ``cli.main`` (batch 32 of
           (1, 5, 256, 256), one epoch of 3 steps and 1 validation batch):
           every draw's masked share, 18 masked and 3 unmasked forward calls
           a step and as many backward, counted; validation on whole 1024^2
           windows, as the config says. (d) The shipped pair cannot be
           chained: the fine-tune's encoder-only load of (c)'s ``last`` must
           raise (the stems differ: (5, 4, 4) at depth 5 against (1, 2, 2)
           at depth 1). ``fit -c configs/fcmae_pretrain.yml`` again with the
           fine-tune's stem and ``z_window_size: 1`` for one step, then
           ``fit -c configs/vscyto2d_finetune.yml`` with ``ckpt_path`` at
           its ``last`` (batch 32 of (1, 1, 256, 256), 3 steps and 1
           validation batch of whole 1024^2 frames, whose stage-0 and last
           decoder calls run as several launches): every encoder tensor
           equals the checkpoint's bit for bit right after the load, the
           decoder and head keep their own; the launches (the warp at depth
           1); the split calls at batch 32 against their plain versions;
           then the warp kernel as the fine-tune's affine member calls it at
           depth 1 ((32, 1 + 2, 1, 256, 256)) against its plain version.
           The configs are the shipped files but for the data path, the
           checkpoint path, the plate's name of the nuclei channel
           (``Nucleus``), the 2-D stem of the second pretraining run and the
           smoke's own crop: a random 256^2 crop put first in the training
           augmentations (the configs have none, and the plate's FOVs are
           1024^2). Prints patches/s and the loader-wait share of both fits,
           and the times of steps 2-3 between CUDA events at step ends.

12. unext2 UNeXt2, the released VSCyto3D architecture, at its released config
           (1 -> 2 channels, depth 5, ``convnextv2_tiny``, stem (5, 4, 4), two
           decoder blocks, head expansion 4; seeded weights, GRN gamma/beta
           non-zero). (a) The fused forward and backward kernels at its
           train shapes (B = 16, 384^2: encoder stage 0 at C = 96 and the
           last decoder stage at C = 224, M = 896) against their plain
           versions in f32 and bf16, and the forward at its 320^2 tiles (B =
           49) and full 2048^2 frame (B = 1); bf16 medians per step beside
           the plain versions and the bounds. (b) f32, card kernels against
           the CPU's plain versions: the forward on two 320^2 tiles and one
           train step (loss and every gradient; <= 2e-3 of range, r >
           0.9999). (c) ``Trainer.fit`` in bf16, ``MixedLoss(0.5, 0, 0.5)``,
           AdamW + WarmupCosine, the train phase's augmentation from seeded
           (16, 1|2, 6, 600, 600) stacks on the card to (5, 384, 384): one
           warm-up step, two timed rounds of four, patches/s, step latency,
           one profiled step (device busy share). (d) ``Trainer.predict`` of
           three seeded (1, 1, 5, 2048, 2048) FOVs, tile 320: FOVs/s and
           request latency. (e) ``cli.main`` ``fit`` and ``predict`` with
           ``architecture: UNeXt2`` and that model config
           (``configs/vscyto3d_{fit,predict}.yml`` composed, the model
           config replaced, ``z_window_size`` 5) on phase 9's fit plate
           (3 + 2 batches) and a seeded (1, 1, 7, 2048, 2048) predict plate.
           Launch counts throughout.
13. dynaclr DynaCLR's ``ContrastiveModule`` at full width, built from
           ``configs/dynaclr_fit.yml``'s model node (``convnext_tiny``, 2
           channels, depth 15, stem (5, 4, 4), embedding 768, projection
           128, NT-Xent 0.07, lr 1e-3; f32). (b) One f32 step card against
           CPU: embedding, projection, loss, every gradient, both
           BatchNorms' running statistics. (c) ``Trainer.fit`` on 32 seeded
           anchor and 32 positive (2, 15, 512, 512) patches on the card,
           each view augmented on its own draws: the bench recipe's affine
           (the warp kernel, both channels in one launch), the config's flip
           and contrast, the center crop to (15, 224, 224); one warm-up
           step, two timed rounds of four (cell pairs/s), one profiled step;
           then the warp kernel as the anchor view's affine calls it against
           its plain version.
14. dynaclr-cli DynaCLR from a plate and its track CSVs to an AnnData
           embedding store, in process through ``cli.main``, at the full
           width of ``configs/dynaclr_fit.yml``. (a) A seeded plate through
           the port's writer (5 FOVs of (2, 2, 40, 1024, 1024) f32, Phase3D
           and RFP, chunks (1, 1, 5, 256, 256)), ``preprocess``, and one
           ultrack-style CSV a FOV (16 cells tracked over both frames, float
           coordinates, more than 256 px from the borders). (b) ``fit -c
           configs/dynaclr_fit.yml`` as shipped (paths, root dir, one epoch
           of 3 train and 1 validation batches and a log line every step
           overridden): cell
           pairs/s over the train loop and the loader-wait share; no kernel
           launches (v1 blocks, no affine); one batch's host reads timed
           apart, with the chunk bytes they touch. (c) The same fit with the bench
           recipe's ``BatchedRandAffined`` put first in the augmentations:
           the warp's launches (three views a step and a validation batch),
           then the warp as the datamodule's anchor view calls it against its
           plain version (:func:`check_warp`, the view's windows rescaled to
           [0, 1]). (d) ``predict -c configs/dynaclr_predict.yml`` from (b)'s
           ``last`` (``predict_cells: false``: the shipped ``true`` names no
           cell, which the port refuses) into an embedding store: cells/s
           disk to store; ``X`` and ``obsm["X_projections"]`` against
           ``predict_step`` on the same windows on the card (<= 1e-6 of
           range), ``obs`` against the track index, ``X_pca`` against a
           float64 SVD on the CPU (<= 1e-4 of range after each component's
           sign). (e) ``convert_to_anndata`` of the store, read back and
           compared bit for bit.

15. celldiff CELLDiff flow matching at the full width of
           ``configs/celldiff_fit.yml`` (``net_config``: dims 64-256, two
           ResnetBlocks a level, YX halved three times, a ViT bottleneck of 8
           layers, hidden 512, 8 heads of 64, patch 4; f32, TF32 off). No
           kernel of ours runs in it (cuDNN convs, GroupNorm, matmuls): its
           launches are checked to be 0. (a) Card against CPU on the same
           weights (every adaLN weight perturbed away from zero) at (1, 1, 8,
           128, 128): the ``CELLDiffNet`` forward, one
           ``DynacellFlowMatching`` train step at fixed ``t`` and ``x0``
           (loss and every gradient), ``VSUNet("FNet3D")`` at (2, 1, 16,
           128, 128): its f32 train-mode loss and running statistics, and
           its f32 gradients of the engine's loss, which at this init are
           exact to only a few 1e-3 of range, against the same step in f64
           on the CPU: the card's worst within twice the CPU's own f32
           worst, the card's step with TF32 allowed outside that bound (the
           conv biases a train-mode BatchNorm removes 0 up to rounding), and
           one ``DynacellUNet("UNetViT3D")`` step at the config's widths (L1
           + L2): <= 2e-3 of range and r > 0.9999. (b) One batch-1 train step
           (forward, backward, AdamW) on a seeded (8, 512, 512) window: peak
           memory, which sets the fit's batch (the config's 4 or the largest
           that fits, with ``accumulate_grad_batches`` to 4); its time with
           TF32 off and allowed; the device busy share and top kernels of a
           profiled step. A seeded plate of 8 FOVs of (1, 2, 16, 512, 512)
           f32 (Phase3D, Fluor) and a predict plate of one (1, 2, 9, 512,
           512), ``preprocess``-ed; ``fit -c configs/celldiff_fit.yml`` with
           the paths, the workers, the batch and its accumulation and one
           epoch of 3 updates and 1 validation batch overridden: patches/s
           over the train loop, the loader-wait share, the later steps'
           seconds, peak memory. (c) ``predict`` from ``last`` through the
           CLI with ``HCSPredictionWriter``: 10 Euler steps (the config's
           50, cut to keep the whole script inside its time limit) over
           the two windows (one batch): windows/s and forwards/s disk to
           store; the store's shape, finiteness and agreement with
           ``predict_step`` on the same windows, blended (<= 1e-6 of range).
16. legacy the legacy U-Nets, ``VSUNet("2.5D")`` (depth 5 -> 1) and
           ``VSUNet("2D")`` at the JAX defaults (filters 16-256 over 4 blocks,
           2 layers a block, dropout 0.2, 1 -> 2 channels, task reg). No
           fused kernel runs in them (cuDNN convs, BatchNorm). (a) f32, card
           against CPU on the same weights at (2, 1, 5 | 1, 256, 256): the
           eval forward, then one train step (the recipe's MixedLoss, dropout
           on the same keep masks drawn on the CPU, train-mode BatchNorm):
           the loss, every gradient and every running statistic (<= 2e-3 of
           range, r > 0.9999). (b) For each: ``fit -c configs/vscyto3d_fit.yml``
           with the model replaced, ``z_window_size`` the model's depth and
           ``target_2d``, one epoch of 3 steps and 1 validation batch on
           phase 9's plate (patches/s, the loader-wait share, peak memory),
           then ``predict -c configs/vscyto3d_predict.yml`` from ``last`` on a
           seeded (1, 1, 7, 1024, 1024) plate (windows/s, the store's written
           slices: a depth-1 output at each window's centre); the warp's
           launches only; the warp kernel as the fit's affine calls it
           (depth 5 and 1, (16, 1+2, *, 384, 384)) against its plain version;
           the device busy share of one profiled 2.5-D train step.
17. gan   ``DynacellGAN``: the FCMAE generator of ``configs/vscyto3d_fit.yml``
           (dims 96-768, bf16), the default multiscale spectral-norm
           PatchGAN3D (base 64, 4 layers, 2 scales, f32), R1, R2, LeCam and the
           EMA on. (a) f32 (drop path 0), card against CPU at (1, 15, 128,
           128): the generator's and discriminator's forwards, one step's loss
           and every generator and discriminator gradient, then the ``u`` and
           ``sigma`` vectors, ``gan_state`` and the EMA generator after it.
           (b) One batch-2 step at (15, 384, 384): peak memory, which sets the
           fit's batch (16, or the largest of 8, 4, 2 that fits, with
           accumulation to 16), its time and device busy share. (c) ``fit -c
           configs/vscyto3d_fit.yml`` with the model replaced by the GAN, 3
           updates and 1 validation batch on phase 9's plate (patches/s, the
           loader-wait share, peak memory, launch counts), ``predict -c
           configs/vscyto3d_predict.yml`` from ``last`` with the EMA generator
           on a seeded (1, 1, 16, 1024, 1024) plate. (d) The warp as the fit's
           affine calls it, and the fused kernels at the generator's train
           shapes (the fit's batch, 384^2, forward and backward) and predict
           shapes (B = 2, 1024^2) against their plain versions.
18. vae   ``BetaVae25D`` and ``BetaVaeModule`` (convnext_tiny, 2 channels,
           depth 16, latent 1024, 256^2; every decoder stage a ConvNeXt-v2
           stage of the fused kernels at C = 384, 192, 96 and 288). The
           defaults reconstruct at twice the input's YX, so training runs
           with a (2, 8, 8) stem (ROADMAP.md Queue 3). (a) The fused forward
           and backward kernels at the decoder's shapes of the default and
           the trained model (batch 32) against their plain versions, and
           their times per train step beside the plain versions and the
           bounds. (b) f32, card against CPU at (2, 2, 16, 128, 128): the
           default model's eval forward; one ``BetaVaeModule`` step of the
           ``convnextv2_tiny`` model (fused kernels in the encoder too) on
           the same latent noise: the ELBO and every gradient. (c) ``fit -c
           configs/dynaclr_fit.yml`` with the model replaced (windows 16
           deep, 256^2 after the crop) on phase 14's plate and tracks, 3
           steps and 1 validation batch (cells/s, loader-wait share, peak
           memory, launch counts), ``predict -c configs/dynaclr_predict.yml``
           from ``last`` through the ``EmbeddingWriter`` (cells/s; features
           the mean, projections equal to it in eval); the device busy share
           of one profiled train step.

19. ddp   data parallelism across processes (``viscy_tpu_torch.parallel``).
           (a) ``fit -c configs/vscyto3d_fit.yml`` on phase 9's plate (3
           steps, 1 validation batch), first in one process without a
           process group, then in ``torch.cuda.device_count()`` processes
           over NCCL (the ``VISCY_*`` environment, ``LOCAL_RANK`` each
           rank's card), each a fresh process with deterministic cuDNN:
           on one card (world 1) the loss curve and every weight of the
           final checkpoint must be bit-identical; on more, the ranks'
           training reads disjoint and the curve within 2e-3 of one
           process's at the global batch (both then without the device
           augmentation and drop path, which each rank draws on its own).
           Every rank on its own card launching every kernel; patches/s of
           both, the gradient all-reduce's CUDA-event time a step. (b) Two
           processes on the one card over gloo: the flagship step in f32
           (8 patches a rank of (15, 384, 384), each rank's own production
           augmentation: the warp at the per-rank batch), its gradients
           reduced, then DynaCLR's f32 step (16 pairs a rank: global
           BatchNorm statistics and NT-Xent negatives); rank 0 then runs
           both as one process on the gathered global batch: losses, every
           gradient, the DynaCLR embedding, projection and running
           statistics within 2e-3 of range and r > 0.9999; step and reduce
           times, launches and peaks per rank. Then phase 17's DynacellGAN in
           f32 (R1 / R2 every second step, LeCam and the EMA on) over the two
           ranks, 2 windows of (15, 128, 128) a rank, two passes (d_step 0
           with R1 / R2, d_step 1 without), against one process at the global
           batch: the loss, each term and the LeCam EMAs (the same on both
           ranks) within 2e-3 relative, every gradient within 2e-3 of range
           and r > 0.9999. Every process has a watchdog.
20. qc, tta, seg, callbacks. (a) ``python -m viscy_tpu_torch.apps.qc.cli run
           -c`` on ``configs/qc_run.yml`` rewritten for phase 9's plate (its
           path; the annotated GFP channel renamed Nucleus): every focus index
           against a float64 FFT's argmax on the host (the smallest margin
           printed), every ``.zattrs`` against the ``--device cpu`` run's,
           seconds per FOV; the plate's ``.zattrs`` restored. (b)
           ``AugmentedPredictionVSUNet.with_rotation_tta`` (4 rotations,
           median) on ``configs/vscyto3d_predict.yml``'s model (f32, full
           width) through ``Trainer.predict``: one seeded (1, 1, 15, 2048,
           2048) FOV, untiled (seconds, fused-forward launches), a (15, 400,
           360) crop card against CPU (<= 2e-3 of range, r > 0.9999), the
           forward kernels at the path's B = 1 full-frame shapes against their
           plain version. (c) ``Trainer.test(SegmentationMetrics2D(),
           SegmentationDataModule)`` on seeded label plates (2 FOVs of (4,
           512, 512)): every metric equal to the plain computation. (d) after
           phase 14 (before phase 18, which removes its plate): its DynaCLR fit with ``EmbeddingSnapshotCallback``
           and ``OnlineEvalCallback`` added, one epoch: the snapshot against a
           CPU forward of the same validation anchors, the logged effective
           rank against the host's on the collected features.

21. transforms  the remaining transforms on phase 9's (grown) plate. (d)
           first: every new device member (elastic, Z shift, histogram shift,
           sharpen, pixel shuffling, inversion batched and per call, noise per
           call, percentiles, weighted crop, Z reduction, zoom linear and
           cubic with antialias off and on) on a seeded (2, 1+2, 15, 384,
           384) f32 batch, its draws taken once on the CPU and handed to the
           card and to the CPU run (max|d| <= 1e-5 of range), then the
           CUDA-event median of each at (16, 1+2, 15, 384, 384), draws
           included, beside the affine member's (the warp kernel, in == out).
           The forward kernels against ``reference_mlp_grn`` (f32 and bf16)
           at every (S, C, M) of the fits below that no other phase checks:
           (a)'s validation on 448^2 at batch 16 and (c)'s model on 256^2 at
           batch 32. Then three ``viscy-torch fit`` runs, one epoch of 3 steps and 1
           validation batch each, with the launch counts of every kernel, the
           patches/s and the loader-wait share: (a)
           ``configs/vscyto3d_fit.yml`` at full width with every augmentation
           under its MONAI name on the host (all twelve aliases:
           ``RandWeightedCropd`` ... ``ToDeviced``); (b) the same recipe with
           its host weighted crop and the batched device list (flip, affine,
           elastic, Z shift, histogram shift, sharpen, pixel shuffling,
           inversion, percentiles, contrast, noise); (c)
           ``configs/vscyto2d_finetune.yml``'s model (2-D stem, no checkpoint)
           on five-slice windows: host weighted crop, the affine fused with a
           random 256^2 crop, ``BatchedChannelWiseZReductiond`` (MIP) of the
           source, contrast, noise, batch 32; then ``BatchedZoomd`` (linear
           and cubic, antialias off and on), ``TiledSpatialCropSamplesd``,
           ``BatchedStackChannelsd`` and ``Decollated`` at that batch, card
           against CPU, with their medians.

22. celldiff-sampler, celldiff-tiles, foundation, datamodules  the slice
           of CELLDiff's ``Sampler``, ``CELLDiff3DVS``, the foundation
           extractors and the new datamodules, in f32 with TF32 off. (a) The
           ``Sampler`` at ``configs/celldiff_fit.yml``'s ``net_config``
           (seeded weights, adaLN perturbed; the SDE's sample eps 1e-3) on
           one (1, 1, 8, 512, 512) window, 2 steps each: RK4, Heun reversed,
           SDE Euler with the ``Mean`` last step, SDE Heun with
           ``Tweedie``, the likelihood (one VJP a step); each method's
           seconds, net evaluations and peak memory, and each against the
           CPU on a (1, 1, 8, 32, 32) window with the same weights and draws
           (<= 2e-3 of range, r > 0.9999). (b) ``generate_sliding_window``
           at the config's (8, 512, 512) patch on a 1024^2 FOV (4 tiles) and
           a 1000^2 FOV (the last tiles snapped, overlapping), 1 Euler step,
           against ``generate`` on each tile's crop and noise (<= 1e-6 of
           range); ``generate_trajectory``'s shape and last entry. (c)
           ``viscy-torch predict`` of ``configs/dynaclr_predict.yml`` with
           ``FoundationModule(DINOv3Model())`` (ViT-S/16) on phase 14's
           plate: cells/s into the store, its rows against the CPU;
           ``CellDinoModel`` and ``OpenPhenomModel`` in process, card
           against CPU. (d) ``viscy-torch fit -c configs/vscyto3d_fit.yml``
           over ``ConcatDataModule`` and then ``CombinedDataModule``
           (``max_size_cycle``) of phase 9's plate and a hard-linked copy:
           launch counts of the warp and the fused forward and backward,
           patches/s, the loader-wait share; ``configs/dynaclr_fit.yml`` over
           ``CellDivisionTripletDataModule`` on 40 seeded ``.npy`` tracks of
           (4, 2, 15, 224, 224): pairs/s and the wait share; batches/s out of
           the ``CTMCv1DataModule`` and ``ClassificationDataModule`` train
           loaders.
23. dynaclr-eval  DynaCLR's embedding evaluation on the card. (a)
           ``viscy-torch predict`` of ``configs/dynaclr_predict.yml`` from
           phase 14's affine fit (whose warp launches feed it) with
           ``umap_kwargs`` and ``phate_kwargs`` on the writer, then every
           ported subcommand of ``python -m viscy_tpu_torch.apps.dynaclr.cli``
           on that store (labels and conditions from a seeded CSV through
           ``append-obs``): seconds, peak memory, finite results, the
           store's new ``obsm`` and ``obs`` entries; no kernel launch on
           this path. (b) A seeded store of 50,000 cells (10 FOVs x 250
           tracks x 20 frames, 4 classes, 4 conditions, 768 features, 128
           projections): ``reduce-dimensionality`` pca / umap (200 epochs) /
           phate (2000 landmarks), ``cross-validate``, ``train-mlp-embedder``
           and ``apply-mlp-embedder``, ``compute-mmd`` (groups of 12,500,
           1000 permutations), ``smoothness``, ``evaluate-tracking-accuracy
           --embeddings``: seconds and peak memory each, the busy share of
           the UMAP layout and of the first MMD test (one profiled call
           each). (c) The same functions on the first 2000 cells on the
           card and on the CPU with the same draws, each difference against
           its bound; two card calls of the UMAP layout identical; the
           sorted ``index_put_(accumulate=True)`` timed against the atomic
           ``index_add_``.
24. dynacell-eval  the virtual-staining benchmark on the card, through
           ``python -m viscy_tpu_torch.apps.dynacell`` in process: its
           ``__main__.py`` and ``eval/`` modules ``runtime``, ``cache``,
           ``segmentation`` with ``_ndimage``, ``spectral``, ``metrics``,
           ``instance_metrics``, ``feature_select``, ``feature_metrics``,
           ``linear_probe``, ``features``, ``pipeline`` and
           ``cross_condition``, and ``evaluation/feature.py``'s GLCM. (a)
           ``predict`` of ``configs/vscyto3d_predict.yml`` from the cli
           phase's checkpoint on its predict plate (2 FOVs of (1, 1, 20,
           2048, 2048)): the fused forward's launches (the cli phase's
           count), one FOV against the cli phase's store (<= 1e-6 of
           range). (b) A seeded GT plate (``Nucleus``, ``Membrane``: 300
           ellipsoidal nuclei, membrane shells, noise) at both FOVs'
           positions and a prediction plate of the first FOV's nuclei with
           seeded noise: the flagship's plate is scored on two FOVs, the
           noisy one on one. (c) ``precompute-gt``, then ``evaluate`` of both
           plates (every tier: spectral PCC, FSC, multiband EV, per-cell PCC and
           SSIM, instance AP, CP with GLCM, a DynaCLR encoder at
           ``configs/dynaclr_fit.yml``'s width on 1-deep crops and a
           ViT-S/16, seeded ``.pt`` checkpoints, patch 64; the two
           evaluations at once), then
           ``evaluate-grouped`` of the two as conditions
           (their final-metrics caches hit; the probe CSV). Checks: no GT
           artifact rewritten, finite pixel rows, PCC > 0.8 and Dice > 0.5
           on the noisy GT, the flagship's FOV-grouped real-against-predicted
           probes finite (CP, DINOv3, DynaCLR), the cross-condition probe's 8
           rows; card against the CPU: the pixel row of the FOV's centre
           (20, 256, 256) within 1e-8 (a whole FOV takes the CPU about 100
           s), the flagship's DynaCLR similarity within 1e-8 (a spread
           over subsets within 1e-8 of its metric) and its probe AUROC
           within 1e-3 (also of the CSV's); the nucleus masks and
           instances of both predictions, the GT's membrane mask and the CP
           features on a FOV's centre (20, 320, 320), the card's filters
           against scipy's, bit for bit; seconds per tier and FOV
           (``timings.csv``), cells a FOV, peak memory, the busy share of
           one profiled pixel tier. (d) ``spectral-eval --mode compute``
           (``eval/decorr.py``, ``eval/spectral_eval.py``) of the
           flagship's prediction of the first FOV against the GT, the whole
           (20, 2048, 2048) FOV on the card: seconds, peak memory, finite
           row; then its centre (20, 256, 256) on the card and with
           ``--device cpu``: every float column within 1e-8 relative (one
           within 1e-12 of 0 on both sides is 0 but for rounding), the
           resolution columns equal; ``segment_whole_cell`` (membrane and
           nucleus channels, nucleus instances as seeds) of the GT's centre
           (20, 320, 320), the card's closing, Gaussian and distance
           transform against scipy's, bit for bit.
25. joint  cross-modal ``JointEncoderModule`` (``apps/dynaclr/multi_modal.py``):
           two single-channel ``convnextv2_tiny`` encoders at
           ``configs/dynaclr_fit.yml``'s width (depth 15, (5, 4, 4) stem,
           embedding 768, projection 128), every block through the fused
           kernels. (a) The forward and backward kernels at the encoders'
           largest and smallest rows (B = 32, 224^2) against their plain
           versions, then f32 CUDA-event medians per train step of both
           encoders beside the plain versions and the bounds. (b) One f32
           step at 4 pairs of (1, 15, 224, 224), card against CPU: both
           embeddings and projections, the loss, every gradient, both
           BatchNorms' running statistics, and its launches. (c)
           ``viscy-torch fit`` of a ``JointEncoderModule`` config written
           from ``configs/dynaclr_fit.yml``'s recipe with ``HCSDataModule``
           (Phase3D to RFP, phase 14's plate, a host weighted crop of 8
           patches a window to 224^2, batch 32): 3 steps and 1 validation
           batch, then ``viscy-torch predict`` from its ``last`` on a
           plate of two (2, 15, 512, 512) FOVs: the fused launches of both
           encoders per step, finite losses, pairs/s and the wait share,
           the predictions' shapes. (d)
           The busy share and top kernels of one profiled step at batch 32.

26. ctc, suites  DynaCLR's CTC tracking benchmark and the config-driven
           evaluation subcommands. (a) A seeded sequence ``01`` in the CTC
           layout (``tracking_benchmark/synthetic.py``, the port's TIFF
           writer): 40 frames of 1024^2 uint16 (Fluo-N2DH-GOWT1's frame; 92
           frames cut to 40), 30 nuclei on a random walk, 3 divisions, the
           error segmentation with 4 dropped and 3 merged detections;
           ``python -m viscy_tpu_torch.apps.dynaclr.cli --device cuda
           evaluate-tracking-accuracy -c`` in process on a config of three
           models at JAX's defaults (160^2 crops, batch 128, distance 325, 10
           neighbours, delta t 5): the IoU baseline and seeded
           ``ContrastiveEncoder`` models (``convnext_tiny`` and
           ``convnextv2_tiny``, 1 channel, depth 1, (1, 4, 4) stem, 768
           features, GRN randomized) from ``.pt`` files. Checks: the v2
           encoder's fused-forward launches (the v1 has none), JAX's columns
           in ``results.csv`` and ``summary.csv``, every solution within the
           flow constraints (the solver checks); the baseline on the GT's
           own masks (on a host thread meanwhile) DET = TRA = 1; each
           encoder's embeddings of the first frames' 128 crops card against
           CPU (<= 2e-3 of range, r > 0.9999) and their ILP's objective
           within 1e-6 relative; the forward kernels at the encoder's four
           (S, C, M) at B = 128 against their plain version (f32 and bf16) and
           f32 medians per call beside the plain version and the bound.
           Prints the node and edge counts, the seconds of the crops (host),
           the embedding (card) and the solve (host), the metrics. (b) On
           phase 23 (b)'s 50,000-cell store, a copy with perturbed features
           and the store split by FOV into two experiments:
           ``evaluate-smoothness`` (grouped by condition), ``compare-models``
           live and ``-c`` over the saved CSVs, ``mmd-analysis`` in its three
           modes (the conditions as groups, 1000 cells a side, 200
           permutations), ``prepare-eval-configs`` and ``check-evals``, each
           on the card and with ``--device cpu``: every statistic and MMD
           value within 1e-6 relative, the p-values and counts equal.
27. lc, pseudotime  DynaCLR's dataset-level linear classifiers and DTW
           pseudotime, through ``python -m viscy_tpu_torch.apps.dynaclr.cli``
           in process, on phase 23 (b)'s seeded store split by FOV into 5
           experiment stores of 10,000 cells (``experiment`` and a
           two-marker ``marker`` column) with annotation CSVs (``treated``
           from the condition, the 4-class ``state``). (a)
           ``run-linear-classifiers -c`` at JAX's defaults (liblinear), the
           split grouped by FOV, published: the binary task trains per
           marker, the 4-class task is skipped (liblinear refuses it, as in
           JAX), the figures are refused by name after everything is
           written; on the card and with ``--device cpu``: the objective
           within 1e-9 relative, the probabilities on every cell within
           1e-6, accuracy and F1 equal (or the cells within 1e-6 of a tie
           printed). (b) ``cross-validate-datasets -c`` over the 5 stores
           (lbfgs, both tasks, one seed: 50 folds of 768 features) on the
           card: seconds, peak memory, finite AUROCs, the impact labels;
           then on a copy of each store's first 2000 cells through PCA 16,
           on the card and with ``--device cpu``: the CSVs within 1e-6
           relative, accuracy and F1 equal. (c) ``build-pseudotime-template``
           (PCA 20, DBA at its defaults) from a copy of the store whose
           infected frames are shifted and a seeded tracks CSV of the first
           4 FOVs (lineages; three tracks in four turn ``infected`` at a
           seeded onset), on the card and with ``--device cpu``: the
           template within 1e-6 of its range; host kernel H2
           (``csrc/dtw.cpp``) bit for bit against its plain version on every
           DP of the CPU build's first DBA iteration, microseconds a call of
           each; ``dtw_align_tracks`` of every track (warp paths equal card
           against CPU) and ``evaluate_embedding``: AUC, AP, onset rho; H2's
           launches on the card's path counted.
28. features, parity  the engineered cell features and the
           released-checkpoint parity harness. (a) ``python -m
           viscy_tpu_torch.training.parity --output <tmp>/parity.json`` on
           the card without artifacts: the four released architectures'
           inventories load strictly into the port's models (``ok``). (b)
           ``capture_activations`` of the harness's default model
           (``VSCYTO3D_MODEL_CONFIG``: FCMAE, dims 96-768, depth 15, f32,
           seeded, GRN perturbed) on one (1, 1, 15, 512, 512) input on the
           card (the fused kernels) and on the CPU: every module within 2e-3
           of its range, r > 0.9999. (c) ``run_checkpoint_parity`` on a
           fixture written here: that model as a Lightning checkpoint, a
           one-FOV plate with its ``fov_statistics`` and a reference store
           of the CPU's sliding-window prediction; the contract passes on
           the card (max|d| / range printed). (d) On the host:
           ``CellFeatures.compute_all_features`` on 256 seeded cells of 128^2
           with masks (ms a cell), ``DynamicFeatures`` over phase 23 (b)'s
           50,000-cell tracks one FOV at a time (ms a track) and
           ``annotation.convert`` of that set to an AnnData store, read back
           equal. The leg's own device memory stays under 6 GiB.

Phase 20 (a) runs after phase 10, on phase 9's plate of 4 FOVs; phases 11,
12, 16 and 19 after it, 12, 16 and 19 on that plate grown by phase 11; 24
(on the cli phase's predict plate and checkpoint), then 21 and 22 (d) (on
the grown plate) beside them; then phase 14, and on its plate and tracks
13, 20 (b)-(d), 22 (c), 17, 25 and 18 beside 23 (also on its affine fit's
checkpoint) and 26 (in 23's directory); 22 (a)-(b) during the build; 27
beside 9 and 10; 28 beside 14; 15 last.

Host-bound phases run beside card-bound ones, each leg in a process of its
own on the same card (``Beside``): phases 24, 21 and 22 (d) beside 20 (a),
11, 12, 16 and 19 (21 waits until 11 has grown the plate); phases 23 and 26
beside 13, 20 (b)-(d), 22 (c), 17, 25 and 18 (18 waits until 23 has read
the plate it removes); phase 27 (store reads, annotation joins and the DTW
on the host; a few GiB on the card) beside 9 and 10 (beside 15, whose fit
reserves most of the card, the pair held more than the limit); phase 28
(the features and the store conversion on the host, the parity harness's
captures and checkpoint on the card: a few GiB) beside 14. The device
memory of each pair is
watched and held under 70 GiB; every line printed by a phase that ran
beside another ends with ``[beside phases ...]``. The phases behind the
kernel table (3-7) run alone. After the ``[done]`` line: one JSON line
``{"phase_seconds": {...}}`` (each phase's wall seconds, the legs' in their
own processes, and each window's), the card's name and power limit, a JSON
``kernels`` record (with ``host_kernels``: H2, the DTW DP, and H1, the
cached fit's batched crop, which stay on the host; H1's bound is its bytes
at the host's copy rate on all threads) and the JSON result line.
Needs ``torch.cuda.is_available()`` and the repo's ``viscy_tpu_torch``
beside this file. Imports nothing of JAX or ``viscy_tpu``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

FLAGSHIP = dict(
    in_channels=1,
    out_channels=2,
    encoder_blocks=(3, 3, 9, 3),
    dims=(96, 192, 384, 768),
    decoder_conv_blocks=2,
    stem_kernel_size=(5, 4, 4),
    in_stack_depth=15,
    pretraining=False,
    dtype="bfloat16",
    fused_mlp=True,
)
TILE = 320
# all 49 tiles of a 2048^2 FOV (7 x 7 at 32 px overlap) in one forward:
# about 5 GB of bf16 activations, well inside the card's 80 GB
TILE_BATCH = 49
FOV_SHAPE = (1, 1, 15, 2048, 2048)
N_REQUESTS = 3
# timed rounds of N_REQUESTS each, so the rate comes with its spread
N_ROUNDS = 5
# H100 SXM data sheet: HBM rate and dense peaks (bf16 tensor core, f32 CUDA core)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TIMED_RUNS = 20
# flagship train step (bench.py): host-crop stacks -> device crop, batch 16
TRAIN_BATCH = 16
TRAIN_STACK = (20, 600, 600)
TRAIN_PATCH = (15, 384, 384)
TRAIN_ROUNDS = 5
STEPS_PER_ROUND = 4
# f32 card-vs-CPU train-step cross-check
XCHECK_STACK = (20, 160, 160)
XCHECK_PATCH = (15, 128, 128)
# the fit recipe: epochs of FIT_STEPS train steps and FIT_VAL validation batches
FIT_STEPS = 3
FIT_VAL = 2
FIT_CONFIG = dict(FLAGSHIP, encoder_drop_path_rate=0.1)
# the cli phase's plates: the fit plate's 23 slices give 4 widened (20-deep)
# training windows per FOV, so 3 training FOVs fill 3 batches of 4 stacks
CLI_FIT_FOVS = ("0", "1", "2", "3")
CLI_FIT_ZYX = (23, 1024, 1024)
CLI_PREDICT_FOVS = ("0", "1")
CLI_PREDICT_ZYX = (20, 2048, 2048)
CLI_CHANNELS = ("Phase3D", "Nucleus", "Membrane")
# phase 11: FCMAE pretraining, then the VSCyto2D fine-tune from its last,
# on phase 9's fit plate grown by four FOVs (six training FOVs: 114
# five-deep windows, three batches of 32, and 138 one-deep ones)
PRETRAIN_FOVS = ("4", "5", "6", "7")
PRETRAIN_BATCH = 32
PRETRAIN_YX = 256
PRETRAIN_STEPS = 3
PRETRAIN_VAL = 1
# phase 12: UNeXt2 at the released VSCyto3D config (RELEASED_ARCHITECTURES["vscyto3d"]);
# the train stacks 6 deep: the even depth the affine's z-scale of 1.3 needs for 5 slices
UNEXT2 = dict(in_channels=1, out_channels=2, in_stack_depth=5, backbone="convnextv2_tiny",
              stem_kernel_size=(5, 4, 4), decoder_conv_blocks=2, head_expansion_ratio=4)
UNEXT2_STACK = (6, 600, 600)
UNEXT2_PATCH = (5, 384, 384)
UNEXT2_ROUNDS = 2
UNEXT2_FOV = (1, 1, 5, 2048, 2048)
UNEXT2_PREDICT_ZYX = (7, 2048, 2048)
# phase 13: DynaCLR (configs/dynaclr_fit.yml): 32 anchor + positive pairs of
# (2, 15, 512, 512) patches, cut to (15, 224, 224) after augmentation
DYNACLR_CHANNELS = ("Phase3D", "RFP")
DYNACLR_BATCH = 32
DYNACLR_STACK = (15, 512, 512)
DYNACLR_PATCH = (15, 224, 224)
DYNACLR_ROUNDS = 2
# phase 14: DynaCLR from a plate and its track CSVs through the command line:
# 5 FOVs (the 0.8 split leaves one for validation) of (2, 2, 40, 1024, 1024)
# f32 (z_range [25, 40]), 16 tracked cells a FOV at more than 256 px from the
# borders (4 FOVs x 2 frames x 16 cells = 4 train batches of 32)
DYNACLR_CLI_FOVS = ("0", "1", "2", "3", "4")
DYNACLR_CLI_T = 2
DYNACLR_CLI_ZYX = (40, 1024, 1024)
DYNACLR_CLI_CHUNKS = (1, 1, 5, 256, 256)
DYNACLR_CLI_CELLS = 16
DYNACLR_CLI_MARGIN = 256  # half the config's initial 512^2 patch
DYNACLR_CLI_STEPS = 3
DYNACLR_CLI_VAL = 1
# phase 15: CELLDiff flow matching (configs/celldiff_fit.yml, net_config at its
# full width): the card-vs-CPU checks at (1, 1, 8, 128, 128) (FNet3D's, whose
# Z is downsampled 4 times, 16 deep); the fit plate 8 FOVs (the 0.8 split
# leaves two for validation) of (1, 2, 16, 512, 512) f32: 9 windows of the
# config's (8, 512, 512) a FOV; the predict plate one FOV 9 deep: 2 windows
CELLDIFF_CHANNELS = ("Phase3D", "Fluor")
CELLDIFF_XCHECK = (1, 1, 8, 128, 128)
CELLDIFF_FNET_XCHECK = (2, 1, 16, 128, 128)
CELLDIFF_FOVS = ("0", "1", "2", "3")
CELLDIFF_COLS = ("1", "2")
CELLDIFF_ZYX = (16, 512, 512)
CELLDIFF_PREDICT_Z = 9
CELLDIFF_PREDICT_STEPS = 10  # the config samples 50; cut to keep the whole script inside its limit
CELLDIFF_STEPS = 3  # optimizer updates, each of the config's batch of 4
CELLDIFF_VAL = 1
CELLDIFF_BATCH = 4
# the bench recipe's affine (bench.py:392-398) on the config's two channels
BENCH_AFFINE = {"class_path": "viscy_transforms.BatchedRandAffined",
                "init_args": {"keys": list(DYNACLR_CHANNELS), "prob": 0.8, "rotate_range": [3.14, 0.0, 0.0],
                              "scale_range": [[0.9, 1.1], [0.9, 1.1], [0.9, 1.1]],
                              "shear_range": [0.05, 0.05, 0.0, 0.05, 0.0, 0.05]}}


# while set, every log line ends with it: the rates on that line were measured beside another phase
BESIDE = {"note": ""}
PHASE_SECONDS: dict[str, float] = {}  # wall seconds of each phase, printed as the phase_seconds line


def log(msg: str) -> None:
    print(msg + BESIDE["note"], flush=True)


def timed_phase(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept as ``PHASE_SECONDS[name]``.
    Beside another phase, the cached device memory is released after it, so
    that the pair holds only what each phase is using."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if BESIDE["note"]:
        torch.cuda.empty_cache()
    PHASE_SECONDS[name] = round(PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0, 1)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_shapes(cfg: dict, tile: int) -> list[tuple[int, int, int]]:
    """(S, C, M) of every fused block call in one forward, in call order."""
    r = tile // cfg["stem_kernel_size"][-1]
    dims = cfg["dims"]
    shapes = []
    for i, (n, d) in enumerate(zip(cfg["encoder_blocks"], dims)):
        shapes += [((r >> i) ** 2, d, 4 * d)] * n
    dec = list(dims[::-1])
    dec[-1] = cfg.get("decoder_out") or cfg["out_channels"] * cfg["in_stack_depth"] * cfg["stem_kernel_size"][-1] ** 2
    for i in range(len(dims) - 1):
        side = r >> (len(dims) - 2 - i)
        shapes += [(side * side, dec[i + 1], 4 * dec[i + 1])] * cfg["decoder_conv_blocks"]
    return shapes


def pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.double().flatten()
    b = b.double().flatten()
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))


def cuda_median_ms(fn, runs: int = TIMED_RUNS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_inputs(b, s, c, m, dtype, seed, masked=False):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape, mean, std, dt=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * std + mean).to(dt)

    args = (
        normal((b, s, c), 0.0, 1.0, dtype),  # x
        normal((b, s, c), 0.0, 1.0, dtype),  # shortcut
        normal((c,), 1.0, 0.1),  # ln scale (not 1)
        normal((c,), 0.0, 0.1),  # ln bias
        normal((m, c), 0.0, 1.0 / math.sqrt(c)),  # fc1 weight
        normal((m,), 0.0, 0.02),  # fc1 bias
        normal((m,), 0.5, 0.2),  # GRN gamma (non-zero)
        normal((m,), 0.0, 0.05),  # GRN beta (non-zero)
        normal((c, m), 0.0, 1.0 / math.sqrt(m)),  # fc2 weight
        normal((c,), 0.0, 0.02),  # fc2 bias
    )
    mask = None
    if masked:
        mask = (torch.rand((b, s), generator=g, device="cuda") > 0.4).float()
    return args, mask


def block_bound_ms(b, s, c, m, dtype, masked=False) -> tuple[float, str]:
    """Least time for one call: each input read once, the output written once,
    4 B S C M operations (fc1 once, fc2 once: what the function needs, not
    the kernel's recompute of fc1) at the dtype's peak."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 3 * b * s * c * elem + 4 * (2 * c * m + 3 * m + 3 * c) + (4 * b * s if masked else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * b * s * c * m / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_env() -> str:
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[env] device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    card = card_line()
    log(f"[env] nvidia-smi: {card}")
    return card


def phase_build(beside=None, what: str = ""):
    """Compile every kernel source (one ``nvcc`` each, all started
    together). ``beside`` (``what``), when given, runs on the card while
    nvcc compiles on the host; it must launch none of the port's kernels
    (checked). Returns its result."""
    import threading

    from viscy_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built: dict = {}

    def build() -> None:
        try:
            built["results"] = _build.build_all()
        except BaseException as e:  # re-raised below, in the main thread
            built["error"] = e
        built["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=build, name="nvcc")
    thread.start()
    out = None
    try:
        if beside is not None:
            _zero_counts()
            out = beside()
            if any(_counts().values()):
                raise AssertionError(f"the work beside the build launched {_counts()}")
    finally:
        thread.join()
    if "error" in built:
        raise built["error"]
    results = built["results"]
    log(f"[build] {len(results)} source(s) in {built['seconds']:.2f} s"
        + (f" ({what} ran on the card meanwhile; {time.perf_counter() - t0:.1f} s to the end of both)"
           if beside is not None else ""))
    for r in results:
        cached = " (library already built; ptxas lines from the build that made it)" if r.cached else ""
        log(f"[build] {r.name}: {r.seconds:.2f} s -> {r.path.name}{cached}")
        for line in r.log.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    return out


def check_forward(batch, s, c, m, seed, masked_cases, worst, ref_batch=None) -> None:
    """The forward kernels against ``reference_mlp_grn`` at (batch, S, C, M)
    in f32 (max|d| <= 1e-4 of range) and bf16 (1.5e-2 of range, r > 0.9999),
    each case run twice and bit-identical; raises on failure. ``worst`` maps
    each dtype to the largest (max|d|, share of range) seen so far. With
    ``ref_batch`` the plain version runs on that many samples at a time (its
    statistics are per sample), to bound its memory."""
    from viscy_tpu_torch.ops import fused_block as fb

    for masked in masked_cases:
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)):
            args, mask = block_inputs(batch, s, c, m, dtype, seed=seed, masked=masked)
            got = fb.fused_mlp_grn(*args, mask=mask)
            again = fb.fused_mlp_grn(*args, mask=mask)
            step = ref_batch or batch
            want = torch.cat([fb.reference_mlp_grn(args[0][i:i + step], args[1][i:i + step], *args[2:],
                                                   mask=None if mask is None else mask[i:i + step])
                              for i in range(0, batch, step)])
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"two forward runs differ at S={s} C={c} M={m} B={batch} {dtype}")
            gotf, wantf = got.float(), want.float()
            err = float((gotf - wantf).abs().max())
            rng = float(wantf.max() - wantf.min())
            r = pearson(gotf, wantf)
            ok = torch.isfinite(gotf).all().item() and err <= rel * rng
            if dtype == torch.bfloat16:
                ok = ok and r > 0.9999
            share = err / max(rng, 1e-30)
            worst[dtype] = max(worst.get(dtype, (0.0, 0.0)), (err, share), key=lambda w: w[1])
            tag = f"S={s} C={c} M={m} B={batch} {str(dtype)[6:]}{' masked' if masked else ''}"
            log(
                f"[kernel] {tag}: max|d|={err:.3e} range={rng:.3e} "
                f"({share:.2e} of range, bound {rel:g}) r={r:.7f}, two runs bit-identical"
            )
            if not ok:
                raise AssertionError(f"kernel disagrees with the plain version at {tag}")
            del args, mask, got, again, want, gotf, wantf
    torch.cuda.empty_cache()


def log_worst(where: str, worst: dict) -> None:
    log(f"[kernel] worst at {where}: " + "; ".join(
        f"{str(dt)[6:]} max|d|={e:.3e} ({share:.2e} of range)" for dt, (e, share) in worst.items()))


def phase_kernel() -> dict:
    from viscy_tpu_torch.ops import fused_block as fb

    batch = TILE_BATCH
    per_forward = kernel_shapes(FLAGSHIP, TILE)
    distinct = sorted(set(per_forward), key=per_forward.index)
    rows = {}
    worst: dict = {}
    for k, (s, c, m) in enumerate(distinct):
        check_forward(batch, s, c, m, 100 + k, (False, True), worst)
        # timing at the flagship dtype, unmasked
        args, _ = block_inputs(batch, s, c, m, torch.bfloat16, seed=200 + k)
        kernel_ms = cuda_median_ms(lambda: fb.fused_mlp_grn(*args))
        plain_ms = cuda_median_ms(lambda: fb.reference_mlp_grn(*args))
        bound, bound_by = block_bound_ms(batch, s, c, m, torch.bfloat16)
        n = per_forward.count((s, c, m))
        rows[(s, c, m)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, n=n)
        log(
            f"[kernel] time S={s} C={c} M={m} B={batch} bf16 x{n}/forward: kernel {kernel_ms:.3f} ms "
            f"plain {plain_ms:.3f} ms bound {bound:.4f} ms ({bound_by}) "
            f"= {bound / kernel_ms:.3f} of bound, library n/a"
        )
        del args
        torch.cuda.empty_cache()
    total = {key: sum(v[key] * v["n"] for v in rows.values()) for key in ("ms", "plain_ms", "bound_ms")}
    by_ops = sum(v["bound_ms"] * v["n"] for v in rows.values() if v["bound_by"] == "operations")
    log(
        f"[kernel] per forward ({len(per_forward)} calls, B={batch}): kernel {total['ms']:.3f} ms "
        f"plain {total['plain_ms']:.3f} ms bound {total['bound_ms']:.3f} ms"
    )
    log_worst(f"the serving shapes (B={batch})", worst)
    worst_train = fwd_train_checks()
    fwd_stage_times(*max(distinct, key=lambda k: k[0] * k[1] * k[2]))
    return dict(
        total,
        bound_by="operations" if by_ops >= total["bound_ms"] / 2 else "bytes",
        max_abs_err=max(worst[torch.bfloat16][0], worst_train[torch.bfloat16][0]),
    )


def fwd_train_checks() -> dict:
    """Passes A + B at the train step's shapes (batch 16, 384^2 patches):
    at each, the kernels against the plain version (:func:`check_forward`,
    one masked case), then CUDA-event medians of kernels and plain, and the
    bound, per call and per step (bf16, unmasked). Returns the worst errors."""
    from viscy_tpu_torch.ops import fused_block as fb

    batch = TRAIN_BATCH
    per_step = kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1])
    distinct = sorted(set(per_step), key=per_step.index)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    worst: dict = {}
    for k, (s, c, m) in enumerate(distinct):
        check_forward(batch, s, c, m, 150 + k, (False, True), worst)
        args, _ = block_inputs(batch, s, c, m, torch.bfloat16, seed=250 + k)
        kernel_ms = cuda_median_ms(lambda: fb.fused_mlp_grn(*args))
        plain_ms = cuda_median_ms(lambda: fb.reference_mlp_grn(*args), runs=5)
        bound, bound_by = block_bound_ms(batch, s, c, m, torch.bfloat16)
        n = per_step.count((s, c, m))
        for key, val in (("ms", kernel_ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
            total[key] += val * n
        log(
            f"[kernel] train time S={s} C={c} M={m} B={batch} bf16 x{n}/step: kernel {kernel_ms:.3f} ms "
            f"plain {plain_ms:.3f} ms bound {bound:.4f} ms ({bound_by}) = {bound / kernel_ms:.3f} of bound"
        )
        del args
        torch.cuda.empty_cache()
    log(f"[kernel] per step ({len(per_step)} calls, B={batch}, forward): kernel {total['ms']:.3f} ms "
        f"plain {total['plain_ms']:.3f} ms bound {total['bound_ms']:.3f} ms")
    log_worst(f"the train shapes (B={batch})", worst)
    return worst


def fwd_stage_times(s: int, c: int, m: int) -> None:
    """CUDA-event medians of each stage of the forward at (S, C, M), batch
    49, bf16, and beside each product ``torch.matmul`` in bf16 on the same
    (M, N, K) (bf16 out; a yardstick of the main loop the port never calls);
    then a per-kernel profile of one call. A stage's time runs from the
    previous stage's end event to its own."""
    from viscy_tpu_torch.ops import fused_block as fb

    args, _ = block_inputs(TILE_BATCH, s, c, m, torch.bfloat16, seed=210)
    x, sc, *params = args
    torch.cuda.reset_peak_memory_stats()
    times: dict[str, list[float]] = {}
    for run in range(TIMED_RUNS + 1):
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        fb._fused_cuda(x, sc, params, None, 1e-6, 1e-6, mark=mark)
        torch.cuda.synchronize()
        if run == 0:
            continue  # warm-up
        prev = start
        for stage, ev in marks:
            times.setdefault(stage, []).append(prev.elapsed_time(ev))
            prev = ev
    peak = torch.cuda.max_memory_allocated()
    profile_call(lambda: fb.fused_mlp_grn(*args), f"S={s} C={c} M={m} B={TILE_BATCH} bf16 prep+A+glue+B")
    del args, x, sc, params
    n = TILE_BATCH * s

    def rand(*shape):
        return torch.randn(shape, device="cuda", dtype=torch.bfloat16)

    ln, w1, v, w2 = rand(n, c), rand(m, c), rand(n, m), rand(c, m)
    yardsticks = {
        "pass A": (f"({n}, {m}, {c})", lambda: torch.matmul(ln, w1.t())),
        "pass B": (f"({n}, {c}, {m})", lambda: torch.matmul(v, w2.t())),
    }
    tflop = 2.0 * n * c * m / 1e12
    total = 0.0
    for stage, ts in times.items():
        med = statistics.median(ts)
        total += med
        line = f"[kernel] stage S={s} C={c} M={m} B={TILE_BATCH} bf16 {stage}: {med:.3f} ms"
        if stage in yardsticks:
            shape, fn = yardsticks[stage]
            lib_ms = cuda_median_ms(fn)
            line += (f" ({tflop / med * 1e3:.0f} TFLOP/s); torch.matmul bf16 {shape}: {lib_ms:.3f} ms "
                     f"({tflop / lib_ms * 1e3:.0f} TFLOP/s)")
        log(line)
    log(f"[kernel] stages sum {total:.3f} ms; peak device memory of the timed calls, inputs included, "
        f"{peak / 2**30:.2f} GiB")
    del ln, w1, v, w2
    torch.cuda.empty_cache()


class _FovDataModule:
    """In-memory stand-in for the HCS prediction datamodule: ``n`` seeded
    uniform FOVs in host memory, one per request, drawn up front (set-up,
    outside the timed run)."""

    def __init__(self, n: int, seed: int, shape: tuple = FOV_SHAPE) -> None:
        g = torch.Generator().manual_seed(seed)
        self.fovs = [torch.rand(shape, generator=g) for _ in range(n)]

    def setup(self, stage: str) -> None:
        pass

    def predict_dataloader(self):
        for fov in self.fovs:
            yield {"source": fov}


def _request_timer():
    from viscy_tpu_torch.training.callbacks.base import Callback

    class RequestTimer(Callback):
        def on_predict_start(self, trainer, module) -> None:
            torch.cuda.synchronize()
            self.latencies = []
            self._last = self.start = time.perf_counter()

        def write_on_batch_end(self, trainer, module, prediction, batch, batch_idx) -> None:
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.latencies.append(now - self._last)
            self._last = now

    return RequestTimer()


def profile_request(trainer, module) -> None:
    """Device time by kernel over one more request, from torch.profiler's
    CUDA activity; the wall time includes the profiler's own overhead."""
    from torch.profiler import ProfilerActivity, profile

    data = _FovDataModule(1, seed=40)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.predict(module, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("[profile] torch.profiler recorded no device time: breakdown not measured")
        return
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    fused_ms = sum(e.self_device_time_total for e in events if "fwd::" in e.key) / 1e3
    log(f"[profile] one request: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%} of wall), fused MLP+GRN forward kernels {fused_ms:.1f} ms "
        f"({fused_ms / busy_ms:.1%} of busy)")
    for e in events[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")


def phase_slice(card: str) -> dict:
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.apps.cytoland.prediction import tile_positions
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.training.trainer import Trainer

    module = VSUNet(
        architecture="fcmae",
        model_config=FLAGSHIP,
        tile_yx=(TILE, TILE),
        tile_batch=TILE_BATCH,
        seed=0,
        device="cuda",
    )
    randomize_grn(module, seed=1)
    n_params = sum(p.numel() for p in module.parameters())
    log(f"[slice] VSUNet fcmae dims {FLAGSHIP['dims']} bf16: {n_params} parameters, "
        f"tile {TILE}x{TILE}, tile_batch {TILE_BATCH}")
    timer = _request_timer()
    trainer = Trainer(callbacks=[timer], device="cuda")

    trainer.predict(module, _FovDataModule(1, seed=10))
    log(f"[slice] warm-up request: {timer.latencies[0]:.3f} s")

    n_tiles = len(tile_positions(FOV_SHAPE[-2], TILE)) * len(tile_positions(FOV_SHAPE[-1], TILE))
    forwards_per_request = math.ceil(n_tiles / TILE_BATCH)
    requests = _FovDataModule(N_REQUESTS, seed=20)
    torch.cuda.reset_peak_memory_stats()
    rates, latencies = [], []
    fb.launches = 0
    for rnd in range(N_ROUNDS):
        preds = trainer.predict(module, requests, return_predictions=True)
        wall = timer._last - timer.start  # first request in to last prediction out
        for i, p in enumerate(preds):
            if tuple(p.shape) != (1, 2, *FOV_SHAPE[2:]) or p.dtype != torch.float32:
                raise AssertionError(f"round {rnd} request {i}: prediction {tuple(p.shape)} {p.dtype}")
            if not torch.isfinite(p).all():
                raise AssertionError(f"round {rnd} request {i}: non-finite prediction")
        del preds
        rates.append(N_REQUESTS / wall)
        latencies += timer.latencies
        log(f"[slice] round {rnd}: latencies {', '.join(f'{t:.4f}' for t in timer.latencies)} s; "
            f"{rates[-1]:.4f} FOVs/s")
    launches = fb.launches
    per_forward = 2 * len(kernel_shapes(FLAGSHIP, TILE))
    expected = per_forward * forwards_per_request * N_REQUESTS * N_ROUNDS
    log(f"[slice] fused_mlp_grn launches {launches}, expected {per_forward} x "
        f"{forwards_per_request * N_REQUESTS * N_ROUNDS} forwards = {expected}")
    if launches != expected:
        raise AssertionError(f"main path launched the kernel {launches} times, expected {expected}")
    log(f"[slice] outputs (1, 2, {', '.join(map(str, FOV_SHAPE[2:]))}) float32, finite; "
        f"{N_ROUNDS} rounds of {N_REQUESTS} requests: FOVs/s median {statistics.median(rates):.4f} "
        f"(min {min(rates):.4f}, max {max(rates):.4f}); request latency median "
        f"{statistics.median(latencies):.4f} s (min {min(latencies):.4f}, max {max(latencies):.4f}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    profile_request(trainer, module)

    # cross-check: the same weights in f32, two tiles, card (kernel) vs CPU (plain)
    cfg32 = dict(FLAGSHIP, dtype="float32")
    on_card = VSUNet("fcmae", cfg32, device="cuda")
    on_card.load_state_dict(module.state_dict())
    on_cpu = VSUNet("fcmae", cfg32, device="cpu")
    on_cpu.load_state_dict(module.state_dict())
    tiles = torch.rand((2, 1, 15, TILE, TILE), generator=torch.Generator().manual_seed(30))
    with torch.inference_mode():
        got = on_card(tiles.cuda()).cpu()
        t0 = time.perf_counter()
        want = on_cpu(tiles)
        cpu_s = time.perf_counter() - t0
    err = float((got - want).abs().max())
    rng = float(want.max() - want.min())
    r = pearson(got, want)
    log(f"[slice] f32 cross-check (2,1,15,{TILE},{TILE}) card kernel vs CPU plain: "
        f"max|d|={err:.3e} range={rng:.3e} ({err / rng:.2e} of range, bound 2e-3) r={r:.8f} "
        f"(CPU forward {cpu_s:.1f} s)")
    if not (err <= 2e-3 * rng and r > 0.9999):
        raise AssertionError("f32 card forward disagrees with the CPU plain forward")
    return dict(launches=launches)


GRAD_NAMES = ("dx", "dshortcut", "dln_scale", "dln_bias", "dw1", "db1", "dgrn_gamma",
              "dgrn_beta", "dw2", "db2")


def production_aug(patch):
    """The flagship VSCyto3D device augmentation (bench.py, ``_production_aug``)."""
    from viscy_tpu_torch.transforms import (
        BatchedCenterSpatialCropd,
        BatchedRandAdjustContrastd,
        BatchedRandAffined,
        BatchedRandGaussianNoised,
        BatchedRandGaussianSmoothd,
        BatchedRandScaleIntensityd,
        Compose,
    )

    return Compose(
        [
            BatchedRandAffined(
                keys=["source", "target"],
                prob=0.8,
                rotate_range=[3.14, 0, 0],
                shear_range=[0.0, 0.05, 0.05],
                scale_range=[[0.7, 1.3], [0.5, 1.5], [0.5, 1.5]],
            ),
            BatchedCenterSpatialCropd(keys=["source", "target"], roi_size=list(patch)),
            BatchedRandAdjustContrastd(keys=["source"], prob=0.5, gamma=(0.8, 1.2)),
            BatchedRandScaleIntensityd(keys=["source"], prob=0.5, factors=0.5),
            BatchedRandGaussianNoised(keys=["source"], prob=0.5, mean=0.0, std=0.3),
            BatchedRandGaussianSmoothd(
                keys=["source"], prob=0.5, sigma_x=(0.25, 0.75), sigma_y=(0.25, 0.75),
                sigma_z=(0.25, 0.75),
            ),
        ]
    )


def train_engine(cfg: dict, device: str, bf16_loss: bool):
    """The flagship engine of ``__graft_entry__._flagship``: MixedLoss(0.5, 0,
    0.5), AdamW lr 2e-5 with WarmupCosine (warmup 30)."""
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

    return VSUNet(
        architecture="fcmae",
        model_config=cfg,
        loss_function=MixedLoss(l1_alpha=0.5, l2_alpha=0.0, ms_dssim_alpha=0.5),
        lr=2e-5,
        schedule="WarmupCosine",
        warmup_steps=30,
        bf16_loss=bf16_loss,
        seed=0,
        device=device,
    )


def randomize_grn(module, seed: int) -> None:
    """GRN gamma/beta away from their zero init, so the GRN terms of every
    kernel carry weight."""
    from viscy_tpu_torch.models.components.blocks import GRN

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, GRN):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g) * 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g) * 0.1)


def compare(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max |d|, max |d| / range(want), Pearson r) in float64."""
    gotf, wantf = got.double(), want.double().to(got.device)
    err = float((gotf - wantf).abs().max())
    rng = float(wantf.max() - wantf.min())
    return err, err / max(rng, 1e-30), pearson(gotf, wantf)


def _compare_grads(on_card, on_cpu, zero: dict, tag: str) -> tuple[int, tuple]:
    """Every parameter gradient of two copies of one engine, card against
    CPU (:func:`compare_grad_dicts`). Returns (gradients compared, worst)."""
    return compare_grad_dicts({n: p.grad for n, p in on_card.named_parameters()},
                              {n: p.grad for n, p in on_cpu.named_parameters()}, zero, tag)


def compare_grad_dicts(got: dict, want: dict, zero: dict, tag: str) -> tuple[int, tuple]:
    """Gradients by parameter name (``None``: no gradient), ``got`` against
    ``want``: within 2e-3 of the range and Pearson r > 0.9999 (a single
    value: within 2e-3 of itself); ``zero`` maps the parameters whose
    gradient is 0 up to rounding (a shift a following normalization
    removes) to the parameter whose gradient sets its scale: both sides
    below 1e-3 of it (a gradient that mattered would be of its order).
    Returns (gradients compared, worst)."""
    worst, n_grads = (0.0, "", 1.0), 0
    for name, w in want.items():
        g = got[name]
        if w is None or g is None:
            if (w is None) != (g is None):
                raise AssertionError(f"{tag}: {name} has a gradient on one side only")
            continue
        if name in zero:
            scale = float(got[zero[name]].abs().max())
            ratios = float(g.abs().max()) / scale, float(w.abs().max()) / scale
            if not max(ratios) < 1e-3:
                raise AssertionError(f"{tag}: {name} should have a gradient of 0 up to rounding: its largest "
                                     f"is {ratios[0]:.2e} and {ratios[1]:.2e} of {zero[name]}'s")
            continue
        if w.numel() == 1:  # a PReLU slope, a one-channel bias: relative error, no correlation
            wc = w.cpu()
            g_rel, g_r = float((g.cpu() - wc).abs() / wc.abs().clamp_min(1e-30)), 1.0
        else:
            _, g_rel, g_r = compare(g.cpu(), w.cpu())
        if not (g_rel <= 2e-3 and g_r > 0.9999):
            raise AssertionError(f"{tag}: gradient of {name} disagrees: {g_rel:.2e} of range, r={g_r:.8f}")
        n_grads += 1
        if g_rel >= worst[0]:
            worst = (g_rel, name, min(worst[2], g_r))
    return n_grads, worst


def check_backward(batch, s, c, m, seed, masked) -> float:
    """The backward kernels against ``reference_mlp_grn_bwd`` at (batch, S,
    C, M) in f32 (every gradient within 1e-4 of its range) and bf16 (1.5e-2,
    r > 0.999), each case run twice and bit-identical; raises on failure.
    Returns the largest bf16 max|d|."""
    from viscy_tpu_torch.ops import fused_block as fb

    worst_bf16 = 0.0
    for dtype, rel, r_min in ((torch.float32, 1e-4, None), (torch.bfloat16, 1.5e-2, 0.999)):
        args, mask = block_inputs(batch, s, c, m, dtype, seed=seed, masked=masked)
        gen = torch.Generator(device="cuda").manual_seed(seed + 100)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(dtype)
        x, _, *params = args
        ss = fb._reference_ss(x, *params[:4], mask, 1e-6)
        mask_f = fb._check_cuda_args(x, g, params, mask)
        got = fb._fused_bwd_cuda(x, g, params, mask_f, ss, 1e-6, 1e-6)
        again = fb._fused_bwd_cuda(x, g, params, mask_f, ss, 1e-6, 1e-6)
        want = fb.reference_mlp_grn_bwd(x, g, *params, ss, mask=mask)
        torch.cuda.synchronize()
        tag = f"S={s} C={c} M={m} B={batch} {str(dtype)[6:]}{' masked' if masked else ''}"
        worst_rel, worst_name, min_r = 0.0, "", 1.0
        for name, a, b2, w in zip(GRAD_NAMES, got, again, want):
            if not torch.equal(a, b2):
                raise AssertionError(f"{name} differs between two runs at {tag}")
            err, e_rel, r = compare(a, w)
            ok = bool(torch.isfinite(a).all()) and e_rel <= rel and (r_min is None or r > r_min)
            if not ok:
                raise AssertionError(
                    f"backward kernels disagree with the plain version at {tag}: {name} "
                    f"max|d|={err:.3e} ({e_rel:.2e} of range, bound {rel:g}) r={r:.7f}"
                )
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
            if e_rel >= worst_rel:
                worst_rel, worst_name = e_rel, name
            min_r = min(min_r, r)
        log(f"[kernel-bwd] {tag}: 10 gradients, worst {worst_name} {worst_rel:.2e} of range "
            f"(bound {rel:g}), min r={min_r:.7f}, two runs bit-identical")
        del args, mask, g, x, params, ss, got, again, want
        torch.cuda.empty_cache()
    return worst_bf16


def phase_kernel_bwd() -> dict:
    from viscy_tpu_torch.ops import fused_block as fb

    batch = TRAIN_BATCH
    per_step = kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1])
    distinct = sorted(set(per_step), key=per_step.index)
    rows = {}
    worst_bf16 = 0.0
    for k, (s, c, m) in enumerate(distinct):
        for masked in [False, True] if k == 1 else [False]:
            worst_bf16 = max(worst_bf16, check_backward(batch, s, c, m, 300 + k, masked))
        args, _ = block_inputs(batch, s, c, m, torch.bfloat16, seed=500 + k)
        gen = torch.Generator(device="cuda").manual_seed(600 + k)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(torch.bfloat16)
        x, _, *params = args
        ss = fb._reference_ss(x, *params[:4], None, 1e-6)
        kernel_ms = cuda_median_ms(lambda: fb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6))
        profile_call(lambda: fb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6),
                     f"S={s} C={c} M={m} B={batch} bf16 C+glue+D")
        plain_ms = cuda_median_ms(lambda: fb.reference_mlp_grn_bwd(x, g, *params, ss), runs=5)
        # 8 B S C M operations (dy, d fc2, d fc1, dln); bytes: x, g read and dx
        # written once in bf16, f32 parameters read and their gradients written
        t_ops = 8.0 * batch * s * c * m / PEAK_FLOPS[torch.bfloat16] * 1e3
        nbytes = 3 * batch * s * c * 2 + 2 * 4 * (2 * c * m + 3 * m + 3 * c) + 4 * batch * m
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        n = per_step.count((s, c, m))
        rows[(s, c, m)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, n=n)
        log(
            f"[kernel-bwd] time S={s} C={c} M={m} B={batch} bf16 x{n}/step: C+glue+D {kernel_ms:.3f} ms "
            f"plain {plain_ms:.3f} ms bound {bound:.4f} ms ({bound_by}) "
            f"= {bound / kernel_ms:.3f} of bound, library n/a"
        )
        del args, g, x, params, ss
        torch.cuda.empty_cache()
    bwd_stage_times(*max(distinct, key=lambda k: k[0] * k[1] * k[2]))
    total = {key: sum(v[key] * v["n"] for v in rows.values()) for key in ("ms", "plain_ms", "bound_ms")}
    log(f"[kernel-bwd] per step ({len(per_step)} calls, B={batch}): kernels {total['ms']:.3f} ms "
        f"plain {total['plain_ms']:.3f} ms bound {total['bound_ms']:.3f} ms")
    return dict(total, bound_by="operations", max_abs_err=worst_bf16)


def device_busy_ms(fn, runs: int = 5) -> float | None:
    """Mean device time of the kernels of one call of ``fn`` over ``runs``
    calls (torch.profiler), or None where it records no device time: beside
    a CUDA-event median, what of that span the card computed and what it
    waited for the host to enqueue."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3 / runs if events else None


def profile_call(fn, tag: str) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log(f"[profile] {tag}: torch.profiler recorded no device time: breakdown not measured")
        return
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] {tag}: device busy {busy_ms:.3f} ms over {sum(e.count for e in events)} kernels")
    for e in events[:8]:
        name = e.key.replace("(anonymous namespace)::", "")
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<3d} {name[:90]}")


def bwd_stage_times(s: int, c: int, m: int) -> None:
    """CUDA-event medians of each stage of the backward at (S, C, M), batch
    16, bf16, and beside each product ``torch.matmul`` in bf16 on the same
    (M, N, K) (bf16 out; a yardstick of the main loop the port never calls).
    A stage's time runs from the previous stage's end event to its own."""
    from viscy_tpu_torch.ops import fused_block as fb

    args, _ = block_inputs(TRAIN_BATCH, s, c, m, torch.bfloat16, seed=700)
    g = torch.randn(args[0].shape, generator=torch.Generator(device="cuda").manual_seed(701),
                    device="cuda").to(torch.bfloat16)
    x, _, *params = args
    ss = fb._reference_ss(x, *params[:4], None, 1e-6)
    torch.cuda.reset_peak_memory_stats()
    times: dict[str, list[float]] = {}
    for run in range(TIMED_RUNS + 1):
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        fb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6, mark=mark)
        torch.cuda.synchronize()
        if run == 0:
            continue  # warm-up
        prev = start
        for stage, ev in marks:
            times.setdefault(stage, []).append(prev.elapsed_time(ev))
            prev = ev
    del args, g, x, params, ss
    n = TRAIN_BATCH * s

    def rand(*shape):
        return torch.randn(shape, device="cuda", dtype=torch.bfloat16)

    ln, dz, h = rand(n, c), rand(n, c), rand(n, m)
    w1, w2 = rand(m, c), rand(c, m)
    front = (f"2 x ({n}, {m}, {c})", lambda: (torch.matmul(ln, w1.t()), torch.matmul(dz, w2)))
    yardsticks = {
        "front C": front,
        "d fc2": (f"({c}, {m}, {n})", lambda: torch.matmul(dz.t(), h)),
        "front D": front,
        "d fc1": (f"({m}, {c}, {n})", lambda: torch.matmul(h.t(), ln)),
        "dln + LN backward": (f"({n}, {c}, {m}) for dln", lambda: torch.matmul(h, w1)),
    }
    total = 0.0
    for stage, ts in times.items():
        med = statistics.median(ts)
        total += med
        line = f"[kernel-bwd] stage S={s} C={c} M={m} B={TRAIN_BATCH} bf16 {stage}: {med:.3f} ms"
        if stage in yardsticks:
            shape, fn = yardsticks[stage]
            line += f"; torch.matmul bf16 {shape}: {cuda_median_ms(fn):.3f} ms"
        log(line)
    log(f"[kernel-bwd] stages sum {total:.3f} ms; peak device memory of the timed calls, inputs included, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ln, dz, h, w1, w2
    torch.cuda.empty_cache()


def library_warp(vol, mats, offset, out_shape, padding_mode):
    """``F.affine_grid`` + ``F.grid_sample(align_corners=True)`` on the same
    maps, rewritten for normalized (x, y, z) coordinates. (Its zeros mode
    blends partial border points, where the kernel zeroes the point.)"""
    import torch.nn.functional as F

    b = vol.shape[0]
    hi = torch.tensor([(n - 1) / 2.0 for n in vol.shape[-3:]], device=vol.device)
    ho = torch.tensor([(n - 1) / 2.0 for n in out_shape], device=vol.device)
    off = torch.tensor(offset, device=vol.device)
    a, t = mats[:, :, :3], mats[:, :, 3]
    theta = a * ho[None, None, :] / hi[None, :, None]
    shift = (torch.einsum("bij,j->bi", a, off) + t) / hi[None, :]
    theta = torch.cat([theta.flip(1).flip(2), shift.flip(1)[:, :, None]], dim=2)
    grid = F.affine_grid(theta, (b, vol.shape[1], *out_shape), align_corners=True)
    return F.grid_sample(vol, grid, mode="bilinear", padding_mode=padding_mode, align_corners=True)


def touched_input_voxels(mats, offset, in_shape, out_shape) -> int:
    """Input voxels the kernel reads in zeros mode: the 8 corners of every
    output point whose coordinates lie inside the volume, counted once."""
    from viscy_tpu_torch.ops import warp as tw

    b = mats.shape[0]
    if b == 0:
        return 0
    grids = tw.affine_grid_3d(mats, in_shape, out_shape, offset)
    zi, yi, xi = in_shape
    n_in = zi * yi * xi
    inside = torch.ones(grids.shape[:1] + grids.shape[2:], dtype=torch.bool, device=grids.device)
    base = torch.zeros(inside.shape, dtype=torch.long, device=grids.device)
    for a, n in enumerate(in_shape):
        cc = grids[:, a]
        inside &= (cc >= 0) & (cc <= n - 1)
        base = base * n + torch.clamp(torch.floor(cc), 0, max(n - 2, 0)).long()
    del grids
    base = torch.where(inside, base, n_in).reshape(b, -1)
    read = torch.zeros((b, n_in + 1), dtype=torch.bool, device=base.device)
    for dz in (0, yi * xi):
        for dy in (0, xi):
            for dx in (0, 1):
                idx = torch.clamp_max(base + (dz + dy + dx), n_in)
                idx = torch.where(base == n_in, n_in, idx)
                read.scatter_(1, idx, True)
    return int(read[:, :n_in].sum())


def warp_inputs():
    """Seeded (16, 3, 20, 600, 600) stacks in [0, 1], the production affine
    member (center crop fused) with its draws, their maps and crop offset."""
    from viscy_tpu_torch.ops import warp as tw

    gen = torch.Generator(device="cuda").manual_seed(50)
    vol = torch.rand((TRAIN_BATCH, 3, *TRAIN_STACK), generator=gen, device="cuda")
    affine = production_aug(TRAIN_PATCH).transforms[0]
    d = affine.draw({"source": vol}, gen)
    mats = tw.compose_affine_3d(rotation=d["rotation"], scale=d["scale"], shear=d["shear"],
                                translate=d["translate"])
    offset = tuple((s - r) // 2 - (s - r) / 2.0 for r, s in zip(TRAIN_PATCH, TRAIN_STACK))
    return vol, affine, d, mats, offset


def phase_warp_time() -> dict:
    """Times of the warp kernel (every sample warped, zeros, one 3-channel
    key: the shape earlier versions of the kernel were timed at), its
    plain version and ``grid_sample``, and of the whole affine member
    (``BatchedRandAffined.apply``: source and target keys, its own
    application mask) at the production draws, each beside its bound.
    Uses only what every version of the port has (``affine_warp_3d`` and
    the transform), so an A/B can run it on an older tree."""
    from viscy_tpu_torch.ops import warp as tw
    from viscy_tpu_torch.ops import warp3d

    vol, affine, d, mats, offset = warp_inputs()
    b, c = vol.shape[:2]
    kernel_ms = cuda_median_ms(lambda: warp3d.affine_warp_3d(vol, mats, TRAIN_PATCH, "zeros", offset))
    plain_ms = cuda_median_ms(lambda: tw.affine_warp_3d(vol, mats, TRAIN_PATCH, "zeros", offset), runs=5)
    library_ms = cuda_median_ms(lambda: library_warp(vol, mats, offset, TRAIN_PATCH, "zeros"))
    n_patch = math.prod(TRAIN_PATCH)
    n_out = b * c * n_patch
    full_bytes = (b * c * math.prod(TRAIN_STACK) + n_out) * 4
    touched = touched_input_voxels(mats, offset, TRAIN_STACK, TRAIN_PATCH)
    touched_bytes = (touched * c + n_out) * 4 + mats.numel() * 4
    full_ms = full_bytes / HBM_BYTES_PER_S * 1e3
    bound = touched_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[warp] {(b, c, *TRAIN_STACK)} -> {(b, c, *TRAIN_PATCH)} zeros: kernel {kernel_ms:.3f} ms plain "
        f"{plain_ms:.3f} ms affine_grid+grid_sample {library_ms:.3f} ms; bound {bound:.4f} ms (bytes: "
        f"{touched} touched input voxels x {c} ch = {touched / (b * math.prod(TRAIN_STACK)):.1%} of "
        f"the input, read once, + output) = {bound / kernel_ms:.3f} of bound; the whole input read "
        f"once + output: {full_bytes / 1e9:.3f} GB, {full_ms:.4f} ms")
    # the member as the train step runs it: two keys, 20 % of samples unapplied
    data = {"source": vol[:, :1].contiguous(), "target": vol[:, 1:].contiguous()}
    del vol
    torch.cuda.empty_cache()
    member_ms = cuda_median_ms(lambda: affine.apply(dict(data), d))
    compose_ms = cuda_median_ms(lambda: tw.compose_affine_3d(rotation=d["rotation"], scale=d["scale"],
                                                             shear=d["shear"], translate=d["translate"]))
    mask = d["mask"]
    n_kept = int((~mask).sum())
    touched_applied = touched_input_voxels(mats[mask], offset, TRAIN_STACK, TRAIN_PATCH)
    member_bytes = (touched_applied * c + n_kept * c * n_patch + n_out) * 4
    member_bound = member_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[warp] affine member (BatchedRandAffined.apply, source 1 ch + target 2 ch, "
        f"{b - n_kept} of {b} samples applied): median {member_ms:.3f} ms; member bound "
        f"{member_bound:.4f} ms (bytes: touched voxels of the applied samples + crops of the "
        f"others, read once, + output) = {member_bound / member_ms:.3f} of bound; of it "
        f"compose_affine_3d (the maps) {compose_ms:.3f} ms")
    del data
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                bound_by="bytes")


def check_warp(label, vols, mats, in_shape, out_shape, mode, offset, flips, mask, lib_vol=None) -> float:
    """The warp kernel against its plain version on the same inputs:
    max|d| <= 1e-6 (inputs in [0, 1]), finite, two runs bit-identical,
    direct-path blocks and applied samples as ``warp_plan`` predicts; with
    ``lib_vol``, also ``grid_sample``'s distance. Raises on a miss; returns
    max|d|."""
    from viscy_tpu_torch.ops import warp as tw
    from viscy_tpu_torch.ops import warp3d

    b, c = mats.shape[0], sum(v.shape[1] for v in vols)
    counters = warp3d.direct_counter("cuda")
    n_tiles = warp3d.tiles(out_shape)
    counters.zero_()
    got = warp3d.affine_warp_3d_keys(vols, mats, out_shape, mode, offset, flips, mask)
    seen = counters.tolist()
    again = warp3d.affine_warp_3d_keys(vols, mats, out_shape, mode, offset, flips, mask)
    want = tw.affine_warp_3d_keys(vols, mats, out_shape, mode, offset, flips, mask)
    torch.cuda.synchronize()
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    plan = warp3d.warp_plan(mats, in_shape, out_shape, mode, offset, flips, channels=c)
    applied = torch.ones(b, dtype=torch.bool, device="cuda") if mask is None else mask
    expected = int(plan.direct_blocks[applied].sum())
    line = (f"{label}: kernel vs plain max|d|={err:.3e} (bound 1e-6, inputs in [0, 1]), "
            f"two runs {'bit-identical' if same else 'DIFFER'}; direct-path blocks {seen[0]} of "
            f"{seen[2] * n_tiles} ({seen[0] / max(seen[2] * n_tiles, 1):.1%}; plan {expected}), "
            f"voxels of staged slices read directly {seen[1]}")
    if lib_vol is not None:
        lib = library_warp(lib_vol, mats, offset, out_shape, mode)
        line += f"; grid_sample vs kernel max|d|={float((lib - got[0]).abs().max()):.3e}"
        del lib
    log(line)
    if not (finite and same and err <= 1e-6 and seen[0] == expected and seen[2] == int(applied.sum())):
        raise AssertionError(f"warp kernel check failed ({label})")
    return err


def phase_warp() -> dict:
    """The warp kernel against its plain version (:func:`check_warp`) at
    the train shapes in every mode, with flip signs, and as the affine
    member calls it (source and target keys in one launch, the member's
    apply mask); then :func:`phase_warp_time`."""
    vol, _, d, mats, offset = warp_inputs()
    b = vol.shape[0]
    g = torch.Generator(device="cuda").manual_seed(51)
    signs = torch.where(torch.rand((b, 3), generator=g, device="cuda") < 0.5, -1.0, 1.0)
    keys = [vol[:, :1].contiguous(), vol[:, 1:].contiguous()]
    cases = [("zeros", "zeros", [vol], None, None), ("border", "border", [vol], None, None),
             ("reflection", "reflection", [vol], None, None),
             ("zeros, flip signs", "zeros", [vol], signs, None),
             ("zeros, member call (source 1 ch + target 2 ch, apply mask)", "zeros", keys, None, d["mask"])]
    worst = 0.0
    for label, mode, vols, flips, mask in cases:
        lib_vol = vol if mask is None and mode != "reflection" and flips is None else None
        worst = max(worst, check_warp(f"[warp] {label}", vols, mats, TRAIN_STACK, TRAIN_PATCH, mode, offset,
                                      flips, mask, lib_vol))
    del vol, keys
    torch.cuda.empty_cache()
    return dict(phase_warp_time(), max_abs_err=worst)


def _stack_datamodule(batch: dict, steps: int, aug):
    from viscy_tpu_torch.data.gpu_aug import DeviceTransformDataModule

    class StackDataModule(DeviceTransformDataModule):
        """In-memory stand-in for the HCS datamodule: the seeded host-crop
        output stacks, already in device memory, handed out ``steps`` times."""

        train_device_transforms = aug

        def train_dataloader(self):
            return [batch] * steps

    return StackDataModule()


def _step_timer():
    from viscy_tpu_torch.training.callbacks.base import Callback

    class StepTimer(Callback):
        """Round wall times (synchronized at round ends only) and the loss
        of every step, kept on the card until the run ends."""

        def __init__(self):
            self.losses, self.rounds, self.t0 = [], [], None

        def on_train_batch_end(self, trainer, module, metrics, batch, batch_idx):
            self.losses.append(metrics["loss/train"])
            step = trainer.global_step
            if step == 1 or (step > 1 and (step - 1) % STEPS_PER_ROUND == 0):
                torch.cuda.synchronize()
                now = time.perf_counter()
                if self.t0 is not None:
                    self.rounds.append(now - self.t0)
                self.t0 = now

    return StepTimer()


def record_draws(compose, data: dict, gen: torch.Generator) -> list[dict]:
    """Draws of every random member of ``compose`` on ``data`` with every
    application mask set (each member applies)."""
    draws = []
    for t in compose.transforms:
        if getattr(t, "is_random", False):
            d = t.draw(data, gen)
            d["mask"] = torch.ones_like(d["mask"])
            draws.append(d)
            data = t(data, draws=d)
        else:
            data = t(data)
    return draws


def _to(v, dev):
    if isinstance(v, list):
        return [_to(x, dev) for x in v]
    return v.to(dev) if isinstance(v, torch.Tensor) else v


def train_cross_check(module) -> None:
    """One f32 step's loss and gradients, card (kernels) against CPU (plain)."""
    cfg32 = dict(FLAGSHIP, dtype="float32")
    on_card = train_engine(cfg32, "cuda", bf16_loss=False)
    on_card.load_state_dict(module.state_dict())
    on_cpu = train_engine(cfg32, "cpu", bf16_loss=False)
    on_cpu.load_state_dict(module.state_dict())
    g = torch.Generator().manual_seed(60)
    batch = {
        "source": torch.rand((1, 1, *XCHECK_STACK), generator=g),
        "target": torch.rand((1, 2, *XCHECK_STACK), generator=g),
    }
    aug = production_aug(XCHECK_PATCH)
    draws = record_draws(aug, batch, torch.Generator().manual_seed(61))
    t0 = time.perf_counter()
    cpu_batch = aug(batch, draws=draws)
    cpu_loss = on_cpu.training_loss(cpu_batch)
    cpu_loss.backward()
    cpu_s = time.perf_counter() - t0
    card_batch = aug({k: v.cuda() for k, v in batch.items()}, draws=[{k: _to(v, "cuda") for k, v in d.items()} for d in draws])
    card_loss = on_card.training_loss(card_batch)
    card_loss.backward()
    torch.cuda.synchronize()
    for k in ("source", "target"):
        err, e_rel, r = compare(card_batch[k].cpu(), cpu_batch[k])
        log(f"[train] f32 cross-check augmented {k} {tuple(cpu_batch[k].shape)}: max|d|={err:.3e} "
            f"({e_rel:.2e} of range) r={r:.8f}")
        if not (e_rel <= 2e-3 and r > 0.9999):
            raise AssertionError(f"augmented {k} on the card disagrees with the CPU")
    card_loss, cpu_loss = float(card_loss.detach()), float(cpu_loss.detach())
    l_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    _, worst = _compare_grads(on_card, on_cpu, {}, "train step")
    log(f"[train] f32 cross-check (1,1,{','.join(map(str, XCHECK_STACK))}) -> "
        f"{XCHECK_PATCH} card kernels vs CPU plain: loss {card_loss:.7f} vs {cpu_loss:.7f} "
        f"(rel {l_rel:.2e}); every parameter gradient within 2e-3 of range and r > 0.9999, worst "
        f"{worst[1]} {worst[0]:.2e} (CPU step {cpu_s:.1f} s)")
    if not l_rel <= 2e-3:
        raise AssertionError("f32 train-step loss on the card disagrees with the CPU")


def profile_step(trainer, module, datamodule) -> None:
    """Device time by kernel over one more train step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    trainer.max_steps = trainer.global_step + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(module, datamodule)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("[profile] torch.profiler recorded no device time: breakdown not measured")
        return
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3

    def share(pat):
        return sum(e.self_device_time_total for e in events if pat in e.key) / 1e3

    log(f"[profile] one train step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%} of wall); fused MLP+GRN forward {share('fwd::'):.1f} ms, "
        f"backward {share('bwd::'):.1f} ms, warp {share('warp_kernel'):.1f} ms")
    for e in events[:15]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")


def phase_train(card: str) -> dict:
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d
    from viscy_tpu_torch.training.trainer import Trainer

    module = train_engine(FLAGSHIP, "cuda", bf16_loss=True)
    randomize_grn(module, seed=2)
    gen = torch.Generator(device="cuda").manual_seed(70)
    batch = {
        "source": torch.rand((TRAIN_BATCH, 1, *TRAIN_STACK), generator=gen, device="cuda"),
        "target": torch.rand((TRAIN_BATCH, 2, *TRAIN_STACK), generator=gen, device="cuda"),
    }
    n_steps = 1 + TRAIN_ROUNDS * STEPS_PER_ROUND
    dm = _stack_datamodule(batch, n_steps + 1, production_aug(TRAIN_PATCH))
    timer = _step_timer()
    # no logging and no checkpoint: the phase times the steps alone
    trainer = Trainer(max_steps=n_steps, callbacks=[timer], log_every_n_steps=10**9,
                      checkpoint_every_n_epochs=10**9, seed=0, device="cuda")
    watched = dict(module.model.named_parameters())
    names = ["encoder.stem.conv3d.weight", "encoder.stages.0.blocks.0.mlp.fc1.weight",
             "encoder.stages.3.blocks.0.mlp.grn.weight", "decoder.decoder_stages.2.conv.blocks.1.mlp.fc2.weight"]
    before = {n: watched[n].detach().clone() for n in names}
    torch.cuda.reset_peak_memory_stats()
    direct = warp3d.direct_counter("cuda")
    direct.zero_()
    fb.launches = fb.bwd_launches = warp3d.launches = 0
    t0 = time.perf_counter()
    trainer.fit(module, dm)
    torch.cuda.synchronize()
    counts = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches)
    total_s = time.perf_counter() - t0
    d_blocks, d_voxels, warped = direct.tolist()
    warp_blocks = warped * warp3d.tiles(TRAIN_PATCH)
    log(f"[train] warp: {warped} samples warped, {n_steps * TRAIN_BATCH - warped} copied as crops; "
        f"direct-path blocks {d_blocks} of {warp_blocks} ({d_blocks / max(warp_blocks, 1):.1%}), "
        f"voxels of staged slices read directly {d_voxels}")
    per_fwd = len(kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1]))
    want = dict(fwd=2 * per_fwd * n_steps, bwd=2 * per_fwd * n_steps, warp=n_steps)
    log(f"[train] {n_steps} steps in {total_s:.1f} s; launches A+B {counts['fwd']}, C+D {counts['bwd']}, "
        f"warp {counts['warp']}; expected {2 * per_fwd}/{2 * per_fwd}/1 per step = "
        f"{want['fwd']}/{want['bwd']}/{want['warp']}")
    if counts != want:
        raise AssertionError(f"train path launched {counts}, expected {want}")
    losses = torch.stack(timer.losses).float().cpu()
    if len(losses) != n_steps or not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite or missing train losses: {losses.tolist()}")
    for n in names:
        if torch.equal(before[n], watched[n].detach()):
            raise AssertionError(f"parameter {n} did not change")
    rates = [TRAIN_BATCH * STEPS_PER_ROUND / t for t in timer.rounds]
    steps_ms = [t / STEPS_PER_ROUND * 1e3 for t in timer.rounds]
    log(f"[train] losses {', '.join(f'{v:.5f}' for v in losses.tolist())}")
    log(f"[train] rounds of {STEPS_PER_ROUND} steps: patches/s " + ", ".join(f"{r:.4f}" for r in rates))
    log(f"[train] flagship train step, batch {TRAIN_BATCH}, {TRAIN_STACK} -> {TRAIN_PATCH}, bf16: "
        f"patches/s median {statistics.median(rates):.4f} (min {min(rates):.4f}, max {max(rates):.4f}, "
        f"spread {(max(rates) - min(rates)) / min(rates):.1%}); step latency median "
        f"{statistics.median(steps_ms):.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    profile_step(trainer, module, dm)
    del batch, dm
    torch.cuda.empty_cache()
    train_cross_check(module)
    return dict(bwd_launches=counts["bwd"], warp_launches=counts["warp"])


def recipe_aug():
    """The device augmentation of ``configs/vscyto3d_fit.yml`` (after the
    host weighted crop): flip, affine (no crop: in == out), contrast, noise."""
    from viscy_tpu_torch.transforms import (
        BatchedRandAdjustContrastd,
        BatchedRandAffined,
        BatchedRandFlipd,
        BatchedRandGaussianNoised,
        Compose,
    )

    keys = ["source", "target"]
    return Compose(
        [
            BatchedRandFlipd(keys=keys, prob=0.5),
            BatchedRandAffined(keys=keys, prob=0.5, rotate_range=[3.14, 0.0, 0.0],
                               scale_range=[[1.0, 1.3], [0.75, 1.3], [0.75, 1.3]]),
            BatchedRandAdjustContrastd(keys=["source"], gamma=[0.8, 1.2], prob=0.3),
            BatchedRandGaussianNoised(keys=["source"], prob=0.5, std=0.5),
        ]
    )


def fit_batch(seed: int) -> dict:
    """Seeded (16, 1|2, 15, 384, 384) stacks on the card with per-sample
    ``fov_statistics`` (mean, std) for NormalizeSampled."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {
        "source": torch.rand((TRAIN_BATCH, 1, *TRAIN_PATCH), generator=gen, device="cuda"),
        "target": torch.rand((TRAIN_BATCH, 2, *TRAIN_PATCH), generator=gen, device="cuda"),
    }
    batch["norm_meta"] = {
        k: {"fov_statistics": {
            "mean": 0.5 + 0.1 * torch.rand(TRAIN_BATCH, generator=gen, device="cuda"),
            "std": 0.25 + 0.1 * torch.rand(TRAIN_BATCH, generator=gen, device="cuda"),
        }}
        for k in ("source", "target")
    }
    return batch


def _fit_datamodule(train: dict, val: list[dict]):
    from viscy_tpu_torch.data.gpu_aug import DeviceTransformDataModule
    from viscy_tpu_torch.transforms import NormalizeSampled

    class RecipeDataModule(DeviceTransformDataModule):
        """In-memory stand-in for the HCS datamodule of the fit recipe: the
        seeded stacks on the card, NormalizeSampled on every batch, then the
        stage's device transforms (none for validation)."""

        train_device_transforms = recipe_aug()
        normalize = NormalizeSampled(keys=["source", "target"], level="fov_statistics")

        def train_dataloader(self):
            return [train] * FIT_STEPS

        def val_dataloader(self):
            return list(val)

        def device_transform(self, batch, generator, stage="train"):
            return super().device_transform(self.normalize(batch), generator, stage)

    return RecipeDataModule()


def _fit_trainer(**kw):
    """A Trainer that times its checkpoint saves and loads (synchronized)."""
    from viscy_tpu_torch.training.trainer import Trainer

    class TimedTrainer(Trainer):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.saves, self.loads = [], []

        def _save_checkpoint(self, module, val_metrics):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = super()._save_checkpoint(module, val_metrics)
            self.saves.append((time.perf_counter() - t0, path.stat().st_size))
            return path

        def load_checkpoint(self, path, module):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().load_checkpoint(path, module)
            torch.cuda.synchronize()
            self.loads.append(time.perf_counter() - t0)

    return TimedTrainer(**kw)


def _fit_callbacks(saved=None):
    """The recipe's callbacks, a timer, and (with ``saved = (module,
    trainer)``) the resume check: at fit start, after the checkpoint's load,
    the weights and AdamW state equal ``saved``'s bit for bit and the fit
    resumes at the saved epoch + 1 and the saved step."""
    from viscy_tpu_torch.training.callbacks.base import Callback
    from viscy_tpu_torch.training.callbacks.checkpoint import LearningRateMonitor, ModelCheckpoint

    class FitTimer(Callback):
        def __init__(self):
            self.train_s, self.val_ms, self.losses, self.val_losses = [], [], [], []

        def on_train_epoch_start(self, trainer, module, epoch):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, trainer, module, metrics, batch, batch_idx):
            self.losses.append(metrics["loss/train"])
            if batch_idx == FIT_STEPS - 1:
                torch.cuda.synchronize()
                self.train_s.append(time.perf_counter() - self.t0)

        def on_validation_epoch_start(self, trainer, module):
            torch.cuda.synchronize()
            self.v0 = time.perf_counter()

        def on_validation_batch_end(self, trainer, module, outputs, batch, batch_idx):
            self.val_losses.append(outputs["loss/validate"])

        def on_validation_epoch_end(self, trainer, module, metrics):
            torch.cuda.synchronize()
            self.val_ms.append((time.perf_counter() - self.v0) / FIT_VAL * 1e3)

    class ResumeCheck(Callback):
        def on_fit_start(self, trainer, module):
            ref_module, ref_trainer = saved
            for (name, a), b in zip(module.model.state_dict().items(), ref_module.model.state_dict().values()):
                if not torch.equal(a, b):
                    raise AssertionError(f"resumed weight {name} differs from the saved one")
            got, want = trainer.optimizer.state_dict(), ref_trainer.optimizer.state_dict()
            if got["param_groups"] != want["param_groups"] or got["state"].keys() != want["state"].keys():
                raise AssertionError("resumed AdamW param groups differ from the saved ones")
            for k, st in got["state"].items():
                for name, v in st.items():
                    if not torch.equal(v, want["state"][k][name]):
                        raise AssertionError(f"resumed AdamW {name} of parameter {k} differs")
            if (trainer.current_epoch, trainer.global_step) != (ref_trainer.current_epoch + 1,
                                                                ref_trainer.global_step):
                raise AssertionError(f"resumed at epoch {trainer.current_epoch}, step "
                                     f"{trainer.global_step}; saved epoch {ref_trainer.current_epoch}, "
                                     f"step {ref_trainer.global_step}")
            log(f"[fit] resume from last: weights ({len(got['state'])} AdamW states) equal the saved ones "
                f"bit for bit; epoch {trainer.current_epoch}, step {trainer.global_step}")

    callbacks = [ModelCheckpoint(monitor="loss/validate", every_n_epochs=1, save_top_k=5, save_last=True),
                 LearningRateMonitor(logging_interval="step"), FitTimer()]
    if saved is not None:
        callbacks.append(ResumeCheck())
    return callbacks


def recipe_warp(batch: dict) -> float:
    """The warp kernel as the recipe's affine member calls it (in == out
    (15, 384, 384), no offset, source and target keys, the member's apply
    mask, the recipe's scale range): held against its plain version by
    :func:`check_warp`, then its CUDA-event median beside its byte bound
    (touched input voxels of the applied samples, the unapplied samples'
    copies, the output). Returns max|d|."""
    from viscy_tpu_torch.ops import warp as tw
    from viscy_tpu_torch.ops import warp3d

    affine = recipe_aug().transforms[1]
    data = {"source": batch["source"], "target": batch["target"]}
    d = affine.draw(data, torch.Generator(device="cuda").manual_seed(82))
    mats = tw.compose_affine_3d(rotation=d["rotation"], scale=d["scale"], shear=d["shear"],
                                translate=d["translate"])
    vols = [data["source"], data["target"]]
    mask = d["mask"]
    b, c, n_patch = TRAIN_BATCH, 3, math.prod(TRAIN_PATCH)
    n_kept = int((~mask).sum())
    shape = f"({b},1+2,{','.join(map(str, TRAIN_PATCH))}) in == out, {b - n_kept} of {b} samples applied"
    err = check_warp(f"[fit] warp kernel at the recipe's shape {shape}", vols, mats, TRAIN_PATCH, TRAIN_PATCH,
                     "zeros", None, None, mask)
    ms = cuda_median_ms(lambda: warp3d.affine_warp_3d_keys(vols, mats, TRAIN_PATCH, "zeros", None,
                                                           apply_mask=mask))
    touched = touched_input_voxels(mats[mask], None, TRAIN_PATCH, TRAIN_PATCH)
    bound = (touched * c + n_kept * c * n_patch + b * c * n_patch) * 4 / HBM_BYTES_PER_S * 1e3
    log(f"[fit] warp kernel at the recipe's shape {shape}: median {ms:.3f} ms; bound {bound:.4f} ms (bytes: "
        f"touched input voxels of the applied samples + copies of the others, read once, + output) = "
        f"{bound / ms:.3f} of bound")
    return err


def phase_fit(card: str) -> dict:
    """The VSCyto3D fit recipe through ``Trainer.fit``: two epochs, then a
    resume from ``last`` for a third (see the module docstring)."""
    import shutil

    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d

    root = ROOT / "lightning_logs" / "chip_smoke_fit"
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    module = train_engine(FIT_CONFIG, "cuda", bf16_loss=False)
    randomize_grn(module, seed=3)
    train = fit_batch(80)
    val = [fit_batch(81 + i) for i in range(FIT_VAL)]
    dm = _fit_datamodule(train, val)
    kw = dict(default_root_dir=root, log_every_n_steps=1, seed=0, device="cuda")
    callbacks = _fit_callbacks()
    timer = callbacks[2]
    trainer = _fit_trainer(max_epochs=2, callbacks=callbacks, **kw)
    fb.launches = fb.bwd_launches = warp3d.launches = 0
    t0 = time.perf_counter()
    trainer.fit(module, dm)
    resumed_module = train_engine(FIT_CONFIG, "cuda", bf16_loss=False)
    resume_callbacks = _fit_callbacks(saved=(module, trainer))
    resume_callbacks[2] = timer
    resumed = _fit_trainer(max_epochs=3, callbacks=resume_callbacks, **kw)
    resumed.fit(resumed_module, dm, ckpt_path=root / "checkpoints" / "last")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches)
    steps, val_batches = 3 * FIT_STEPS, 3 * FIT_VAL
    per_fwd = len(kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1]))
    want = dict(fwd=2 * per_fwd * (steps + val_batches), bwd=2 * per_fwd * steps, warp=steps)
    log(f"[fit] {steps} train steps and {val_batches} validation batches over 3 epochs (one resumed) in "
        f"{total_s:.1f} s; launches A+B {counts['fwd']}, C+D {counts['bwd']}, warp {counts['warp']}; "
        f"expected {want['fwd']}/{want['bwd']}/{want['warp']}")
    if counts != want:
        raise AssertionError(f"fit path launched {counts}, expected {want}")
    losses = torch.stack(timer.losses).float().cpu()
    if len(losses) != steps or not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite or missing fit losses: {losses.tolist()}")
    val_losses = timer.val_losses
    if len(val_losses) != val_batches or not all(math.isfinite(v) for v in val_losses):
        raise AssertionError(f"non-finite or missing validation losses: {val_losses}")
    lines = [json.loads(s) for s in (root / "metrics.csv").read_text().splitlines()]
    n_val = sum("loss/validate" in line for line in lines)
    n_lr = sum("lr" in line for line in lines)
    if n_val != 3 or n_lr != steps:
        raise AssertionError(f"metrics.csv has {n_val} loss/validate and {n_lr} lr lines, expected 3 and {steps}")
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    last = root / "checkpoints" / "last"
    if len(ckpts) > 6 or "last" not in ckpts or not last.resolve().exists() or not last.resolve().name.startswith(
            f"epoch=2-step={steps}-loss="):
        raise AssertionError(f"checkpoints after the fit: {ckpts}")
    rates = [TRAIN_BATCH * FIT_STEPS / t for t in timer.train_s]
    log(f"[fit] losses {', '.join(f'{v:.5f}' for v in losses.tolist())}; validation "
        f"{', '.join(f'{v:.5f}' for v in val_losses)}; metrics.csv {len(lines)} lines "
        f"({n_lr} with lr, {n_val} with loss/validate); checkpoints {ckpts}")
    log(f"[fit] recipe train steps (batch {TRAIN_BATCH}, {TRAIN_PATCH}, bf16 model, f32 loss, every step "
        f"logged): patches/s per epoch {', '.join(f'{r:.4f}' for r in rates)} (epoch 2 resumed); "
        f"validation {', '.join(f'{v:.1f}' for v in timer.val_ms)} ms per batch of {TRAIN_BATCH}")
    saves = trainer.saves + resumed.saves
    log(f"[fit] checkpoints: save {', '.join(f'{s:.3f}' for s, _ in saves)} s, "
        f"{saves[0][1] / 2**20:.1f} MiB each (weights, AdamW and scheduler state); load "
        f"{resumed.loads[0]:.3f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({card})")
    drop_path_cost(resumed_module, train, card)
    del module, resumed_module, trainer, resumed, dm, val
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    err = recipe_warp(train)
    del train
    torch.cuda.empty_cache()
    return dict(counts, warp_max_abs_err=err)


def drop_path_cost(module, batch: dict, card: str) -> None:
    """CUDA-event medians of one batch's forward + backward (``training_loss``
    with the engine's drop-path generator, no optimizer step) with every
    encoder block's stochastic depth at the recipe's 0.1 and at 0, in
    alternation on the same engine and batch."""
    from viscy_tpu_torch.models.components.blocks import DropPath

    # the encoder's: the decoder's blocks carry a DropPath too, at rate 0
    blocks = [m for name, m in module.named_modules() if isinstance(m, DropPath) and ".encoder." in name]
    gen = torch.Generator(device="cuda").manual_seed(90)
    data = {"source": batch["source"], "target": batch["target"]}
    module.train()

    def step():
        module.zero_grad(set_to_none=True)
        module.training_loss(data, gen).backward()

    times: dict[float, list[float]] = {0.1: [], 0.0: []}
    for _ in range(5):
        for rate in times:
            for b in blocks:
                b.rate = rate
            times[rate].append(cuda_median_ms(step, runs=3))
    for b in blocks:
        b.rate = 0.1
    module.zero_grad(set_to_none=True)
    on, off = statistics.median(times[0.1]), statistics.median(times[0.0])
    log(f"[fit] stochastic depth (0.1 in all {len(blocks)} encoder blocks) vs none, forward + backward of one "
        f"batch of {TRAIN_BATCH} {TRAIN_PATCH}, alternating, 5 x median of 3: {on:.2f} ms vs {off:.2f} ms "
        f"({on - off:+.2f} ms, {on / off - 1:+.2%}) ({card})")


def _cli_config(path: Path, override: dict, base: Path | None = None) -> str:
    """A config file: ``override`` on top of ``base`` (when given)."""
    import yaml

    path.write_text(yaml.safe_dump({"base": [str(base)], **override} if base else override))
    return str(path)


def plate_round_trip(plate: Path, copy: Path, card: str) -> None:
    """Read every FOV of ``plate`` with the port's reader, write it into a new
    store with the port's writer, read that back: bit-exact, with rates."""
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    src = open_ome_zarr(plate)
    dst = open_ome_zarr(copy, layout="hcs", mode="w", channel_names=list(CLI_CHANNELS))
    nbytes, read_s, write_s = 0, 0.0, 0.0
    for name, pos in src.positions():
        t0 = time.perf_counter()
        data = pos["0"][:]
        t1 = time.perf_counter()
        img = dst.create_position(*name.split("/")).create_zeros("0", data.shape, data.dtype,
                                                                  chunks=pos["0"].chunks)
        img[:] = data
        t2 = time.perf_counter()
        if not np.array_equal(open_ome_zarr(copy)[name]["0"][:], data):
            raise AssertionError(f"plate round trip of {name} is not bit-exact")
        nbytes += data.nbytes
        read_s += t1 - t0
        write_s += t2 - t1
    log(f"[cli] fit plate round trip through the port's reader and writer: bit-exact; "
        f"read {nbytes / read_s / 1e6:.1f} MB/s, write {nbytes / write_s / 1e6:.1f} MB/s "
        f"({nbytes / 2**20:.0f} MiB, uncompressed chunks of {pos['0'].chunks}) ({card})")
    shutil.rmtree(copy)


def recompute_fov(store: Path, ckpt: Path, config: Path, fov: str) -> tuple[float, float]:
    """One FOV of the prediction store against ``VSUNet.predict_step`` on its
    z-windows, batched as the predict loader batches them, blended with the
    plain ``blend_in``. Returns (max|d|, range)."""
    from viscy_tpu_torch.training.callbacks.prediction_writer import blend_in
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.instantiate import instantiate
    from viscy_tpu_torch.training.trainer import Trainer
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    cfg = load_composed_config(config)
    module = instantiate(cfg["model"])
    dm = instantiate(cfg["data"])
    Trainer(device="cuda", default_root_dir=ckpt.parent).load_checkpoint(ckpt, module)
    module.eval()
    dm.setup("predict")
    z_total = CLI_PREDICT_ZYX[0]
    want, windows = None, 0
    with torch.inference_mode():
        for batch in dm.predict_dataloader():
            rows = [i for i, idx in enumerate(batch["index"]) if idx[0].strip("/").startswith(fov + "/")]
            if not rows:
                continue
            pred = module.predict_step({"source": torch.from_numpy(batch["source"]).cuda()}).cpu().numpy()
            for i in rows:
                _, t, z = batch["index"][i]
                if want is None:
                    want = np.zeros((pred.shape[1], z_total, *pred.shape[-2:]), np.float32)
                zs = slice(z, z + pred.shape[2])
                want[:, zs] = blend_in(want[:, zs], pred[i], zs)
                windows += 1
    got = open_ome_zarr(store)[fov]["0"][0]
    err = float(np.abs(got - want).max())
    rng = float(want.max() - want.min())
    log(f"[cli] {fov}: the store against predict_step on its {windows} z-windows + plain blend_in: "
        f"max|d|={err:.3e} range={rng:.3e} ({err / rng:.2e} of range, bound 1e-6)")
    if windows != z_total - 15 + 1 or not err <= 1e-6 * rng:
        raise AssertionError(f"prediction store disagrees with its recomputation ({windows} windows)")
    return err, rng


def phase_cli(card: str, tmp: Path) -> dict:
    """``viscy-torch preprocess / fit / predict`` on seeded plates written in
    ``tmp`` (see the module docstring); returns the launch counts and what
    phase 10 reads: the fit plate, the fit's root directory and feed
    statistics."""
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr
    from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fit_plate = build_hcs_plate(tmp / "fit.zarr", CLI_CHANNELS, zyx_shape=CLI_FIT_ZYX, num_timepoints=1,
                                rows=("A",), cols=("1",), fovs=CLI_FIT_FOVS, seed=7)
    pred_plate = build_hcs_plate(tmp / "predict.zarr", CLI_CHANNELS[:1], zyx_shape=CLI_PREDICT_ZYX,
                                 num_timepoints=1, rows=("B",), cols=("2",), fovs=CLI_PREDICT_FOVS, seed=8)
    log(f"[cli] seeded plates written in {time.perf_counter() - t0:.1f} s: {len(CLI_FIT_FOVS)} FOVs of "
        f"(1, 3, {', '.join(map(str, CLI_FIT_ZYX))}) and {len(CLI_PREDICT_FOVS)} of "
        f"(1, 1, {', '.join(map(str, CLI_PREDICT_ZYX))}) float32 ({card})")
    plate_round_trip(fit_plate, tmp / "copy.zarr", card)

    t0 = time.perf_counter()
    for plate in (fit_plate, pred_plate):
        cli.main(["preprocess", "-c", _cli_config(tmp / f"pp_{plate.stem}.yml",
                                                   {"data_path": str(plate), "num_workers": 8})])
    pp_s = time.perf_counter() - t0
    stats = open_ome_zarr(fit_plate)["A/1/0"].zattrs["normalization"]["Phase3D"]["fov_statistics"]
    if not 0.45 < stats["mean"] < 0.55:
        raise AssertionError(f"preprocess statistics off: {stats}")
    log(f"[cli] preprocess of both plates: {pp_s:.2f} s (fov mean of A/1/0 Phase3D {stats['mean']:.4f}) "
        f"({card})")

    root = tmp / "fit"
    fit_cfg = _cli_config(tmp / "fit.yml", {
        "data": {"init_args": {"data_path": str(fit_plate), "num_workers": 8}},
        "trainer": {"default_root_dir": str(root), "max_epochs": 1, "limit_train_batches": FIT_STEPS,
                    "limit_val_batches": FIT_VAL},
    }, ROOT / "configs/vscyto3d_fit.yml")
    store = tmp / "prediction.zarr"
    pred_cfg = _cli_config(tmp / "predict.yml", {
        "data": {"init_args": {"data_path": str(pred_plate), "num_workers": 8}},
        "trainer": {"callbacks": [{"class_path": "viscy_utils.callbacks.HCSPredictionWriter",
                                   "init_args": {"output_store": str(store), "overwrite": False}}]},
    }, ROOT / "configs/vscyto3d_predict.yml")
    ckpt = root / "checkpoints" / "last"
    torch.cuda.synchronize()
    fb.launches = fb.bwd_launches = warp3d.launches = 0
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", fit_cfg])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches)
    fb.launches = fb.bwd_launches = warp3d.launches = 0
    t0 = time.perf_counter()
    predictor = cli.main(["predict", "-c", pred_cfg, "--ckpt_path", str(ckpt)])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_counts = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches)

    per_fwd = len(kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1]))
    want_fit = dict(fwd=2 * per_fwd * (FIT_STEPS + FIT_VAL), bwd=2 * per_fwd * FIT_STEPS, warp=FIT_STEPS)
    n_windows = len(CLI_PREDICT_FOVS) * (CLI_PREDICT_ZYX[0] - 15 + 1)
    want_pred = dict(fwd=2 * len(kernel_shapes(FLAGSHIP, CLI_PREDICT_ZYX[-1])) * math.ceil(n_windows / 2),
                     bwd=0, warp=0)
    log(f"[cli] launches: fit A+B {fit_counts['fwd']}, C+D {fit_counts['bwd']}, warp {fit_counts['warp']} "
        f"(expected {want_fit['fwd']}/{want_fit['bwd']}/{want_fit['warp']}); predict A+B "
        f"{pred_counts['fwd']} (expected {want_pred['fwd']}), C+D {pred_counts['bwd']}, warp "
        f"{pred_counts['warp']}")
    if fit_counts != want_fit or pred_counts != want_pred:
        raise AssertionError(f"cli paths launched {fit_counts} / {pred_counts}, expected {want_fit} / {want_pred}")
    feed = trainer.feed_stats
    if feed["steps"] != FIT_STEPS or not ckpt.resolve().exists():
        raise AssertionError(f"fit ran {feed['steps']} steps; last -> {ckpt.resolve()}")
    val = trainer.logged_metrics.get("loss/validate")
    if val is None or not math.isfinite(val):
        raise AssertionError(f"fit validation loss {val}")
    patches = FIT_STEPS * TRAIN_BATCH
    log(f"[cli] fit (configs/vscyto3d_fit.yml, drop path 0.1, host weighted crop of 4 x 4 patches from "
        f"(3, 20, 1024, 1024) windows): {fit_s:.1f} s in all; train loop {feed['seconds']:.2f} s for "
        f"{FIT_STEPS} steps = {patches / feed['seconds']:.2f} patches/s (first step included); waited "
        f"{feed['wait_s']:.2f} s for batches = {feed['wait_s'] / feed['seconds']:.1%} of the loop; "
        f"loss/validate {val:.5f} ({card})")
    writer = next(cb for cb in predictor.callbacks if hasattr(cb, "flush_s"))
    out = open_ome_zarr(store)
    names = [n for n, _ in out.positions()]
    shape = (1, 2, *CLI_PREDICT_ZYX)
    if out.channel_names != ["Nucleus", "Membrane"] or names != [f"B/2/{f}" for f in CLI_PREDICT_FOVS]:
        raise AssertionError(f"prediction store channels {out.channel_names} positions {names}")
    for n in names:
        if out[n]["0"].shape != shape:
            raise AssertionError(f"prediction {n} has shape {out[n]['0'].shape}, expected {shape}")
    log(f"[cli] predict (configs/vscyto3d_predict.yml, f32, full {CLI_PREDICT_ZYX[-1]}^2 frames, batch 2, "
        f"{n_windows} windows): {pred_s:.2f} s = {len(names) / pred_s:.4f} FOVs/s disk to disk; writer "
        f"flushes {writer.flush_s:.2f} s on its pool, of which the loop waited {writer.flush_wait_s:.2f} s; "
        f"store {shape} x {len(names)}, channels {out.channel_names} ({card})")
    recompute_fov(store, ckpt, Path(pred_cfg), names[0])
    del trainer, predictor
    torch.cuda.empty_cache()
    worst: dict = {}
    shapes = kernel_shapes(FLAGSHIP, CLI_PREDICT_ZYX[-1])
    for k, (s, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
        check_forward(2, s, c, m, 300 + k, (False,), worst)
    log_worst("the predict path's shapes (B=2, full frames)", worst)
    return dict(fit=fit_counts, predict=pred_counts, max_abs_err=worst[torch.float32][0], fit_plate=fit_plate,
                fit_root=root, ckpt=ckpt, feed=dict(feed), predict_plate=pred_plate, predict_store=store)


TEST_REGRESSION = ("loss", "metrics/mae", "metrics/mse", "metrics/pearson", "metrics/cosine", "metrics/ssim")
TEST_SEGMENTATION = ("metrics/accuracy", "metrics/dice_score", "metrics/jaccard", "metrics/mAP", "metrics/mAP_50",
                     "metrics/mAP_75", "metrics/mAR_100")
# the export's two batch sizes and two YX extents (multiples of the model's stride, 32)
EXPORT_SHAPES = ((1, 1, 15, 512, 512), (2, 1, 15, 1024, 768))


def png16(labels: np.ndarray) -> bytes:
    """A 16-bit grayscale PNG of ``labels`` (rows unfiltered, one IDAT)."""
    h, w = labels.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = labels.astype(">u2").view(np.uint8).reshape(h, 2 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_masks(plate: Path, out: Path) -> int:
    """Ground-truth masks of FOV A/1/0's z-windows (``img_p000_z<center>``):
    the instances of its smoothed Nucleus slice above mean + 1.5 std."""
    from scipy import ndimage

    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    out.mkdir()
    nucleus = open_ome_zarr(plate)["A/1/0"]["0"][0, 1]
    half = 15 // 2
    for z in range(half, nucleus.shape[0] - half):
        sm = ndimage.gaussian_filter(nucleus[z], 4.0)
        labels = ndimage.label(sm > sm.mean() + 1.5 * sm.std())[0]
        (out / f"img_p000_z{z}_cp_masks.png").write_bytes(png16(labels))
    return nucleus.shape[0] - 2 * half


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        n |= (b & 0x7F) << shift
        i += 1
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i : i + 8], i + 8
        elif wire == 5:
            val, i = buf[i : i + 4], i + 4
        elif wire == 2:
            n, i = _varint(buf, i)
            val, i = buf[i : i + n], i + n
        else:
            raise AssertionError(f"wire type {wire} in an event")
        yield num, wire, val


def read_event_file(path: Path) -> tuple[str, list[tuple[int, str, float]]]:
    """The file version and the (step, tag, value) scalars of a TensorBoard
    event file; raises on a framing CRC (masked CRC-32C) that does not match."""
    from viscy_tpu_torch.zarr_io.store import crc32c

    def mask(data: bytes) -> int:  # TFRecord's masked CRC-32C
        crc = crc32c(data)
        return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    data, i, version, scalars = path.read_bytes(), 0, None, []
    while i < len(data):
        header = data[i : i + 8]
        (n,) = struct.unpack("<Q", header)
        payload = data[i + 12 : i + 12 + n]
        if (struct.unpack("<I", data[i + 8 : i + 12])[0] != mask(header)
                or struct.unpack("<I", data[i + 12 + n : i + 16 + n])[0] != mask(payload)):
            raise AssertionError(f"{path.name}: record at byte {i} fails its CRC")
        step = 0
        for num, _, val in _fields(payload):
            if num == 2:
                step = val
            elif num == 3:
                version = val.decode()
            elif num == 5:
                for vnum, _, value in _fields(val):
                    if vnum == 1:
                        f = dict((k, v) for k, _, v in _fields(value))
                        scalars.append((step, f[1].decode(), struct.unpack("<f", f[2])[0]))
        i += 16 + n
    return version, scalars


def stage_test(card: str, tmp: Path, plate: Path, ckpt: Path, module) -> dict:
    """``viscy-torch test`` from phase 9's ``last`` with ground-truth masks."""
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.instantiate import instantiate
    from viscy_tpu_torch.training.trainer import read_checkpoint

    n_masks = write_masks(plate, tmp / "masks")
    root = tmp / "test"
    cfg = _cli_config(tmp / "test.yml", {
        "data": {"init_args": {"data_path": str(plate), "num_workers": 8, "ground_truth_masks": str(tmp / "masks")}},
        "trainer": {"default_root_dir": str(root), "callbacks": []},
    }, ROOT / "configs/vscyto3d_predict.yml")
    seg_s = []
    leg = VSUNet.test_step_host

    def timed_leg(self, batch, pred=None):  # host seconds of the leg, after the card's forward
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = leg(self, batch, pred)
        seg_s.append(time.perf_counter() - t0)
        return out

    VSUNet.test_step_host = timed_leg
    try:
        torch.cuda.synchronize()
        fb.launches = fb.bwd_launches = warp3d.launches = 0
        t0 = time.perf_counter()
        cli.main(["test", "-c", cfg, "--ckpt_path", str(ckpt)])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
    finally:
        VSUNet.test_step_host = leg
    counts = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches)
    n_windows = len(CLI_FIT_FOVS) * (CLI_FIT_ZYX[0] - 15 + 1)
    want = dict(fwd=2 * len(kernel_shapes(FLAGSHIP, CLI_FIT_ZYX[-1])) * n_windows, bwd=0, warp=0)
    rows = [json.loads(line) for line in (root / "metrics.csv").read_text().splitlines()]
    got = {k[len("test/"):]: v for k, v in rows[-1].items() if k.startswith("test/")}
    log(f"[stages] test (configs/vscyto3d_predict.yml, f32, {n_windows} full {CLI_FIT_ZYX[-1]}^2 windows at batch 1,"
        f" {n_masks} with masks): {test_s:.2f} s = {len(CLI_FIT_FOVS) / test_s:.4f} FOVs/s disk to metrics; "
        f"segmentation leg {statistics.mean(seg_s):.3f} s of host time per labeled batch ({len(seg_s)} batches, "
        f"max {max(seg_s):.3f}); launches A+B {counts['fwd']} (expected {want['fwd']}), C+D {counts['bwd']}, warp "
        f"{counts['warp']} ({card})")
    log("[stages] test metrics: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(got.items())))
    if counts != want or len(seg_s) != n_masks:
        raise AssertionError(f"test launched {counts}, expected {want}; {len(seg_s)} labeled batches")
    missing = [k for k in TEST_REGRESSION + TEST_SEGMENTATION if not math.isfinite(got.get(k, math.nan))]
    if missing:
        raise AssertionError(f"test metrics missing or not finite: {missing}")

    # one batch's regression metrics, card (kernels) against the CPU (plain), f32, TF32 off
    composed = load_composed_config(cfg)
    on_cpu = instantiate(cli._with_device(composed["model"], "cpu"))
    on_cpu.model.load_state_dict(read_checkpoint(ckpt)[1])
    dm = instantiate(composed["data"])
    dm.setup("test")
    batch = next(iter(dm.test_dataloader()))
    batch = {k: torch.from_numpy(batch[k]) for k in ("source", "target")}
    with torch.no_grad():
        card_m = {k: float(v) for k, v in module.test_step({k: v.cuda() for k, v in batch.items()}).items()}
        t0 = time.perf_counter()
        cpu_m = {k: float(v) for k, v in on_cpu.eval().test_step(batch).items()}
        cpu_s = time.perf_counter() - t0
    worst = max(abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-3) for k in TEST_REGRESSION)
    log(f"[stages] one test batch, card kernels vs CPU plain (f32): " + ", ".join(
        f"{k} {card_m[k]:.6f}/{cpu_m[k]:.6f}" for k in TEST_REGRESSION)
        + f"; worst |d| {worst:.2e} relative (bound 2e-3; CPU {cpu_s:.1f} s)")
    if not worst <= 2e-3:
        raise AssertionError("the card's test metrics disagree with the CPU's")
    del on_cpu
    return dict(counts=counts, fovs_per_s=len(CLI_FIT_FOVS) / test_s)


def stage_export(card: str, tmp: Path, ckpt: Path, module) -> dict:
    """``viscy-torch export`` of ``last``, the program against the eager forward."""
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.export import load_exported

    out = tmp / "model.pt2"
    cfg = _cli_config(tmp / "export.yml", {
        "trainer": {"default_root_dir": str(tmp / "export"), "callbacks": []},
        "export": {"format": "stablehlo", "export_path": str(out), "ckpt_path": str(ckpt), "embed_params": True},
    }, ROOT / "configs/vscyto3d_predict.yml")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["export", "-c", cfg])
    export_s = time.perf_counter() - t0
    program = load_exported(out)
    per_call = 2 * len(kernel_shapes(FLAGSHIP, TILE))
    gen = torch.Generator().manual_seed(50)
    worst, total = 0.0, 0
    with torch.inference_mode():
        for shape in EXPORT_SHAPES:
            x = torch.rand(shape, generator=gen).cuda()
            fb.launches = 0
            got = program(x)
            torch.cuda.synchronize()
            launched = fb.launches
            want = module.forward(x)
            err = float((got - want).abs().max())
            rng = float(want.max() - want.min())
            worst = max(worst, err / rng)
            total += launched
            log(f"[stages] export program at {shape}: max|d| vs eager VSUNet.forward {err:.3e} (range {rng:.3e}, "
                f"{err / rng:.2e} of it, bound 1e-6); fused forward launches {launched} (expected {per_call})")
            if tuple(got.shape) != (shape[0], 2, *shape[2:]) or not err <= 1e-6 * rng or launched != per_call:
                raise AssertionError(f"the exported program disagrees with the eager forward at {shape}")
        prog_ms = cuda_median_ms(lambda: program(x), runs=5)
        eager_ms = cuda_median_ms(lambda: module.forward(x), runs=5)
    log(f"[stages] export (configs/vscyto3d_predict.yml + export: stablehlo, embed_params): {export_s:.1f} s, "
        f"{out.stat().st_size / 2**20:.1f} MiB; forward at {EXPORT_SHAPES[-1]}: program {prog_ms:.2f} ms, eager "
        f"{eager_ms:.2f} ms (CUDA-event medians of 5) ({card})")
    return dict(launches=total, worst=worst)


def stage_precompute(card: str, tmp: Path, plate: Path) -> None:
    """``viscy-torch precompute`` of the fit plate; one FOV against numpy."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    out = tmp / "precomputed.zarr"
    cfg = _cli_config(tmp / "pc.yml", {"precompute": {"data_path": str(plate), "output_path": str(out),
                                                      "channel_names": list(CLI_CHANNELS)}})
    t0 = time.perf_counter()
    cli.main(["precompute", "-c", cfg])
    seconds = time.perf_counter() - t0
    src = open_ome_zarr(plate)["A/1/0"]
    raw, got = src["0"][:], open_ome_zarr(out)["A/1/0"]["0"][:]
    for c, ch in enumerate(CLI_CHANNELS):
        stats = src.zattrs["normalization"][ch]["fov_statistics"]
        want = (raw[:, c].astype(np.float32) - stats["mean"]) / (stats["std"] + 1e-8)
        if not np.array_equal(got[:, c], want):
            raise AssertionError(f"precomputed {ch} of A/1/0 differs from (x - mean) / (std + 1e-8)")
    nbytes = len(CLI_FIT_FOVS) * raw.nbytes
    log(f"[stages] precompute of the fit plate ({nbytes / 2**20:.0f} MiB read and written): {seconds:.2f} s = "
        f"{nbytes / seconds / 1e6:.1f} MB/s; A/1/0 equals (x - mean) / (std + 1e-8) bit for bit ({card})")
    shutil.rmtree(out)


class _Messages(logging.Handler):
    """A logging handler that keeps the messages it sees."""

    def __init__(self) -> None:
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def stage_mmap_fit(card: str, tmp: Path, plate: Path, plate_feed: dict) -> dict:
    """``viscy-torch fit`` with ``MmappedDataModule``, phase 9's overrides."""
    from viscy_tpu_torch.data.mmap_cache import stage_to_mmap
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    scratch = tmp / "scratch"
    names = [n for n, _ in open_ome_zarr(plate).positions()]
    t0 = time.perf_counter()
    views, cache = stage_to_mmap(plate, list(CLI_CHANNELS), scratch, include_fov_names=names)
    stage_s = time.perf_counter() - t0
    for name, view in zip(names, views):
        if not np.array_equal(view, open_ome_zarr(plate)[name]["0"][:]):
            raise AssertionError(f"staged {name} differs from the plate")
    done = (cache / ".done").stat().st_mtime_ns
    nbytes = sum(v.nbytes for v in views)
    del views
    root = tmp / "fit_mmap"
    cfg = _cli_config(tmp / "fit_mmap.yml", {
        "data": {"class_path": "viscy_data.MmappedDataModule",
                 "init_args": {"data_path": str(plate), "num_workers": 8, "scratch_dir": str(scratch)}},
        "trainer": {"default_root_dir": str(root), "max_epochs": 1, "limit_train_batches": FIT_STEPS,
                    "limit_val_batches": FIT_VAL},
    }, ROOT / "configs/vscyto3d_fit.yml")
    lines = _Messages()
    logging.getLogger("viscy_tpu_torch").addHandler(lines)
    try:
        torch.cuda.synchronize()
        fb.launches = fb.bwd_launches = warp3d.launches = 0
        t0 = time.perf_counter()
        trainer = cli.main(["fit", "-c", cfg])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        logging.getLogger("viscy_tpu_torch").removeHandler(lines)
    counts = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches)
    per_fwd = len(kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1]))
    want = dict(fwd=2 * per_fwd * (FIT_STEPS + FIT_VAL), bwd=2 * per_fwd * FIT_STEPS, warp=FIT_STEPS)
    reused = any(m.startswith("Reusing mmap cache") for m in lines.messages)
    if counts != want or not reused or (cache / ".done").stat().st_mtime_ns != done:
        raise AssertionError(f"mmap fit launched {counts} (expected {want}); cache reused: {reused}")
    feed = trainer.feed_stats
    val = trainer.logged_metrics.get("loss/validate")
    if feed["steps"] != FIT_STEPS or val is None or not math.isfinite(val):
        raise AssertionError(f"mmap fit ran {feed['steps']} steps, loss/validate {val}")
    patches = FIT_STEPS * TRAIN_BATCH
    log(f"[stages] mmap fit (configs/vscyto3d_fit.yml, MmappedDataModule): staged {nbytes / 2**20:.0f} MiB in "
        f"{stage_s:.2f} s ({nbytes / stage_s / 1e6:.1f} MB/s, bit-exact), the fit's prepare_data reused it; "
        f"{fit_s:.1f} s in all; train loop {feed['seconds']:.2f} s for {FIT_STEPS} steps = "
        f"{patches / feed['seconds']:.2f} patches/s, waited {feed['wait_s'] / feed['seconds']:.1%} of the loop "
        f"(phase 9's plate fit in this call: {patches / plate_feed['seconds']:.2f} patches/s, waited "
        f"{plate_feed['wait_s'] / plate_feed['seconds']:.1%}); launches A+B {counts['fwd']}, C+D {counts['bwd']}, "
        f"warp {counts['warp']} (expected {want['fwd']}/{want['bwd']}/{want['warp']}); loss/validate {val:.5f} "
        f"({card})")
    return dict(counts=counts, feed=dict(feed))


H1_TIMED = 5  # timed repeats of each crop route on one batch's origins


def _copy_rate(nbytes: int, threads: int) -> float:
    """Bytes a second (read plus written) of ``np.copyto`` of ``nbytes`` on
    this host, on ``threads`` threads at once, each its own buffers (best of
    three)."""
    import threading

    bufs = [(np.ones(nbytes // 4, np.float32), np.empty(nbytes // 4, np.float32)) for _ in range(threads)]
    best = math.inf
    for _ in range(3):
        ths = [threading.Thread(target=np.copyto, args=(d, s)) for s, d in bufs]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        best = min(best, time.perf_counter() - t0)
    return 2 * nbytes * threads / best


def _draw_origins(ds, rng: np.random.Generator, cdf_vx: tuple, z: int) -> tuple[np.ndarray, tuple]:
    """(the (4, 3) origins, the patch) of a pushdown crop at window ``z``,
    drawn from ``rng`` as ``SlidingWindowDataset._get_item_pushdown`` draws
    them after its CDF."""
    from viscy_tpu_torch.data.sliding_window import _sample_origins_from_cdf

    cz, cy, cx = ds.pushdown_crop.spatial_size
    cz = min(cz, ds.z_window_size)
    ys_xs = _sample_origins_from_cdf(*cdf_vx, ds.pushdown_crop.num_samples, rng)
    z_full = cz >= ds.z_window_size
    origins = np.array([(z + (0 if z_full else int(rng.integers(0, ds.z_window_size - cz + 1))), ys, xs)
                        for ys, xs in ys_xs], np.int64)
    return origins, (cz, cy, cx)


def _item_crop(ds, i: int) -> tuple[np.ndarray, int, tuple, np.random.Generator, int]:
    """(the preloaded (C, Z, Y, X) FOV, its window z, the CDF cache key,
    the item's random stream, the weight channel) of train item ``i`` at
    epoch 0."""
    img, tz, _, arr_idx = ds._find_window(i)
    t, z = ds._tz(img, tz)
    return ds._preloaded[arr_idx][t], z, (arr_idx, t, z), np.random.default_rng((ds.seed, 0, i)), len(
        ds.channels["source"])


def _h1_batch(ds, items: list[int]) -> list[tuple[np.ndarray, np.ndarray, tuple]]:
    """(preloaded FOV, (4, 3) origins, patch) of each item of one batch."""
    from viscy_tpu_torch.data.sliding_window import _weighted_origin_cdf

    out = []
    for i in items:
        full, z, _, rng, w = _item_crop(ds, i)
        cdf_vx = _weighted_origin_cdf(full[w, z:z + ds.z_window_size], ds.pushdown_crop.spatial_size[1:])
        out.append((full, *_draw_origins(ds, rng, cdf_vx, z)))
    return out


def h1_checks(card: str, ds, num_workers: int) -> dict:
    """Host kernel H1 on one train batch's origins from the preloaded FOVs:
    against its plain version and against the per-patch copies it replaces,
    bit for bit; ms per batch of each; its host bound (bytes read plus
    written at one ``np.copyto``'s rate, on one thread and on all); and the
    thread count a call: one per hardware thread (JAX's default) against
    ``max(1, cores // num_workers)``, with ``num_workers`` loader threads
    cropping at once."""
    import threading

    from viscy_tpu_torch import native

    batch = _h1_batch(ds, list(range(TRAIN_BATCH // ds.pushdown_crop.num_samples)))

    def kernel(n_threads=ds.crop_threads):
        return [native.batched_crop_normalize(f, o, p, n_threads=n_threads) for f, o, p in batch]

    def plain():
        return [native.batched_crop_normalize_plain(f, o, p) for f, o, p in batch]

    def copies():
        return [np.stack([np.ascontiguousarray(f[:, z0:z0 + p[0], y0:y0 + p[1], x0:x0 + p[2]], dtype=np.float32)
                          for z0, y0, x0 in o]) for f, o, p in batch]

    got, want, per_patch = kernel(), plain(), copies()
    if not all(a.tobytes() == b.tobytes() == c.tobytes() for a, b, c in zip(got, want, per_patch)):
        raise AssertionError("H1 differs from its plain version or from the per-patch copies")
    times = {}
    for name, fn in (("h1", kernel), ("h1_all", lambda: kernel(0)), ("plain", plain), ("copies", copies)):
        runs = []
        for _ in range(H1_TIMED):
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        times[name] = statistics.median(runs) * 1e3
    nbytes = 2 * sum(a.nbytes for a in got)  # each patch voxel read once and written once
    cores = len(os.sched_getaffinity(0))
    rate1, rate_all = _copy_rate(nbytes // 2, 1), _copy_rate(nbytes // (2 * cores), cores)
    bound1, bound_all = nbytes / rate1 * 1e3, nbytes / rate_all * 1e3
    # the loader's case: num_workers threads each cropping its own items
    per_call = {}
    for n_threads in (0, max(1, cores // num_workers)):
        def crop(k):
            for _ in range(H1_TIMED):
                f, o, p = batch[k % len(batch)]
                native.batched_crop_normalize(f, o, p, n_threads=n_threads)

        ths = [threading.Thread(target=crop, args=(k,)) for k in range(num_workers)]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        per_call[n_threads] = (time.perf_counter() - t0) / (num_workers * H1_TIMED) * 1e3
    calls = len(batch)
    log(f"[stages] H1 on one batch's origins ({calls} calls of {batch[0][1].shape[0]} patches of "
        f"(3, {', '.join(map(str, batch[0][2]))}) f32 from the preloaded FOVs): bit for bit against its plain version "
        f"and the per-patch copies; ms per batch: H1 {times['h1']:.3f} ({ds.crop_threads or 'one a hardware'} "
        f"thread(s) a call; {times['h1_all']:.3f} at one a hardware thread), plain {times['plain']:.3f}, "
        f"per-patch copies {times['copies']:.3f}; host bound "
        f"{nbytes / 2**20:.0f} MiB read + written: {bound1:.3f} ms at one np.copyto's {rate1 / 1e9:.2f} GB/s, "
        f"{bound_all:.3f} ms at {cores} threads' {rate_all / 1e9:.2f} GB/s ({card})")
    log(f"[stages] H1 with {num_workers} loader threads cropping at once: {per_call[0]:.3f} ms a call at one "
        f"thread a hardware thread (JAX's default) against {per_call[max(1, cores // num_workers)]:.3f} ms at "
        f"max(1, {cores} // {num_workers}) = {max(1, cores // num_workers)} thread(s) a call; the dataset runs "
        f"{ds.crop_threads or 'one a hardware'} ({card})")
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    return dict(ms=times["h1"] / calls, plain_ms=times["plain"] / calls, copies_ms=times["copies"] / calls,
                batch_ms=times, bound_ms=bound_all / calls, bound1_ms=bound1 / calls, per_call=per_call,
                max_abs_err=err)


def cached_item_split(card: str, ds, items: int = 16) -> dict:
    """The cached fit's item time, split: the origin CDF (cached, and once
    uncached), the origin draws, the crop (H1) and the sample assembly (the
    rest), medians over ``items`` items of epoch 0."""
    from viscy_tpu_torch import native
    from viscy_tpu_torch.data.sliding_window import _weighted_origin_cdf

    items = min(items, len(ds))
    parts = {k: [] for k in ("item", "cdf", "draws", "crop")}
    uncached = None
    for i in range(items):
        t0 = time.perf_counter()
        ds.get_item_with_epoch(i, 0)
        parts["item"].append(time.perf_counter() - t0)
        full, z, key, rng, w = _item_crop(ds, i)
        t0 = time.perf_counter()
        cdf_vx = ds._origin_cdf_cache[key]
        parts["cdf"].append(time.perf_counter() - t0)
        if uncached is None:
            t0 = time.perf_counter()
            _weighted_origin_cdf(full[w, z:z + ds.z_window_size], ds.pushdown_crop.spatial_size[1:])
            uncached = time.perf_counter() - t0
        t0 = time.perf_counter()
        origins, patch = _draw_origins(ds, rng, cdf_vx, z)
        parts["draws"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        native.batched_crop_normalize(full, origins, patch, n_threads=ds.crop_threads)
        parts["crop"].append(time.perf_counter() - t0)
    ms = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
    ms["assembly"] = max(0.0, ms["item"] - ms["cdf"] - ms["draws"] - ms["crop"])
    log(f"[stages] cached fit, one train item ({ds.pushdown_crop.num_samples} patches), median of {items}: "
        f"{ms['item']:.3f} ms = CDF {ms['cdf']:.4f} (cached; {uncached * 1e3:.1f} uncached, once a window) + origin "
        f"draws {ms['draws']:.3f} + crop (H1) {ms['crop']:.3f} + sample assembly {ms['assembly']:.3f} ({card})")
    return dict(ms, cdf_uncached=uncached * 1e3)


def stage_cached_fit(card: str, tmp: Path, plate: Path, plate_feed: dict, mmap_feed: dict) -> dict:
    """``viscy-torch fit -c configs/vscyto3d_fit.yml`` with phase 9's
    overrides and ``data.init_args.caching: true``: the FOVs preloaded, the
    weighted crop pushed down to the preloaded views and cut by host kernel
    H1; launch counts of the fused kernels, the warp and H1; patches/s and
    the loader-wait share beside phase 9's and the memory-mapped fit's; the
    item time split; H1 on one batch (:func:`h1_checks`)."""
    from viscy_tpu_torch import native
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d
    from viscy_tpu_torch.training import cli

    root = tmp / "fit_cached"
    cfg = _cli_config(tmp / "fit_cached.yml", {
        "data": {"init_args": {"data_path": str(plate), "num_workers": 8, "caching": True}},
        "trainer": {"default_root_dir": str(root), "max_epochs": 1, "limit_train_batches": FIT_STEPS,
                    "limit_val_batches": FIT_VAL},
    }, ROOT / "configs/vscyto3d_fit.yml")
    torch.cuda.synchronize()
    fb.launches = fb.bwd_launches = warp3d.launches = native.launches["crop_norm"] = 0
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", cfg])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches, h1=native.launches["crop_norm"])
    per_fwd = len(kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1]))
    want = dict(fwd=2 * per_fwd * (FIT_STEPS + FIT_VAL), bwd=2 * per_fwd * FIT_STEPS, warp=FIT_STEPS)
    dm = trainer._active_datamodule
    ds = dm.train_dataset
    items = FIT_STEPS * TRAIN_BATCH // ds.pushdown_crop.num_samples  # H1 runs once an item the loop takes
    if {k: counts[k] for k in want} != want or counts["h1"] < items:
        raise AssertionError(f"cached fit launched {counts} (expected {want} and H1 at least {items})")
    feed = trainer.feed_stats
    val = trainer.logged_metrics.get("loss/validate")
    if feed["steps"] != FIT_STEPS or val is None or not math.isfinite(val):
        raise AssertionError(f"cached fit ran {feed['steps']} steps, loss/validate {val}")
    nbytes = sum(v.nbytes for v in ds._preloaded) + sum(v.nbytes for v in dm.val_dataset._preloaded)
    patches = FIT_STEPS * TRAIN_BATCH
    log(f"[stages] cached fit (configs/vscyto3d_fit.yml, caching: true, {nbytes / 2**30:.2f} GiB preloaded, the "
        f"weighted crop pushed down, H1 {ds.crop_threads or 'one thread a hardware thread'} a call): {fit_s:.1f} s in "
        f"all; train loop {feed['seconds']:.2f} s for {FIT_STEPS} steps = {patches / feed['seconds']:.2f} patches/s, "
        f"waited {feed['wait_s'] / feed['seconds']:.1%} of the loop (phase 9's plate fit: "
        f"{patches / plate_feed['seconds']:.2f} patches/s, waited {plate_feed['wait_s'] / plate_feed['seconds']:.1%}; "
        f"the memory-mapped fit: {patches / mmap_feed['seconds']:.2f} patches/s, waited "
        f"{mmap_feed['wait_s'] / mmap_feed['seconds']:.1%}); launches A+B {counts['fwd']}, C+D {counts['bwd']}, warp "
        f"{counts['warp']} (expected {want['fwd']}/{want['bwd']}/{want['warp']}), H1 {counts['h1']} (the loop's "
        f"{items} items and the loader's read-ahead); loss/validate {val:.5f} ({card})")
    split = cached_item_split(card, ds)
    h1 = h1_checks(card, ds, dm.num_workers)
    del trainer, dm, ds
    return dict(counts=counts, feed=dict(feed), split=split, h1=h1)


def check_event_file(card: str, root: Path) -> None:
    """A run (phase 9's fit, the test stage) wrote a TensorBoard event file
    beside its metrics.csv: framing CRCs hold and it holds every value of
    the CSV, in order."""
    (path,) = root.glob("events.out.tfevents.*")
    version, scalars = read_event_file(path)
    rows = [json.loads(line) for line in (root / "metrics.csv").read_text().splitlines()]
    csv = [(r["step"], k, float(np.float32(v))) for r in rows for k, v in r.items() if k != "step"]
    if version != "brain.Event:2" or scalars != csv:
        raise AssertionError(f"event file {path.name}: version {version}, {len(scalars)} scalars vs {len(csv)} "
                             "CSV values")
    log(f"[stages] TensorBoard: {root.name}/{path.name} ({path.stat().st_size} bytes): every record's CRCs "
        f"hold; {len(scalars)} scalars, the {len(csv)} values of metrics.csv in order ({card})")


def phase_stages(card: str, tmp: Path, cli_info: dict) -> dict:
    """Phase 10: ``test``, ``export``, ``precompute``, the memory-mapped fit and
    the event file, on phase 9's plate and checkpoint (see the module
    docstring)."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.instantiate import instantiate
    from viscy_tpu_torch.training.trainer import read_checkpoint

    plate, ckpt = cli_info["fit_plate"], cli_info["ckpt"]
    module = instantiate(load_composed_config(ROOT / "configs/vscyto3d_predict.yml")["model"])
    module.model.load_state_dict(read_checkpoint(ckpt)[1])
    module.eval()
    test = stage_test(card, tmp, plate, ckpt, module)
    export = stage_export(card, tmp, ckpt, module)
    del module
    torch.cuda.empty_cache()
    stage_precompute(card, tmp, plate)
    mmap = stage_mmap_fit(card, tmp, plate, cli_info["feed"])
    cached = stage_cached_fit(card, tmp, plate, cli_info["feed"], mmap["feed"])
    for root in (cli_info["fit_root"], tmp / "test"):
        check_event_file(card, root)
    worst: dict = {}
    shapes = kernel_shapes(FLAGSHIP, CLI_FIT_ZYX[-1])
    for k, (s, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
        check_forward(1, s, c, m, 400 + k, (False,), worst)
    log_worst("the test path's shapes (B=1, full 1024^2 frames)", worst)
    return dict(test=test["counts"], export=export["launches"], mmap=mmap["counts"], cached=cached,
                max_abs_err=worst[torch.float32][0])


def shipped_model_config(name: str) -> dict:
    """The ``model_config`` of a shipped config, lists as tuples."""
    from viscy_tpu_torch.training.compose import load_composed_config

    cfg = load_composed_config(ROOT / "configs" / name)["model"]["init_args"]["model_config"]
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}


def _train_crop(yx: int) -> dict:
    """The smoke's own crop of both shipped configs (they have none, and the
    plate's FOVs are larger than ``yx_patch_size``, which the data module
    checks in training): a random ``yx``^2 crop put first in the training
    augmentations. Validation runs on whole frames, as the configs say."""
    return {"class_path": "viscy_transforms.BatchedRandSpatialCropd",
            "init_args": {"keys": ["source", "target"], "roi_size": [-1, yx, yx]}}


def _fused_launches(cfg: dict, yx: int, batch: int) -> int:
    """Forward launches (passes A and B) of one forward of ``cfg`` at
    ``yx``^2 and ``batch``: two per launch of at most
    ``samples_per_launch`` samples, for every fused call."""
    from viscy_tpu_torch.ops import fused_block as fb

    return sum(2 * -(-batch // fb.samples_per_launch(s, m)) for s, _, m in kernel_shapes(cfg, yx))


def _zero_counts() -> None:
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d

    torch.cuda.synchronize()
    fb.launches = fb.bwd_launches = fb.masked_launches = fb.masked_bwd_launches = warp3d.launches = 0


def _counts() -> dict:
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d

    torch.cuda.synchronize()
    return dict(fwd=fb.launches, bwd=fb.bwd_launches, masked_fwd=fb.masked_launches,
                masked_bwd=fb.masked_bwd_launches, warp=warp3d.launches)


def pretrain_kernels(cfg: dict, card: str) -> dict:
    """Phase 11 (a): the masked forward and backward kernels at the
    pretraining encoder's four (S, C, M) at batch 32 against their plain
    versions (:func:`check_forward`, :func:`check_backward`: f32 and bf16,
    a masked case each), then bf16 CUDA-event medians per step beside the
    plain versions and the bounds."""
    from viscy_tpu_torch.ops import fused_block as fb

    batch = PRETRAIN_BATCH
    shapes = kernel_shapes(cfg, PRETRAIN_YX)[: sum(cfg["encoder_blocks"])]
    worst: dict = {}
    bwd_worst = 0.0
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bwd_ms=0.0, bwd_plain_ms=0.0, bwd_bound_ms=0.0,
                 busy_ms=0.0, bwd_busy_ms=0.0)
    for k, (s, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
        check_forward(batch, s, c, m, 700 + k, (True,), worst)
        bwd_worst = max(bwd_worst, check_backward(batch, s, c, m, 800 + k, True))
        args, mask = block_inputs(batch, s, c, m, torch.bfloat16, seed=900 + k, masked=True)
        x, sc, *params = args
        mask_f = fb._check_cuda_args(x, sc, params, mask)
        ss = fb._reference_ss(x, *params[:4], mask, 1e-6)
        times = dict(
            ms=cuda_median_ms(lambda: fb.fused_mlp_grn(*args, mask=mask)),
            plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn(*args, mask=mask), runs=5),
            bound_ms=block_bound_ms(batch, s, c, m, torch.bfloat16, masked=True)[0],
            bwd_ms=cuda_median_ms(lambda: fb._fused_bwd_cuda(x, sc, params, mask_f, ss, 1e-6, 1e-6)),
            bwd_plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn_bwd(x, sc, *params, ss, mask=mask), runs=5),
            # 8 B S C M operations at the bf16 peak (the bytes are far below)
            bwd_bound_ms=8.0 * batch * s * c * m / PEAK_FLOPS[torch.bfloat16] * 1e3,
            busy_ms=device_busy_ms(lambda: fb.fused_mlp_grn(*args, mask=mask)) or math.nan,
            bwd_busy_ms=device_busy_ms(lambda: fb._fused_bwd_cuda(x, sc, params, mask_f, ss, 1e-6, 1e-6)) or math.nan,
        )
        n = shapes.count((s, c, m))
        for key, val in times.items():
            total[key] += val * n
        log(f"[pretrain] time S={s} C={c} M={m} B={batch} bf16 masked x{n}/step: forward {times['ms']:.3f} ms "
            f"(device busy {times['busy_ms']:.3f}, plain {times['plain_ms']:.3f}, bound {times['bound_ms']:.4f}), "
            f"backward {times['bwd_ms']:.3f} ms (device busy {times['bwd_busy_ms']:.3f}, plain "
            f"{times['bwd_plain_ms']:.3f}, bound {times['bwd_bound_ms']:.4f})")
        del args, mask, x, sc, params, mask_f, ss
        torch.cuda.empty_cache()
    log(f"[pretrain] masked kernels per step ({len(shapes)} encoder calls, B={batch}, bf16): forward "
        f"{total['ms']:.3f} ms (device busy {total['busy_ms']:.3f}, plain {total['plain_ms']:.3f}, bound "
        f"{total['bound_ms']:.3f}), backward {total['bwd_ms']:.3f} ms (device busy {total['bwd_busy_ms']:.3f}, "
        f"plain {total['bwd_plain_ms']:.3f}, bound {total['bwd_bound_ms']:.3f}); CUDA-event medians, the busy "
        f"time by torch.profiler ({card})")
    log_worst(f"the pretraining encoder's shapes (B={batch}, masked)", worst)
    return dict(total, fwd_err=worst[torch.bfloat16][0], bwd_err=bwd_worst)


def pretrain_cross_check(cfg: dict) -> None:
    """Phase 11 (b): one f32 pretraining step of the full-width model at
    batch 2 (256^2, mask ratio 0.5, drop path 0.1 so the masked branch runs
    alone too), the card's kernels against the CPU's plain versions on the
    same weights, token mask and keep masks: the prediction, the loss and
    every parameter gradient within 2e-3 of the range and Pearson r > 0.9999;
    the card's masked launches counted."""
    from viscy_tpu_torch.apps.cytoland.engine import FcmaeUNet, MaskedMSELoss
    from viscy_tpu_torch.models.unet.fcmae import generate_mask

    cfg32 = dict(cfg, dtype="float32", encoder_drop_path_rate=0.1)
    make = lambda dev: FcmaeUNet(fit_mask_ratio=0.5, model_config=dict(cfg32), loss_function=MaskedMSELoss(),
                                 device=dev).train()
    on_card = make("cuda")
    randomize_grn(on_card, 95)
    on_cpu = make("cpu")
    on_cpu.load_state_dict(on_card.state_dict())
    g = torch.Generator().manual_seed(96)
    source = torch.rand((2, 1, cfg["in_stack_depth"], PRETRAIN_YX, PRETRAIN_YX), generator=g)
    mask = generate_mask(torch.Generator().manual_seed(97), 2, (PRETRAIN_YX,) * 2, on_card.model.total_stride, 0.5)
    n_blocks = sum(cfg["encoder_blocks"])
    keeps = torch.rand((n_blocks, 2), generator=g) < 0.9
    keeps[0] = torch.tensor([False, True])  # one dropped branch, and a kept one in the same block

    def step(module, dev):
        batch = {"source": source.to(dev), "target": source.to(dev)}
        pred, target, m = module.forward_fit_fcmae(batch, drop_path_masks=list(keeps.to(dev)), mask=mask.to(dev))
        loss = module._masked_loss(pred, target, m)
        loss.backward()
        return pred.detach().cpu(), float(loss.detach())

    t0 = time.perf_counter()
    cpu_pred, cpu_loss = step(on_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    _zero_counts()
    card_pred, card_loss = step(on_card, "cuda")
    counts = _counts()
    want = dict(masked_fwd=2 * n_blocks, masked_bwd=2 * n_blocks, fwd=2 * (n_blocks + 3), bwd=2 * (n_blocks + 3))
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"pretraining step launched {counts}, expected {want}")
    err, e_rel, r = compare(card_pred, cpu_pred)
    l_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not (e_rel <= 2e-3 and r > 0.9999 and l_rel <= 2e-3):
        raise AssertionError(f"pretraining prediction / loss on the card disagree with the CPU: {e_rel:.2e} of "
                             f"range, r={r:.8f}, loss rel {l_rel:.2e}")
    n_grads, worst = _compare_grads(on_card, on_cpu, {}, "pretraining step")
    log(f"[pretrain] f32 step (2, 1, {cfg['in_stack_depth']}, {PRETRAIN_YX}, {PRETRAIN_YX}), mask ratio 0.5, "
        f"drop path 0.1 ({int((~keeps).sum())} of {keeps.numel()} branches dropped), card kernels vs CPU plain: "
        f"prediction {e_rel:.2e} of range r={r:.8f}; loss {card_loss:.7f} vs {cpu_loss:.7f} (rel {l_rel:.2e}); "
        f"{n_grads} parameter gradients within 2e-3 of range and r > 0.9999, worst {worst[1]} {worst[0]:.2e}; "
        f"card launches {counts} (CPU step {cpu_s:.1f} s)")
    del on_card, on_cpu
    torch.cuda.empty_cache()


def grow_plate(plate: Path, card: str) -> None:
    """Add the seeded FOVs ``PRETRAIN_FOVS`` to phase 9's fit plate with the
    port's writer, then ``viscy-torch preprocess`` it again."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    t0 = time.perf_counter()
    store = open_ome_zarr(plate, mode="r+", channel_names=list(CLI_CHANNELS))
    rng = np.random.default_rng(11)
    for fov in PRETRAIN_FOVS:
        data = rng.random((1, len(CLI_CHANNELS), *CLI_FIT_ZYX), dtype=np.float32)
        store.create_position("A", "1", fov).create_image("0", data, chunks=(1, 1, 1, *CLI_FIT_ZYX[1:]))
    grow_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.main(["preprocess", "-c", _cli_config(plate.parent / "pp_grown.yml",
                                              {"data_path": str(plate), "num_workers": 8})])
    n = len(list(open_ome_zarr(plate).positions()))
    log(f"[pretrain] phase 9's fit plate grown by {len(PRETRAIN_FOVS)} seeded FOVs of (1, 3, "
        f"{', '.join(map(str, CLI_FIT_ZYX))}) in {grow_s:.1f} s, preprocessed again in "
        f"{time.perf_counter() - t0:.2f} s: {n} FOVs ({card})")


def _spy(cls, name: str, after):
    """Wrap ``cls.name`` so ``after(self, result)`` sees each call's result;
    returns a function that restores it."""
    orig = getattr(cls, name)

    def wrapped(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        after(self, out)
        return out

    setattr(cls, name, wrapped)
    return lambda: setattr(cls, name, orig)


def _timed_steps():
    """A CUDA event recorded on the current stream after each
    ``Trainer._train_step`` (no synchronize, so the loop runs as it would);
    returns (the step times in s, read once the fit is done, as a function;
    restore)."""
    from viscy_tpu_torch.training.trainer import Trainer

    def mark(*_):
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()

    ends: list = []
    mark()

    def times() -> list[str]:
        torch.cuda.synchronize()
        return [f"{a.elapsed_time(b) / 1e3:.3f}" for a, b in zip(ends[1:], ends[2:])]

    return times, _spy(Trainer, "_train_step", mark)


def pretrain_fit(card: str, tmp: Path, plate: Path, cfg: dict) -> dict:
    """Phase 11 (c): ``viscy-torch fit -c configs/fcmae_pretrain.yml`` with the
    data path, the crops and one epoch of 3 steps and 1 validation batch;
    every draw's masked share, the launches per step (masked apart), the
    rate and the wait share."""
    from viscy_tpu_torch.apps.cytoland.engine import FcmaeUNet
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config

    crop = _train_crop(PRETRAIN_YX)
    shipped = load_composed_config(ROOT / "configs/fcmae_pretrain.yml")
    augs = shipped["data"]["init_args"]["augmentations"]
    ratio = shipped["model"]["init_args"]["fit_mask_ratio"]
    if shipped["data"]["init_args"]["batch_size"] != PRETRAIN_BATCH:
        raise AssertionError(f"configs/fcmae_pretrain.yml no longer trains at batch {PRETRAIN_BATCH}")
    root = tmp / "pretrain"
    fit_cfg = _cli_config(tmp / "pretrain.yml", {
        "data": {"init_args": {"data_path": str(plate), "num_workers": 8, "augmentations": [crop] + augs}},
        "trainer": {"default_root_dir": str(root), "max_epochs": 1, "limit_train_batches": PRETRAIN_STEPS,
                    "limit_val_batches": PRETRAIN_VAL},
    }, ROOT / "configs/fcmae_pretrain.yml")
    shares = []
    restore = _spy(FcmaeUNet, "forward_fit_fcmae", lambda self, out: shares.append(out[2].float().mean()))
    step_times, restore_steps = _timed_steps()
    try:
        _zero_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["fit", "-c", fit_cfg])
        counts = _counts()
        fit_s = time.perf_counter() - t0
    finally:
        restore()
        restore_steps()
    steps = step_times()
    shares = [float(v) for v in shares]
    n_enc = sum(cfg["encoder_blocks"])
    n_dec = (len(cfg["dims"]) - 1) * cfg["decoder_conv_blocks"]
    passes = PRETRAIN_STEPS + PRETRAIN_VAL
    # validation on whole frames: no call there needs more than one launch
    if _fused_launches(cfg, CLI_FIT_ZYX[-1], PRETRAIN_BATCH) != 2 * (n_enc + n_dec):
        raise AssertionError("the pretraining validation's calls no longer fit one launch each")
    want = dict(fwd=2 * (n_enc + n_dec) * passes, bwd=2 * (n_enc + n_dec) * PRETRAIN_STEPS,
                masked_fwd=2 * n_enc * passes, masked_bwd=2 * n_enc * PRETRAIN_STEPS, warp=0)
    ckpt = root / "checkpoints" / "last"
    feed = trainer.feed_stats
    val = trainer.logged_metrics.get("loss/validate")
    share = lambda yx: (lambda n: int(n * ratio) / n)((yx // (cfg["stem_kernel_size"][-1] * 2 ** (len(cfg["dims"]) - 1))) ** 2)
    if (counts != want or shares != [share(PRETRAIN_YX)] * PRETRAIN_STEPS + [share(CLI_FIT_ZYX[-1])] * PRETRAIN_VAL
            or feed["steps"] != PRETRAIN_STEPS or not ckpt.resolve().exists() or val is None
            or not math.isfinite(val)):
        raise AssertionError(f"pretraining fit: launches {counts} (expected {want}), masked shares {shares}, "
                             f"{feed['steps']} steps, last -> {ckpt.resolve()}, loss/validate {val}")
    patches = PRETRAIN_STEPS * PRETRAIN_BATCH
    log(f"[pretrain] fit (configs/fcmae_pretrain.yml, batch {PRETRAIN_BATCH} of (1, 5, {PRETRAIN_YX}, "
        f"{PRETRAIN_YX}) from (5, {CLI_FIT_ZYX[1]}, {CLI_FIT_ZYX[2]}) windows, validation on whole (5, "
        f"{CLI_FIT_ZYX[1]}, {CLI_FIT_ZYX[2]}) windows, mask ratio {ratio}): {fit_s:.1f} s in "
        f"all; train loop {feed['seconds']:.2f} s for {PRETRAIN_STEPS} steps = {patches / feed['seconds']:.2f} "
        f"patches/s (first step included; steps 2-3 took {', '.join(steps)} s between CUDA events at step ends); "
        f"waited {feed['wait_s']:.2f} s = {feed['wait_s'] / feed['seconds']:.1%} of the loop; masked share of tokens {shares} (train steps, then validation); per step {n_enc} masked + "
        f"{n_dec} unmasked forward calls and as many backward (launches over the fit: A+B {counts['fwd']}, of "
        f"them masked {counts['masked_fwd']}; C+D {counts['bwd']}, masked {counts['masked_bwd']}; expected "
        f"{want}); loss/validate {val:.5f} ({card})")
    return dict(counts=counts, ckpt=ckpt)


def member_warp(prefix: str, what: str, aug_cfg: list, batch: int, shape: tuple, seed: int) -> float:
    """The warp kernel as an augmentation list's affine member calls it on
    a seeded (``batch``, 1 + 2, *``shape``) batch (source and target keys,
    in == out, the member's apply mask): the member's call is caught and the
    kernel held against its plain version on those arguments
    (:func:`check_warp`). Returns max|d|."""
    from viscy_tpu_torch.training.instantiate import instantiate
    from viscy_tpu_torch.transforms import Compose
    from viscy_tpu_torch.transforms import affine as taffine

    compose = Compose(instantiate(aug_cfg))
    calls = []
    orig = taffine.affine_warp_3d_keys
    taffine.affine_warp_3d_keys = lambda *a, **k: calls.append((a, k)) or orig(*a, **k)
    try:
        g = torch.Generator(device="cuda").manual_seed(seed)
        compose({"source": torch.rand((batch, 1, *shape), generator=g, device="cuda"),
                 "target": torch.rand((batch, 2, *shape), generator=g, device="cuda")}, g)
    finally:
        taffine.affine_warp_3d_keys = orig
    (args, kwargs), = calls
    vols, mats, out_shape, mode, offset, flips = args
    mask = kwargs.get("apply_mask")
    applied = batch if mask is None else int(mask.sum())
    return check_warp(f"[{prefix}] warp kernel as {what} ({batch}, 1+2, {', '.join(map(str, out_shape))}), "
                      f"{applied} of {batch} samples applied", vols, mats, vols[0].shape[-3:], out_shape, mode,
                      offset, flips, mask)


def finetune_warp(aug_cfg: list) -> float:
    """The warp kernel as the fine-tune's affine member calls it at depth 1
    ((32, 1 + 2, 1, 256, 256) in == out, the member's apply mask) against
    its plain version (:func:`member_warp`). Returns max|d|."""
    return member_warp("pretrain", "the fine-tune's affine calls it at depth 1", aug_cfg, PRETRAIN_BATCH,
                       (1, PRETRAIN_YX, PRETRAIN_YX), 91)


def chain_pretrain(card: str, tmp: Path, plate: Path, shipped_ckpt: Path) -> dict:
    """Phase 11 (d), first half. The shipped pair cannot be chained: the
    fine-tune's encoder-only load of (c)'s ``last`` must refuse it (the
    pretraining stem is (5, 4, 4) at depth 5, the fine-tune's (1, 2, 2) at
    depth 1). So ``fit -c configs/fcmae_pretrain.yml`` runs again with the
    fine-tune's stem (``stem_kernel_size``, ``in_stack_depth`` and
    ``z_window_size: 1``) for one step and no validation; returns its
    ``last`` and its launches."""
    from viscy_tpu_torch.apps.cytoland.engine import FcmaeUNet
    from viscy_tpu_torch.training import cli

    ft = shipped_model_config("vscyto2d_finetune.yml")
    try:
        FcmaeUNet(encoder_only=True, ckpt_path=str(shipped_ckpt), model_config=dict(ft), device="cuda").load_pretrained()
    except ValueError as err:
        if "stem kernels differ" not in str(err):
            raise
        refusal = str(err).split("; the ")[-1]
    else:
        raise AssertionError("the fine-tune's encoder-only load took the (5, 4, 4) pretraining stem")
    stem = {"stem_kernel_size": list(ft["stem_kernel_size"]), "in_stack_depth": ft["in_stack_depth"]}
    root = tmp / "pretrain_2d_stem"
    fit_cfg = _cli_config(tmp / "pretrain_2d_stem.yml", {
        "model": {"init_args": {"model_config": stem}},
        "data": {"init_args": {"data_path": str(plate), "num_workers": 8, "z_window_size": 1,
                               "augmentations": [_train_crop(PRETRAIN_YX)] + load_augs("fcmae_pretrain.yml")}},
        "trainer": {"default_root_dir": str(root), "max_epochs": 1, "limit_train_batches": 1,
                    "check_val_every_n_epoch": 2},
    }, ROOT / "configs/fcmae_pretrain.yml")
    _zero_counts()
    t0 = time.perf_counter()
    cli.main(["fit", "-c", fit_cfg])
    counts = _counts()
    fit_s = time.perf_counter() - t0
    n_enc = sum(ft["encoder_blocks"])
    ckpt = root / "checkpoints" / "last"
    if counts["masked_fwd"] != 2 * n_enc or counts["masked_bwd"] != 2 * n_enc or not ckpt.resolve().exists():
        raise AssertionError(f"pretraining with the fine-tune's stem: launches {counts}, last -> {ckpt.resolve()}")
    log(f"[pretrain] the fine-tune refuses the shipped pretraining's last ({refusal}); pretrained again with "
        f"the fine-tune's stem {stem} on (1, 1, {PRETRAIN_YX}, {PRETRAIN_YX}) at batch {PRETRAIN_BATCH}, 1 step: "
        f"{fit_s:.1f} s in all, launches {counts} ({card})")
    return dict(ckpt=ckpt, counts=counts)


def load_augs(name: str) -> list:
    from viscy_tpu_torch.training.compose import load_composed_config

    return load_composed_config(ROOT / "configs" / name)["data"]["init_args"]["augmentations"]


def finetune_fit(card: str, tmp: Path, plate: Path, ckpt: Path) -> dict:
    """Phase 11 (d): ``viscy-torch fit -c configs/vscyto2d_finetune.yml`` with
    ``ckpt_path`` at :func:`chain_pretrain`'s ``last``, the data path, the
    plate's name of the nuclei channel, the training crop and 3 steps and 1
    validation batch of whole 1024^2 frames (the fused calls at S = 512^2
    run as several launches, :func:`fused_block.samples_per_launch`, and
    are held against their plain versions at that batch); every
    ``encoder.*`` tensor checked bit for bit at the load; the rate, the
    wait share, the launches; then :func:`finetune_warp`."""
    from viscy_tpu_torch.apps.cytoland.engine import FcmaeUNet
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.trainer import read_checkpoint

    init = load_composed_config(ROOT / "configs/vscyto2d_finetune.yml")["data"]["init_args"]
    if init["batch_size"] != PRETRAIN_BATCH:
        raise AssertionError(f"configs/vscyto2d_finetune.yml no longer trains at batch {PRETRAIN_BATCH}")
    plate_name = lambda names: ["Nucleus" if n == "Nuclei" else n for n in names]
    norms = [dict(n, init_args=dict(n["init_args"], keys=plate_name(n["init_args"]["keys"])))
             for n in init["normalizations"]]
    augs = [_train_crop(PRETRAIN_YX)] + init["augmentations"]
    root = tmp / "finetune"
    fit_cfg = _cli_config(tmp / "finetune.yml", {
        "model": {"init_args": {"ckpt_path": str(ckpt)}},
        "data": {"init_args": {"data_path": str(plate), "num_workers": 8,
                               "target_channel": plate_name(init["target_channel"]), "normalizations": norms,
                               "augmentations": augs}},
        "trainer": {"default_root_dir": str(root), "max_epochs": 1, "limit_train_batches": PRETRAIN_STEPS,
                    "limit_val_batches": PRETRAIN_VAL},
    }, ROOT / "configs/vscyto2d_finetune.yml")
    loads = []
    state = lambda self: {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}
    orig_load = FcmaeUNet.load_pretrained

    def load_and_record(self):
        before = state(self)
        orig_load(self)
        loads.append((before, state(self)))

    FcmaeUNet.load_pretrained = load_and_record
    step_times, restore_steps = _timed_steps()
    try:
        _zero_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["fit", "-c", fit_cfg])
        counts = _counts()
        fit_s = time.perf_counter() - t0
    finally:
        FcmaeUNet.load_pretrained = orig_load
        restore_steps()
    steps = step_times()
    (before, after), = loads
    saved = read_checkpoint(ckpt)[1]
    enc = [k for k in after if k.startswith("encoder.")]
    other = [k for k in after if not k.startswith("encoder.")]
    differ = [k for k in other if k in saved and saved[k].shape == after[k].shape and not torch.equal(after[k], saved[k])]
    if not (enc and all(torch.equal(after[k], saved[k]) for k in enc)
            and all(torch.equal(after[k], before[k]) for k in other)):
        raise AssertionError("encoder-only load: an encoder tensor differs from the checkpoint's, or a decoder "
                             "or head tensor changed")
    cfg = shipped_model_config("vscyto2d_finetune.yml")
    n_calls = sum(cfg["encoder_blocks"]) + (len(cfg["dims"]) - 1) * cfg["decoder_conv_blocks"]
    val_launches = _fused_launches(cfg, CLI_FIT_ZYX[-1], PRETRAIN_BATCH)
    split = sorted({(s, c, m) for s, c, m in kernel_shapes(cfg, CLI_FIT_ZYX[-1])
                    if fb.samples_per_launch(s, m) < PRETRAIN_BATCH})
    if not split:
        raise AssertionError("the fine-tune's validation on whole frames no longer needs a split launch")
    want = dict(fwd=2 * n_calls * PRETRAIN_STEPS + val_launches * PRETRAIN_VAL, bwd=2 * n_calls * PRETRAIN_STEPS,
                masked_fwd=0, masked_bwd=0, warp=PRETRAIN_STEPS)
    feed = trainer.feed_stats
    val = trainer.logged_metrics.get("loss/validate")
    if counts != want or feed["steps"] != PRETRAIN_STEPS or val is None or not math.isfinite(val):
        raise AssertionError(f"fine-tune fit: launches {counts} (expected {want}), {feed['steps']} steps, "
                             f"loss/validate {val}")
    patches = PRETRAIN_STEPS * PRETRAIN_BATCH
    log(f"[pretrain] fine-tune (configs/vscyto2d_finetune.yml from the 2-D-stem pretraining's last, batch "
        f"{PRETRAIN_BATCH} of (1, 1, {PRETRAIN_YX}, {PRETRAIN_YX}), validation on whole (1, {CLI_FIT_ZYX[1]}, "
        f"{CLI_FIT_ZYX[2]}) frames, targets Nucleus + Membrane): encoder-only load copied all {len(enc)} encoder "
        f"tensors bit for bit and left all {len(other)} decoder and head tensors as built ({len(differ)} of "
        f"the same shape differ from the checkpoint's); {fit_s:.1f} s in all; train loop {feed['seconds']:.2f} s "
        f"for {PRETRAIN_STEPS} steps = {patches / feed['seconds']:.2f} patches/s (first step included; steps 2-3 "
        f"took {', '.join(steps)} s between CUDA events at step ends); waited {feed['wait_s']:.2f} s = "
        f"{feed['wait_s'] / feed['seconds']:.1%} of the loop; launches A+B {counts['fwd']} (validation "
        f"{val_launches} for {n_calls} calls: (S, C, M) {split} in launches of at most "
        f"{[fb.samples_per_launch(s, m) for s, _, m in split]} samples), C+D {counts['bwd']}, masked 0, warp {counts['warp']} at depth 1 (expected {want}); "
        f"loss/validate {val:.5f} ({card})")
    worst: dict = {}
    for k, (s, c, m) in enumerate(split):
        check_forward(PRETRAIN_BATCH, s, c, m, 950 + k, (False,), worst, ref_batch=8)
    log_worst(f"the fine-tune validation's split calls (B={PRETRAIN_BATCH}, whole frames)", worst)
    err = finetune_warp(augs)
    return dict(counts=counts, warp_err=err, fwd_err=worst[torch.bfloat16][0])


def phase_pretrain(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 11: FCMAE pretraining and the VSCyto2D fine-tune (see the module
    docstring)."""
    cfg = shipped_model_config("fcmae_pretrain.yml")
    kernels = pretrain_kernels(cfg, card)
    pretrain_cross_check(cfg)
    grow_plate(plate, card)
    pre = pretrain_fit(card, tmp, plate, cfg)
    chain = chain_pretrain(card, tmp, plate, pre["ckpt"])
    fine = finetune_fit(card, tmp, plate, chain["ckpt"])
    launches = {k: sum(run["counts"][k] for run in (pre, chain, fine)) for k in pre["counts"]}
    return dict(kernels=kernels, launches=launches, warp_err=fine["warp_err"], fwd_err=fine["fwd_err"])


# -- phase 12: UNeXt2, the released VSCyto3D architecture -------------------------------------


def unext2_shape_cfg(cfg: dict) -> dict:
    """A UNeXt2 ``model_config`` in the form :func:`kernel_shapes` reads."""
    from viscy_tpu_torch.models.components.blocks import convnext_arch

    depths, dims, _ = convnext_arch(cfg["backbone"])
    out_depth = cfg.get("out_stack_depth") or cfg["in_stack_depth"]
    return dict(stem_kernel_size=cfg["stem_kernel_size"], dims=dims, encoder_blocks=depths,
                decoder_conv_blocks=cfg["decoder_conv_blocks"],
                decoder_out=(out_depth + 2) * cfg["out_channels"] * 4 * cfg["head_expansion_ratio"])


def unext2_kernels(card: str) -> dict:
    """Phase 12 (a): the fused forward and backward kernels at the UNeXt2
    path's shapes against their plain versions (:func:`check_forward`,
    :func:`check_backward`): the train step's (B = 16, 384^2 patches) forward
    and backward, the predict tiles' (B = 49, 320^2) and the full 2048^2
    frame's (B = 1) forward; then bf16 CUDA-event medians per train step
    beside the plain versions and the bounds."""
    from viscy_tpu_torch.ops import fused_block as fb

    shape_cfg = unext2_shape_cfg(UNEXT2)
    train = kernel_shapes(shape_cfg, UNEXT2_PATCH[-1])
    distinct = sorted(set(train), key=train.index)
    worst: dict = {}
    bwd_worst = 0.0
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bwd_ms=0.0, bwd_plain_ms=0.0, bwd_bound_ms=0.0)
    for k, (s, c, m) in enumerate(distinct):
        check_forward(TRAIN_BATCH, s, c, m, 1000 + k, (False,), worst)
        bwd_worst = max(bwd_worst, check_backward(TRAIN_BATCH, s, c, m, 1100 + k, False))
        args, _ = block_inputs(TRAIN_BATCH, s, c, m, torch.bfloat16, seed=1200 + k)
        x, sc, *params = args
        g = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(1300 + k),
                        device="cuda").to(torch.bfloat16)
        ss = fb._reference_ss(x, *params[:4], None, 1e-6)
        times = dict(
            ms=cuda_median_ms(lambda: fb.fused_mlp_grn(*args)),
            plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn(*args), runs=5),
            bound_ms=block_bound_ms(TRAIN_BATCH, s, c, m, torch.bfloat16)[0],
            bwd_ms=cuda_median_ms(lambda: fb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6)),
            bwd_plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn_bwd(x, g, *params, ss), runs=5),
            bwd_bound_ms=8.0 * TRAIN_BATCH * s * c * m / PEAK_FLOPS[torch.bfloat16] * 1e3,
        )
        n = train.count((s, c, m))
        for key, val in times.items():
            total[key] += val * n
        log(f"[unext2] time S={s} C={c} M={m} B={TRAIN_BATCH} bf16 x{n}/step: forward {times['ms']:.3f} ms "
            f"(plain {times['plain_ms']:.3f}, bound {times['bound_ms']:.4f}), backward {times['bwd_ms']:.3f} ms "
            f"(plain {times['bwd_plain_ms']:.3f}, bound {times['bwd_bound_ms']:.4f})")
        del args, x, sc, params, g, ss
        torch.cuda.empty_cache()
    log_worst(f"the UNeXt2 train shapes (B={TRAIN_BATCH}, 384^2)", worst)
    for batch, yx in ((TILE_BATCH, TILE), (1, UNEXT2_FOV[-1])):
        shapes = kernel_shapes(shape_cfg, yx)
        for k, (s, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
            check_forward(batch, s, c, m, 1400 + yx + k, (False,), worst)
        log_worst(f"the UNeXt2 {'tile' if batch > 1 else 'full-frame'} shapes (B={batch}, {yx}^2)", worst)
    log(f"[unext2] fused kernels per train step ({len(train)} calls, B={TRAIN_BATCH}, bf16): forward "
        f"{total['ms']:.3f} ms (plain {total['plain_ms']:.3f}, bound {total['bound_ms']:.3f}), backward "
        f"{total['bwd_ms']:.3f} ms (plain {total['bwd_plain_ms']:.3f}, bound {total['bwd_bound_ms']:.3f}); "
        f"CUDA-event medians ({card})")
    return dict(total, fwd_err=worst[torch.bfloat16][0], bwd_err=bwd_worst)


def unext2_engine(cfg: dict, device: str, **kw):
    """``VSUNet("UNeXt2")`` with the flagship recipe's loss and optimizer:
    MixedLoss(0.5, 0, 0.5), AdamW lr 2e-5 with WarmupCosine (warmup 30)."""
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

    return VSUNet("UNeXt2", dict(cfg), loss_function=MixedLoss(l1_alpha=0.5, l2_alpha=0.0, ms_dssim_alpha=0.5),
                  lr=2e-5, schedule="WarmupCosine", warmup_steps=30, seed=0, device=device, **kw)


def unext2_cross_check(state: dict) -> None:
    """Phase 12 (b): f32, card kernels against the CPU's plain versions on
    the same weights: the forward on two 320^2 tiles, then one train step
    (MixedLoss; the loss and every parameter gradient)."""
    cfg32 = dict(UNEXT2, dtype="float32")
    on_card, on_cpu = unext2_engine(cfg32, "cuda"), unext2_engine(cfg32, "cpu")
    on_card.load_state_dict(state)
    on_cpu.load_state_dict(state)
    g = torch.Generator().manual_seed(1500)
    tiles = torch.rand((2, 1, UNEXT2["in_stack_depth"], TILE, TILE), generator=g)
    with torch.inference_mode():
        got = on_card.eval()(tiles.cuda()).cpu()
        t0 = time.perf_counter()
        want = on_cpu.eval()(tiles)
        cpu_fwd_s = time.perf_counter() - t0
    _, e_rel, r = compare(got, want)
    log(f"[unext2] f32 forward (2, 1, 5, {TILE}, {TILE}) card kernels vs CPU plain: {e_rel:.2e} of range "
        f"(bound 2e-3) r={r:.8f} (CPU forward {cpu_fwd_s:.1f} s)")
    if not (e_rel <= 2e-3 and r > 0.9999 and got.shape == (2, 2, 5, TILE, TILE)):
        raise AssertionError("UNeXt2 f32 forward on the card disagrees with the CPU")
    batch = {"source": tiles, "target": torch.rand((2, 2, UNEXT2["in_stack_depth"], TILE, TILE), generator=g)}
    _zero_counts()
    card_loss = on_card.train().training_loss({k: v.cuda() for k, v in batch.items()})
    card_loss.backward()
    counts = _counts()
    t0 = time.perf_counter()
    cpu_loss = on_cpu.train().training_loss(batch)
    cpu_loss.backward()
    cpu_s = time.perf_counter() - t0
    n_calls = len(kernel_shapes(unext2_shape_cfg(UNEXT2), TILE))
    if counts["fwd"] != 2 * n_calls or counts["bwd"] != 2 * n_calls:
        raise AssertionError(f"UNeXt2 f32 step launched {counts}, expected {2 * n_calls} forward and backward")
    card_loss, cpu_loss = float(card_loss.detach()), float(cpu_loss.detach())
    l_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    zero = {"model.head.conv.0.conv.bias": "model.head.conv.0.conv.weight"}
    n_grads, worst = _compare_grads(on_card, on_cpu, zero, "UNeXt2 f32 step")
    log(f"[unext2] f32 train step (2, 1, 5, {TILE}, {TILE}), MixedLoss, card kernels vs CPU plain: loss "
        f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {l_rel:.2e}); {n_grads} parameter gradients within 2e-3 of "
        f"range and r > 0.9999, worst {worst[1]} {worst[0]:.2e}; the head's conv0 bias (under the instance "
        f"norm) 0 up to rounding on both; card launches {counts} (CPU step {cpu_s:.1f} s)")
    if not l_rel <= 2e-3:
        raise AssertionError("UNeXt2 f32 train-step loss on the card disagrees with the CPU")
    del on_card, on_cpu
    torch.cuda.empty_cache()


def unext2_fit(card: str, module) -> dict:
    """Phase 12 (c): ``Trainer.fit`` of the bf16 model on the train phase's
    augmentation at depth 5 (seeded (16, 1|2, 6, 600, 600) stacks on the
    card, 6 the even depth the affine's z-scale of 1.3 needs for 5 slices,
    as the HCS datamodule widens it): one warm-up step, then timed rounds;
    launch counts, finite losses; then one profiled step (device busy
    share)."""
    from viscy_tpu_torch.training.trainer import Trainer

    gen = torch.Generator(device="cuda").manual_seed(1600)
    batch = {
        "source": torch.rand((TRAIN_BATCH, 1, *UNEXT2_STACK), generator=gen, device="cuda"),
        "target": torch.rand((TRAIN_BATCH, 2, *UNEXT2_STACK), generator=gen, device="cuda"),
    }
    n_steps = 1 + UNEXT2_ROUNDS * STEPS_PER_ROUND
    dm = _stack_datamodule(batch, n_steps + 1, production_aug(UNEXT2_PATCH))
    timer = _step_timer()
    trainer = Trainer(max_steps=n_steps, callbacks=[timer], log_every_n_steps=10**9,
                      checkpoint_every_n_epochs=10**9, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer.fit(module, dm)
    counts = _counts()
    total_s = time.perf_counter() - t0
    per_fwd = len(kernel_shapes(unext2_shape_cfg(UNEXT2), UNEXT2_PATCH[-1]))
    want = dict(fwd=2 * per_fwd * n_steps, bwd=2 * per_fwd * n_steps, masked_fwd=0, masked_bwd=0, warp=n_steps)
    losses = torch.stack(timer.losses).float().cpu()
    if counts != want or len(losses) != n_steps or not torch.isfinite(losses).all():
        raise AssertionError(f"UNeXt2 fit: launches {counts} (expected {want}), losses {losses.tolist()}")
    rates = [TRAIN_BATCH * STEPS_PER_ROUND / t for t in timer.rounds]
    steps_ms = [t / STEPS_PER_ROUND * 1e3 for t in timer.rounds]
    log(f"[unext2] fit: {n_steps} steps in {total_s:.1f} s, losses {', '.join(f'{v:.5f}' for v in losses.tolist())}; "
        f"launches A+B {counts['fwd']}, C+D {counts['bwd']}, warp {counts['warp']} (expected {want})")
    log(f"[unext2] train step, batch {TRAIN_BATCH}, {UNEXT2_STACK} -> {UNEXT2_PATCH}, bf16, MixedLoss(0.5, 0, "
        f"0.5) on bf16 inputs: patches/s per round {', '.join(f'{r:.4f}' for r in rates)}, median "
        f"{statistics.median(rates):.4f}; step latency median {statistics.median(steps_ms):.1f} ms; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    _zero_counts()
    profile_step(trainer, module, dm)
    extra = _counts()
    del batch, dm
    torch.cuda.empty_cache()
    return {k: counts[k] + extra[k] for k in counts}


def unext2_predict(card: str, module) -> dict:
    """Phase 12 (d): ``Trainer.predict`` of three seeded (1, 1, 5, 2048, 2048)
    FOVs with tile 320 (49 tiles in one forward), after one warm-up request:
    FOVs/s, request latency, launch counts, shapes and finiteness."""
    from viscy_tpu_torch.training.trainer import Trainer

    timer = _request_timer()
    trainer = Trainer(callbacks=[timer], device="cuda")
    trainer.predict(module, _FovDataModule(1, seed=1700, shape=UNEXT2_FOV))
    warm = timer.latencies[0]
    _zero_counts()
    preds = trainer.predict(module, _FovDataModule(N_REQUESTS, seed=1701, shape=UNEXT2_FOV), return_predictions=True)
    counts = _counts()
    wall = timer._last - timer.start
    for p in preds:
        if tuple(p.shape) != (1, 2, *UNEXT2_FOV[2:]) or not torch.isfinite(p).all():
            raise AssertionError(f"UNeXt2 prediction {tuple(p.shape)}, finite {bool(torch.isfinite(p).all())}")
    want = 2 * len(kernel_shapes(unext2_shape_cfg(UNEXT2), TILE)) * N_REQUESTS
    if counts["fwd"] != want or counts["bwd"] or counts["warp"]:
        raise AssertionError(f"UNeXt2 predict launched {counts}, expected {want} forward")
    log(f"[unext2] predict {N_REQUESTS} seeded {UNEXT2_FOV} FOVs, tile {TILE}, tile batch {TILE_BATCH}, bf16: "
        f"{N_REQUESTS / wall:.4f} FOVs/s; request latencies {', '.join(f'{t:.4f}' for t in timer.latencies)} s "
        f"(warm-up {warm:.3f} s); outputs (1, 2, {', '.join(map(str, UNEXT2_FOV[2:]))}) float32, finite; "
        f"launches A+B {counts['fwd']} ({card})")
    return counts


def unext2_cli(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 12 (e): ``viscy-torch fit`` and ``predict`` with
    ``model.init_args.architecture: UNeXt2`` and the released model config:
    ``configs/vscyto3d_fit.yml`` / ``vscyto3d_predict.yml`` composed, their
    model config replaced (not merged: the FCMAE keys do not apply) and
    ``z_window_size`` 5 (the host crop 5 deep); one epoch of 3 + 2 batches
    on phase 9's fit plate, then predict from ``last`` on a new seeded
    plate of one (1, 1, 7, 2048, 2048) FOV (three z-windows). Launch counts,
    the store's shape, finite values."""
    import yaml

    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr
    from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

    def config(name: str, edit) -> str:
        cfg = load_composed_config(ROOT / "configs" / name)
        init = cfg["model"]["init_args"]
        init["architecture"] = "UNeXt2"
        init["model_config"] = {k: list(v) if isinstance(v, tuple) else v for k, v in UNEXT2.items()}
        cfg["data"]["init_args"]["z_window_size"] = UNEXT2["in_stack_depth"]
        cfg["data"]["init_args"]["num_workers"] = 8
        edit(cfg)
        path = tmp / f"unext2_{name}"
        path.write_text(yaml.safe_dump(cfg))
        return str(path)

    root = tmp / "unext2_fit"

    def fit_edit(cfg):
        cfg["model"]["init_args"]["model_config"]["dtype"] = "bfloat16"
        init = cfg["data"]["init_args"]
        init["data_path"] = str(plate)
        for aug in init["augmentations"]:
            if aug["class_path"].endswith("HostRandWeightedCropd"):
                aug["init_args"]["spatial_size"][0] = UNEXT2["in_stack_depth"]
        cfg["trainer"].update(default_root_dir=str(root), max_epochs=1, limit_train_batches=FIT_STEPS,
                              limit_val_batches=FIT_VAL)

    fit_cfg = config("vscyto3d_fit.yml", fit_edit)
    pred_plate = build_hcs_plate(tmp / "unext2_predict.zarr", CLI_CHANNELS[:1], zyx_shape=UNEXT2_PREDICT_ZYX,
                                 num_timepoints=1, rows=("C",), cols=("3",), fovs=("0",), seed=9)
    cli.main(["preprocess", "-c", _cli_config(tmp / "pp_unext2.yml", {"data_path": str(pred_plate),
                                                                      "num_workers": 8})])
    store = tmp / "unext2_prediction.zarr"

    def pred_edit(cfg):
        cfg["data"]["init_args"]["data_path"] = str(pred_plate)
        cfg["trainer"]["callbacks"][0]["init_args"].update(output_store=str(store))
        cfg.pop("ckpt_path", None)

    pred_cfg = config("vscyto3d_predict.yml", pred_edit)
    ckpt = root / "checkpoints" / "last"
    _zero_counts()
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", fit_cfg])
    fit_counts = _counts()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.main(["predict", "-c", pred_cfg, "--ckpt_path", str(ckpt)])
    pred_counts = {k: v - fit_counts[k] for k, v in _counts().items()}
    pred_s = time.perf_counter() - t0
    shape_cfg = unext2_shape_cfg(UNEXT2)
    per_fwd = len(kernel_shapes(shape_cfg, 384))
    want_fit = dict(fwd=2 * per_fwd * FIT_STEPS + FIT_VAL * _fused_launches(shape_cfg, 384, TRAIN_BATCH),
                    bwd=2 * per_fwd * FIT_STEPS, masked_fwd=0, masked_bwd=0, warp=FIT_STEPS)
    windows = UNEXT2_PREDICT_ZYX[0] - UNEXT2["in_stack_depth"] + 1
    want_pred = dict(fwd=_fused_launches(shape_cfg, UNEXT2_PREDICT_ZYX[-1], 2) * (windows // 2)
                     + _fused_launches(shape_cfg, UNEXT2_PREDICT_ZYX[-1], 1) * (windows % 2),
                     bwd=0, masked_fwd=0, masked_bwd=0, warp=0)
    val = trainer.logged_metrics.get("loss/validate")
    out = open_ome_zarr(store)["C/3/0"]["0"][:]
    if (fit_counts != want_fit or pred_counts != want_pred or trainer.feed_stats["steps"] != FIT_STEPS
            or val is None or not math.isfinite(val) or out.shape != (1, 2, *UNEXT2_PREDICT_ZYX)
            or not np.isfinite(out).all()):
        raise AssertionError(f"UNeXt2 cli: fit launches {fit_counts} (expected {want_fit}), predict {pred_counts} "
                             f"(expected {want_pred}), loss/validate {val}, store {out.shape}")
    feed = trainer.feed_stats
    log(f"[unext2] viscy-torch fit (configs/vscyto3d_fit.yml with architecture UNeXt2, the released model "
        f"config in bf16, z_window_size 5): {fit_s:.1f} s in all, train loop {feed['seconds']:.2f} s for "
        f"{FIT_STEPS} steps = {FIT_STEPS * TRAIN_BATCH / feed['seconds']:.2f} patches/s, waited "
        f"{feed['wait_s'] / feed['seconds']:.1%}; loss/validate {val:.5f}; predict (f32, full "
        f"{UNEXT2_PREDICT_ZYX[-1]}^2 frames, "
        f"{windows} windows) {pred_s:.2f} s into a (1, 2, {', '.join(map(str, UNEXT2_PREDICT_ZYX))}) store, "
        f"finite; launches fit {fit_counts}, predict {pred_counts} ({card})")
    shutil.rmtree(store)
    shutil.rmtree(pred_plate)
    del trainer
    torch.cuda.empty_cache()
    return {k: fit_counts[k] + pred_counts[k] for k in fit_counts}


def phase_unext2(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 12: UNeXt2 at the released VSCyto3D config (see the module
    docstring)."""
    kernels = unext2_kernels(card)
    module = unext2_engine(dict(UNEXT2, dtype="bfloat16"), "cuda", bf16_loss=True, tile_yx=(TILE, TILE),
                           tile_batch=TILE_BATCH)
    randomize_grn(module, seed=1800)
    n_params = sum(p.numel() for p in module.parameters())
    log(f"[unext2] VSUNet UNeXt2 {UNEXT2}: {n_params} parameters")
    unext2_cross_check({k: v.float() for k, v in module.state_dict().items()})
    fit = unext2_fit(card, module)
    pred = unext2_predict(card, module.eval())
    del module
    torch.cuda.empty_cache()
    entry = unext2_cli(card, tmp, plate)
    launches = {k: fit[k] + pred[k] + entry[k] for k in fit}
    return dict(kernels=kernels, launches=launches)


# -- phase 13: DynaCLR's ContrastiveEncoder and its train step ---------------------------------


def dynaclr_aug(keys: tuple[str, str]):
    """One view's augmentation: the bench recipe's affine (``bench.py``), then
    ``configs/dynaclr_fit.yml``'s flip and contrast, then the center crop to
    (15, 224, 224) the triplet datamodule appends."""
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.instantiate import instantiate
    from viscy_tpu_torch.transforms import BatchedCenterSpatialCropd, BatchedRandAffined, Compose

    shipped = load_composed_config(ROOT / "configs/dynaclr_fit.yml")["data"]["init_args"]
    if list(shipped["source_channel"]) != list(keys):
        raise AssertionError(f"configs/dynaclr_fit.yml's channels are {shipped['source_channel']}, not {keys}")
    return Compose([
        BatchedRandAffined(keys=list(keys), prob=0.8, rotate_range=[3.14, 0.0, 0.0],
                           scale_range=[[0.9, 1.1], [0.9, 1.1], [0.9, 1.1]],
                           shear_range=[0.05, 0.05, 0.0, 0.05, 0.0, 0.05]),
        *instantiate(shipped["augmentations"]),
        BatchedCenterSpatialCropd(keys=list(keys), roi_size=list(DYNACLR_PATCH)),
    ])


def _dynaclr_datamodule(batch: dict, steps: int):
    """In-memory stand-in for the triplet datamodule: seeded anchor and
    positive patches on the card, each view augmented on its own draws."""
    from viscy_tpu_torch.data.gpu_aug import DeviceTransformDataModule

    keys = tuple(DYNACLR_CHANNELS)
    aug = dynaclr_aug(keys)

    class TripletStand(DeviceTransformDataModule):
        def train_dataloader(self):
            return [batch] * steps

        def device_transform(self, b: dict, generator: torch.Generator, stage: str = "train") -> dict:
            out = {}
            for view in ("anchor", "positive"):
                x = aug({k: b[view][:, i:i + 1] for i, k in enumerate(keys)}, generator)
                out[view] = torch.cat([x[k] for k in keys], dim=1)
            return out

    return TripletStand()


def dynaclr_module(device: str):
    """``configs/dynaclr_fit.yml``'s model node, instantiated as the CLI
    would (the encoder, NT-Xent at 0.07, lr 1e-3)."""
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.instantiate import instantiate

    node = load_composed_config(ROOT / "configs/dynaclr_fit.yml")["model"]
    return instantiate(dict(node, init_args=dict(node["init_args"], device=device)))


def dynaclr_cross_check(state: dict) -> None:
    """Phase 13 (b): one f32 step, card against CPU on the same weights and
    views (the fit's 32 seeded pairs, at the crop's (2, 15, 224, 224): the
    BatchNorms' statistics over that batch, as in the fit; over a handful of
    samples a near-constant channel amplifies rounding): the anchor's
    embedding and projection, the NT-Xent loss, every gradient (the three
    shifts a train-mode BatchNorm removes 0 up to rounding on both), and
    both BatchNorms' running statistics after the step."""
    on_card, on_cpu = dynaclr_module("cuda"), dynaclr_module("cpu")
    on_card.model.load_state_dict(state)
    on_cpu.model.load_state_dict(state)
    g = torch.Generator().manual_seed(1900)
    batch = {v: torch.rand((DYNACLR_BATCH, 2, *DYNACLR_PATCH), generator=g) for v in ("anchor", "positive")}
    results = []
    for module, dev in ((on_card, "cuda"), (on_cpu, "cpu")):
        module.train()
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        emb, proj = module.model(b["anchor"])
        loss = module.training_loss(b)
        loss.backward()
        results.append((emb.detach().cpu(), proj.detach().cpu(), float(loss.detach()), time.perf_counter() - t0))
    (emb_g, proj_g, loss_g, _), (emb_c, proj_c, loss_c, cpu_s) = results
    checks = {"embedding": compare(emb_g, emb_c), "projection": compare(proj_g, proj_c)}
    state_g, state_c = on_card.model.state_dict(), on_cpu.model.state_dict()
    for k in state_c:
        if k.startswith("projection.") and k.endswith(("running_mean", "running_var")):
            checks[k] = compare(state_g[k].cpu(), state_c[k])
    bad = {k: v for k, v in checks.items() if not (v[1] <= 2e-3 and v[2] > 0.9999)}
    l_rel = abs(loss_g - loss_c) / abs(loss_c)
    log(f"[dynaclr] f32 step ({DYNACLR_BATCH} pairs of (2, {', '.join(map(str, DYNACLR_PATCH))})), card vs CPU: "
        f"embedding {checks['embedding'][1]:.2e} of range, projection {checks['projection'][1]:.2e}, NT-Xent "
        f"{loss_g:.7f} vs {loss_c:.7f} (rel {l_rel:.2e}); running statistics of both BatchNorms after three "
        f"forwards worst {max(v[1] for k, v in checks.items() if 'running' in k):.2e} of range (CPU {cpu_s:.1f} s)")
    if bad or l_rel > 2e-3 or int(state_g["projection.1.num_batches_tracked"]) != 3:
        raise AssertionError(f"DynaCLR f32 step on the card disagrees with the CPU: {bad}, loss rel {l_rel:.2e}")
    zero = {f"model.{n}": f"model.{n.replace('bias', 'weight')}"
            for n in ("encoder.head.norm.bias", "projection.0.bias", "projection.3.bias")}
    n_grads, worst = _compare_grads(on_card, on_cpu, zero, "DynaCLR f32 step")
    log(f"[dynaclr] f32 step: {n_grads} parameter gradients within 2e-3 of range and r > 0.9999, worst "
        f"{worst[1]} {worst[0]:.2e}; the three shifts a train-mode BatchNorm removes 0 up to rounding on both")
    del on_card, on_cpu
    torch.cuda.empty_cache()


def dynaclr_warp(dm, batch: dict) -> float:
    """Phase 13 (c): the warp kernel as the anchor view's affine member calls
    it at 2 channels (the two channel keys in one launch) against its plain
    version on those arguments (:func:`check_warp`). Returns max|d|."""
    from viscy_tpu_torch.transforms import affine as taffine

    calls = []
    orig = taffine.affine_warp_3d_keys
    taffine.affine_warp_3d_keys = lambda *a, **k: calls.append((a, k)) or orig(*a, **k)
    try:
        dm.device_transform({"anchor": batch["anchor"], "positive": batch["positive"][:1]},
                            torch.Generator(device="cuda").manual_seed(1950))
    finally:
        taffine.affine_warp_3d_keys = orig
    (args, kwargs) = calls[0]
    vols, mats, out_shape, mode, offset, flips = args
    mask = kwargs.get("apply_mask")
    applied = len(mats) if mask is None else int(mask.sum())
    return check_warp(f"[dynaclr] warp kernel as the anchor view's affine calls it ({len(mats)}, 1+1, "
                      f"{', '.join(map(str, vols[0].shape[-3:]))}) -> {tuple(out_shape)}, {applied} samples "
                      f"applied", vols, mats, vols[0].shape[-3:], out_shape, mode, offset, flips, mask)


def phase_dynaclr(card: str) -> dict:
    """Phase 13: DynaCLR's contrastive train step at full width (see the
    module docstring)."""
    from viscy_tpu_torch.training.trainer import Trainer

    module = dynaclr_module("cuda")
    n_params = sum(p.numel() for p in module.parameters())
    log(f"[dynaclr] ContrastiveModule from configs/dynaclr_fit.yml: convnext_tiny, {n_params} parameters, "
        f"NT-Xent {module.loss_function.temperature}, lr {module.lr}")
    dynaclr_cross_check({k: v.clone() for k, v in module.model.state_dict().items()})
    gen = torch.Generator(device="cuda").manual_seed(2000)
    batch = {v: torch.rand((DYNACLR_BATCH, 2, *DYNACLR_STACK), generator=gen, device="cuda")
             for v in ("anchor", "positive")}
    n_steps = 1 + DYNACLR_ROUNDS * STEPS_PER_ROUND
    dm = _dynaclr_datamodule(batch, n_steps + 1)
    timer = _step_timer()
    trainer = Trainer(max_steps=n_steps, callbacks=[timer], log_every_n_steps=10**9,
                      checkpoint_every_n_epochs=10**9, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer.fit(module, dm)
    counts = _counts()
    total_s = time.perf_counter() - t0
    losses = torch.stack(timer.losses).float().cpu()
    want = dict(fwd=0, bwd=0, masked_fwd=0, masked_bwd=0, warp=2 * n_steps)
    if counts != want or len(losses) != n_steps or not torch.isfinite(losses).all():
        raise AssertionError(f"DynaCLR fit: launches {counts} (expected {want}), losses {losses.tolist()}")
    rates = [DYNACLR_BATCH * STEPS_PER_ROUND / t for t in timer.rounds]
    log(f"[dynaclr] fit: {n_steps} steps in {total_s:.1f} s, losses {', '.join(f'{v:.5f}' for v in losses.tolist())}; "
        f"warp launches {counts['warp']} (anchor and positive, expected {want['warp']})")
    log(f"[dynaclr] train step, {DYNACLR_BATCH} pairs of (2, {', '.join(map(str, DYNACLR_STACK))}) -> "
        f"(2, {', '.join(map(str, DYNACLR_PATCH))}), f32: cell pairs/s per round "
        f"{', '.join(f'{r:.4f}' for r in rates)}, median {statistics.median(rates):.4f}; step latency median "
        f"{statistics.median(t / STEPS_PER_ROUND * 1e3 for t in timer.rounds):.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    _zero_counts()
    profile_step(trainer, module, dm)
    extra = _counts()
    err = dynaclr_warp(dm, batch)
    del batch, dm, module, trainer
    torch.cuda.empty_cache()
    return dict(warp_launches=counts["warp"] + extra["warp"], warp_err=err)


# -- phase 14: DynaCLR from a plate and its track CSVs through the command line -------------------


def dynaclr_plate(tmp: Path, card: str) -> tuple[Path, Path]:
    """Phase 14 (a): the seeded plate, its normalization statistics
    (``preprocess``) and one tracking CSV a FOV; returns their paths."""
    import csv

    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    plate_path, tracks = tmp / "dynaclr.zarr", tmp / "tracks"
    rng = np.random.default_rng(14)
    t0 = time.perf_counter()
    plate = open_ome_zarr(plate_path, layout="hcs", mode="w", channel_names=list(DYNACLR_CHANNELS))
    shape = (DYNACLR_CLI_T, len(DYNACLR_CHANNELS), *DYNACLR_CLI_ZYX)
    lo, hi = DYNACLR_CLI_MARGIN + 44, DYNACLR_CLI_ZYX[1] - DYNACLR_CLI_MARGIN - 44
    for fov in DYNACLR_CLI_FOVS:
        img = plate.create_position("A", "1", fov).create_zeros("0", shape, np.float32, chunks=DYNACLR_CLI_CHUNKS)
        for t in range(shape[0]):
            img[t] = rng.random(shape[1:], dtype=np.float32)
        rows = []
        for cell in range(DYNACLR_CLI_CELLS):
            track_id = 3 + 7 * cell  # 3, 10, 17, ...: the string order is not the numeric one
            y, x = rng.uniform(lo, hi, 2)
            for t in range(shape[0]):
                rows.append([track_id, t, 100 * track_id + t, -1, -1, 32, f"{y + rng.uniform(-20, 20):.2f}",
                             f"{x + rng.uniform(-20, 20):.2f}"])
        (tracks / "A/1" / fov).mkdir(parents=True)
        with open(tracks / "A/1" / fov / "tracks.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["track_id", "t", "id", "parent_track_id", "parent_id", "z", "y", "x"])
            w.writerows(rows)
    write_s = time.perf_counter() - t0
    nbytes = len(DYNACLR_CLI_FOVS) * math.prod(shape) * 4
    t0 = time.perf_counter()
    cli.main(["preprocess", "-c", _cli_config(tmp / "pp_dynaclr.yml", {"data_path": str(plate_path),
                                                                      "num_workers": 8})])
    pp_s = time.perf_counter() - t0
    stats = open_ome_zarr(plate_path)["A/1/0"].zattrs["normalization"]["RFP"]["fov_statistics"]
    if not 0.45 < stats["mean"] < 0.55:
        raise AssertionError(f"preprocess statistics off: {stats}")
    log(f"[dynaclr-cli] plate: {len(DYNACLR_CLI_FOVS)} FOVs of {shape} f32 ({nbytes / 2**30:.2f} GiB, "
        f"uncompressed chunks of {DYNACLR_CLI_CHUNKS}) written in {write_s:.1f} s "
        f"({nbytes / write_s / 1e6:.0f} MB/s); preprocess {pp_s:.1f} s; {DYNACLR_CLI_CELLS} tracks a FOV over "
        f"{shape[0]} frames ({card})")
    return plate_path, tracks


def _dynaclr_fit(tmp: Path, name: str, plate: Path, tracks: Path, augmentations: list | None, card: str,
                 callbacks: list | None = None):
    """``fit -c configs/dynaclr_fit.yml`` with the paths, the root dir and
    the epoch's length overridden (and ``augmentations`` and the trainer's
    ``callbacks`` when given); returns the trainer, its root and the launch
    counts."""
    from viscy_tpu_torch.training import cli

    root = tmp / name
    data = {"data_path": str(plate), "tracks_path": str(tracks)}
    if augmentations is not None:
        data["augmentations"] = augmentations
    trainer_cfg = {"default_root_dir": str(root), "max_epochs": 1, "limit_train_batches": DYNACLR_CLI_STEPS,
                   "limit_val_batches": DYNACLR_CLI_VAL, "log_every_n_steps": 1}
    if callbacks is not None:
        trainer_cfg["callbacks"] = callbacks
    cfg = _cli_config(tmp / f"{name}.yml", {"data": {"init_args": data}, "trainer": trainer_cfg},
                      ROOT / "configs/dynaclr_fit.yml")
    torch.cuda.empty_cache()
    _zero_counts()
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", cfg])
    counts = _counts()
    total_s = time.perf_counter() - t0
    feed = trainer.feed_stats
    loss, val = trainer.logged_metrics.get("loss/train"), trainer.logged_metrics.get("loss/validate")
    if feed["steps"] != DYNACLR_CLI_STEPS or not (root / "checkpoints/last").resolve().exists() \
            or not all(v is not None and math.isfinite(v) for v in (loss, val)):
        raise AssertionError(f"DynaCLR fit ({name}): {feed['steps']} steps, losses {loss} / {val}")
    pairs = DYNACLR_CLI_STEPS * DYNACLR_BATCH
    log(f"[dynaclr-cli] fit ({name}): {total_s:.1f} s in all; train loop {feed['seconds']:.2f} s for "
        f"{DYNACLR_CLI_STEPS} steps of {DYNACLR_BATCH} = {pairs / feed['seconds']:.4f} cell pairs/s (first step "
        f"included; each step reads 2 x {DYNACLR_BATCH} windows of (2, 15, 512, 512), anchors and negatives: "
        f"the positive is the anchor's window); waited "
        f"{feed['wait_s']:.2f} s for batches = {feed['wait_s'] / feed['seconds']:.1%} of the loop; loss/train "
        f"{loss:.5f}, loss/validate {val:.5f}; launches {counts} ({card})")
    return trainer, root, counts


def dynaclr_host_split(dm, loop_s: float, card: str) -> None:
    """Phase 14 (b): where a step's host time goes. One training batch's
    ``__getitems__`` (anchors and negatives read, negatives drawn, norm meta
    collated) and its anchors' window reads alone, timed, with the bytes the
    windows keep and the bytes of the chunks they touch."""
    ds = dm.train_dataset
    idx = list(range(DYNACLR_BATCH))
    rows = ds.valid_anchors.take(np.asarray(idx))
    t0 = time.perf_counter()
    patches, _ = ds._slice_patches(rows)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds.__getitems__(idx)
    batch_s = time.perf_counter() - t0
    cz, cy, cx = DYNACLR_CLI_CHUNKS[2:]
    z = ds.z_range
    half = ds.yx_patch_size[0] // 2
    span = lambda lo, hi, c: (hi - 1) // c - lo // c + 1
    chunks = sum(span(z.start, z.stop, cz) * span(y - half, y + half, cy) * span(x - half, x + half, cx)
                 for y, x in zip(rows["y"].tolist(), rows["x"].tolist())) * len(ds.channel_indices)
    touched = chunks * cz * cy * cx * 4
    log(f"[dynaclr-cli] host split: one batch's __getitems__ {batch_s:.2f} s (2 x {DYNACLR_BATCH} window reads, "
        f"negatives drawn, norm meta); its {DYNACLR_BATCH} anchor windows alone {read_s:.2f} s: "
        f"{patches.nbytes / read_s / 1e6:.0f} MB/s kept ({patches.nbytes / 2**20:.0f} MiB) from {chunks} chunks "
        f"of {DYNACLR_CLI_CHUNKS} ({touched / 2**20:.0f} MiB touched, {touched / patches.nbytes:.2f}x); "
        f"the fit's loop took {loop_s / DYNACLR_CLI_STEPS:.2f} s a step ({card})")


def dynaclr_cli_warp(dm) -> float:
    """Phase 14 (c): the warp kernel as the datamodule's device transform
    calls it on the anchor view of one training batch (read from the plate),
    against its plain version (:func:`check_warp`); the view's normalized
    windows are rescaled to [0, 1] first (the warp is linear in its input,
    and the bound is stated for inputs in [0, 1])."""
    from viscy_tpu_torch.training.trainer import BatchPrefetcher
    from viscy_tpu_torch.transforms import affine as taffine

    host = [dm.train_dataset.__getitems__(list(range(DYNACLR_BATCH)))]
    (batch,) = list(BatchPrefetcher(host, torch.device("cuda")))
    view = {k: batch[k] for k in ("anchor", "anchor_norm_meta")}
    calls = []
    orig = taffine.affine_warp_3d_keys
    taffine.affine_warp_3d_keys = lambda *a, **k: calls.append((a, k)) or orig(*a, **k)
    try:
        dm.device_transform(view, torch.Generator(device="cuda").manual_seed(1414), "train")
    finally:
        taffine.affine_warp_3d_keys = orig
    (vols, mats, out_shape, mode, offset, flips), kwargs = calls[0]
    lo = min(float(v.min()) for v in vols)
    hi = max(float(v.max()) for v in vols)
    vols = [(v - lo) / (hi - lo) for v in vols]
    mask = kwargs.get("apply_mask")
    applied = len(mats) if mask is None else int(mask.sum())
    return check_warp(f"[dynaclr-cli] warp kernel as TripletDataModule.device_transform's anchor view calls it "
                      f"({len(mats)}, 1+1, {', '.join(map(str, vols[0].shape[-3:]))}) -> {tuple(out_shape)}, "
                      f"{applied} samples applied", vols, mats, vols[0].shape[-3:], out_shape, mode, offset, flips,
                      mask)


def _dynaclr_recompute(cfg: dict, ckpt: Path) -> tuple[np.ndarray, np.ndarray, list]:
    """``predict_step`` of the predict config's model and data on the card,
    batch by batch, outside the trainer: features, projections, index."""
    from viscy_tpu_torch.training.instantiate import instantiate
    from viscy_tpu_torch.training.trainer import BatchPrefetcher, read_checkpoint

    module = instantiate(dict(cfg["model"], init_args=dict(cfg["model"]["init_args"], device="cuda"))).eval()
    module.model.load_state_dict(read_checkpoint(ckpt)[1])
    dm = instantiate(cfg["data"])
    dm.setup("predict")
    feats, projs, index = [], [], []
    with torch.inference_mode():
        for batch in BatchPrefetcher(dm.predict_dataloader(), torch.device("cuda")):
            pred = module.predict_step(dm.device_transform(batch, None, "predict"))
            feats.append(pred["features"].float().cpu().numpy())
            projs.append(pred["projections"].float().cpu().numpy())
            index += batch["index"]
    return np.concatenate(feats), np.concatenate(projs), index


def dynaclr_predict(tmp: Path, plate: Path, tracks: Path, ckpt: Path, card: str) -> Path:
    """Phase 14 (d) and (e): predict into an embedding store, check it, and
    convert it with ``convert_to_anndata``; returns the store."""
    from viscy_tpu_torch.data.triplet import TripletDataModule
    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config

    store = tmp / "embeddings.zarr"
    shipped = load_composed_config(ROOT / "configs/dynaclr_predict.yml")
    writer = dict(shipped["trainer"]["callbacks"][0])
    writer["init_args"] = dict(writer["init_args"], output_path=str(store))
    data = {"data_path": str(plate), "tracks_path": str(tracks)}
    try:  # the shipped predict_cells: true with no (fov_name, track_id) pair selects no cell
        TripletDataModule(**dict(shipped["data"]["init_args"], **data)).setup("predict")
    except ValueError as e:
        log(f"[dynaclr-cli] the shipped predict_cells: true names no cell and is refused: {e}")
    else:
        raise AssertionError("predict_cells: true without include_fov_names was not refused")
    cfg_path = _cli_config(tmp / "dynaclr_predict.yml", {
        "data": {"init_args": {**data, "predict_cells": False}},
        "trainer": {"default_root_dir": str(tmp / "dynaclr_predict"), "callbacks": [writer]},
        "ckpt_path": str(ckpt),
    }, ROOT / "configs/dynaclr_predict.yml")
    torch.cuda.empty_cache()
    _zero_counts()
    t0 = time.perf_counter()
    cli.main(["predict", "-c", cfg_path])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    counts = _counts()
    got = read_anndata_zarr(store)
    n = got.n_obs
    want_n = len(DYNACLR_CLI_FOVS) * DYNACLR_CLI_T * DYNACLR_CLI_CELLS
    log(f"[dynaclr-cli] predict (configs/dynaclr_predict.yml, batch 64 of (2, 15, 224, 224)): {n} cells in "
        f"{pred_s:.2f} s = {n / pred_s:.2f} cells/s disk to store; store X {got.X.shape}, obsm "
        f"{ {k: v.shape for k, v in got.obsm.items()} }; launches {counts} ({card})")
    if n != want_n or sorted(got.obsm) != ["X_pca", "X_projections"] or any(counts.values()):
        raise AssertionError(f"embedding store: {n} cells (expected {want_n}), obsm {sorted(got.obsm)}, "
                             f"launches {counts}")
    feats, projs, index = _dynaclr_recompute(load_composed_config(Path(cfg_path)), ckpt)
    for key, have, want in (("X", got.X, feats), ("X_projections", got.obsm["X_projections"], projs)):
        err, rng = float(np.abs(have - want).max()), float(want.max() - want.min())
        log(f"[dynaclr-cli] store {key} against predict_step on the same windows: max|d|={err:.3e} "
            f"({err / rng:.2e} of range, bound 1e-6)")
        if have.shape != want.shape or not err <= 1e-6 * rng:
            raise AssertionError(f"embedding store {key} disagrees with predict_step")
    cols = [c for c in index[0]]
    for c in cols:
        want = [str(r[c]).strip("/") if c == "fov_name" else int(r[c]) for r in index]
        if got.obs.names != cols or got.obs[c].tolist() != want:
            raise AssertionError(f"embedding store obs {got.obs.names} / column {c} differs from the track index")
    x = got.X.astype(np.float64)
    u, sv, _ = np.linalg.svd(x - x.mean(axis=0), full_matrices=False)
    want = (u * sv)[:, : got.obsm["X_pca"].shape[1]]
    have = got.obsm["X_pca"].astype(np.float64)
    want *= np.sign((have * want).sum(axis=0))
    err = float(np.abs(have - want).max() / (want.max() - want.min()))
    log(f"[dynaclr-cli] store obs equals the track index ({len(cols)} columns, {n} rows); X_pca "
        f"{have.shape} against a float64 SVD on the CPU: {err:.2e} of range (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"X_pca off by {err:.2e} of range")

    out = tmp / "embeddings_anndata.zarr"
    t0 = time.perf_counter()
    cli.main(["convert_to_anndata", "-c", _cli_config(tmp / "convert.yml", {
        "convert": {"embeddings_path": str(store), "output_path": str(out)}})])
    conv_s = time.perf_counter() - t0
    back = read_anndata_zarr(out)
    same = (np.array_equal(back.X, got.X) and list(back.obsm) == ["X_projections"]
            and np.array_equal(back.obsm["X_projections"], got.obsm["X_projections"])
            and back.obs.names == got.obs.names and back.obs.index.tolist() == got.obs.index.tolist()
            and all(back.obs[c].tolist() == got.obs[c].tolist() for c in got.obs.names))
    log(f"[dynaclr-cli] convert_to_anndata: {conv_s:.2f} s; X, X_projections and obs read back "
        f"{'bit for bit' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("convert_to_anndata's store differs from the embedding store")
    return store


def phase_dynaclr_cli(card: str, tmp: Path) -> dict:
    """Phase 14: DynaCLR from a plate and its track CSVs to an AnnData
    embedding store through the command line (see the module docstring)."""
    from viscy_tpu_torch.training.compose import load_composed_config

    plate, tracks = dynaclr_plate(tmp, card)
    trainer, root, shipped_counts = _dynaclr_fit(tmp, "dynaclr_fit", plate, tracks, None, card)
    if any(shipped_counts.values()):
        raise AssertionError(f"the shipped DynaCLR fit launched {shipped_counts} (no kernel expected)")
    dynaclr_host_split(trainer._active_datamodule, trainer.feed_stats["seconds"], card)
    del trainer
    augs = [BENCH_AFFINE, *load_composed_config(ROOT / "configs/dynaclr_fit.yml")["data"]["init_args"]["augmentations"]]
    trainer, _, counts = _dynaclr_fit(tmp, "dynaclr_fit_affine", plate, tracks, augs, card)
    want = dict(fwd=0, bwd=0, masked_fwd=0, masked_bwd=0, warp=3 * (DYNACLR_CLI_STEPS + DYNACLR_CLI_VAL))
    if counts != want:
        raise AssertionError(f"the DynaCLR fit with the bench affine launched {counts}, expected {want}")
    err = dynaclr_cli_warp(trainer._active_datamodule)
    del trainer
    torch.cuda.empty_cache()
    store = dynaclr_predict(tmp, plate, tracks, root / "checkpoints/last", card)
    shutil.rmtree(store)
    return dict(warp_launches=counts["warp"], warp_err=err, plate=plate, tracks=tracks,
                affine_ckpt=tmp / "dynaclr_fit_affine" / "checkpoints/last")


def celldiff_module(device: str):
    """``configs/celldiff_fit.yml``'s model node, instantiated as the CLI
    would."""
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.instantiate import instantiate

    node = load_composed_config(ROOT / "configs/celldiff_fit.yml")["model"]
    return instantiate(dict(node, init_args=dict(node["init_args"], device=device)))


def perturb_adaln(module, seed: int) -> None:
    """Every adaLN-Zero weight and bias away from its zero init (normal,
    std 0.02), so the ViT blocks are not the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "adaLN" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)


def _xcheck_engines(build, seed: int):
    """Two copies of one engine on the same weights, card and CPU."""
    on_cpu = build("cpu")
    on_card = build("cuda")
    perturb_adaln(on_cpu, seed)
    on_card.model.load_state_dict(on_cpu.model.state_dict())
    return on_card, on_cpu


def _xcheck_step(tag: str, on_card, on_cpu, batch: dict, loss_fn, zero: dict, stats: bool = False,
                 grads: bool = True, phase: str = "celldiff") -> None:
    """One train-mode loss + backward on both copies: the loss within 2e-3
    relative; with ``grads`` every gradient as ``_compare_grads``; with
    ``stats`` every BatchNorm running statistic after the step (<= 2e-3 of
    range, r > 0.9999). Logged under ``[phase]``."""
    losses = []
    for module, dev in ((on_card, "cuda"), (on_cpu, "cpu")):
        module.train()
        t0 = time.perf_counter()
        loss = loss_fn(module, {k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        losses.append((float(loss.detach()), time.perf_counter() - t0))
    (l_card, _), (l_cpu, cpu_s) = losses
    l_rel = abs(l_card - l_cpu) / abs(l_cpu)
    if not l_rel <= 2e-3:
        raise AssertionError(f"{tag}: loss {l_card} on the card against {l_cpu} on the CPU")
    note = f"loss {l_card:.7f} vs {l_cpu:.7f} (rel {l_rel:.2e})"
    if grads:
        n_grads, worst = _compare_grads(on_card, on_cpu, zero, tag)
        note += f"; {n_grads} gradients within 2e-3 of range and r > 0.9999, worst {worst[1]} {worst[0]:.2e}"
    if stats:
        s_card, s_cpu = on_card.model.state_dict(), on_cpu.model.state_dict()
        keys = [k for k in s_cpu if k.endswith(("running_mean", "running_var"))]
        errs = {k: compare(s_card[k].cpu(), s_cpu[k]) for k in keys}
        bad = {k: v for k, v in errs.items() if not (v[1] <= 2e-3 and v[2] > 0.9999)}
        if not keys or bad:
            raise AssertionError(f"{tag}: running statistics disagree: {bad}")
        note += f"; {len(keys)} running statistics after it worst {max(v[1] for v in errs.values()):.2e} of range"
    log(f"[{phase}] {tag}: {note} (CPU {cpu_s:.1f} s)")


def celldiff_cross_check() -> None:
    """Phase 15 (a): f32 (TF32 off), card against CPU on the same weights
    (adaLN perturbed) and draws: the ``CELLDiffNet`` forward and one
    ``DynacellFlowMatching`` train step at fixed ``t`` and ``x0``; then
    ``VSUNet("FNet3D")``'s f32 train-mode loss and running statistics, and
    its f32 gradients against an f64 step on the CPU; then one ``DynacellUNet("UNetViT3D")`` step at
    the config's widths."""
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.apps.dynacell.engine import DynacellUNet
    from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

    g = torch.Generator().manual_seed(1500)
    shape = CELLDIFF_XCHECK
    batch = {"source": torch.randn(shape, generator=g), "target": torch.randn(shape, generator=g)}
    t, x0 = torch.rand(shape[0], generator=g), torch.randn(shape, generator=g)
    on_card, on_cpu = _xcheck_engines(celldiff_module, 1501)
    with torch.no_grad():
        outs = [m.model.eval()(batch["target"].to(dev), batch["source"].to(dev), t.to(dev)).cpu()
                for m, dev in ((on_card, "cuda"), (on_cpu, "cpu"))]
    err, rel, r = compare(*outs)
    log(f"[celldiff] CELLDiffNet forward at {shape}, card vs CPU: max|d|={err:.3e} ({rel:.2e} of range), "
        f"r={r:.8f}")
    if not (rel <= 2e-3 and r > 0.9999):
        raise AssertionError("the CELLDiffNet forward on the card disagrees with the CPU")
    step = lambda m, b: m.training_loss(b, t=t.to(b["source"].device), x0=x0.to(b["source"].device))
    _xcheck_step(f"DynacellFlowMatching step at {shape}", on_card, on_cpu, batch, step, {})
    del on_card, on_cpu
    cfg = {k: v for k, v in load_net_config().items() if k not in ("cond_channels",)}
    loss = lambda: MixedLoss(l1_alpha=0.5, l2_alpha=0.5, ms_dssim_alpha=0.0)
    plain = lambda m, b: m.training_loss(b)
    fshape = CELLDIFF_FNET_XCHECK
    fbatch = {"source": torch.randn(fshape, generator=g), "target": torch.randn(fshape, generator=g)}
    fnet = lambda dev: VSUNet("FNet3D", dict(in_stack_depth=fshape[2]), loss_function=loss(), device=dev)
    on_card, on_cpu = _xcheck_engines(fnet, 1502)
    _xcheck_step(f"VSUNet('FNet3D') f32 step at {fshape}", on_card, on_cpu, fbatch, plain, {}, stats=True,
                 grads=False)
    # a conv bias before a train-mode BatchNorm: removed by it, 0 up to rounding
    zero = {f"model.{k}": f"model.{k[:-4]}weight" for k, _ in on_cpu.model.named_parameters()
            if k.endswith("proj.bias")}
    card64, cpu64 = _xcheck_engines(fnet, 1502)
    card64.double(), cpu64.double()
    _xcheck_step(f"VSUNet('FNet3D') f64 step at {fshape}", card64, cpu64, {k: v.double() for k, v in fbatch.items()},
                 plain, zero)
    _grads_against_f64("VSUNet('FNet3D')", on_card, on_cpu, cpu64, fbatch, plain, zero)
    del on_card, on_cpu, card64, cpu64
    on_card, on_cpu = _xcheck_engines(
        lambda dev: DynacellUNet("UNetViT3D", dict(cfg), loss_function=loss(), device=dev), 1503)
    _xcheck_step(f"DynacellUNet('UNetViT3D') step at {shape}", on_card, on_cpu, batch, plain, {})
    del on_card, on_cpu
    torch.cuda.empty_cache()


def _grads_against_f64(tag: str, on_card, on_cpu, cpu64, batch: dict, loss_fn, zero: dict, phase: str = "celldiff",
                       part=lambda module: module, no_cudnn_yardstick: bool = False) -> None:
    """The f32 gradients of one train-mode step on the card and on the CPU
    (taken by ``_xcheck_step``) against the same step's f64 ones on the CPU
    (``cpu64``, taken too). Every gradient's Pearson r > 0.9999, and all of
    them at once within four times the CPU's own f32 error (||d|| / ||f64||
    over every gradient but the ``zero`` ones, which ``_compare_grads``'s
    rule holds): at this init the worst single gradients are exact to only
    1e-3 to 4e-2 of their range in any f32 (a sum over a few hundred voxels
    of a deep level behind a train-mode BatchNorm), so no per-gradient
    range bound holds f32 there. The same step on the card with TF32
    allowed must fail the bound, or it could not tell a lower precision
    from f32. ``part`` picks the submodule whose gradients are held (the
    whole engine by default); lines are logged under ``[phase]``. With
    ``no_cudnn_yardstick`` the f32 error the bound is four times is the
    larger of two independent f32 implementations' (the CPU's, and the
    card's own CUDA convolutions with cuDNN off): one step's f32 error is a
    single draw of rounding noise, which for the legacy 2-D U-Net varies
    from 3.3e-4 to 1.4e-3 with the inputs on the CPU alone
    (``tools/fnet3d_grad_precision.py --arch 2D`` on an NVIDIA H100 80GB
    HBM3 at 700 W)."""
    ref = {n: p.grad for n, p in part(cpu64).named_parameters()}
    names = [n for n in ref if n not in zero]

    def errors(module) -> tuple[float, tuple, tuple]:
        grads = {n: p.grad.cpu().double() for n, p in part(module).named_parameters()}
        for name, weight in zero.items():
            ratio = float(grads[name].abs().max() / grads[weight].abs().max())
            if not ratio < 1e-3:
                raise AssertionError(f"{tag}: {name} should have a gradient of 0 up to rounding: its largest is "
                                     f"{ratio:.2e} of {weight}'s")
        d = torch.cat([(grads[n] - ref[n]).flatten() for n in names])
        total = float(d.norm() / torch.cat([ref[n].flatten() for n in names]).norm())
        of_range = max((compare(grads[n], ref[n])[1], n) for n in names if ref[n].numel() > 1)
        low_r = min((compare(grads[n], ref[n])[2], n) for n in names if ref[n].numel() > 1)
        return total, of_range, low_r

    card, cpu = errors(on_card), errors(on_cpu)
    yardstick, what = cpu[0], "the CPU's"
    if no_cudnn_yardstick:
        on_card.zero_grad(set_to_none=True)
        torch.backends.cudnn.enabled = False
        try:
            loss_fn(on_card, {k: v.cuda() for k, v in batch.items()}).backward()
        finally:
            torch.backends.cudnn.enabled = True
        plain = errors(on_card)
        if plain[0] > yardstick:
            yardstick, what = plain[0], "the card's without cuDNN"
        what += f" (the card's without cuDNN {plain[0]:.3e})"
    bound = 4 * yardstick
    on_card.zero_grad(set_to_none=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        loss_fn(on_card, {k: v.cuda() for k, v in batch.items()}).backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    tf32 = errors(on_card)
    note = lambda e: (f"||d||/||f64|| {e[0]:.3e}, lowest r {e[2][1]} {e[2][0]:.8f}, worst of range {e[1][1]} "
                      f"{e[1][0]:.2e}")
    log(f"[{phase}] {tag}: {len(names)} f32 gradients against the CPU's f64: card {note(card)}; the CPU's own f32 "
        f"{note(cpu)}; bound r > 0.9999 and ||d||/||f64|| <= 4x {what} = {bound:.3e}; the card with TF32 "
        f"allowed (must fail it) {note(tf32)}; {len(zero)} conv biases 0 up to rounding")
    if not (card[0] <= bound and card[2][0] > 0.9999):
        raise AssertionError(f"{tag}: the card's f32 gradients disagree with the f64 step")
    if tf32[0] <= bound and tf32[2][0] > 0.9999:
        raise AssertionError(f"{tag}: the f32 gradient bound does not tell TF32 from f32")


def load_net_config() -> dict:
    from viscy_tpu_torch.training.compose import load_composed_config

    net = load_composed_config(ROOT / "configs/celldiff_fit.yml")["model"]["init_args"]["net_config"]
    return {k: tuple(v) if isinstance(v, list) else v for k, v in net.items()}


def celldiff_probe(card: str) -> int:
    """Phase 15 (b), before the fit: one train step (forward, backward,
    AdamW) of the config's model at batch 1 on a seeded (8, 512, 512)
    window: its operations (``torch.utils.flop_counter``) and peak memory,
    which sets the fit's batch (the config's 4, or the largest that fits
    with accumulation to 4); the step's time with TF32 off and then allowed
    (restored after); the device busy share and top kernels of one profiled
    step. Returns the batch."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    module = celldiff_module("cuda").train()
    opt, _, _ = module.configure_optimizers(100)
    g = torch.Generator(device="cuda").manual_seed(1510)
    shape = (1, 1, 8, *CELLDIFF_ZYX[1:])
    batch = {"source": torch.randn(shape, generator=g, device="cuda"),
             "target": torch.randn(shape, generator=g, device="cuda")}

    def step():
        module.zero_grad(set_to_none=True)
        module.training_loss(batch, g).backward()
        opt.step()

    n_params = sum(p.numel() for p in module.parameters())
    with torch.no_grad(), FlopCounterMode(display=False) as fwd_count:
        module.model(batch["target"], batch["source"], torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    static = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as step_count:
        step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    state = torch.cuda.memory_allocated()  # weights, gradients, AdamW moments
    total = torch.cuda.get_device_properties(0).total_memory
    per_sample = peak - state
    fits = [b for b in (CELLDIFF_BATCH, 2, 1) if CELLDIFF_BATCH % b == 0 and state + b * per_sample <= 0.9 * total]
    batch_size = fits[0] if fits else 1
    log(f"[celldiff] {n_params / 1e6:.1f} M parameters; one batch-1 step of {shape[1:]}: peak "
        f"{peak / 2**30:.2f} GiB of {total / 2**30:.1f} GiB (weights {static / 2**30:.2f} GiB, with gradients and "
        f"AdamW {state / 2**30:.2f} GiB, the step's activations {per_sample / 2**30:.2f} GiB): batch "
        f"{batch_size} x accumulation {CELLDIFF_BATCH // batch_size} makes the config's {CELLDIFF_BATCH} ({card})")
    times = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            times[tf32] = cuda_median_ms(step, runs=2)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    flops = step_count.get_total_flops()
    log(f"[celldiff] one batch-1 train step (CUDA-event median of 2 after a warm-up): f32 {times[False]:.1f} ms, "
        f"TF32 allowed {times[True]:.1f} ms ({times[False] / times[True]:.2f}x); {flops / 1e12:.2f} TFLOP a step "
        f"(forward {fwd_count.get_total_flops() / 1e12:.2f}; torch.utils.flop_counter): f32 "
        f"{flops / times[False] / 1e9:.1f} TFLOP/s against a bound of {flops / PEAK_FLOPS[torch.float32] * 1e3:.1f} "
        f"ms at {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s ({card})")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("[celldiff] torch.profiler recorded no device time: busy share not measured")
    else:
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        log(f"[celldiff] one profiled batch-1 step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"({busy_ms / wall_ms:.1%} of wall) over {sum(e.count for e in events)} kernels")
        for e in events[:10]:
            log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")
    del module, opt, batch
    torch.cuda.empty_cache()
    return batch_size


def celldiff_plates(tmp: Path, card: str) -> tuple[Path, Path]:
    """Phase 15 (b): the seeded fit plate and the one-FOV predict plate,
    written by the port's writer and ``preprocess``-ed."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

    t0 = time.perf_counter()
    fit = build_hcs_plate(tmp / "celldiff.zarr", list(CELLDIFF_CHANNELS), zyx_shape=CELLDIFF_ZYX, num_timepoints=1,
                          rows=("A",), cols=CELLDIFF_COLS, fovs=CELLDIFF_FOVS, seed=15)
    pred = build_hcs_plate(tmp / "celldiff_predict.zarr", list(CELLDIFF_CHANNELS),
                           zyx_shape=(CELLDIFF_PREDICT_Z, *CELLDIFF_ZYX[1:]), num_timepoints=1, rows=("B",),
                           cols=("1",), fovs=("0",), seed=16)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for plate in (fit, pred):
        cli.main(["preprocess", "-c", _cli_config(tmp / f"pp_{plate.stem}.yml", {"data_path": str(plate),
                                                                                "num_workers": 8})])
    n = len(CELLDIFF_FOVS) * len(CELLDIFF_COLS)
    nbytes = n * len(CELLDIFF_CHANNELS) * math.prod(CELLDIFF_ZYX) * 4
    log(f"[celldiff] fit plate: {n} FOVs of (1, {len(CELLDIFF_CHANNELS)}, {', '.join(map(str, CELLDIFF_ZYX))}) f32 "
        f"({nbytes / 2**20:.0f} MiB) and a predict plate of one (1, 2, {CELLDIFF_PREDICT_Z}, "
        f"{CELLDIFF_ZYX[1]}, {CELLDIFF_ZYX[2]}) written in {write_s:.1f} s; preprocess {time.perf_counter() - t0:.1f} s "
        f"({card})")
    return fit, pred


def celldiff_fit(tmp: Path, plate: Path, batch: int, card: str) -> Path:
    """Phase 15 (b): ``fit -c configs/celldiff_fit.yml`` with the paths, the
    workers, the batch and its accumulation to the config's 4, and one epoch
    of ``CELLDIFF_STEPS`` updates and ``CELLDIFF_VAL`` validation batches
    overridden; returns the root directory."""
    from viscy_tpu_torch.training import cli

    acc = CELLDIFF_BATCH // batch
    root = tmp / "celldiff_fit"
    cfg = _cli_config(tmp / "celldiff_fit.yml", {
        "data": {"init_args": {"data_path": str(plate), "batch_size": batch, "num_workers": 4}},
        "trainer": {"default_root_dir": str(root), "max_epochs": 1, "limit_train_batches": CELLDIFF_STEPS * acc,
                    "limit_val_batches": CELLDIFF_VAL, "accumulate_grad_batches": acc, "log_every_n_steps": 1},
    }, ROOT / "configs/celldiff_fit.yml")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    step_times, restore = _timed_steps()
    try:
        t0 = time.perf_counter()
        trainer = cli.main(["fit", "-c", cfg])
        total_s = time.perf_counter() - t0
    finally:
        restore()
    counts = _counts()
    feed = trainer.feed_stats
    loss, val = trainer.logged_metrics.get("loss/train"), trainer.logged_metrics.get("loss/validate")
    if feed["steps"] != CELLDIFF_STEPS * acc or not (root / "checkpoints/last").resolve().exists() \
            or not all(v is not None and math.isfinite(v) for v in (loss, val)) or any(counts.values()):
        raise AssertionError(f"CELLDiff fit: {feed['steps']} steps, losses {loss} / {val}, launches {counts}")
    patches = CELLDIFF_STEPS * CELLDIFF_BATCH
    log(f"[celldiff] fit (configs/celldiff_fit.yml, batch {batch} x accumulation {acc}, {CELLDIFF_STEPS} updates "
        f"of {CELLDIFF_BATCH} windows of (8, {CELLDIFF_ZYX[1]}, {CELLDIFF_ZYX[2]}), {CELLDIFF_VAL} validation "
        f"batch): {total_s:.1f} s in all; "
        f"train loop {feed['seconds']:.2f} s = {patches / feed['seconds']:.4f} patches/s (first step included); "
        f"waited {feed['wait_s']:.2f} s for batches = {feed['wait_s'] / feed['seconds']:.1%} of the loop; "
        f"steps after the first (s): {', '.join(step_times())}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss/train {loss:.5f}, loss/validate {val:.5f}; "
        f"no kernel of ours ({counts}) ({card})")
    del trainer
    torch.cuda.empty_cache()
    return root


def celldiff_predict(tmp: Path, plate: Path, ckpt: Path, card: str) -> None:
    """Phase 15 (c): ``predict`` through the CLI with ``HCSPredictionWriter``
    from ``last``: ``CELLDIFF_PREDICT_STEPS`` Euler steps (cut from the
    config's 50 to keep the script inside its time limit; the rate is given
    per forward too) over the predict plate's two windows (one batch); the
    store's shape, finiteness and agreement with ``predict_step`` on the
    same windows, blended (<= 1e-6 of range)."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.callbacks.prediction_writer import blend_in
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.instantiate import instantiate
    from viscy_tpu_torch.training.trainer import BatchPrefetcher, read_checkpoint
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    store = tmp / "celldiff_pred.zarr"
    cfg_path = _cli_config(tmp / "celldiff_predict.yml", {
        "model": {"init_args": {"num_generate_steps": CELLDIFF_PREDICT_STEPS}},
        "data": {"init_args": {"data_path": str(plate), "num_workers": 2}},
        "trainer": {"default_root_dir": str(tmp / "celldiff_predict"), "callbacks": [
            {"class_path": "viscy_utils.callbacks.HCSPredictionWriter", "init_args": {"output_store": str(store)}}]},
        "ckpt_path": str(ckpt),
    }, ROOT / "configs/celldiff_fit.yml")
    torch.cuda.empty_cache()
    _zero_counts()
    t0 = time.perf_counter()
    cli.main(["predict", "-c", cfg_path])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    counts = _counts()
    windows = CELLDIFF_PREDICT_Z - 8 + 1
    cfg = load_composed_config(Path(cfg_path))
    steps = cfg["model"]["init_args"]["num_generate_steps"]
    got = open_ome_zarr(store)["B/1/0"]["0"][0]
    log(f"[celldiff] predict ({steps} Euler steps, {windows} windows of (8, {CELLDIFF_ZYX[1]}, {CELLDIFF_ZYX[2]}) "
        f"in one batch): "
        f"{pred_s:.2f} s disk to store (model build and checkpoint load included) = {windows / pred_s:.4f} "
        f"windows/s, {steps / pred_s:.3f} forwards/s of the batch; store {got.shape}; no kernel of ours "
        f"({counts}) ({card})")
    if got.shape != (1, CELLDIFF_PREDICT_Z, *CELLDIFF_ZYX[1:]) or not np.isfinite(got).all() or any(counts.values()):
        raise AssertionError(f"CELLDiff prediction store {got.shape}, launches {counts}")
    module = instantiate(dict(cfg["model"], init_args=dict(cfg["model"]["init_args"], device="cuda"))).eval()
    module.model.load_state_dict(read_checkpoint(ckpt)[1])
    dm = instantiate(cfg["data"])
    dm.setup("predict")
    want = np.zeros_like(got)
    n = 0
    with torch.inference_mode():
        for batch in BatchPrefetcher(dm.predict_dataloader(), torch.device("cuda")):
            pred = module.predict_step(batch).float().cpu().numpy()
            for i, (_, _, z) in enumerate(batch["index"]):
                zs = slice(z, z + pred.shape[2])
                want[:, zs] = blend_in(want[:, zs], pred[i], zs)
                n += 1
    err, rng = float(np.abs(got - want).max()), float(want.max() - want.min())
    log(f"[celldiff] the store against predict_step on its {n} windows + plain blend_in: max|d|={err:.3e} "
        f"({err / rng:.2e} of range, bound 1e-6)")
    if n != windows or not err <= 1e-6 * rng:
        raise AssertionError("the CELLDiff prediction store disagrees with predict_step")


def phase_celldiff(card: str, tmp: Path) -> None:
    """Phase 15: CELLDiff flow matching (see the module docstring)."""
    torch.cuda.empty_cache()
    celldiff_cross_check()
    batch = celldiff_probe(card)
    fit_plate, predict_plate = celldiff_plates(tmp, card)
    root = celldiff_fit(tmp, fit_plate, batch, card)
    celldiff_predict(tmp, predict_plate, root / "checkpoints/last", card)


# -- phase 16: the legacy U-Nets ----------------------------------------------------------------


# the JAX defaults (filters 16 * 2**i over 4 blocks, 2 layers a block, dropout 0.2)
LEGACY = {"2.5D": dict(in_channels=1, out_channels=2, in_stack_depth=5, out_stack_depth=1, task="reg"),
          "2D": dict(in_channels=1, out_channels=2, task="reg")}
LEGACY_XCHECK_YX = 256
LEGACY_VAL = 1
LEGACY_PREDICT_ZYX = (7, 1024, 1024)


def legacy_engine(arch: str, device: str):
    """``VSUNet(arch)`` at the JAX defaults with the recipe's loss
    (``MixedLoss(0.5, 0, 0.5)``)."""
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

    return VSUNet(arch, dict(LEGACY[arch]), loss_function=MixedLoss(l1_alpha=0.5, l2_alpha=0.0, ms_dssim_alpha=0.5),
                  device=device)


def _dropout_replay():
    """A train-mode loss function for ``_xcheck_step`` whose first call (the
    card's) draws the conv blocks' dropout keep masks from a CPU generator
    and whose second (the CPU's) replays them; and a function that restores
    the blocks' dropout."""
    from viscy_tpu_torch.models.components import conv_blocks as cb

    orig, masks, g = cb.dropout, [], torch.Generator().manual_seed(1600)
    state = {"replay": False, "i": 0}

    def dropout(x, rate, generator=None, keep=None):
        if state["replay"]:
            keep = masks[state["i"]]
            state["i"] += 1
        else:
            keep = torch.rand(x.shape, generator=g) < 1.0 - rate
            masks.append(keep)
        return orig(x, rate, None, keep.to(x.device))

    def loss_fn(module, batch):
        try:
            return module.training_loss(batch)
        finally:
            state["replay"], state["i"] = True, 0

    cb.dropout = dropout
    return loss_fn, lambda: setattr(cb, "dropout", orig)


def legacy_cross_check() -> None:
    """Phase 16 (a): f32 (TF32 off), card against CPU on the same weights:
    the eval forward of both legacy U-Nets on two seeded 256^2 windows; then
    one train step each (L1 + L2, dropout 0.2 on the same keep masks, drawn
    on the CPU, train-mode BatchNorm): the f32 loss and every running
    statistic after it, the step in f64 on the card and the CPU (every
    gradient), and the f32 gradients against the f64 step as phase 15 holds
    FNet3D's (at this init single gradients behind train-mode BatchNorms
    are exact to about 2e-3 of range in f32: a first-block bias of the
    2.5-D model differed by 2.35e-3 of range, r 0.99998627, card against
    CPU on an NVIDIA H100 80GB HBM3 at 700 W)."""
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

    g = torch.Generator().manual_seed(1601)
    for arch, cfg in LEGACY.items():
        depth = cfg.get("in_stack_depth", 1)
        shape = (2, 1, depth, LEGACY_XCHECK_YX, LEGACY_XCHECK_YX)
        batch = {"source": torch.rand(shape, generator=g),
                 "target": torch.rand((2, 2, cfg.get("out_stack_depth", 1), *shape[-2:]), generator=g)}
        build = lambda dev: VSUNet(arch, dict(cfg), loss_function=MixedLoss(l1_alpha=0.5, l2_alpha=0.5,  # noqa: E731
                                                                             ms_dssim_alpha=0.0), device=dev)
        on_card, on_cpu = _xcheck_engines(build, 1602)
        state = {k: v.clone() for k, v in on_cpu.model.state_dict().items()}
        with torch.no_grad():
            outs = [m.eval()(batch["source"].to(dev)).cpu() for m, dev in ((on_card, "cuda"), (on_cpu, "cpu"))]
        _, rel, r = compare(*outs)
        log(f"[legacy] VSUNet('{arch}') f32 eval forward {shape}, card vs CPU: {rel:.2e} of range (bound 2e-3) "
            f"r={r:.8f}; {sum(p.numel() for p in on_cpu.parameters())} parameters")
        if not (rel <= 2e-3 and r > 0.9999 and outs[0].shape == batch["target"].shape):
            raise AssertionError(f"VSUNet('{arch}') forward on the card disagrees with the CPU")
        loss_fn, restore = _dropout_replay()
        try:
            tag = f"VSUNet('{arch}') step (dropout 0.2, batch statistics) at {shape}"
            _xcheck_step(f"{tag}, f32", on_card, on_cpu, batch, loss_fn, {}, stats=True, grads=False, phase="legacy")
            card64, cpu64 = build("cuda"), build("cpu")
            for m in (card64, cpu64):
                m.model.load_state_dict(state)
                m.double()
            _xcheck_step(f"{tag}, f64", card64, cpu64, {k: v.double() for k, v in batch.items()}, loss_fn, {},
                         phase="legacy")
            _grads_against_f64(f"VSUNet('{arch}')", on_card, on_cpu, cpu64, batch, loss_fn, {}, phase="legacy",
                               no_cudnn_yardstick=True)
        finally:
            restore()
        del on_card, on_cpu, card64, cpu64
    torch.cuda.empty_cache()


def busy_share(prefix: str, tag: str, step) -> None:
    """Wall time and device busy time (torch.profiler) of one call of
    ``step`` after a warm-up call, and the busy share; the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log(f"[{prefix}] {tag}: torch.profiler recorded no device time: busy share not measured")
        return
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[{prefix}] {tag}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%} of wall) "
        f"over {sum(e.count for e in events)} kernels")
    for e in events[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")


def _engine_step(module, batch: dict, generator=None):
    """One optimizer step of ``module`` on ``batch`` (forward, backward,
    AdamW), as a function; the optimizer is the engine's own."""
    opt, _, _ = module.configure_optimizers(100)

    def step():
        module.zero_grad(set_to_none=True)
        module.training_loss(batch, generator).backward()
        opt.step()

    return step


def _composed(tmp: Path, name: str, out: str, model: dict, edit) -> str:
    """``configs/<name>`` composed, its model node replaced by ``model``
    (not merged: the shipped model's keys do not apply), ``edit``-ed and
    written standalone to ``tmp/<out>``."""
    import yaml

    from viscy_tpu_torch.training.compose import load_composed_config

    cfg = load_composed_config(ROOT / "configs" / name)
    cfg["model"] = model
    edit(cfg)
    path = tmp / out
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _predict_plate(tmp: Path, name: str, zyx: tuple, row: str, seed: int) -> Path:
    """A seeded one-FOV Phase3D plate, ``preprocess``-ed."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

    plate = build_hcs_plate(tmp / f"{name}.zarr", CLI_CHANNELS[:1], zyx_shape=zyx, num_timepoints=1, rows=(row,),
                            cols=("1",), fovs=("0",), seed=seed)
    cli.main(["preprocess", "-c", _cli_config(tmp / f"pp_{name}.yml", {"data_path": str(plate), "num_workers": 8})])
    return plate


def legacy_cli(card: str, tmp: Path, plate: Path, arch: str) -> dict:
    """Phase 16 (b): ``viscy-torch fit -c configs/vscyto3d_fit.yml`` with the
    model replaced by ``VSUNet(arch)`` at the JAX defaults, ``z_window_size``
    the model's depth and ``target_2d`` (the host crop that deep), one epoch
    of 3 steps and 1 validation batch on phase 9's plate; then ``predict``
    from ``last`` on a seeded (1, 1, 7, 1024, 1024) plate: launch counts (the
    warp's only), finite losses, the store's written slices (a depth-1
    output at each window's centre). Returns the launch counts."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    depth = LEGACY[arch].get("in_stack_depth", 1)
    model = {"class_path": "cytoland.engine.VSUNet",
             "init_args": {"architecture": arch, "model_config": dict(LEGACY[arch]), "lr": 1e-3,
                           "loss_function": {"class_path": "viscy_utils.losses.MixedLoss",
                                             "init_args": {"l1_alpha": 0.5, "l2_alpha": 0.0, "ms_dssim_alpha": 0.5}}}}
    name = arch.replace(".", "")
    root = tmp / f"legacy_{name}"

    def fit_edit(cfg):
        init = cfg["data"]["init_args"]
        init.update(data_path=str(plate), num_workers=8, z_window_size=depth, target_2d=True)
        for aug in init["augmentations"]:
            if aug["class_path"].endswith("HostRandWeightedCropd"):
                aug["init_args"]["spatial_size"][0] = depth
        cfg["trainer"].update(default_root_dir=str(root), max_epochs=1, limit_train_batches=FIT_STEPS,
                              limit_val_batches=LEGACY_VAL, log_every_n_steps=1)

    pred_plate = _predict_plate(tmp, f"legacy_predict_{name}", LEGACY_PREDICT_ZYX, "D", 16)
    store = tmp / f"legacy_{name}_prediction.zarr"

    def pred_edit(cfg):
        cfg["data"]["init_args"].update(data_path=str(pred_plate), num_workers=8, z_window_size=depth)
        cfg["trainer"]["callbacks"][0]["init_args"].update(output_store=str(store))
        cfg.pop("ckpt_path", None)

    fit_cfg = _composed(tmp, "vscyto3d_fit.yml", f"legacy_{name}_fit.yml", model, fit_edit)
    pred_cfg = _composed(tmp, "vscyto3d_predict.yml", f"legacy_{name}_predict.yml",
                         {"class_path": model["class_path"],
                          "init_args": {"architecture": arch, "model_config": dict(LEGACY[arch])}}, pred_edit)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", fit_cfg])
    fit_counts = _counts()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _zero_counts()
    t0 = time.perf_counter()
    cli.main(["predict", "-c", pred_cfg, "--ckpt_path", str(root / "checkpoints/last")])
    pred_counts = _counts()
    pred_s = time.perf_counter() - t0
    feed = trainer.feed_stats
    val = trainer.logged_metrics.get("loss/validate")
    out = open_ome_zarr(store)["D/1/0"]["0"][:]
    windows = LEGACY_PREDICT_ZYX[0] - depth + 1
    written = [z for z in range(out.shape[2]) if np.abs(out[0, :, z]).max() > 0]
    want_written = list(range(depth // 2, depth // 2 + windows))
    want_fit = dict(fwd=0, bwd=0, masked_fwd=0, masked_bwd=0, warp=FIT_STEPS)
    if (fit_counts != want_fit or any(pred_counts.values()) or feed["steps"] != FIT_STEPS or val is None
            or not math.isfinite(val) or out.shape[:2] != (1, 2) or written != want_written
            or not np.isfinite(out).all()):
        raise AssertionError(f"legacy {arch} cli: fit launches {fit_counts} (expected {want_fit}), predict "
                             f"{pred_counts}, loss/validate {val}, store {out.shape} written at {written}")
    log(f"[legacy] viscy-torch fit (configs/vscyto3d_fit.yml with VSUNet('{arch}') at the JAX defaults, "
        f"z_window_size {depth}, target_2d): {fit_s:.1f} s in all, train loop {feed['seconds']:.2f} s for "
        f"{FIT_STEPS} steps = {FIT_STEPS * TRAIN_BATCH / feed['seconds']:.2f} patches/s (first step included), "
        f"waited {feed['wait_s'] / feed['seconds']:.1%} of the loop; peak memory {peak / 2**30:.2f} GiB; "
        f"loss/validate {val:.5f}; predict {windows} windows of (1, {depth}, {LEGACY_PREDICT_ZYX[1]}, "
        f"{LEGACY_PREDICT_ZYX[2]}) {pred_s:.2f} s = {windows / pred_s:.3f} windows/s disk to store, slices "
        f"{written} written, finite; launches fit {fit_counts}, predict {pred_counts} ({card})")
    aug = load_composed_config_node("vscyto3d_fit.yml", "data")["init_args"]["augmentations"][1:]
    err = member_warp("legacy", f"the {arch} fit's affine calls it at depth {depth}", aug, TRAIN_BATCH,
                      (depth, *TRAIN_PATCH[1:]), 1602)
    if arch == "2.5D":
        module = legacy_engine(arch, "cuda").train()
        g = torch.Generator(device="cuda").manual_seed(1603)
        batch = {"source": torch.rand((TRAIN_BATCH, 1, depth, *TRAIN_PATCH[1:]), generator=g, device="cuda"),
                 "target": torch.rand((TRAIN_BATCH, 2, 1, *TRAIN_PATCH[1:]), generator=g, device="cuda")}
        busy_share("legacy", f"one VSUNet('{arch}') train step at batch {TRAIN_BATCH} of (1, {depth}, "
                   f"{TRAIN_PATCH[1]}, {TRAIN_PATCH[2]})",
                   _engine_step(module, batch, g))
        del module, batch
    shutil.rmtree(store)
    shutil.rmtree(pred_plate)
    del trainer
    torch.cuda.empty_cache()
    return dict(fit_counts, warp=fit_counts["warp"] + pred_counts["warp"], warp_err=err)


def load_composed_config_node(name: str, key: str) -> dict:
    from viscy_tpu_torch.training.compose import load_composed_config

    return load_composed_config(ROOT / "configs" / name)[key]


def seeded_fit_plate(tmp: Path, card: str) -> Path:
    """Phase 9's seeded fit plate, written and ``preprocess``-ed on its own
    (for running phases 16 and 17 alone)."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

    t0 = time.perf_counter()
    plate = build_hcs_plate(tmp / "fit.zarr", CLI_CHANNELS, zyx_shape=CLI_FIT_ZYX, num_timepoints=1, rows=("A",),
                            cols=("1",), fovs=CLI_FIT_FOVS, seed=7)
    cli.main(["preprocess", "-c", _cli_config(tmp / "pp_fit.yml", {"data_path": str(plate), "num_workers": 8})])
    log(f"[cli] phase 9's fit plate written and preprocessed in {time.perf_counter() - t0:.1f} s ({card})")
    return plate


def phase_legacy(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 16: the legacy U-Nets (see the module docstring)."""
    legacy_cross_check()
    runs = [legacy_cli(card, tmp, plate, arch) for arch in LEGACY]
    return dict(warp_launches=sum(r["warp"] for r in runs), warp_err=max(r["warp_err"] for r in runs))


# -- phase 17: DynacellGAN with the multiscale spectral-norm PatchGAN3D ------------------------------


# every regularizer on (r1_every at its default, 16: the first D-step applies R1 / R2)
GAN_REGS = dict(r1_gamma=1.0, r2_gamma=1.0, ema_kimg=10.0, lecam_gamma=0.01)
GAN_XCHECK = (1, 15, 128, 128)
GAN_BATCHES = (16, 8, 4, 2)
GAN_PREDICT_ZYX = (16, 1024, 1024)


def gan_engine(device: str, dtype: str | None = "bfloat16", drop_path: float | None = None):
    """``DynacellGAN`` with ``configs/vscyto3d_fit.yml``'s model config as the
    FCMAE generator (``dtype`` and the drop path overridden when given), the
    JAX default discriminator and every regularizer on."""
    from viscy_tpu_torch.apps.dynacell.engine import DynacellGAN

    cfg = shipped_model_config("vscyto3d_fit.yml")
    cfg["dtype"] = dtype
    if drop_path is not None:
        cfg["encoder_drop_path_rate"] = drop_path
    return DynacellGAN(generator_config=cfg, **GAN_REGS, device=device)


class _FixedOutput(torch.nn.Module):
    """A generator stand-in that returns one fixed prediction."""

    def __init__(self, out: torch.Tensor) -> None:
        super().__init__()
        self.out = out

    def forward(self, x, generator=None):
        return self.out


def _clone(node):
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    return node.clone() if isinstance(node, torch.Tensor) else node


def gan_cross_check() -> None:
    """Phase 17 (a): f32 (TF32 off, drop path 0: the card's and the CPU's
    generators draw differently), card against CPU on the same weights, GRN
    gamma/beta non-zero, the same ``u`` vectors: the generator's and the
    discriminator's eval forwards; then one ``DynacellGAN`` step with R1,
    R2, LeCam and the EMA on: the loss, every generator gradient (<= 2e-3
    of range, r > 0.9999), after it the ``u`` and ``sigma`` vectors,
    ``gan_state`` and the EMA generator; the discriminator's gradients
    against its f64 step on the CPU on the CPU's prediction, as phase 15
    holds FNet3D's (its conv weights' f32 gradients through R1 / R2 are
    exact to about 2e-3 of range: layer 2's differed by 2.23e-3, r
    0.99999886, card against CPU on an NVIDIA H100 80GB HBM3 at 700 W)."""
    g = torch.Generator().manual_seed(1700)
    b, *zyx = GAN_XCHECK
    batch = {"source": torch.rand((b, 1, *zyx), generator=g), "target": torch.rand((b, 2, *zyx), generator=g)}
    on_cpu = gan_engine("cpu", "float32", 0.0)
    randomize_grn(on_cpu, 1701)
    on_card = gan_engine("cuda", "float32", 0.0)
    weights, engine_state = _clone(on_cpu.state_dict()), _clone(on_cpu.checkpoint_state())

    def reset(module) -> None:
        module.load_state_dict(weights)
        module.load_checkpoint_state(_clone(engine_state))

    reset(on_card)
    with torch.no_grad():
        outs = [m.eval().model(batch["source"].to(dev)).cpu() for m, dev in ((on_card, "cuda"), (on_cpu, "cpu"))]
        d_in = torch.cat([batch["source"], outs[1]], dim=1)
        logits = [[t.cpu() for t in m.discriminator(d_in.to(dev))] for m, dev in ((on_card, "cuda"), (on_cpu, "cpu"))]
        pred = on_cpu.train().model(batch["source"])
    _, rel, r = compare(*outs)
    d_rel = max(compare(a, w)[1] for a, w in zip(*logits))
    log(f"[gan] f32 eval forwards at {GAN_XCHECK}, card vs CPU: generator {rel:.2e} of range r={r:.8f}; "
        f"discriminator logits (2 scales) worst {d_rel:.2e} of range (bound 2e-3); "
        f"{sum(p.numel() for p in on_cpu.model.parameters())} generator and "
        f"{sum(p.numel() for p in on_cpu.discriminator.parameters())} discriminator parameters")
    if not (rel <= 2e-3 and r > 0.9999 and d_rel <= 2e-3):
        raise AssertionError("the GAN's forwards on the card disagree with the CPU")
    tag = f"DynacellGAN f32 step (R1, R2, LeCam, EMA) at {GAN_XCHECK}"
    step = lambda m, bb: (reset(m), m.training_loss(bb))[1]  # noqa: E731
    _zero_counts()
    _xcheck_step(tag, on_card, on_cpu, batch, step, {}, grads=False, phase="gan")
    counts = _counts()
    per_fwd = len(kernel_shapes(FLAGSHIP, zyx[-1]))
    if counts["fwd"] != 2 * per_fwd or counts["bwd"] != 2 * per_fwd:
        raise AssertionError(f"the GAN's f32 step launched {counts}, expected {2 * per_fwd} forward and backward")
    n_grads, worst_g = _compare_grads(on_card.model, on_cpu.model, {}, f"{tag}, generator")
    s_card, s_cpu = on_card.checkpoint_state(), on_cpu.checkpoint_state()
    worst = (0.0, "")
    for k, v in s_cpu["discriminator"].items():
        if k.endswith((".u", ".sigma")):
            err = float((s_card["discriminator"][k].cpu() - v).abs().max() / v.abs().max())
            worst = max(worst, (err, k))
    ema = [compare(s_card["ema_generator"][k].cpu(), v) for k, v in s_cpu["ema_generator"].items() if v.numel() > 1]
    ema_rel = max(e[1] for e in ema)
    gs_card, gs_cpu = s_card["gan_state"], s_cpu["gan_state"]
    lecam = max(abs(float(gs_card[k]) - float(gs_cpu[k])) / abs(float(gs_cpu[k])) for k in ("lecam_real", "lecam_fake"))
    log(f"[gan] {tag}: {n_grads} generator gradients within 2e-3 of range and r > 0.9999, worst {worst_g[1]} "
        f"{worst_g[0]:.2e}; after the step {sum(k.endswith('.u') for k in s_cpu['discriminator'])} spectral-norm u and "
        f"sigma worst {worst[0]:.2e} of max (bound 2e-3, {worst[1]}); d_step {gs_card['d_step']} / "
        f"{gs_cpu['d_step']}; LeCam EMAs worst {lecam:.2e} relative; {len(ema)} EMA generator tensors worst "
        f"{ema_rel:.2e} of range; card launches {counts}")
    if not (worst[0] <= 2e-3 and ema_rel <= 2e-3 and lecam <= 2e-3 and gs_card["d_step"] == gs_cpu["d_step"] == 1):
        raise AssertionError("the GAN's state after the step on the card disagrees with the CPU")
    cpu64 = gan_engine("cpu", "float32", 0.0)
    reset(cpu64)
    cpu64.discriminator.double()
    cpu64.model = _FixedOutput(pred.double())
    cpu64.ema_generator = None
    cpu64.train().training_loss({k: v.double() for k, v in batch.items()}).backward()
    zero = {f"discriminators.{s}.layer{i}.0.bias": f"discriminators.{s}.layer{i}.0.weight"
            for s in range(2) for i in (2, 3, 4)}
    _grads_against_f64("DynacellGAN's discriminator", on_card, on_cpu, cpu64, batch, step, zero, phase="gan",
                       part=lambda m: m.discriminator)
    del on_card, on_cpu, cpu64
    torch.cuda.empty_cache()


def gan_probe(card: str) -> int:
    """Phase 17 (b), before the fit: one step (forward, backward, AdamW) of
    the fit's engine (bf16 generator, drop path 0.1) at batch 2 of the fit's
    (15, 384, 384) windows: peak memory, which sets the fit's batch (the
    config's 16, or the largest of 8, 4, 2 that fits, with accumulation to
    16); the step's time; the device busy share of a profiled step.
    Returns the batch."""
    module = gan_engine("cuda").train()
    g = torch.Generator(device="cuda").manual_seed(1710)
    batch = {"source": torch.rand((2, 1, *TRAIN_PATCH), generator=g, device="cuda"),
             "target": torch.rand((2, 2, *TRAIN_PATCH), generator=g, device="cuda")}
    step = _engine_step(module, batch, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    state = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    per_sample = (peak - state) / 2
    fits = [b for b in GAN_BATCHES if state + b * per_sample <= 0.85 * total]
    batch_size = fits[0] if fits else 1
    log(f"[gan] one batch-2 step of {TRAIN_PATCH} (bf16 generator, f32 discriminator, R1 and R2 applied): peak "
        f"{peak / 2**30:.2f} GiB of {total / 2**30:.1f} GiB (weights, gradients and AdamW {state / 2**30:.2f} GiB, "
        f"{per_sample / 2**30:.2f} GiB a sample): batch {batch_size} x accumulation {TRAIN_BATCH // batch_size} "
        f"makes the config's {TRAIN_BATCH} ({card})")
    ms = cuda_median_ms(step, runs=2)
    log(f"[gan] one batch-2 step: {ms:.1f} ms (CUDA-event median of 2 after a warm-up; the R1/R2 step of "
        f"every 16) ({card})")
    busy_share("gan", "one profiled batch-2 step", step)
    del module, batch, step
    torch.cuda.empty_cache()
    return batch_size


def gan_cli(card: str, tmp: Path, plate: Path, batch: int) -> dict:
    """Phase 17 (c): ``viscy-torch fit -c configs/vscyto3d_fit.yml`` with the
    model replaced by ``DynacellGAN`` (the config's model config as the FCMAE
    generator, every regularizer on), the batch and its accumulation to the
    config's 16, one epoch of 3 updates and 1 validation batch on phase 9's
    plate; then ``predict -c configs/vscyto3d_predict.yml`` (its model
    config as the generator, the EMA at predict) from ``last`` on a seeded
    (1, 1, 16, 1024, 1024) plate: launch counts, finite losses, the store.
    Returns the launch counts and the fit's kernel shapes."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    acc = TRAIN_BATCH // batch
    fit_model = load_composed_config_node("vscyto3d_fit.yml", "model")["init_args"]["model_config"]
    pred_model = load_composed_config_node("vscyto3d_predict.yml", "model")["init_args"]["model_config"]
    gan = lambda cfg: {"class_path": "dynacell.engine.DynacellGAN",  # noqa: E731
                       "init_args": {"generator_config": cfg, **GAN_REGS}}
    root = tmp / "gan_fit"

    def fit_edit(cfg):
        cfg["data"]["init_args"].update(data_path=str(plate), num_workers=8, batch_size=batch)
        cfg["trainer"].update(default_root_dir=str(root), max_epochs=1, limit_train_batches=FIT_STEPS * acc,
                              limit_val_batches=1, accumulate_grad_batches=acc, log_every_n_steps=1)

    pred_plate = _predict_plate(tmp, "gan_predict", GAN_PREDICT_ZYX, "E", 17)
    store = tmp / "gan_prediction.zarr"

    def pred_edit(cfg):
        cfg["data"]["init_args"].update(data_path=str(pred_plate), num_workers=8)
        cfg["trainer"]["callbacks"][0]["init_args"].update(output_store=str(store))
        cfg.pop("ckpt_path", None)

    fit_cfg = _composed(tmp, "vscyto3d_fit.yml", "gan_fit.yml", gan(fit_model), fit_edit)
    pred_cfg = _composed(tmp, "vscyto3d_predict.yml", "gan_predict.yml", gan(pred_model), pred_edit)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    step_times, restore = _timed_steps()
    try:
        t0 = time.perf_counter()
        trainer = cli.main(["fit", "-c", fit_cfg])
        fit_s = time.perf_counter() - t0
    finally:
        restore()
    fit_counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    _zero_counts()
    t0 = time.perf_counter()
    cli.main(["predict", "-c", pred_cfg, "--ckpt_path", str(root / "checkpoints/last")])
    pred_counts = _counts()
    pred_s = time.perf_counter() - t0
    per_fwd = 2 * len(kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1]))
    micro = FIT_STEPS * acc
    want_fit = dict(fwd=per_fwd * (micro + 1), bwd=per_fwd * micro, masked_fwd=0, masked_bwd=0, warp=micro)
    windows = GAN_PREDICT_ZYX[0] - 15 + 1
    want_pred = dict(fwd=2 * len(kernel_shapes(FLAGSHIP, GAN_PREDICT_ZYX[-1])) * math.ceil(windows / 2), bwd=0,
                     masked_fwd=0, masked_bwd=0, warp=0)
    feed = trainer.feed_stats
    metrics = trainer.logged_metrics
    out = open_ome_zarr(store)["E/1/0"]["0"][:]
    if (fit_counts != want_fit or pred_counts != want_pred or feed["steps"] != micro
            or not all(math.isfinite(metrics.get(k, math.nan)) for k in ("loss/train", "loss/validate"))
            or out.shape != (1, 2, *GAN_PREDICT_ZYX) or not np.isfinite(out).all()):
        raise AssertionError(f"GAN cli: fit launches {fit_counts} (expected {want_fit}), predict {pred_counts} "
                             f"(expected {want_pred}), steps {feed['steps']}, metrics {metrics}, store {out.shape}")
    log(f"[gan] viscy-torch fit (configs/vscyto3d_fit.yml with DynacellGAN: the config's FCMAE in bf16 as the "
        f"generator, the default multiscale PatchGAN3D, R1 {GAN_REGS['r1_gamma']}, R2 {GAN_REGS['r2_gamma']}, EMA "
        f"{GAN_REGS['ema_kimg']} kimg, LeCam {GAN_REGS['lecam_gamma']}; batch {batch} x accumulation {acc}): "
        f"{fit_s:.1f} s in all, train loop {feed['seconds']:.2f} s for {FIT_STEPS} updates of {TRAIN_BATCH} = "
        f"{FIT_STEPS * TRAIN_BATCH / feed['seconds']:.3f} patches/s (first step included), waited "
        f"{feed['wait_s'] / feed['seconds']:.1%} of the loop; micro-steps after the first (s): "
        f"{', '.join(step_times())}; peak memory {peak / 2**30:.2f} GiB; loss/train {metrics['loss/train']:.4f}, "
        f"loss/validate {metrics['loss/validate']:.5f}; predict (EMA generator, f32, {windows} windows of "
        f"(15, {GAN_PREDICT_ZYX[1]}, {GAN_PREDICT_ZYX[2]})) {pred_s:.2f} s disk to store = {windows / pred_s:.3f} "
        f"windows/s, store {out.shape} finite; launches fit {fit_counts}, predict {pred_counts} ({card})")
    shutil.rmtree(store)
    shutil.rmtree(pred_plate)
    del trainer
    torch.cuda.empty_cache()
    return {k: fit_counts[k] + pred_counts[k] for k in fit_counts}


def gan_kernels(batch: int) -> dict:
    """Phase 17 (d): the fused forward and backward kernels at the GAN
    generator's train shapes (the fit's batch, 384^2) and the forward at its
    predict shapes (B = 2, full 1024^2 frames) against their plain
    versions."""
    worst: dict = {}
    bwd_worst = 0.0
    train = kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1])
    for k, (s, c, m) in enumerate(sorted(set(train), key=train.index)):
        check_forward(batch, s, c, m, 1720 + k, (False,), worst)
        bwd_worst = max(bwd_worst, check_backward(batch, s, c, m, 1730 + k, False))
    log_worst(f"the GAN generator's train shapes (B={batch}, {TRAIN_PATCH[-1]}^2)", worst)
    pred = kernel_shapes(FLAGSHIP, GAN_PREDICT_ZYX[-1])
    for k, (s, c, m) in enumerate(sorted(set(pred), key=pred.index)):
        check_forward(2, s, c, m, 1740 + k, (False,), worst)
    log_worst(f"the GAN generator's predict shapes (B=2, {GAN_PREDICT_ZYX[-1]}^2)", worst)
    return dict(fwd_err=worst[torch.bfloat16][0], bwd_err=bwd_worst)


def phase_gan(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 17: DynacellGAN (see the module docstring)."""
    gan_cross_check()
    batch = gan_probe(card)
    launches = gan_cli(card, tmp, plate, batch)
    aug = load_composed_config_node("vscyto3d_fit.yml", "data")["init_args"]["augmentations"][1:]
    warp_err = member_warp("gan", f"the GAN fit's affine calls it at batch {batch}", aug, batch, TRAIN_PATCH, 1750)
    return dict(launches=launches, kernels=gan_kernels(batch), warp_err=warp_err)


# -- phase 18: the beta-VAEs and BetaVaeModule --------------------------------------------------------


# BetaVae25D's defaults (convnext_tiny, 2 channels, depth 16 -> 16, latent
# 1024, 256^2, stem (2, 4, 4), 4 decoder stages) reconstruct at twice the
# input's YX, so no loss can be taken against the input (in JAX too,
# ROADMAP.md Queue 3): training runs with the (2, 8, 8) stem, the one
# change that makes the sizes meet
VAE_TRAIN = dict(stem_kernel_size=[2, 8, 8], stem_stride=[2, 8, 8])
VAE_XCHECK = (2, 2, 16, 128, 128)
VAE_BATCH = 32
VAE_YX = 256
VAE_STEPS = 3
VAE_VAL = 1


def vae_shapes(cfg: dict, yx: int) -> list[tuple[int, int, int]]:
    """(S, C, M) of every fused block call of one ``BetaVae25D`` forward of
    ``cfg`` at ``yx``^2, in call order: the v2 encoder's (a v2 backbone
    only), then the decoder's up stages (always v2)."""
    from viscy_tpu_torch.models.components.blocks import convnext_arch
    from viscy_tpu_torch.models.vae.beta_vae_25d import encoder_grid

    depths, dims, v2 = convnext_arch(cfg.get("backbone", "convnext_tiny"))
    stride = cfg.get("stem_stride", (2, 4, 4))
    side = (yx - stride[1]) // stride[1] + 1
    shapes = [((side >> i) ** 2, d, 4 * d) for i, (n, d) in enumerate(zip(depths, dims)) for _ in range(n)] if v2 else []
    h, _ = encoder_grid((yx, yx), stride, len(dims))
    stages = cfg.get("decoder_stages", 4)
    channels = [dims[-1] // 2 ** (i + 1) for i in range(stages - 1)]
    channels.append((cfg.get("out_stack_depth", 16) + 2) * cfg.get("in_channels", 2) * 4
                    * cfg.get("head_expansion_ratio", 2))
    for i, c in enumerate(channels):
        shapes += [((h << (i + 1)) ** 2, c, 4 * c)] * cfg.get("conv_blocks", 2)
    return shapes


def _vae_launches(cfg: dict, yx: int, batch: int) -> int:
    """Forward (or backward) launches of one ``BetaVae25D`` forward: two per
    launch of at most ``samples_per_launch`` samples, for every fused call."""
    from viscy_tpu_torch.ops import fused_block as fb

    return sum(2 * -(-batch // fb.samples_per_launch(s, m)) for s, _, m in vae_shapes(cfg, yx))


def vae_kernels(card: str) -> dict:
    """Phase 18 (a): the fused forward and backward kernels at the decoder's
    widths C = 384 / 192 / 96 / 288, at the row counts of the default model
    (256^2 input: S = 16^2 .. 128^2) and of the trained one ((2, 8, 8) stem:
    S = 8^2 .. 64^2), batch 32, against their plain versions; then bf16
    CUDA-event medians per train step of the trained model beside the plain
    versions and the bounds."""
    from viscy_tpu_torch.ops import fused_block as fb

    worst: dict = {}
    bwd_worst = 0.0
    for tag, cfg in (("default", {}), ("trained", VAE_TRAIN)):
        shapes = vae_shapes(cfg, VAE_YX)
        for k, (s, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
            check_forward(VAE_BATCH, s, c, m, 1800 + k, (False,), worst)
            bwd_worst = max(bwd_worst, check_backward(VAE_BATCH, s, c, m, 1810 + k, False))
        log_worst(f"the {tag} BetaVae25D decoder's shapes (B={VAE_BATCH}, {VAE_YX}^2 input)", worst)
    shapes = vae_shapes(VAE_TRAIN, VAE_YX)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bwd_ms=0.0, bwd_plain_ms=0.0, bwd_bound_ms=0.0)
    for k, (s, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
        args, _ = block_inputs(VAE_BATCH, s, c, m, torch.float32, seed=1820 + k)
        x, sc, *params = args
        g = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(1830 + k), device="cuda")
        ss = fb._reference_ss(x, *params[:4], None, 1e-6)
        n = shapes.count((s, c, m))
        times = dict(
            ms=cuda_median_ms(lambda: fb.fused_mlp_grn(*args)),
            plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn(*args), runs=5),
            bound_ms=block_bound_ms(VAE_BATCH, s, c, m, torch.float32)[0],
            bwd_ms=cuda_median_ms(lambda: fb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6)),
            bwd_plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn_bwd(x, g, *params, ss), runs=5),
            bwd_bound_ms=8.0 * VAE_BATCH * s * c * m / PEAK_FLOPS[torch.float32] * 1e3,
        )
        for key, val in times.items():
            total[key] += val * n
        log(f"[vae] time S={s} C={c} M={m} B={VAE_BATCH} f32 x{n}/step: forward {times['ms']:.3f} ms (plain "
            f"{times['plain_ms']:.3f}, bound {times['bound_ms']:.4f}), backward {times['bwd_ms']:.3f} ms (plain "
            f"{times['bwd_plain_ms']:.3f}, bound {times['bwd_bound_ms']:.4f})")
        del args, x, sc, params, g, ss
        torch.cuda.empty_cache()
    log(f"[vae] fused kernels per train step of the trained decoder ({len(shapes)} calls, B={VAE_BATCH}, f32): "
        f"forward {total['ms']:.3f} ms (plain {total['plain_ms']:.3f}, bound {total['bound_ms']:.3f}), backward "
        f"{total['bwd_ms']:.3f} ms (plain {total['bwd_plain_ms']:.3f}, bound {total['bwd_bound_ms']:.3f}); "
        f"CUDA-event medians ({card})")
    return dict(total, fwd_err=worst[torch.bfloat16][0], bwd_err=bwd_worst)


def vae_module(cfg: dict, device: str):
    from viscy_tpu_torch.apps.dynaclr.vae_engine import BetaVaeModule

    return BetaVaeModule(vae=dict(cfg), beta=0.5, device=device)


def vae_cross_check() -> None:
    """Phase 18 (b): f32 (TF32 off), card against CPU on the same weights
    (GRN gamma/beta non-zero) at (2, 2, 16, 128, 128): the default
    ``BetaVae25D`` (``convnext_tiny``) eval forward (reconstruction at twice
    the YX, mean, logvar), then one ``BetaVaeModule`` train step of the
    ``convnextv2_tiny`` model with the (2, 8, 8) stem on the same latent
    noise (drawn on the CPU): the ELBO and every gradient, the fused kernels
    in the encoder and the decoder."""
    g = torch.Generator().manual_seed(1850)
    x = torch.rand(VAE_XCHECK, generator=g)
    size = dict(input_spatial_size=list(VAE_XCHECK[-2:]))
    on_cpu, on_card = vae_module(size, "cpu"), vae_module(size, "cuda")
    randomize_grn(on_cpu, 1851)
    on_card.load_state_dict(on_cpu.state_dict())
    with torch.no_grad():
        outs = [m.eval().model(x.to(dev)) for m, dev in ((on_card, "cuda"), (on_cpu, "cpu"))]
    errs = {name: compare(a.cpu(), w)[1:] for name, a, w in zip(("recon", "mean", "logvar"), outs[0], outs[1])}
    log(f"[vae] BetaVae25D defaults f32 eval forward {VAE_XCHECK}, card vs CPU: " + ", ".join(
        f"{k} {e:.2e} of range r={r:.8f}" for k, (e, r) in errs.items())
        + f"; reconstruction {tuple(outs[0].recon_x.shape)}; {sum(p.numel() for p in on_cpu.parameters())} parameters")
    if not all(e <= 2e-3 and r > 0.9999 for e, r in errs.values()):
        raise AssertionError("the BetaVae25D forward on the card disagrees with the CPU")
    del on_card, on_cpu, outs
    cfg = dict(VAE_TRAIN, backbone="convnextv2_tiny", **size)
    on_cpu, on_card = vae_module(cfg, "cpu"), vae_module(cfg, "cuda")
    randomize_grn(on_cpu, 1852)
    on_card.load_state_dict(on_cpu.state_dict())
    eps = torch.randn((VAE_XCHECK[0], 1024), generator=g)
    _zero_counts()
    _xcheck_step(f"BetaVaeModule f32 step (convnextv2_tiny, (2, 8, 8) stem) at {VAE_XCHECK}", on_card, on_cpu,
                 {"anchor": x}, lambda m, b: m.training_loss(b, eps=eps.to(b["anchor"].device)),
                 {"model.head.conv.0.conv.bias": "model.head.conv.0.conv.weight"}, phase="vae")
    counts = _counts()
    want = _vae_launches(cfg, VAE_XCHECK[-1], VAE_XCHECK[0])
    log(f"[vae] the step's launches on the card {counts} (expected {want} forward and backward)")
    if counts["fwd"] != want or counts["bwd"] != want:
        raise AssertionError(f"the VAE step launched {counts}, expected {want}")
    del on_card, on_cpu
    torch.cuda.empty_cache()


def vae_cli(card: str, tmp: Path, plate: Path, tracks: Path) -> dict:
    """Phase 18 (c): ``viscy-torch fit -c configs/dynaclr_fit.yml`` with the
    model replaced by ``BetaVaeModule`` (BetaVae25D at its defaults but the
    (2, 8, 8) stem) and the windows 16 deep and (256, 256) after the crop,
    on phase 14's plate and tracks: one epoch of 3 steps and 1 validation
    batch; then ``predict -c configs/dynaclr_predict.yml`` from ``last``
    through the ``EmbeddingWriter``: launch counts, finite losses, the
    store's features (the mean) and projections (z, the mean in eval).
    Returns the launch counts."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    vae = dict(VAE_TRAIN, input_spatial_size=[VAE_YX, VAE_YX])
    model = {"class_path": "dynaclr.vae_engine.BetaVaeModule", "init_args": {"vae": vae, "beta": 0.5}}
    data = {"data_path": str(plate), "tracks_path": str(tracks), "z_range": [24, 40],
            "final_yx_patch_size": [VAE_YX, VAE_YX], "num_workers": 8}
    root = tmp / "vae_fit"
    store = tmp / "vae_embeddings.zarr"

    def fit_edit(cfg):
        cfg["data"]["init_args"].update(data)
        cfg["trainer"].update(default_root_dir=str(root), max_epochs=1, limit_train_batches=VAE_STEPS,
                              limit_val_batches=VAE_VAL, log_every_n_steps=1)

    def pred_edit(cfg):
        cfg["data"]["init_args"].update(data, initial_yx_patch_size=[VAE_YX, VAE_YX], predict_cells=False)
        cfg["trainer"]["default_root_dir"] = str(tmp / "vae_predict")
        cfg["trainer"]["callbacks"][0]["init_args"].update(output_path=str(store))
        cfg.pop("ckpt_path", None)

    fit_cfg = _composed(tmp, "dynaclr_fit.yml", "vae_fit.yml", model, fit_edit)
    pred_cfg = _composed(tmp, "dynaclr_predict.yml", "vae_predict.yml", model, pred_edit)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", fit_cfg])
    fit_s = time.perf_counter() - t0
    fit_counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    _zero_counts()
    t0 = time.perf_counter()
    predictor = cli.main(["predict", "-c", pred_cfg, "--ckpt_path", str(root / "checkpoints/last")])
    pred_s = time.perf_counter() - t0
    pred_counts = _counts()
    per = _vae_launches(VAE_TRAIN, VAE_YX, VAE_BATCH)
    want_fit = dict(fwd=per * (VAE_STEPS + VAE_VAL), bwd=per * VAE_STEPS, masked_fwd=0, masked_bwd=0, warp=0)
    dm = predictor._active_datamodule
    n = len(dm.predict_dataset)
    bs = dm.batch_size
    want_pred = dict(fwd=_vae_launches(VAE_TRAIN, VAE_YX, bs) * (n // bs)
                     + (_vae_launches(VAE_TRAIN, VAE_YX, n % bs) if n % bs else 0),
                     bwd=0, masked_fwd=0, masked_bwd=0, warp=0)
    got = read_embedding_dataset(store)
    feed = trainer.feed_stats
    metrics = trainer.logged_metrics
    if (fit_counts != want_fit or pred_counts != want_pred or feed["steps"] != VAE_STEPS
            or not all(math.isfinite(metrics.get(k, math.nan)) for k in ("loss/train", "loss/validate"))
            or got.X.shape != (n, 1024) or not np.isfinite(got.X).all()
            or not np.array_equal(got.obsm["X_projections"], got.X)):
        raise AssertionError(f"VAE cli: fit launches {fit_counts} (expected {want_fit}), predict {pred_counts} "
                             f"(expected {want_pred}), steps {feed['steps']}, metrics {metrics}, X {got.X.shape}")
    log(f"[vae] viscy-torch fit (configs/dynaclr_fit.yml with BetaVaeModule: BetaVae25D defaults with a (2, 8, 8) "
        f"stem, windows (2, 16, {VAE_YX}, {VAE_YX}), batch {VAE_BATCH}): {fit_s:.1f} s in all, train loop "
        f"{feed['seconds']:.2f} s for {VAE_STEPS} steps = {VAE_STEPS * VAE_BATCH / feed['seconds']:.3f} cells/s "
        f"(first step included), waited {feed['wait_s'] / feed['seconds']:.1%} of the loop; peak memory "
        f"{peak / 2**30:.2f} GiB; loss/train {metrics['loss/train']:.5f}, loss/validate "
        f"{metrics['loss/validate']:.5f}; predict {n} cells in batches of {bs} {pred_s:.2f} s disk to store = "
        f"{n / pred_s:.2f} cells/s, X {got.X.shape} finite, projections = the mean; launches fit {fit_counts}, "
        f"predict {pred_counts} ({card})")
    module = vae_module(vae, "cuda").train()
    g = torch.Generator(device="cuda").manual_seed(1860)
    batch = {"anchor": torch.rand((VAE_BATCH, 2, 16, VAE_YX, VAE_YX), generator=g, device="cuda")}
    busy_share("vae", f"one BetaVaeModule train step at batch {VAE_BATCH} of (2, 16, {VAE_YX}, {VAE_YX})",
               _engine_step(module, batch, g))
    shutil.rmtree(store)
    del trainer, predictor, module, batch
    torch.cuda.empty_cache()
    return {k: fit_counts[k] + pred_counts[k] for k in fit_counts}


def phase_vae(card: str, tmp: Path, plate: Path, tracks: Path) -> dict:
    """Phase 18: the beta-VAEs (see the module docstring)."""
    kernels = vae_kernels(card)
    vae_cross_check()
    launches = vae_cli(card, tmp, plate, tracks)
    shutil.rmtree(plate)
    return dict(kernels=kernels, launches=launches)


# -- phase 19: data parallelism across processes ---------------------------------------------------------


# (a): `viscy-torch fit` of the shipped recipe, 3 steps and 1 validation batch
DDP_STEPS = 3
DDP_VAL = 1
# (b): two processes on the one card over gloo; per-rank batches of the
# flagship f32 step (from TRAIN_STACK stacks, cut to TRAIN_PATCH; the
# recipe's 16 over the two, about 0.45 GiB of peak memory a patch) and of
# DynaCLR's step (DYNACLR_PATCH pairs; the config's 32 over the two)
DDP_RANK_BATCH = 8
DDP_DYNACLR_RANK_BATCH = 16
DDP_WATCHDOG_S = 240
# phase 17's DynacellGAN in f32 over the two ranks, R1 / R2 every second
# step: DDP_GAN_STEPS passes (d_step 0 applies R1 / R2, d_step 1 does not)
# of DDP_GAN_RANK_BATCH windows a rank
DDP_GAN_RANK_BATCH = 2
DDP_GAN_ZYX = (15, 128, 128)
DDP_GAN_STEPS = 2
# the discriminator's conv biases an instance norm follows: 0 up to rounding
GAN_NORMED_BIASES = {f"discriminator.discriminators.{s}.layer{i}.0.bias":
                     f"discriminator.discriminators.{s}.layer{i}.0.weight" for s in range(2) for i in (2, 3, 4)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(world: int, rank: int, port: int, local_rank: int) -> dict:
    """The environment of one rank: the ``VISCY_*`` contract, the rank's
    card, cuBLAS's fixed workspace (deterministic GEMMs); any launcher's
    variables removed."""
    import os

    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                                                             "MASTER_PORT")}
    env.update(VISCY_COORDINATOR=f"localhost:{port}", VISCY_NUM_PROCESSES=str(world), VISCY_PROCESS_ID=str(rank),
               LOCAL_RANK=str(local_rank), CUBLAS_WORKSPACE_CONFIG=":4096:8")
    return env


def run_processes(call: str, envs: list[dict], out: Path, tag: str) -> list[dict]:
    """Start one ``python3 -c`` process a rank, all together, each running
    ``chip_smoke.<call>`` with its result path; wait under a watchdog (all
    killed, and the phase failed, when one is late or fails); return each
    rank's JSON result. Each process writes its output to a log file
    beside its result, printed when a process fails."""
    procs = []
    for i, env in enumerate(envs):
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke as cs; "
                f"cs.{call}({str(out / f'{tag}{i}.json')!r})")
        with open(out / f"{tag}{i}.log", "w") as fh:
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(ROOT), stdout=fh,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DDP_WATCHDOG_S
    late = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        late = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if late or any(p.returncode for p in procs):
        for i in range(len(procs)):
            for line in (out / f"{tag}{i}.log").read_text().splitlines()[-60:]:
                log(f"[ddp]   {tag} rank {i}: {line}")
        raise AssertionError(f"[ddp] {tag}: exit codes {[p.returncode for p in procs]}"
                             + (f" (killed after {DDP_WATCHDOG_S} s)" if late else ""))
    return [json.loads((out / f"{tag}{i}.json").read_text()) for i in range(len(envs))]


def _worker_setup() -> None:
    """A phase-19 process: a watchdog that ends it with every thread's
    traceback, TF32 off, deterministic cuDNN."""
    import faulthandler

    faulthandler.dump_traceback_later(DDP_WATCHDOG_S - 20, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def ddp_fit_worker(out: str) -> None:
    """One process of phase 19 (a): ``cli.main(["fit", "-c", <config>])``
    with the config named by ``VISCY_DDP_CONFIG``, the trainer's gradient
    reduce timed between CUDA events and every window read recorded;
    writes the launches, the train loop's feed statistics, the reduce's
    times, the host clock at each reduce's end (after the step's backward,
    synchronized) and the reads to ``out``."""
    import os

    _worker_setup()
    from viscy_tpu_torch.data import loader
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d
    from viscy_tpu_torch.parallel import process_count, process_index
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training import trainer as trainer_mod

    reduce_ms, step_ends, devices, reads = [], [], set(), []
    reduce = trainer_mod.all_reduce_gradients_

    def timed_reduce(parameters):
        params = list(parameters)
        devices.add(str(params[0].device))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        reduce(params)
        end.record()
        end.synchronize()
        reduce_ms.append(start.elapsed_time(end))
        step_ends.append(time.perf_counter())

    load_item = loader.DataLoader._load_item

    def spy(self, idx):
        reads.append((bool(self.shuffle), int(idx)))
        return load_item(self, idx)

    trainer_mod.all_reduce_gradients_ = timed_reduce
    loader.DataLoader._load_item = spy
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", os.environ["VISCY_DDP_CONFIG"]])
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps(dict(
        rank=process_index(), world=process_count(), device=str(trainer.device), param_devices=sorted(devices),
        seconds=time.perf_counter() - t0, feed=trainer.feed_stats, reduce_ms=reduce_ms, step_ends=step_ends,
        launches=dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches),
        train_reads=sorted({i for shuffled, i in reads if shuffled}),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)))


def _curve(root: Path) -> list[dict]:
    """``metrics.csv`` without the host's step times."""
    lines = [json.loads(s) for s in (root / "metrics.csv").read_text().splitlines()]
    return [{k: v for k, v in line.items() if k != "step_time_ms"} for line in lines]


def ddp_fit(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 19 (a): ``fit -c configs/vscyto3d_fit.yml`` on phase 9's plate,
    in one process without a process group, then in
    ``torch.cuda.device_count()`` processes over NCCL. On one card (world 1)
    the loss curve and the final weights must be bit-identical; on more,
    each rank's per-rank batch is 16 / world, the ranks' training reads are
    disjoint, and since each rank draws its own augmentation both runs then
    train without the device augmentation and drop path and the curves agree
    within the f32 bound."""
    world = torch.cuda.device_count()
    override = {"data": {"init_args": {"data_path": str(plate), "num_workers": 8}},
                "trainer": {"max_epochs": 1, "limit_train_batches": DDP_STEPS, "limit_val_batches": DDP_VAL,
                            "log_every_n_steps": 1}}
    if world > 1:
        shipped = load_composed_config_node("vscyto3d_fit.yml", "data")["init_args"]
        model = load_composed_config_node("vscyto3d_fit.yml", "model")
        override["data"]["init_args"]["augmentations"] = shipped["augmentations"][:1]  # the host crop
        override["model"] = {"init_args": {"model_config": dict(model["init_args"]["model_config"],
                                                                encoder_drop_path_rate=0.0)}}
    runs = {}
    for name, n in (("single", 1), ("nccl", world)):
        cfg = json.loads(json.dumps(override))
        cfg["trainer"]["default_root_dir"] = str(tmp / f"ddp_{name}")
        if name == "nccl" and world > 1:
            cfg["data"]["init_args"]["batch_size"] = TRAIN_BATCH // world
        path = _cli_config(tmp / f"ddp_{name}.yml", cfg, ROOT / "configs/vscyto3d_fit.yml")
        port = _free_port()
        envs = [dict(_rank_env(n, r, port, r), VISCY_DDP_CONFIG=path) for r in range(n)]
        if name == "single":
            for k in ("VISCY_COORDINATOR", "VISCY_NUM_PROCESSES", "VISCY_PROCESS_ID", "LOCAL_RANK"):
                envs[0].pop(k)
        runs[name] = run_processes("ddp_fit_worker", envs, tmp, f"ddp_{name}")
    single, nccl = runs["single"][0], runs["nccl"]
    curves = {name: _curve(tmp / f"ddp_{name}") for name in runs}
    for r in nccl:
        if r["launches"]["fwd"] == 0 or r["launches"]["bwd"] == 0 or r["launches"]["warp"] == 0:
            raise AssertionError(f"[ddp] rank {r['rank']} launched {r['launches']}: every kernel must run on every rank")
        if r["param_devices"] != [f"cuda:{r['rank']}"] or r["device"] != f"cuda:{r['rank']}":
            raise AssertionError(f"[ddp] rank {r['rank']} trained on {r['param_devices']} ({r['device']})")
    if world == 1:
        ckpt = {name: torch.load(tmp / f"ddp_{name}" / "checkpoints" / "last", map_location="cpu",
                                 weights_only=True)["state_dict"] for name in runs}
        differ = [k for k in ckpt["single"] if not torch.equal(ckpt["single"][k], ckpt["nccl"][k])]
        if curves["single"] != curves["nccl"] or differ or set(ckpt["single"]) != set(ckpt["nccl"]):
            raise AssertionError(f"[ddp] the world-1 NCCL fit is not bit-identical to the fit without a process "
                                 f"group: curves {curves}, {len(differ)} weights differ ({differ[:3]})")
        verdict = (f"loss curve ({len(curves['nccl'])} lines) and all {len(ckpt['nccl'])} weights of the final "
                   f"checkpoint bit-identical")
    else:
        reads = [set(r["train_reads"]) for r in nccl]
        if any(a & b for i, a in enumerate(reads) for b in reads[i + 1:]):
            raise AssertionError(f"[ddp] ranks read overlapping training windows: {reads}")
        got = [v for line in curves["nccl"] for k, v in sorted(line.items()) if k.startswith("loss/")]
        want = [v for line in curves["single"] for k, v in sorted(line.items()) if k.startswith("loss/")]
        if len(got) != len(want) or max(abs(a - b) / abs(b) for a, b in zip(got, want)) > 2e-3:
            raise AssertionError(f"[ddp] the {world}-rank curve {got} is not within 2e-3 of one process's {want}")
        verdict = f"training reads disjoint; loss curve within 2e-3 relative of one process's: {got} vs {want}"
    rate = lambda r: DDP_STEPS * TRAIN_BATCH / r["feed"]["seconds"]
    # steps 2..: the spans between the synchronized ends of the steps' reduces
    steady = lambda r: (len(r["step_ends"]) - 1) * TRAIN_BATCH / (r["step_ends"][-1] - r["step_ends"][0])
    reduce_ms = [statistics.median(r["reduce_ms"]) for r in nccl]
    log(f"[ddp] (a) fit -c configs/vscyto3d_fit.yml, {DDP_STEPS} steps + {DDP_VAL} validation batch, global batch "
        f"{TRAIN_BATCH}: without a process group {rate(single):.2f} patches/s over the train loop "
        f"({single['feed']['seconds']:.2f} s), {steady(single):.2f} over steps 2-{DDP_STEPS}, process "
        f"{single['seconds']:.1f} s; {world} NCCL rank(s) {', '.join(f'{rate(r):.2f}' for r in nccl)} over the "
        f"loop ({', '.join(f'{r['feed']['seconds']:.2f}' for r in nccl)} s), "
        f"{', '.join(f'{steady(r):.2f}' for r in nccl)} over steps 2-{DDP_STEPS}; gradient all-reduce "
        f"{', '.join(f'{m:.3f}' for m in reduce_ms)} ms a step (median of {len(nccl[0]['reduce_ms'])}, CUDA "
        f"events) ({card})")
    for r in nccl:
        log(f"[ddp] (a) rank {r['rank']} on {r['device']}: launches A+B {r['launches']['fwd']}, C+D "
            f"{r['launches']['bwd']}, warp {r['launches']['warp']}; peak {r['peak_gib']:.2f} GiB")
    log(f"[ddp] (a) {verdict}")
    launches = {k: sum(r["launches"][k] for r in nccl) for k in ("fwd", "bwd", "warp")}
    return dict(launches=launches, reduce_ms=reduce_ms, rate_single=rate(single), rate_nccl=[rate(r) for r in nccl],
                steady_single=steady(single), steady_nccl=[steady(r) for r in nccl])


def ddp_step_worker(out: str) -> None:
    """One of phase 19 (b)'s two processes on the one card over gloo: the
    flagship f32 train step on its rows (augmented on its own draws: the
    warp at the per-rank batch), its gradients reduced, then DynaCLR's f32
    step on its rows of a seeded global batch (global BatchNorm statistics
    and NT-Xent negatives); rank 0 keeps the gathered global batch, the
    reduced gradients and copies of both engines as they were before the
    steps (no optimizer step runs), leaves the group and runs both steps as
    one process on the global batch; writes the checks, times, launches,
    peaks and the seconds since the start at each stage."""
    import copy

    t_start = time.perf_counter()
    marks = {}
    _worker_setup()
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.ops import warp3d
    from viscy_tpu_torch.parallel import (all_reduce_gradients_, all_reduce_mean, barrier, broadcast_module_,
                                          gather_batch, maybe_initialize, process_count, process_index)

    maybe_initialize(backend="gloo")
    rank, world = process_index(), process_count()
    dev = torch.device("cuda", torch.cuda.current_device())
    res: dict = {"rank": rank, "world": world, "device": str(dev)}
    cfg32 = dict(FLAGSHIP, dtype="float32")
    module = train_engine(cfg32, "cuda", bf16_loss=False)
    randomize_grn(module, 1900)
    broadcast_module_(module)
    ref = copy.deepcopy(module) if rank == 0 else None
    marks["built"] = time.perf_counter() - t_start
    g = torch.Generator(device=dev).manual_seed(1901 + rank)
    stacks = {"source": torch.rand((DDP_RANK_BATCH, 1, *TRAIN_STACK), generator=g, device=dev),
              "target": torch.rand((DDP_RANK_BATCH, 2, *TRAIN_STACK), generator=g, device=dev)}
    aug = production_aug(TRAIN_PATCH)
    torch.cuda.synchronize()
    fb.launches = fb.bwd_launches = warp3d.launches = 0
    batch = aug(stacks, torch.Generator(device=dev).manual_seed(1950 + rank))
    step_s = []
    for _ in range(2):  # a warm-up, then the timed step
        module.zero_grad(set_to_none=True)
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = module.training_loss(batch)
        loss.backward()
        all_reduce_gradients_(module.parameters())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    res["launches"] = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches)
    reduce_ms = []
    for _ in range(3):  # the mean of equal gradients is exact: timing it again changes nothing
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        all_reduce_gradients_(module.parameters())
        end.record()
        end.synchronize()
        reduce_ms.append(start.elapsed_time(end))
    res.update(step_s=step_s[-1], reduce_ms=statistics.median(reduce_ms),
               loss=float(all_reduce_mean(loss.detach())), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    global_batch = {k: gather_batch(v.contiguous()) for k, v in batch.items()}
    del batch, stacks, loss
    marks["flagship"] = time.perf_counter() - t_start

    clr = dynaclr_module("cuda")
    broadcast_module_(clr)
    clr_ref = copy.deepcopy(clr).train() if rank == 0 else None
    clr.train()
    gc = torch.Generator(device=dev).manual_seed(1990)
    n = DDP_DYNACLR_RANK_BATCH
    views = {v: torch.rand((n * world, 2, *DYNACLR_PATCH), generator=gc, device=dev) for v in ("anchor", "positive")}
    local = {k: v[rank * n:(rank + 1) * n] for k, v in views.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (a_proj, p_proj, n_proj), a_emb = clr._views(local, None, embedding=True)
    clr_loss = clr._contrastive_loss(a_proj, p_proj, n_proj)
    clr_loss.backward()
    all_reduce_gradients_(clr.parameters())
    torch.cuda.synchronize()
    res["dynaclr_step_s"] = time.perf_counter() - t0
    clr_emb, clr_proj = gather_batch(a_emb.detach()), gather_batch(a_proj.detach())
    marks["dynaclr"] = time.perf_counter() - t_start
    gan = ddp_gan_engine()
    gan_ref = copy.deepcopy(gan) if rank == 0 else None
    gg = torch.Generator(device=dev).manual_seed(1961)
    n = DDP_GAN_RANK_BATCH
    gan_batch = {"source": torch.rand((n * world, 1, *DDP_GAN_ZYX), generator=gg, device=dev),
                 "target": torch.rand((n * world, 2, *DDP_GAN_ZYX), generator=gg, device=dev)}
    torch.cuda.synchronize()
    fb.launches = fb.bwd_launches = warp3d.launches = 0
    gan_two = ddp_gan_steps(gan, {k: v[rank * n:(rank + 1) * n] for k, v in gan_batch.items()})
    res["gan_launches"] = dict(fwd=fb.launches, bwd=fb.bwd_launches, warp=warp3d.launches)
    res.update(gan_step_s=[t["seconds"] for t in gan_two], gan_lecam=[t["lecam"] for t in gan_two],
               gan_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del gan
    marks["gan"] = time.perf_counter() - t_start
    barrier()
    import torch.distributed as dist

    dist.destroy_process_group()
    if rank == 0:
        t0 = time.perf_counter()
        ref_loss = ref.training_loss(global_batch)
        ref_loss.backward()
        torch.cuda.synchronize()
        res["single_step_s"] = time.perf_counter() - t0
        res["loss_rel"] = abs(res["loss"] - float(ref_loss.detach())) / abs(float(ref_loss.detach()))
        res["grads"], res["worst"] = _compare_grads(module, ref, {}, "[ddp] two ranks vs one process, flagship")
        del ref, module, global_batch
        torch.cuda.empty_cache()
        (a_proj, p_proj, n_proj), a_emb = clr_ref._views(views, None, embedding=True)
        ref_loss = clr_ref._contrastive_loss(a_proj, p_proj, n_proj)
        ref_loss.backward()
        checks = {"embedding": compare(clr_emb, a_emb.detach()), "projection": compare(clr_proj, a_proj.detach())}
        clr_state, ref_state = clr.model.state_dict(), clr_ref.model.state_dict()
        for k in ref_state:
            if k.endswith(("running_mean", "running_var")):
                checks[k] = compare(clr_state[k], ref_state[k])
        bad = {k: v for k, v in checks.items() if not (v[1] <= 2e-3 and v[2] > 0.9999)}
        res["dynaclr_loss_rel"] = abs(float(clr_loss.detach()) - float(ref_loss.detach())) / abs(float(ref_loss))
        if bad or res["dynaclr_loss_rel"] > 2e-3:
            raise AssertionError(f"[ddp] DynaCLR two ranks vs one process: {bad}, loss {res['dynaclr_loss_rel']:.2e}")
        res["dynaclr_worst"] = max(v[1] for v in checks.values())
        zero = {f"model.{m}": f"model.{m.replace('bias', 'weight')}"
                for m in ("encoder.head.norm.bias", "projection.0.bias", "projection.3.bias")}
        res["dynaclr_grads"], res["dynaclr_grad_worst"] = _compare_grads(clr, clr_ref, zero,
                                                                         "[ddp] two ranks vs one process, DynaCLR")
        del clr, clr_ref
        torch.cuda.empty_cache()
        res.update(ddp_gan_check(gan_two, ddp_gan_steps(gan_ref, gan_batch)))
        if res["loss_rel"] > 2e-3:
            raise AssertionError(f"[ddp] flagship loss of two ranks vs one process: rel {res['loss_rel']:.2e}")
    res["marks"] = dict(marks, done=time.perf_counter() - t_start)
    Path(out).write_text(json.dumps(res))


def ddp_gan_engine():
    """Phase 19 (b)'s GAN: phase 17's engine (R1, R2, LeCam, EMA) in f32
    with drop path 0, R1 / R2 every second step, GRN gamma/beta non-zero."""
    module = gan_engine("cuda", "float32", 0.0)
    module.r1_every = 2
    randomize_grn(module, 1960)
    return module.train()


def ddp_gan_steps(module, batch: dict) -> list[dict]:
    """``DDP_GAN_STEPS`` forward and backward passes of ``module`` on
    ``batch``, the gradients averaged over the processes (no optimizer step):
    per step the loss and its terms averaged over the processes, the LeCam
    EMAs, every gradient, and the seconds."""
    from viscy_tpu_torch.parallel import all_reduce_gradients_, all_reduce_mean

    out = []
    for _ in range(DDP_GAN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        module.zero_grad(set_to_none=True)
        loss = module.training_loss(batch)
        loss.backward()
        all_reduce_gradients_(module.parameters())
        torch.cuda.synchronize()
        out.append(dict(seconds=time.perf_counter() - t0, loss=float(all_reduce_mean(loss.detach())),
                        terms={k: float(all_reduce_mean(v)) for k, v in module.last_metrics.items()},
                        lecam=[float(module.lecam_real), float(module.lecam_fake)],
                        grads={n: None if p.grad is None else p.grad.detach().clone()
                               for n, p in module.named_parameters()}))
    return out


def ddp_gan_check(two: list[dict], one: list[dict]) -> dict:
    """Phase 19 (b) on rank 0: the two ranks' GAN passes against one
    process's at the global batch: the loss, each term and the LeCam EMAs
    within 2e-3 relative, every gradient within 2e-3 of range and r >
    0.9999 (:func:`compare_grad_dicts`)."""
    worst_rel, grads, worst = 0.0, [], []
    for i, (got, want) in enumerate(zip(two, one)):
        if ("loss/r1" in got["terms"]) != (i == 0) or got["terms"].keys() != want["terms"].keys():
            raise AssertionError(f"[ddp] GAN pass {i}: terms {sorted(got['terms'])} vs {sorted(want['terms'])}")
        pairs = [(got["loss"], want["loss"]), *zip(got["lecam"], want["lecam"]),
                 *((got["terms"][k], want["terms"][k]) for k in want["terms"])]
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in pairs)
        if rel > 2e-3:
            raise AssertionError(f"[ddp] GAN pass {i}: loss, terms or LeCam EMAs {rel:.2e} relative from one process")
        worst_rel = max(worst_rel, rel)
        n, w = compare_grad_dicts(got["grads"], want["grads"], GAN_NORMED_BIASES,
                                  f"[ddp] GAN pass {i}, two ranks vs one process")
        grads.append(n)
        worst.append(w)
    return dict(gan_rel=worst_rel, gan_grads=grads, gan_grad_worst=max(worst),
                gan_terms=[sorted(t["terms"]) for t in two], gan_single_s=[t["seconds"] for t in one])


def ddp_steps(card: str, tmp: Path) -> dict:
    """Phase 19 (b): two processes on the one card over gloo (see
    :func:`ddp_step_worker`)."""
    port = _free_port()
    ranks = run_processes("ddp_step_worker", [_rank_env(2, r, port, 0) for r in range(2)], tmp, "ddp_gloo")
    r0 = ranks[0]
    if ranks[0]["gan_lecam"] != ranks[1]["gan_lecam"]:
        raise AssertionError(f"[ddp] the ranks' LeCam EMAs differ: {[r['gan_lecam'] for r in ranks]}")
    for r in ranks:
        if r["gan_launches"]["fwd"] == 0 or r["gan_launches"]["bwd"] == 0:
            raise AssertionError(f"[ddp] rank {r['rank']}'s GAN passes launched {r['gan_launches']}")
    for r in ranks:
        if min(r["launches"].values()) == 0:
            raise AssertionError(f"[ddp] rank {r['rank']} launched {r['launches']}: every kernel must run")
        log(f"[ddp] (b) rank {r['rank']} on {r['device']}: flagship f32 step of {DDP_RANK_BATCH} "
            f"{TRAIN_PATCH} patches {r['step_s'] * 1e3:.1f} ms (forward, backward, gloo reduce; second step), "
            f"reduce {r['reduce_ms']:.1f} ms (CUDA events, median of 3); launches A+B {r['launches']['fwd']}, C+D "
            f"{r['launches']['bwd']}, warp {r['launches']['warp']}; DynaCLR step of {DDP_DYNACLR_RANK_BATCH} pairs "
            f"{r['dynaclr_step_s'] * 1e3:.1f} ms; peak {r['peak_gib']:.2f} GiB; seconds since the process's "
            f"start: {', '.join(f'{k} {v:.1f}' for k, v in r['marks'].items())} ({card})")
    log(f"[ddp] (b) against one process at the global batch ({2 * DDP_RANK_BATCH} patches, "
        f"{r0['single_step_s'] * 1e3:.1f} ms a forward + backward there): flagship loss rel {r0['loss_rel']:.2e}, "
        f"{r0['grads']} gradients within 2e-3 of range and r > 0.9999, worst {r0['worst'][1]} "
        f"{r0['worst'][0]:.2e}; DynaCLR ({2 * DDP_DYNACLR_RANK_BATCH} pairs) loss rel "
        f"{r0['dynaclr_loss_rel']:.2e}, embedding, projection and running statistics worst "
        f"{r0['dynaclr_worst']:.2e} of range, {r0['dynaclr_grads']} gradients, worst "
        f"{r0['dynaclr_grad_worst'][1]} {r0['dynaclr_grad_worst'][0]:.2e}")
    log(f"[ddp] (b) DynacellGAN f32 (FCMAE generator, PatchGAN3D, R1 / R2 every second step, LeCam, EMA), "
        f"{DDP_GAN_RANK_BATCH} windows of {DDP_GAN_ZYX} a rank, {DDP_GAN_STEPS} passes (terms "
        f"{r0['gan_terms']}): a rank's pass {', '.join(f'{s * 1e3:.1f}' for s in r0['gan_step_s'])} ms, one "
        f"process at the global batch {', '.join(f'{s * 1e3:.1f}' for s in r0['gan_single_s'])} ms; loss, terms and "
        f"LeCam EMAs (equal on both ranks) within {r0['gan_rel']:.2e} relative of one process; "
        f"{'+'.join(str(n) for n in r0['gan_grads'])} gradients within 2e-3 of range and r > 0.9999, worst "
        f"{r0['gan_grad_worst'][1]} {r0['gan_grad_worst'][0]:.2e}; launches a rank "
        f"{[r['gan_launches'] for r in ranks]}; peak {', '.join(f'{r['gan_peak_gib']:.2f}' for r in ranks)} GiB "
        f"({card})")
    return dict(launches={k: sum(r["launches"][k] + r["gan_launches"][k] for r in ranks) for k in ("fwd", "bwd", "warp")},
                step_ms=[r["step_s"] * 1e3 for r in ranks], reduce_ms=[r["reduce_ms"] for r in ranks])


def phase_ddp(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 19: data parallelism across processes (see the module docstring)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    fit = ddp_fit(card, tmp, plate)
    steps = ddp_steps(card, tmp)
    log(f"[ddp] phase 19 in {time.perf_counter() - t0:.1f} s")
    return dict(fit=fit, steps=steps,
                launches={k: fit["launches"][k] + steps["launches"][k] for k in ("fwd", "bwd", "warp")})


# -- phase 20: QC, rotation-TTA prediction, the segmentation test stage, the callbacks in a fit ------------


# (b): one FOV of the predict plates' frame (the serving phase's 2048^2 x 15), untiled; the cross-check on
# a crop whose X the model's 2^4 factor does not divide
TTA_FOV = (1, 1, 15, 2048, 2048)
TTA_XCHECK = (1, 1, 15, 400, 360)
# (c): label plates of SEG_FOVS FOVs of SEG_ZYX (int labels as f32), SEG_CELLS instances a slice
SEG_FOVS = ("0", "1")
SEG_ZYX = (4, 512, 512)
SEG_CELLS = 60


def qc_config(tmp: Path, plate: Path) -> tuple[Path, dict]:
    """``configs/qc_run.yml`` rewritten for phase 9's fit plate: its path,
    and the annotated fluorescence channel ``GFP`` renamed to the plate's
    ``Nucleus`` (the focus channel Phase3D and the well A/1 are the
    plate's already)."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs/qc_run.yml").read_text())
    cfg["data_path"] = str(plate)
    channels = cfg["annotation"]["channels_metadata"]
    channels["Nucleus"] = channels.pop("GFP")
    path = tmp / "qc_run.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def _zattrs(plate: Path) -> dict:
    return {str(f.relative_to(plate)): json.loads(f.read_text()) for f in sorted(plate.rglob(".zattrs"))}


def phase_qc(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 20 (a): ``python -m viscy_tpu_torch.apps.qc.cli run -c`` on the
    rewritten ``configs/qc_run.yml`` (focus slice of Phase3D, channel and
    experiment annotation) over phase 9's fit plate, on the card; every
    focus index against the argmax of a float64 FFT on the host (the
    smallest relative margin between the best and the second band power
    printed); every ``.zattrs`` against the same command with ``--device
    cpu``; the seconds per FOV of the metric in process on the card. The
    plate's ``.zattrs`` are restored afterwards."""
    import scipy.fft

    from viscy_tpu_torch.apps.qc import cli as qc_cli
    from viscy_tpu_torch.apps.qc.focus import FocusSliceMetric
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    path, cfg = qc_config(tmp, plate)
    saved = {f: f.read_bytes() for f in plate.rglob(".zattrs")}

    def restore() -> None:
        for f, raw in saved.items():
            f.write_bytes(raw)

    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "viscy_tpu_torch.apps.qc.cli", "run", "-c", str(path)], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=600)
    command_s = time.perf_counter() - t0
    if run.returncode:
        raise AssertionError(f"[qc] the QC command failed ({run.returncode}): {run.stdout[-2000:]}{run.stderr[-4000:]}")
    on_card = _zattrs(plate)
    restore()
    qc_cli.main(["run", "-c", str(path), "--device", "cpu"], standalone_mode=False)
    on_cpu = _zattrs(plate)
    restore()
    if on_card != on_cpu:
        differ = sorted(k for k in on_cpu if on_card.get(k) != on_cpu[k])
        raise AssertionError(f"[qc] the card's .zattrs differ from the CPU's in {differ}")
    focus = cfg["focus_slice"]
    metric = FocusSliceMetric(focus["NA_det"], focus["lambda_ill"], focus["pixel_size"], focus["channel_names"],
                              focus["midband_fractions"], device="cuda")
    store = open_ome_zarr(plate)
    ch = store.channel_names.index("Phase3D")
    margins, per_fov = [], []
    for name, pos in store.positions():
        stack = pos["0"][:, ch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric(pos, "Phase3D", ch)
        torch.cuda.synchronize()
        per_fov.append(time.perf_counter() - t0)
        _, y, x = stack.shape[1:]
        frr = np.hypot(*np.meshgrid(np.fft.fftfreq(y, focus["pixel_size"]), np.fft.fftfreq(x, focus["pixel_size"]),
                                    indexing="ij"))
        cut = 2 * focus["NA_det"] / focus["lambda_ill"]
        lo, hi = focus["midband_fractions"]
        band = (frr > lo * cut) & (frr < hi * cut)
        got = on_card[f"{name}/.zattrs"]["focus_slice"]["Phase3D"]["per_timepoint"]
        for t in range(stack.shape[0]):
            power = (np.abs(scipy.fft.fft2(stack[t].astype(np.float64), axes=(1, 2), workers=8)) * band).sum(axis=(1, 2))
            order = np.argsort(power)[::-1]
            margins.append((power[order[0]] - power[order[1]]) / power[order[0]])
            if got[str(t)] != int(order[0]):
                raise AssertionError(f"[qc] {name} t={t}: focus index {got[str(t)]} on the card, {order[0]} in f64")
    annotated = [k for k, v in on_card.items() if "experiment_metadata" in v]
    log(f"[qc] python -m viscy_tpu_torch.apps.qc.cli run -c configs/qc_run.yml (rewritten for phase 9's plate: "
        f"{len(per_fov)} FOVs of (1, 3, {', '.join(map(str, CLI_FIT_ZYX))})): {command_s:.2f} s for the command "
        f"(interpreter start included); the focus metric in process {np.mean(per_fov):.3f} s per FOV (read + "
        f"FFT on the card; {', '.join(f'{v:.3f}' for v in per_fov)}); every focus index equals the float64 "
        f"FFT's argmax on the host (smallest margin between the best and the second band power "
        f"{min(margins):.3e} of the best); all {len(on_card)} .zattrs equal to the --device cpu run's "
        f"(experiment_metadata on {len(annotated)} positions) ({card})")
    return dict(per_fov_s=float(np.mean(per_fov)), command_s=command_s, margin=float(min(margins)))


class _PredictBatches:
    """A datamodule whose predict loader yields the given batches."""

    def __init__(self, batches: list[dict]) -> None:
        self.batches = batches

    def setup(self, stage: str) -> None:
        pass

    def predict_dataloader(self):
        return self.batches


def phase_tta(card: str) -> dict:
    """Phase 20 (b): ``AugmentedPredictionVSUNet.with_rotation_tta`` (4
    rotations, median) around the flagship predict model
    (``configs/vscyto3d_predict.yml``: f32, full width, seeded weights, GRN
    gamma/beta non-zero) through ``Trainer.predict``: one seeded host FOV of
    ``TTA_FOV`` (one untiled forward a rotation), a warm-up request, then a
    timed one with its fused-forward launches counted; the median of the
    four rotations on a ``TTA_XCHECK`` crop on the card against the same
    call on the CPU (plain kernels): max |d| <= 2e-3 of range, r > 0.9999;
    then the forward kernels at this path's shapes (B = 1, full frames)
    against their plain version."""
    import copy

    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.apps.cytoland.prediction import AugmentedPredictionVSUNet
    from viscy_tpu_torch.training.trainer import Trainer

    cfg = shipped_model_config("vscyto3d_predict.yml")
    engine = VSUNet("fcmae", cfg, device="cuda")
    randomize_grn(engine, 2000)
    module = AugmentedPredictionVSUNet.with_rotation_tta(engine.model, 4, "median")
    fov = np.random.default_rng(2001).random(TTA_FOV, dtype=np.float32)
    trainer = Trainer(device="cuda", use_tensorboard=False, default_root_dir=str(ROOT / "lightning_logs"))
    trainer.predict(module, _PredictBatches([{"source": fov}]))
    _zero_counts()
    t0 = time.perf_counter()
    (pred,) = trainer.predict(module, _PredictBatches([{"source": fov}]), return_predictions=True)
    torch.cuda.synchronize()
    fov_s = time.perf_counter() - t0
    counts = _counts()
    want = 4 * _fused_launches(cfg, TTA_FOV[-1], 1)
    if tuple(pred.shape) != (1, 2, *TTA_FOV[2:]) or not torch.isfinite(pred).all() or counts["fwd"] != want:
        raise AssertionError(f"[tta] prediction {tuple(pred.shape)}, launches {counts} (expected {want} forward)")
    del pred
    crop = torch.from_numpy(np.ascontiguousarray(fov[..., :TTA_XCHECK[-2], :TTA_XCHECK[-1]]))
    on_cpu = AugmentedPredictionVSUNet.with_rotation_tta(copy.deepcopy(engine.model).cpu(), 4, "median").eval()
    with torch.inference_mode():
        got = module.eval().predict_step({"source": crop.cuda()}).cpu()
        ref = on_cpu.predict_step({"source": crop})
    _, rel, r = compare(got, ref)
    if not (rel <= 2e-3 and r > 0.9999):
        raise AssertionError(f"[tta] the card's TTA median disagrees with the CPU's: {rel:.2e} of range, r={r:.8f}")
    del engine, module, on_cpu
    torch.cuda.empty_cache()
    worst: dict = {}
    shapes = kernel_shapes(cfg, TTA_FOV[-1])
    for k, (s_, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
        check_forward(1, s_, c, m, 2010 + k, (False,), worst)
    log_worst("the TTA path's shapes (B=1, full 2048^2 frames)", worst)
    log(f"[tta] AugmentedPredictionVSUNet.with_rotation_tta(4, median) on configs/vscyto3d_predict.yml's model (f32, "
        f"full width) through Trainer.predict: one {TTA_FOV} FOV in {fov_s:.3f} s ({1 / fov_s:.4f} FOVs/s, host "
        f"FOV to prediction on the card, four untiled forwards and the median); fused-forward launches "
        f"{counts['fwd']} (4 rotations x {want // 4}); {TTA_XCHECK} crop card vs CPU {rel:.2e} of range, "
        f"r={r:.8f} ({card})")
    return dict(launches=counts, fov_s=fov_s, rel=rel, max_abs_err=worst[torch.float32][0])


def _seg_labels(rng, shape) -> np.ndarray:
    """Rectangular instances on a 2-D frame, some overlapping."""
    out = np.zeros(shape, np.float32)
    for i in range(1, SEG_CELLS + 1):
        y, x = rng.integers(0, shape[0] - 40), rng.integers(0, shape[1] - 40)
        h, w = rng.integers(12, 40, 2)
        out[y:y + h, x:x + w] = i
    return out


def phase_seg(card: str, tmp: Path) -> dict:
    """Phase 20 (c): ``Trainer.test(SegmentationMetrics2D(),
    SegmentationDataModule(...))`` on the card over seeded target and
    prediction label plates (the prediction: the target's instances
    shifted, some dropped, others added); every mean metric equal to the
    plain computation (``evaluation/metrics.py`` on each slice, averaged)."""
    from viscy_tpu_torch.apps.cytoland.evaluation import SegmentationMetrics2D
    from viscy_tpu_torch.data.segmentation import SegmentationDataModule
    from viscy_tpu_torch.evaluation.metrics import pod_metric, voi_score
    from viscy_tpu_torch.training.trainer import Trainer
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    rng = np.random.default_rng(2020)
    plates = {side: open_ome_zarr(tmp / f"seg_{side}.zarr", layout="hcs", mode="w-", channel_names=["seg"])
              for side in ("target", "pred")}
    slices = []
    for fov in SEG_FOVS:
        target = np.stack([_seg_labels(rng, SEG_ZYX[1:]) for _ in range(SEG_ZYX[0])])
        pred = np.roll(target, (3, -2), axis=(1, 2))
        pred[np.isin(pred, rng.choice(SEG_CELLS, 10))] = 0
        pred[:, :30, :30] = SEG_CELLS + 1
        for side, labels in (("target", target), ("pred", pred)):
            plates[side].create_position("A", "1", fov).create_image("0", labels[None, None])
        slices.extend(zip(pred.astype(np.int16), target.astype(np.int16)))
    t0 = time.perf_counter()
    got = Trainer(device="cuda", default_root_dir=str(tmp / "seg_test"), use_tensorboard=False).test(
        SegmentationMetrics2D(), SegmentationDataModule(tmp / "seg_pred.zarr", tmp / "seg_target.zarr", "seg", "seg"))
    test_s = time.perf_counter() - t0
    plain: dict[str, list] = {}
    for p_, t_ in slices:
        pb, tb = p_ > 0, t_ > 0
        pod, voi = pod_metric(p_, t_), voi_score(p_, t_)
        values = {"accuracy": (pb == tb).mean(), "dice": 2 * np.logical_and(pb, tb).sum() / max(pb.sum() + tb.sum(), 1),
                  "jaccard": np.logical_and(pb, tb).sum() / max(np.logical_or(pb, tb).sum(), 1),
                  "pod_f1": pod["f1"], "pod_precision": pod["precision"], "pod_recall": pod["recall"],
                  "voi": voi[0] + voi[1]}
        for k, v in values.items():
            plain.setdefault(f"test_metrics/{k}", []).append(float(v))
    want = {k: float(np.mean(v)) for k, v in plain.items()}
    if got.keys() != want.keys() or any(abs(got[k] - want[k]) > 1e-12 for k in want):
        raise AssertionError(f"[seg] Trainer.test {got} differs from the plain computation {want}")
    for side in plates:
        shutil.rmtree(tmp / f"seg_{side}.zarr")
    log(f"[seg] Trainer.test(SegmentationMetrics2D(), SegmentationDataModule) on the card, {len(slices)} slices of "
        f"{SEG_ZYX[1]}^2 ({SEG_CELLS} instances each): {test_s:.2f} s = {test_s / len(slices):.3f} s a slice (host "
        f"metrics); every metric equals the plain computation: "
        f"{', '.join(f'{k.split('/')[1]} {v:.5f}' for k, v in sorted(got.items()))} ({card})")
    return dict(slice_s=test_s / len(slices))


def phase_callbacks(card: str, tmp: Path, plate: Path, tracks: Path) -> dict:
    """Phase 20 (d): phase 14's ``fit -c configs/dynaclr_fit.yml`` with
    ``EmbeddingSnapshotCallback`` and ``OnlineEvalCallback`` added to the
    recipe's callbacks, one epoch; the snapshot ``embeddings/epoch_0.npy``
    against a CPU forward of the same validation anchors (the first batch
    through the datamodule's validation transform) with the ``last``
    weights (<= 2e-3 of range, r > 0.9999; the transform's draws from epoch
    0's validation generator); the logged online metrics
    against the callback's functions run on the host on the features it
    collected."""
    from viscy_tpu_torch.training.callbacks.online_eval import OnlineEvalCallback, effective_rank
    from viscy_tpu_torch.training.trainer import BatchPrefetcher, read_checkpoint

    callbacks = load_composed_config_node("dynaclr_fit.yml", "trainer")["callbacks"] + [
        {"class_path": "viscy_utils.callbacks.EmbeddingSnapshotCallback", "init_args": {"every_n_epochs": 1}},
        {"class_path": "viscy_utils.callbacks.OnlineEvalCallback", "init_args": {"every_n_epochs": 1}}]
    trainer, root, counts = _dynaclr_fit(tmp, "dynaclr_callbacks", plate, tracks, None, card, callbacks=callbacks)
    snapshot = np.load(root / "embeddings" / "epoch_0.npy")
    online = next(cb for cb in trainer.callbacks if isinstance(cb, OnlineEvalCallback))
    feats = np.concatenate(online._features)
    lines = [json.loads(x) for x in (root / "metrics.csv").read_text().splitlines()]
    logged = {k: v for x in lines for k, v in x.items() if k.endswith("effective_rank") or "effective_rank/" in k}
    rank = effective_rank(feats)
    if logged != {"metrics/effective_rank/val": rank, "online_eval/effective_rank": rank}:
        raise AssertionError(f"[callbacks] logged {logged}, the host's effective rank {rank}")
    dm = trainer._active_datamodule
    (batch,) = list(BatchPrefetcher(dm.val_dataloader(), trainer.device, limit=1))
    # epoch 0's validation generator, as the trainer seeds it: the first batch's draws again
    val_gen = torch.Generator(device=trainer.device).manual_seed(trainer._rank_seed(trainer.seed + 2))
    anchors = dm.device_transform(batch, val_gen, "val")["anchor"].cpu()
    cpu = dynaclr_module("cpu")
    cpu.model.load_state_dict(read_checkpoint(root / "checkpoints" / "last")[1])
    n = min(8, len(anchors))
    with torch.no_grad():
        want = cpu.eval().model(anchors[:n])[0]
    _, rel, r = compare(torch.from_numpy(snapshot[:n]), want)
    _, frel, _ = compare(torch.from_numpy(feats[:len(snapshot)]), torch.from_numpy(snapshot))
    if snapshot.shape[0] != len(anchors) or not (rel <= 2e-3 and r > 0.9999 and frel <= 2e-3):
        raise AssertionError(f"[callbacks] snapshot {snapshot.shape} against the CPU: {rel:.2e} of range, r={r:.8f}; "
                             f"against the online callback's features {frel:.2e}")
    del trainer, cpu
    torch.cuda.empty_cache()
    import importlib.util

    pairplot = "logged" if importlib.util.find_spec("matplotlib") else "skipped (no matplotlib here)"
    log(f"[callbacks] fit -c configs/dynaclr_fit.yml with EmbeddingSnapshotCallback and OnlineEvalCallback, one "
        f"epoch: embeddings/epoch_0.npy {snapshot.shape} (PCA pairplot {pairplot}), its first {n} rows vs a CPU "
        f"forward of the same anchors "
        f"{rel:.2e} of range, r={r:.8f}; the online features vs the snapshot {frel:.2e}; logged effective rank "
        f"{rank:.6f} = the host's on {feats.shape[0]} collected features (no k-NN or smoothness: the validation "
        f"batches carry no labels or tracks); launches {counts} ({card})")
    return dict(launches=counts, rank=rank)


# -- phase 21: the remaining transforms through viscy-torch fit ---------------------------------------

TRANSFORM_STEPS = 3
TRANSFORM_VAL = 1
TRANSFORM_SHAPE = (15, 384, 384)
TRANSFORM_XCHECK_BATCH = 2
TRANSFORM_RUNS = 5
FIT2D_BATCH = 32
FIT2D_YX = 256
FIT2D_DEPTH = 5
HOST_KEYS = list(CLI_CHANNELS)

# leg (a): every augmentation under its MONAI name, all twelve aliases
MONAI_AUGS = [
    ("RandWeightedCropd", {"keys": HOST_KEYS + ["weight"], "w_key": "weight", "spatial_size": [15, 448, 448],
                           "num_samples": 4}),
    ("RandSpatialCropd", {"keys": HOST_KEYS, "roi_size": [15, 416, 416]}),
    ("RandAffined", {"keys": HOST_KEYS, "prob": 0.5, "rotate_range": [3.14, 0.0, 0.0],
                     "scale_range": [0.0, 0.1, 0.1]}),
    ("CenterSpatialCropd", {"keys": HOST_KEYS, "roi_size": list(TRANSFORM_SHAPE)}),
    ("RandFlipd", {"keys": HOST_KEYS, "spatial_axes": [1, 2], "prob": 0.5}),
    ("RandAdjustContrastd", {"keys": ["Phase3D"], "prob": 0.3, "gamma": [0.8, 1.2]}),
    ("RandScaleIntensityd", {"keys": ["Phase3D"], "factors": 0.3, "prob": 0.5}),
    ("RandGaussianNoised", {"keys": ["Phase3D"], "prob": 0.5, "std": 0.1}),
    ("RandGaussianSmoothd", {"keys": ["Phase3D"], "prob": 0.3}),
    ("ScaleIntensityRangePercentilesd", {"keys": ["Phase3D"], "lower": 1, "upper": 99, "b_min": 0, "b_max": 1}),
    ("NormalizeIntensityd", {"keys": ["Nucleus", "Membrane"]}),
    ("ToDeviced", {"keys": HOST_KEYS, "device": "cuda"}),
]

# leg (b): the shipped host weighted crop, then every new batched member
_SRC, _BOTH = {"keys": ["source"]}, {"keys": ["source", "target"]}
DEVICE_AUGS = [
    ("BatchedRandFlipd", dict(_BOTH, prob=0.5)),
    ("BatchedRandAffined", dict(_BOTH, prob=0.5, rotate_range=[3.14, 0.0, 0.0],
                                scale_range=[[1.0, 1.3], [0.75, 1.3], [0.75, 1.3]])),
    ("BatchedRand3DElasticd", dict(_BOTH, prob=0.5, sigma_range=[2.0, 3.0], magnitude_range=[2.0, 4.0])),
    ("BatchedRandZStackShiftd", dict(_BOTH, prob=0.5, max_shift=2)),
    ("BatchedRandHistogramShiftd", dict(_SRC, prob=0.5)),
    ("BatchedRandSharpend", dict(_SRC, prob=0.5, alpha=[1.0, 3.0])),
    ("BatchedRandLocalPixelShufflingd", dict(_SRC, prob=0.5)),
    ("BatchedRandInvertIntensityd", dict(_SRC, prob=0.5)),
    ("BatchedScaleIntensityRangePercentilesd", dict(_SRC, lower=1, upper=99, b_min=0, b_max=1)),
    ("BatchedRandAdjustContrastd", dict(_SRC, prob=0.5, gamma=[0.8, 1.2])),
    ("BatchedRandGaussianNoised", dict(_SRC, prob=0.5, std=0.5)),
]


def _aug_nodes(members: list, prefix: str = "viscy_transforms") -> list:
    return [{"class_path": f"{prefix}.{name}", "init_args": dict(kw)} for name, kw in members]


def new_members() -> dict:
    """Every device transform this phase checks, at the shapes of a
    (B, 1 + 2, 15, 384, 384) source / target batch."""
    from viscy_tpu_torch import transforms as T

    members = {}
    for name, kw in DEVICE_AUGS[2:9]:
        members[name] = getattr(T, name)(**kw)
    members.update(
        RandInvertIntensityd=T.RandInvertIntensityd(keys=["source"], prob=1.0),
        RandGaussianNoiseTensord=T.RandGaussianNoiseTensord(keys=["source"], prob=1.0, std=0.3),
        BatchedRandWeightedCropd=T.BatchedRandWeightedCropd(keys=["source", "target"], w_key="target",
                                                            spatial_size=(15, 256, 256)),
        BatchedChannelWiseZReductiond=T.BatchedChannelWiseZReductiond(keys=["source", "target"]),
        **{f"BatchedZoomd-{mode}-aa{int(aa)}": T.BatchedZoomd(keys=["source", "target"], scale_factor=(1.0, 0.5, 0.5),
                                                            mode=mode, antialias=aa)
           for mode in ("linear", "bicubic") for aa in (False, True)},
    )
    return members


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _member_call(t, data: dict, draws: dict | None):
    return t(data, draws=draws) if getattr(t, "is_random", False) else t(data)


def transform_checks(card: str) -> dict:
    """Phase 21 (d): each new device member on a seeded (2, 1 + 2, 15, 384,
    384) f32 batch, its draws taken once on the CPU and handed to the card
    and to the CPU run: max|d| <= 1e-5 of the output's range; then the
    CUDA-event median of each (draws included) at batch 16 beside the affine
    member's (the warp kernel, in == out). Returns the worst relative error
    and the times."""
    from viscy_tpu_torch import transforms as T

    g = torch.Generator().manual_seed(2101)
    small = {"source": torch.rand((TRANSFORM_XCHECK_BATCH, 1, *TRANSFORM_SHAPE), generator=g),
             "target": torch.rand((TRANSFORM_XCHECK_BATCH, 2, *TRANSFORM_SHAPE), generator=g)}
    errs = {}
    for name, t in new_members().items():
        draws = t.draw(small, torch.Generator().manual_seed(7)) if getattr(t, "is_random", False) else None
        want = _member_call(t, dict(small), draws)
        got = _member_call(t, _to(small, "cuda"), _to(draws, "cuda"))
        errs[name] = 0.0
        for k in want:
            span = float(want[k].max() - want[k].min()) or 1.0
            rel = float((got[k].cpu().double() - want[k].double()).abs().max()) / span
            if got[k].shape != want[k].shape or not torch.isfinite(got[k]).all() or rel > 1e-5:
                raise AssertionError(f"{name} on the card against the CPU: {k} {tuple(got[k].shape)} vs "
                                     f"{tuple(want[k].shape)}, max|d| {rel:.3g} of range")
            errs[name] = max(errs[name], rel)
    worst = max(errs.values())
    log(f"[transforms] card against CPU, the same draws, ({TRANSFORM_XCHECK_BATCH}, 1+2, "
        f"{', '.join(map(str, TRANSFORM_SHAPE))}) f32, max|d| / range per member: "
        f"{'; '.join(f'{k} {v:.2g}' for k, v in errs.items())} "
        f"(bound 1e-5) ({card})")
    gen = torch.Generator(device="cuda").manual_seed(2102)
    batch = {"source": torch.rand((TRAIN_BATCH, 1, *TRANSFORM_SHAPE), generator=gen, device="cuda"),
             "target": torch.rand((TRAIN_BATCH, 2, *TRANSFORM_SHAPE), generator=gen, device="cuda")}
    affine = T.BatchedRandAffined(**dict(DEVICE_AUGS[1][1], prob=1.0))
    times = {"BatchedRandAffined (warp kernel)": cuda_median_ms(lambda: affine(batch, gen), TRANSFORM_RUNS)}
    for name, t in new_members().items():
        fn = (lambda t=t: t(batch, gen)) if getattr(t, "is_random", False) else (lambda t=t: t(batch))
        times[name] = cuda_median_ms(fn, TRANSFORM_RUNS)
    stack = T.BatchedStackChannelsd(stacked=["source", "target"])
    times["BatchedStackChannelsd"] = cuda_median_ms(lambda: stack(batch), TRANSFORM_RUNS)
    warp_ms = times["BatchedRandAffined (warp kernel)"]
    log(f"[transforms] CUDA-event medians of {TRANSFORM_RUNS} calls at ({TRAIN_BATCH}, 1+2, "
        f"{', '.join(map(str, TRANSFORM_SHAPE))}) f32, draws included: "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in times.items())
        + f"; slower than the warp: {[k for k, v in times.items() if v > warp_ms] or 'none'} ({card})")
    del batch
    torch.cuda.empty_cache()
    return dict(max_rel_err=worst, times=times)


def transform_fit(card: str, tmp: Path, plate: Path, name: str, edit, want: dict) -> dict:
    """One ``viscy-torch fit`` of phase 21: ``configs/<shipped>`` composed,
    ``edit``-ed, one epoch of ``TRANSFORM_STEPS`` steps and
    ``TRANSFORM_VAL`` validation batch on phase 9's plate; the launch counts
    against ``want``, finite losses; prints the rate and the wait share."""
    from viscy_tpu_torch.training import cli

    from viscy_tpu_torch.training.compose import load_composed_config

    root = tmp / f"transforms_{name}"

    def full_edit(cfg):
        cfg["data"]["init_args"].update(data_path=str(plate), num_workers=8)
        cfg["trainer"].update(default_root_dir=str(root), max_epochs=1, limit_train_batches=TRANSFORM_STEPS,
                              limit_val_batches=TRANSFORM_VAL, log_every_n_steps=1)
        edit(cfg)

    shipped, what = edit(None)
    model = load_composed_config(ROOT / "configs" / shipped)["model"]
    model["init_args"].pop("ckpt_path", None)
    model["init_args"].pop("encoder_only", None)
    path = _composed(tmp, shipped, f"transforms_{name}.yml", model, full_edit)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", path])
    counts = _counts()
    fit_s = time.perf_counter() - t0
    feed = trainer.feed_stats
    val = trainer.logged_metrics.get("loss/validate")
    loss = trainer.logged_metrics.get("loss/train")
    batch = load_composed_config(path)["data"]["init_args"]["batch_size"]
    if (counts != want or feed["steps"] != TRANSFORM_STEPS or val is None or not math.isfinite(val)
            or loss is None or not math.isfinite(loss)):
        raise AssertionError(f"phase 21 ({name}): launches {counts} (expected {want}), {feed['steps']} steps, "
                             f"loss/train {loss}, loss/validate {val}")
    rate = TRANSFORM_STEPS * batch / feed["seconds"]
    log(f"[transforms] ({name}) viscy-torch fit of configs/{shipped} {what}: {fit_s:.1f} s in all; train loop "
        f"{feed['seconds']:.2f} s for {TRANSFORM_STEPS} steps of {batch} = {rate:.2f} patches/s (first step "
        f"included); waited {feed['wait_s']:.2f} s = {feed['wait_s'] / feed['seconds']:.1%} of the loop; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss/train {loss:.5f}, loss/validate "
        f"{val:.5f}; launches {counts} ({card})")
    shutil.rmtree(root, ignore_errors=True)
    del trainer
    torch.cuda.empty_cache()
    return dict(counts=counts, rate=rate, wait=feed["wait_s"] / feed["seconds"])


def fit2d_batch_members(card: str) -> float:
    """Phase 21 (c), second half: ``BatchedZoomd`` (linear and cubic,
    antialias on and off), ``TiledSpatialCropSamplesd``,
    ``BatchedStackChannelsd`` and ``Decollated`` at the 2-D fit's full-width
    batch ((32, 1 + 2, 1, 256, 256)), each on the card against the CPU
    (max|d| <= 1e-5 of range; the crops, stacking and splitting exact), with
    CUDA-event medians. Returns the worst relative error."""
    from viscy_tpu_torch import transforms as T

    g = torch.Generator().manual_seed(2103)
    cpu = {"source": torch.rand((FIT2D_BATCH, 1, 1, FIT2D_YX, FIT2D_YX), generator=g),
           "target": torch.rand((FIT2D_BATCH, 2, 1, FIT2D_YX, FIT2D_YX), generator=g)}
    card_batch = _to(cpu, "cuda")
    members = {f"BatchedZoomd-{m}-aa{int(aa)}": T.BatchedZoomd(keys=["source", "target"], scale_factor=(1.0, 0.5, 0.5),
                                                              mode=m, antialias=aa)
               for m in ("linear", "bicubic") for aa in (False, True)}
    members["BatchedStackChannelsd"] = T.BatchedStackChannelsd(stacked=["source", "target"])
    worst, times = 0.0, {}
    for name, t in members.items():
        want, got = t(dict(cpu)), t(dict(card_batch))
        for k in want:
            span = float(want[k].max() - want[k].min()) or 1.0
            rel = float((got[k].cpu() - want[k]).abs().max()) / span
            if got[k].shape != want[k].shape or rel > 1e-5:
                raise AssertionError(f"{name} ({k}) on the card: {tuple(got[k].shape)}, max|d| {rel:.3g} of range")
            worst = max(worst, rel)
        times[name] = cuda_median_ms(lambda t=t: t(card_batch), TRANSFORM_RUNS)
    tiles = T.TiledSpatialCropSamplesd(keys=["source", "target"], roi_size=(1, 128, 128), num_samples=4)
    parts = T.Decollated(keys=["source", "target"])
    for t, name in ((tiles, "TiledSpatialCropSamplesd"), (parts, "Decollated")):
        want, got = t(dict(cpu)), t(dict(card_batch))
        if len(want) != len(got) or any(not torch.equal(a[k].cpu(), b[k]) for a, b in zip(got, want)
                                        for k in ("source", "target")):
            raise AssertionError(f"{name} on the card differs from the CPU")
        times[name] = cuda_median_ms(lambda t=t: t(card_batch), TRANSFORM_RUNS)
    log(f"[transforms] (c) at the 2-D fit's batch ({FIT2D_BATCH}, 1+2, 1, {FIT2D_YX}, {FIT2D_YX}) f32, card "
        f"against CPU max|d| / range {worst:.2g} (bound 1e-5; tiles, stacking and splitting exact); medians: "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in times.items()) + f" ({card})")
    return worst


def phase_transforms(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 21: the remaining transforms (see the module docstring)."""
    from viscy_tpu_torch.training.compose import load_composed_config

    checks = transform_checks(card)
    per_fwd = len(kernel_shapes(FLAGSHIP, TRANSFORM_SHAPE[-1]))
    crop448 = _fused_launches(FLAGSHIP, 448, TRAIN_BATCH)
    cfg2d = shipped_model_config("vscyto2d_finetune.yml")
    worst: dict = {}
    for cfg, yx, batch in ((FLAGSHIP, 448, TRAIN_BATCH), (cfg2d, FIT2D_YX, FIT2D_BATCH)):
        shapes = kernel_shapes(cfg, yx)
        for k, (s, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
            check_forward(batch, s, c, m, 2110 + yx + k, (False,), worst)
    log_worst(f"leg (a)'s validation (B={TRAIN_BATCH}, 448^2) and leg (c) (B={FIT2D_BATCH}, {FIT2D_YX}^2)", worst)

    def leg_a(cfg):
        if cfg is None:
            crops = [kw.get("spatial_size", kw.get("roi_size")) for _, kw in MONAI_AUGS[:4]]
            return "vscyto3d_fit.yml", (f"with its augmentations under their twelve MONAI names on the host "
                                        f"(weighted crop of 4 x {crops[0]}, crop to {crops[1]}, affine, center "
                                        f"crop to {crops[3]}, flip, contrast, scale, noise, smooth, "
                                        f"percentiles, z-score, ToDeviced)")
        cfg["data"]["init_args"]["augmentations"] = _aug_nodes(MONAI_AUGS)
        return cfg

    shipped = load_composed_config(ROOT / "configs/vscyto3d_fit.yml")["data"]["init_args"]["augmentations"]

    def leg_b(cfg):
        if cfg is None:
            return "vscyto3d_fit.yml", ("with its host weighted crop and the batched device list (flip, affine "
                                        "(warp kernel), elastic, Z shift, histogram shift, sharpen, pixel "
                                        "shuffling, inversion, percentiles, contrast, noise)")
        cfg["data"]["init_args"]["augmentations"] = shipped[:1] + _aug_nodes(DEVICE_AUGS)
        return cfg

    per_fwd2d = len(kernel_shapes(cfg2d, FIT2D_YX))
    z_reduce = {"class_path": "viscy_transforms.BatchedChannelWiseZReductiond",
                "init_args": {"keys": ["source"], "default_strategy": "mip"}}
    shipped2d = load_composed_config(ROOT / "configs/vscyto2d_finetune.yml")["data"]["init_args"]

    def leg_c(cfg):
        if cfg is None:
            return "vscyto2d_finetune.yml", (f"(FcmaeUNet, 2-D stem, no checkpoint) on {FIT2D_DEPTH}-slice "
                                             f"windows: host weighted crop of 4 x ({FIT2D_DEPTH}, 288, 288), "
                                             f"affine (warp kernel) fused with a random {FIT2D_YX}^2 crop, "
                                             f"Z reduction (MIP) of the source, contrast, noise")
        init = cfg["data"]["init_args"]
        init.update(target_channel=["Nucleus", "Membrane"], z_window_size=FIT2D_DEPTH)
        init["normalizations"][0]["init_args"]["keys"] = HOST_KEYS
        augs = shipped2d["augmentations"]
        crop = {"class_path": "viscy_tpu.data.host_transforms.HostRandWeightedCropd",
                "init_args": {"keys": HOST_KEYS + ["weight"], "w_key": "weight",
                              "spatial_size": [FIT2D_DEPTH, 288, 288], "num_samples": 4}}
        init["augmentations"] = [crop, augs[1], _train_crop(FIT2D_YX), z_reduce, augs[2], augs[3]]
        init["val_augmentations"] = [z_reduce, {"class_path": "viscy_transforms.BatchedCenterSpatialCropd",
                                                "init_args": {"keys": ["source", "target"],
                                                              "roi_size": [-1, FIT2D_YX, FIT2D_YX]}}]
        return cfg

    want_a = dict(fwd=2 * per_fwd * TRANSFORM_STEPS + crop448 * TRANSFORM_VAL, bwd=2 * per_fwd * TRANSFORM_STEPS,
                  masked_fwd=0, masked_bwd=0, warp=0)
    want_b = dict(fwd=2 * per_fwd * (TRANSFORM_STEPS + TRANSFORM_VAL), bwd=2 * per_fwd * TRANSFORM_STEPS,
                  masked_fwd=0, masked_bwd=0, warp=TRANSFORM_STEPS)
    fwd2d = _fused_launches(cfg2d, FIT2D_YX, FIT2D_BATCH)
    want_c = dict(fwd=fwd2d * (TRANSFORM_STEPS + TRANSFORM_VAL), bwd=2 * per_fwd2d * TRANSFORM_STEPS,
                  masked_fwd=0, masked_bwd=0, warp=TRANSFORM_STEPS)
    legs = {name: transform_fit(card, tmp, plate, name, edit, want)
            for name, edit, want in (("a", leg_a, want_a), ("b", leg_b, want_b), ("c", leg_c, want_c))}
    err2d = fit2d_batch_members(card)
    fwd = sum(leg["counts"]["fwd"] for leg in legs.values())
    bwd = sum(leg["counts"]["bwd"] for leg in legs.values())
    warp = sum(leg["counts"]["warp"] for leg in legs.values())
    return dict(launches=dict(fwd=fwd, bwd=bwd, warp=warp), max_rel_err=max(checks["max_rel_err"], err2d),
                times=checks["times"], legs=legs, fwd_err=worst[torch.bfloat16][0])


# -- phase 22: CELLDiff's Sampler and tiled generation, the foundation extractors, the new datamodules --------


SAMPLER_STEPS = 2
SAMPLER_WINDOW = (1, 1, 8, 512, 512)
SAMPLER_XCHECK = (1, 1, 8, 32, 32)
TILE_FOVS = ((1, 1, 8, 1024, 1024), (1, 1, 8, 1000, 1000))
TILE_STEPS = 1
VIT_S16 = dict(embed_dim=384, depth=12, num_heads=6, resize_to=224)
FOUNDATION_XCHECK = 4  # windows of the predict batch held against the CPU
DIVISION_TRACKS = 40
DIVISION_T = 4
DIVISION_WINDOW = (2, 15, 224, 224)  # configs/dynaclr_fit.yml: 2 channels, z_range 15 deep, final 224^2
P22_STEPS = 3
P22_VAL = 1
CTMC_T = 6
CTMC_ZYX = (1, 1024, 1024)
CLS_CELLS = 64


def _timed(fn):
    """``fn()`` synchronized: (result, seconds, peak GiB since the call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def celldiff_wrappers(seed: int):
    """``CELLDiff3DVS`` with ``configs/celldiff_fit.yml``'s ``net_config`` on
    the card and on the CPU, the same weights (adaLN perturbed), the SDE's
    sample eps 1e-3 (the velocity model's default 0 puts the SBDM diffusion
    at 1 / 1e-7 at t = 0)."""
    from viscy_tpu_torch.apps.dynacell import CELLDiff3DVS

    on_cpu = CELLDiff3DVS(net=load_net_config(), sample_eps=1e-3, device="cpu").eval()
    perturb_adaln(on_cpu, seed)
    on_card = CELLDiff3DVS(net=load_net_config(), sample_eps=1e-3, device="cuda").eval()
    on_card.net.load_state_dict(on_cpu.net.state_dict())
    return on_card, on_cpu


def sampler_methods(wrapper, phase: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor, probes: torch.Tensor,
                    steps: int) -> dict:
    """Each ``Sampler`` method of leg (a) on ``wrapper``'s net conditioned on
    ``phase``: name -> (output, net evaluations, seconds, peak GiB)."""
    from viscy_tpu_torch.models.celldiff import Sampler

    sampler = Sampler(wrapper.transport)
    evals = [0]

    def fn(x, t):
        evals[0] += 1
        return wrapper.net(x, phase, t)

    runs = {
        "ode rk4": lambda: sampler.sample_ode(sampling_method="rk4", num_steps=steps)(x0, fn),
        "ode heun reversed": lambda: sampler.sample_ode(sampling_method="heun", num_steps=steps, reverse=True)(x0, fn),
        "sde euler mean": lambda: sampler.sample_sde(sampling_method="Euler", last_step="Mean",
                                                     num_steps=steps)(x0, fn, noise=noise),
        "sde heun tweedie": lambda: sampler.sample_sde(sampling_method="Heun", last_step="Tweedie",
                                                       num_steps=steps)(x0, fn, noise=noise),
        "likelihood": lambda: sampler.sample_ode_likelihood(num_steps=steps)(x0, fn, probes=probes),
    }
    out = {}
    for name, run in runs.items():
        evals[0] = 0
        if name == "likelihood":
            res, s, peak = _timed(run)
        else:
            with torch.no_grad():
                res, s, peak = _timed(run)
        out[name] = (res, evals[0], s, peak)
    return out


def _sampler_draws(shape, steps: int, seed: int, device: str):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn(shape, generator=g)
    phase = torch.randn(shape, generator=g)
    noise = torch.randn((steps, *shape), generator=g)
    probes = torch.randint(0, 2, (steps, *shape), generator=g).float() * 2 - 1
    return [t.to(device) for t in (phase, x0, noise, probes)]


def sampler_leg(card: str, on_card, on_cpu) -> dict:
    """Phase 22 (a): every ``Sampler`` method at the config's width on one
    (1, 1, 8, 512, 512) window (seconds, net evaluations, peak memory), and
    each against the CPU on a (1, 1, 8, 32, 32) window with the same
    weights and draws: max|d| <= 2e-3 of range and r > 0.9999 (``logp``:
    within 2e-3 of itself)."""
    phase, x0, noise, probes = _sampler_draws(SAMPLER_WINDOW, SAMPLER_STEPS, 220, "cuda")
    full = sampler_methods(on_card, phase, x0, noise, probes, SAMPLER_STEPS)
    report = {}
    for name, (res, evals, s, peak) in full.items():
        out = res[1] if name == "likelihood" else res
        if not bool(torch.isfinite(out).all()) or tuple(out.shape) != SAMPLER_WINDOW:
            raise AssertionError(f"phase 22 (a) {name}: output {tuple(out.shape)} not finite or of the window's shape")
        report[name] = dict(seconds=s, evals=evals, peak_gib=peak)
        log(f"[celldiff-sampler] {name}: {SAMPLER_STEPS} steps on {SAMPLER_WINDOW} in {s:.3f} s, {evals} net "
            f"evaluations ({s / evals:.3f} s each), peak {peak:.2f} GiB ({card})")
    del full
    torch.cuda.empty_cache()
    worst = 0.0
    small = _sampler_draws(SAMPLER_XCHECK, SAMPLER_STEPS, 221, "cpu")
    t0 = time.perf_counter()
    on_cpu_runs = sampler_methods(on_cpu, *small, SAMPLER_STEPS)
    cpu_s = time.perf_counter() - t0
    on_card_runs = sampler_methods(on_card, *[t.cuda() for t in small], SAMPLER_STEPS)
    for name, (want, *_rest) in on_cpu_runs.items():
        got = on_card_runs[name][0]
        pairs = [(got[1], want[1])] if name == "likelihood" else [(got, want)]
        for g, w in pairs:
            _, rel, r = compare(g.detach().cpu(), w.detach())
            if not (rel <= 2e-3 and r > 0.9999):
                raise AssertionError(f"phase 22 (a) {name}: card against CPU {rel:.2e} of range, r {r:.8f}")
            worst = max(worst, rel)
        if name == "likelihood":
            lg, lw = got[0].cpu().double(), want[0].double()
            lrel = float(((lg - lw).abs() / lw.abs()).max())
            if not lrel <= 2e-3:
                raise AssertionError(f"phase 22 (a) likelihood: logp {lg.tolist()} on the card, {lw.tolist()} on the CPU")
            log(f"[celldiff-sampler] likelihood logp card {lg.tolist()} vs CPU {lw.tolist()} (rel {lrel:.2e})")
    log(f"[celldiff-sampler] card against CPU at {SAMPLER_XCHECK} (same weights and draws, f32, TF32 off): every "
        f"method within {worst:.2e} of range (bound 2e-3, r > 0.9999); CPU {cpu_s:.1f} s")
    return dict(methods=report, xcheck=worst)


def tiling_leg(card: str, wrapper) -> dict:
    """Phase 22 (b): ``generate_sliding_window`` at the config's (8, 512,
    512) patch on a 1024^2 FOV (4 tiles) and a 1000^2 FOV (edge snap,
    overlap), each against ``generate`` on every tile's crop from its noise,
    later tiles overwriting earlier ones (<= 1e-6 of range); then
    ``generate_trajectory``: its shape and its last entry against
    ``generate``."""
    import itertools

    from viscy_tpu_torch.apps.dynacell.celldiff_wrapper import tile_origins

    patch = wrapper.net.input_spatial_size
    out = {}
    for shape in TILE_FOVS:
        g = torch.Generator(device="cuda").manual_seed(222)
        phase = torch.randn(shape, generator=g, device="cuda")
        grids = [tile_origins(s, p) for s, p in zip(shape[2:], patch)]
        tiles = list(itertools.product(*grids))
        x0s = [torch.randn((1, 1, *patch), generator=g, device="cuda") for _ in tiles]
        with torch.no_grad():
            got, s, peak = _timed(lambda: wrapper.generate_sliding_window(phase, TILE_STEPS, x0s=x0s))
            want = torch.zeros_like(got)
            for starts, x0 in zip(tiles, x0s):
                sl = (slice(None), slice(None)) + tuple(slice(a, a + p) for a, p in zip(starts, patch))
                want[sl] = wrapper.generate(phase[sl], TILE_STEPS, x0=x0)
        err, rel, _ = compare(got, want)
        log(f"[celldiff-tiles] generate_sliding_window {shape}: {len(tiles)} tiles at origins {grids[1:]} of "
            f"{patch}, {TILE_STEPS} Euler step each, {s:.3f} s ({s / len(tiles):.3f} s a tile), peak {peak:.2f} GiB; "
            f"against generate on each tile's crop and noise: max|d| {err:.3e} ({rel:.2e} of range, bound 1e-6) "
            f"({card})")
        if not (rel <= 1e-6 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"phase 22 (b): tiled generation of {shape} disagrees with its tiles")
        out[shape[-1]] = dict(seconds=s, tiles=len(tiles))
    g = torch.Generator(device="cuda").manual_seed(223)
    phase = torch.randn(SAMPLER_WINDOW, generator=g, device="cuda")
    x0 = torch.randn(SAMPLER_WINDOW, generator=g, device="cuda")
    with torch.no_grad():
        traj, s, peak = _timed(lambda: wrapper.generate_trajectory(phase, SAMPLER_STEPS, x0=x0))
        last = wrapper.generate(phase, SAMPLER_STEPS, x0=x0)
    _, rel, _ = compare(traj[-1], last)
    log(f"[celldiff-tiles] generate_trajectory: {tuple(traj.shape)} in {s:.3f} s, peak {peak:.2f} GiB; first entry "
        f"the noise, last against generate {rel:.2e} of range ({card})")
    if tuple(traj.shape) != (SAMPLER_STEPS + 1, *SAMPLER_WINDOW) or not torch.equal(traj[0], x0) or not rel <= 1e-6:
        raise AssertionError("phase 22 (b): generate_trajectory's shape, first or last entry is off")
    return out


def foundation_leg(card: str, tmp: Path, plate: Path, tracks: Path) -> dict:
    """Phase 22 (c): ``viscy-torch predict`` of ``configs/dynaclr_predict.yml``
    with its model replaced by ``FoundationModule(DINOv3Model())`` (ViT-S/16:
    384 wide, 12 blocks, 6 heads, 224^2) and ``predict_cells: false`` on
    phase 14's plate: cells/s into the AnnData store; the store's first
    rows against the same model on the CPU (f32, same weights, <= 2e-3 of
    range, r > 0.9999); then ``CellDinoModel`` (patch 14) and
    ``OpenPhenomModel`` (each channel alone) in process on one batch, card
    against CPU."""
    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr
    from viscy_tpu_torch.models.foundation import CellDinoModel, DINOv3Model, OpenPhenomModel
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.trainer import BatchPrefetcher

    store = tmp / "foundation.zarr"

    def edit(cfg):
        cfg["data"]["init_args"].update(data_path=str(plate), tracks_path=str(tracks), predict_cells=False)
        writer = cfg["trainer"]["callbacks"][0]
        writer["init_args"] = dict(writer["init_args"], output_path=str(store))
        cfg["trainer"]["default_root_dir"] = str(tmp / "foundation_predict")
        cfg.pop("ckpt_path", None)

    model = {"class_path": "dynaclr.FoundationModule",
             "init_args": {"model": {"class_path": "viscy_models.DINOv3Model", "init_args": {}},
                           "example_input_array_shape": [1, 2, 15, 224, 224]}}
    path = _composed(tmp, "dynaclr_predict.yml", "foundation_predict.yml", model, edit)
    _zero_counts()
    trainer, s, peak = _timed(lambda: cli.main(["predict", "-c", path]))
    counts = _counts()
    got = read_anndata_zarr(store)
    n = got.n_obs
    want_n = len(DYNACLR_CLI_FOVS) * DYNACLR_CLI_T * DYNACLR_CLI_CELLS
    log(f"[foundation] viscy-torch predict (configs/dynaclr_predict.yml, FoundationModule(DINOv3Model()) at ViT-S/16, "
        f"batch 64 of (2, 15, 224, 224) -> center slice, RGB, 224^2): {n} cells in {s:.2f} s = {n / s:.2f} cells/s "
        f"disk to store (model build included); store X {got.X.shape}; peak {peak:.2f} GiB; launches {counts} ({card})")
    if n != want_n or got.X.shape[1] != 384 or any(counts.values()) or not np.isfinite(got.X).all():
        raise AssertionError(f"foundation store: {n} cells (expected {want_n}), X {got.X.shape}, launches {counts}")
    dm = trainer._active_datamodule
    batch = next(iter(BatchPrefetcher(dm.predict_dataloader(), torch.device("cuda"))))
    if dm.predict_device_transform:
        batch = dm.device_transform(batch, None, "predict")
    x = batch["anchor"][:FOUNDATION_XCHECK]
    cpu_model = DINOv3Model().eval()
    with torch.no_grad():
        want = cpu_model(x.cpu())[0]
    _, rel, r = compare(torch.from_numpy(got.X[:FOUNDATION_XCHECK]), want)
    log(f"[foundation] store rows against DINOv3Model on the CPU (same seeded weights and windows): {rel:.2e} of "
        f"range, r {r:.8f} (bound 2e-3, r > 0.9999)")
    if not (rel <= 2e-3 and r > 0.9999):
        raise AssertionError("phase 22 (c): the foundation store disagrees with the CPU")
    worst = rel
    for name, cls in (("CellDinoModel", CellDinoModel), ("OpenPhenomModel", OpenPhenomModel)):
        m_cpu = cls(**VIT_S16).eval()
        m_card = cls(**VIT_S16).cuda().eval()
        m_card.load_state_dict(m_cpu.state_dict())
        with torch.no_grad():
            (f_card, _), t_s, peak = _timed(lambda: m_card(batch["anchor"]))
            f_cpu, _ = m_cpu(x.cpu())
        _, rel, r = compare(f_card[:FOUNDATION_XCHECK].cpu(), f_cpu)
        worst = max(worst, rel)
        log(f"[foundation] {name} (patch {m_card.patch_size}) on the predict batch {tuple(batch['anchor'].shape)}: "
            f"{t_s:.3f} s ({batch['anchor'].shape[0] / t_s:.1f} cells/s), peak {peak:.2f} GiB; card against CPU on "
            f"{FOUNDATION_XCHECK} windows {rel:.2e} of range, r {r:.8f} ({card})")
        if not (rel <= 2e-3 and r > 0.9999):
            raise AssertionError(f"phase 22 (c): {name} card against CPU {rel:.2e} of range")
    shutil.rmtree(store)
    del trainer
    torch.cuda.empty_cache()
    return dict(cells_per_s=n / s, xcheck=worst)


def classification_leg(card: str, tmp: Path, plate: Path) -> float:
    """Phase 22 (d), classification: ``ClassificationDataModule`` over phase
    14's plate with a CSV of ``CLS_CELLS`` annotated cells (a few on the
    border, dropped), 128^2 x 15 patches of both channels; batches/s out of
    the train loader (``label`` int32; no JAX engine consumes it)."""
    from viscy_tpu_torch.data import ClassificationDataModule

    rng = np.random.default_rng(224)
    ann = tmp / "classes.csv"
    with open(ann, "w") as f:
        f.write("fov_name,t,y,x,label\n")
        for i in range(CLS_CELLS):
            fov = DYNACLR_CLI_FOVS[i % len(DYNACLR_CLI_FOVS)]
            side = DYNACLR_CLI_ZYX[1]
            y, x = (rng.uniform(10, side - 10, 2) if i % 16 == 0 else rng.uniform(64, side - 64, 2))
            f.write(f"A/1/{fov},{i % DYNACLR_CLI_T},{y:.2f},{x:.2f},{int(rng.integers(0, 4))}\n")
    dm = ClassificationDataModule(plate, ann, list(DYNACLR_CHANNELS), z_window_size=15, yx_patch_size=(128, 128),
                                  batch_size=16, num_workers=8)
    dm.setup("fit")
    t0 = time.perf_counter()
    batches = list(dm.train_dataloader())
    s = time.perf_counter() - t0
    b = batches[0]
    if b["label"].dtype != np.int32 or b["source"].shape != (16, 2, 15, 128, 128):
        raise AssertionError(f"classification batch {b['source'].shape} {b['label'].dtype}")
    kept = len(dm.train_dataset) + len(dm.val_dataset)
    log(f"[datamodules] ClassificationDataModule: {kept} of {CLS_CELLS} cells inside the border; {len(batches)} "
        f"train batches of 16 x (2, 15, 128, 128) in {s:.3f} s = {len(batches) / s:.2f} batches/s from the plate "
        f"({card})")
    return len(batches) / s


def ctmc_leg(card: str, tmp: Path) -> float:
    """Phase 22 (d), CTMC-v1: two seeded plates of (``CTMC_T``, 1,
    ``CTMC_ZYX``) DIC time lapses (2 FOVs to train, 1 to validate); batches/s
    of (t, t + 1) pairs out of the train loader."""
    from viscy_tpu_torch.data import CTMCv1DataModule
    from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

    paths = [build_hcs_plate(tmp / f"ctmc_{n}.zarr", ["DIC"], zyx_shape=CTMC_ZYX, num_timepoints=CTMC_T, rows=("A",),
                             cols=("1",), fovs=fovs, seed=seed) for n, fovs, seed in (("train", ("0", "1"), 225),
                                                                                          ("val", ("0",), 226))]
    dm = CTMCv1DataModule(*paths, channel="DIC", batch_size=4, num_workers=8)
    dm.setup("fit")
    t0 = time.perf_counter()
    batches = list(dm.train_dataloader())
    s = time.perf_counter() - t0
    if batches[0]["source"].shape != (4, 1, *CTMC_ZYX) or len(batches) != 2 * (CTMC_T - 1) // 4:
        raise AssertionError(f"CTMC-v1: {len(batches)} batches of {batches[0]['source'].shape}")
    log(f"[datamodules] CTMCv1DataModule: {len(batches)} train batches of 4 (t, t + 1) pairs of (1, {CTMC_ZYX}) in "
        f"{s:.3f} s = {len(batches) / s:.2f} batches/s ({card})")
    for p in paths:
        shutil.rmtree(p)
    return len(batches) / s


def concat_fits(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 22 (d): ``viscy-torch fit -c configs/vscyto3d_fit.yml`` with its
    datamodule replaced by ``ConcatDataModule`` over phase 9's plate and a
    copy of it, then by ``CombinedDataModule`` in ``max_size_cycle``: one
    epoch of ``P22_STEPS`` steps and ``P22_VAL`` validation batch each, the
    launch counts of the warp and the fused forward and backward against the
    recipe's, patches/s and the loader-wait share."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config

    import os

    copy = tmp / "fit_copy.zarr"
    t0 = time.perf_counter()
    shutil.copytree(plate, copy, copy_function=os.link)  # a second plate of the same files, hard-linked
    log(f"[datamodules] fit plate linked into a second plate in {time.perf_counter() - t0:.1f} s")
    shipped = load_composed_config(ROOT / "configs/vscyto3d_fit.yml")
    shipped["model"]["init_args"].pop("ckpt_path", None)
    child = shipped["data"]
    per_fwd = len(kernel_shapes(FLAGSHIP, TRAIN_PATCH[-1]))
    want = dict(fwd=2 * per_fwd * (P22_STEPS + P22_VAL), bwd=2 * per_fwd * P22_STEPS, masked_fwd=0, masked_bwd=0,
                warp=P22_STEPS)
    out = {}
    for name, node in (
        ("ConcatDataModule", lambda kids: {"class_path": "viscy_data.ConcatDataModule",
                                           "init_args": {"data_modules": kids}}),
        ("CombinedDataModule", lambda kids: {"class_path": "viscy_data.CombinedDataModule",
                                             "init_args": {"data_modules": kids, "train_mode": "max_size_cycle"}}),
    ):
        root = tmp / f"fit_{name}"
        kids = [dict(child, init_args=dict(child["init_args"], data_path=str(p), num_workers=8)) for p in (plate, copy)]

        def edit(cfg, kids=kids, node=node, root=root):
            cfg["data"] = node(kids)
            cfg["trainer"].update(default_root_dir=str(root), max_epochs=1, limit_train_batches=P22_STEPS,
                                  limit_val_batches=P22_VAL, log_every_n_steps=1)

        path = _composed(tmp, "vscyto3d_fit.yml", f"fit_{name}.yml", shipped["model"], edit)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["fit", "-c", path])
        counts = _counts()
        fit_s = time.perf_counter() - t0
        feed = trainer.feed_stats
        loss, val = trainer.logged_metrics.get("loss/train"), trainer.logged_metrics.get("loss/validate")
        batch = child["init_args"]["batch_size"]
        rate = P22_STEPS * batch / feed["seconds"]
        log(f"[datamodules] viscy-torch fit of configs/vscyto3d_fit.yml over {name} (the fit plate and its copy): "
            f"{fit_s:.1f} s in all; train loop {feed['seconds']:.2f} s for {P22_STEPS} steps of {batch} = {rate:.2f} "
            f"patches/s (first step included); waited {feed['wait_s']:.2f} s = {feed['wait_s'] / feed['seconds']:.1%} "
            f"of the loop; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss/train {loss}, loss/validate "
            f"{val}; launches {counts} (expected {want}) ({card})")
        if (counts != want or feed["steps"] != P22_STEPS or not all(v is not None and math.isfinite(v)
                                                                     for v in (loss, val))):
            raise AssertionError(f"phase 22 (d) {name}: launches {counts} (expected {want}), {feed['steps']} steps, "
                                 f"losses {loss} / {val}")
        out[name] = dict(counts=counts, rate=rate, wait=feed["wait_s"] / feed["seconds"])
        shutil.rmtree(root, ignore_errors=True)
        del trainer
        torch.cuda.empty_cache()
    shutil.rmtree(copy)
    return out


def division_fit(card: str, tmp: Path) -> dict:
    """Phase 22 (d): ``viscy-torch fit -c configs/dynaclr_fit.yml`` (the
    DynaCLR-width ``ContrastiveModule``, NT-Xent) with its datamodule
    replaced by ``CellDivisionTripletDataModule`` over ``DIVISION_TRACKS``
    seeded ``.npy`` tracks of (``DIVISION_T``, 2, 15, 224, 224): one epoch
    of ``P22_STEPS`` steps of 32 and ``P22_VAL`` validation batch; pairs/s
    and the loader-wait share. It launches what the shipped DynaCLR fit
    launches: no kernel."""
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config

    tracks = tmp / "division_tracks"
    tracks.mkdir()
    rng = np.random.default_rng(227)
    t0 = time.perf_counter()
    for i in range(DIVISION_TRACKS):
        np.save(tracks / f"track_{i:03d}.npy", rng.random((DIVISION_T, *DIVISION_WINDOW), dtype=np.float32))
    write_s = time.perf_counter() - t0
    batch = load_composed_config(ROOT / "configs/dynaclr_fit.yml")["data"]["init_args"]["batch_size"]
    root = tmp / "division_fit"

    def edit(cfg):
        cfg["data"] = {"class_path": "viscy_data.CellDivisionTripletDataModule",
                       "init_args": {"data_path": str(tracks), "batch_size": batch, "num_workers": 8}}
        cfg["trainer"].update(default_root_dir=str(root), max_epochs=1, limit_train_batches=P22_STEPS,
                              limit_val_batches=P22_VAL, log_every_n_steps=1)

    model = load_composed_config(ROOT / "configs/dynaclr_fit.yml")["model"]
    model["init_args"].pop("ckpt_path", None)
    path = _composed(tmp, "dynaclr_fit.yml", "division_fit.yml", model, edit)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", path])
    counts = _counts()
    fit_s = time.perf_counter() - t0
    feed = trainer.feed_stats
    loss, val = trainer.logged_metrics.get("loss/train"), trainer.logged_metrics.get("loss/validate")
    rate = P22_STEPS * batch / feed["seconds"]
    log(f"[datamodules] viscy-torch fit of configs/dynaclr_fit.yml over CellDivisionTripletDataModule "
        f"({DIVISION_TRACKS} .npy tracks of {(DIVISION_T, *DIVISION_WINDOW)}, written in {write_s:.1f} s): "
        f"{fit_s:.1f} s in all; train loop {feed['seconds']:.2f} s for {P22_STEPS} steps of {batch} = {rate:.2f} "
        f"cell pairs/s (first step included); waited {feed['wait_s']:.2f} s = {feed['wait_s'] / feed['seconds']:.1%} "
        f"of the loop; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss/train {loss}, loss/validate "
        f"{val}; launches {counts} ({card})")
    if any(counts.values()) or feed["steps"] != P22_STEPS or not all(v is not None and math.isfinite(v)
                                                                      for v in (loss, val)):
        raise AssertionError(f"phase 22 (d) division fit: launches {counts}, {feed['steps']} steps, losses {loss} / "
                             f"{val}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(tracks)
    del trainer
    torch.cuda.empty_cache()
    return dict(rate=rate, wait=feed["wait_s"] / feed["seconds"])


def phase_celldiff_sampling(card: str) -> dict:
    """Phase 22 (a) and (b): the Sampler and CELLDiff3DVS's generation at
    ``configs/celldiff_fit.yml``'s width."""
    torch.cuda.empty_cache()
    on_card, on_cpu = celldiff_wrappers(228)
    a = sampler_leg(card, on_card, on_cpu)
    b = tiling_leg(card, on_card)
    del on_card, on_cpu
    torch.cuda.empty_cache()
    return dict(sampler=a, tiles=b)


def phase_datamodules(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 22 (d) on phase 9's plate: the two VSCyto3D fits, the
    cell-division fit and the CTMC-v1 loader."""
    fits = concat_fits(card, tmp, plate)
    division = division_fit(card, tmp)
    ctmc = ctmc_leg(card, tmp)
    launches = {k: sum(f["counts"][k] for f in fits.values()) for k in ("fwd", "bwd", "warp")}
    return dict(fits=fits, division=division, ctmc=ctmc, launches=launches)


# -- phase 23: DynaCLR's embedding evaluation ------------------------------------------------------------------

EVAL_FOVS, EVAL_TRACKS, EVAL_T = 10, 250, 20  # (b): 50,000 cells
EVAL_DIM, EVAL_PROJ = 768, 128  # configs/dynaclr_predict.yml:13-14
EVAL_CLASSES = EVAL_CONDITIONS = 4
EVAL_XCHECK = 2000  # (c): the first cells of (b), on the card and on the CPU
EVAL_MLP_EPOCHS = 30


def eval_cli(args: list[str], device: str = "cuda") -> tuple[str, float, float]:
    """``python -m viscy_tpu_torch.apps.dynaclr.cli --device <device> <args>``
    in process: (its output, seconds, peak GiB)."""
    import contextlib
    import io

    from viscy_tpu_torch.apps.dynaclr import cli as dcli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, s, peak = _timed(lambda: dcli.main(["--device", device, *map(str, args)], standalone_mode=False))
    torch.cuda.empty_cache()  # a leg beside another phase holds only what its next command uses
    return buf.getvalue(), s, peak


def _json_out(out: str):
    return json.loads(out[min(i for i in (out.find("{"), out.find("[")) if i >= 0):])


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def eval_predict(card: str, tmp: Path, plate: Path, tracks: Path, ckpt: Path) -> Path:
    """Phase 23 (a), first half: ``viscy-torch predict`` of
    ``configs/dynaclr_predict.yml`` from phase 14's affine fit, the writer
    with ``umap_kwargs`` and ``phate_kwargs``: the store's reductions."""
    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.training.compose import load_composed_config

    store = tmp / "eval_embeddings.zarr"
    writer = dict(load_composed_config(ROOT / "configs/dynaclr_predict.yml")["trainer"]["callbacks"][0])
    writer["init_args"] = dict(writer["init_args"], output_path=str(store), umap_kwargs={"n_neighbors": 15},
                               phate_kwargs={"knn": 5})
    cfg_path = _cli_config(tmp / "dynaclr_eval_predict.yml", {
        "data": {"init_args": {"data_path": str(plate), "tracks_path": str(tracks), "predict_cells": False}},
        "trainer": {"default_root_dir": str(tmp / "dynaclr_eval_predict"), "callbacks": [writer]},
        "ckpt_path": str(ckpt),
    }, ROOT / "configs/dynaclr_predict.yml")
    _, s, peak = _timed(lambda: cli.main(["predict", "-c", cfg_path]))
    got = read_anndata_zarr(store)
    n = got.n_obs
    log(f"[dynaclr-eval] (a) viscy-torch predict from phase 14's affine fit with UMAP and PHATE in the writer: {n} "
        f"cells in {s:.2f} s, peak {peak:.2f} GiB; obsm { {k: v.shape for k, v in got.obsm.items()} } ({card})")
    for key in ("X_umap", "X_phate"):
        if got.obsm[key].shape != (n, 2) or not np.isfinite(got.obsm[key]).all():
            raise AssertionError(f"phase 23 (a): {key} {got.obsm[key].shape}")
    return store


def eval_tables(tmp: Path, store: Path) -> tuple[Path, Path]:
    """Seeded label and annotation CSVs for the store's cells."""
    import csv

    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr

    obs = read_anndata_zarr(store).obs
    rng = np.random.default_rng(2323)
    labels, ann = tmp / "eval_labels.csv", tmp / "eval_annotations.csv"
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "state", "condition", "score"])
        for cid, tid in zip(obs["id"].tolist(), obs["track_id"].tolist()):
            w.writerow([cid, f"state{tid % EVAL_CLASSES}", f"cond{(tid // 7) % 2}", f"{rng.random():.4f}"])
    with open(ann, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fov_name", "t", "track_id", "y", "x", "division"])
        for row in zip(*(obs[c].tolist() for c in ("fov_name", "t", "track_id", "y", "x"))):
            w.writerow([f"/{row[0]}", *row[1:], "yes" if rng.random() < 0.2 else "no"])
    return labels, ann


def eval_subcommands(card: str, tmp: Path, store: Path) -> dict:
    """Phase 23 (a), second half: every ported subcommand on the store, on
    the card, through the CLI."""
    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr

    labels, ann = eval_tables(tmp, store)
    split = tmp / "eval_split"
    steps = [
        ["info", "--embeddings", store],
        ["append-obs", "--embeddings", store, "--csv", labels],
        ["append-annotations", "--embeddings", store, "--csv", ann],
        ["reduce-dimensionality", "--embeddings", store, "--method", "pca", "--components", "8"],
        ["reduce-dimensionality", "--embeddings", store, "--method", "umap", "--components", "2"],
        ["reduce-dimensionality", "--embeddings", store, "--method", "phate", "--components", "2"],
        ["dimred", "--embeddings", store, "--components", "8", "--output", tmp / "eval_dimred.npy"],
        ["split-embeddings", "--embeddings", store, "--column", "fov_name", "--output-dir", split],
        ["combined-dim-reduction", "--embeddings", split / "A/1/0", "--embeddings", split / "A/1/1", "--components", "4"],
        ["train-classifier", "--embeddings", store, "--label-column", "state", "--output", tmp / "eval_probe.npz"],
        ["cross-validate", "--embeddings", store, "--label-column", "state", "--splits", "3"],
        ["probe-classifiers", "--embeddings", store, "--label-columns", "state,condition", "--splits", "3"],
        ["append-predictions", "--embeddings", store, "--classifier", tmp / "eval_probe.npz", "--task", "state"],
        ["smoothness", "--embeddings", store],
        ["mmd", "--embeddings", store, "--group-column", "condition", "--group-a", "cond0", "--group-b", "cond1",
         "--permutations", "200"],
        ["compute-mmd", "--embeddings", store, "--group-column", "state", "--permutations", "200", "--output",
         tmp / "eval_mmd.csv"],
        ["train-mlp-embedder", "--embeddings", store, "--label-column", "state", "--output", tmp / "eval_mlp",
         "--epochs", "5"],
        ["apply-mlp-embedder", "--embeddings", store, "--model", tmp / "eval_mlp"],
        ["evaluate-tracking-accuracy", "--embeddings", store, "--spatial-gate", "50"],
    ]
    seconds = {}
    for args in steps:
        out, s, peak = eval_cli(args)
        name = args[0] + ("" if args[0] != "reduce-dimensionality" else f" {args[4]}")
        seconds[name] = s
        said = out.strip().splitlines()[-1]
        if "{" in out or "[" in out:
            res = _json_out(out)
            if not _finite(res):
                raise AssertionError(f"phase 23 (a): {name} printed a non-finite number: {out}")
            said = json.dumps(res)
        log(f"[dynaclr-eval] (a) {name}: {s:.2f} s, peak {peak:.3f} GiB; {said[:140]}")
    got = read_anndata_zarr(store)
    want = {"PCA", "UMAP", "PHATE", "MLP", "X_pca", "X_umap", "X_phate", "X_projections"}
    have_obs = {"state", "condition", "score", "division", "predicted_state"}
    if not want <= set(got.obsm) or not have_obs <= set(got.obs.names) or not all(
            np.isfinite(v).all() for v in got.obsm.values()):
        raise AssertionError(f"phase 23 (a): store obsm {sorted(got.obsm)}, obs {got.obs.names}")
    if np.load(tmp / "eval_dimred.npy").shape != (got.n_obs, 8) or not (tmp / "eval_mmd.csv").exists():
        raise AssertionError("phase 23 (a): dimred or compute-mmd wrote nothing")
    return seconds


def eval_full_store(tmp: Path, card: str) -> Path:
    """Phase 23 (b)'s seeded store: EVAL_FOVS x EVAL_TRACKS tracks of EVAL_T
    frames, each drifting (a random walk plus observation noise) around its
    class centre and its condition's offset; 768 features, 128 projections."""
    from viscy_tpu_torch.evaluation.anndata_lite import Frame
    from viscy_tpu_torch.training.callbacks.embedding_writer import write_embedding_dataset

    rng = np.random.default_rng(23)
    shape = (EVAL_FOVS, EVAL_TRACKS)
    centres = rng.normal(size=(EVAL_CLASSES, EVAL_DIM)) * 0.05
    offsets = rng.normal(size=(EVAL_CONDITIONS, EVAL_DIM)) * 0.02
    cls = rng.integers(0, EVAL_CLASSES, size=shape)
    cond = (np.arange(EVAL_TRACKS)[None, :] + np.arange(EVAL_FOVS)[:, None]) % EVAL_CONDITIONS
    base = centres[cls] + offsets[cond] + rng.normal(size=(*shape, EVAL_DIM)) * 0.1
    walk = np.cumsum(rng.normal(size=(*shape, EVAL_T, EVAL_DIM)) * 0.06, axis=2)
    feats = (base[:, :, None] + walk + rng.normal(size=(*shape, EVAL_T, EVAL_DIM)) * 0.15).astype(np.float32)
    feats = feats.reshape(-1, EVAL_DIM)
    proj = feats @ (rng.normal(size=(EVAL_DIM, EVAL_PROJ)) / np.sqrt(EVAL_DIM)).astype(np.float32)
    yx0 = rng.uniform(100, 1900, size=(*shape, 1, 2))
    yx = (yx0 + np.cumsum(rng.normal(size=(*shape, EVAL_T, 2)) * 3.0, axis=2)).reshape(-1, 2)
    f, tr, t = (a.ravel() for a in np.meshgrid(np.arange(EVAL_FOVS), np.arange(EVAL_TRACKS), np.arange(EVAL_T),
                                               indexing="ij"))
    frame = Frame({"fov_name": np.asarray([f"A/1/{i}" for i in f], dtype=object), "track_id": tr, "t": t,
                   "id": np.arange(len(t)), "y": np.round(yx[:, 0], 2), "x": np.round(yx[:, 1], 2),
                   "state": np.asarray([f"state{c}" for c in cls[f, tr]], dtype=object),
                   "condition": np.asarray([f"cond{c}" for c in cond[f, tr]], dtype=object)})
    store = tmp / "eval_full.zarr"
    t0 = time.perf_counter()
    write_embedding_dataset(store, feats, frame, projections=proj)
    log(f"[dynaclr-eval] (b) seeded store: {len(t)} cells ({EVAL_FOVS} FOVs x {EVAL_TRACKS} tracks x {EVAL_T} "
        f"frames, {EVAL_CLASSES} classes, {EVAL_CONDITIONS} conditions), X {feats.shape}, projections {proj.shape}, "
        f"written in {time.perf_counter() - t0:.1f} s ({card})")
    return store


def _capture_first(module, name: str, calls: dict):
    """Wrap ``module.name`` so that the arguments of its first call are kept
    in ``calls[name]``; returns the original (restore with ``setattr``)."""
    orig = getattr(module, name)

    def wrapper(*a, **k):
        calls.setdefault(name, (a, k))
        return orig(*a, **k)

    setattr(module, name, wrapper)
    return orig


def _profiled(fn) -> tuple[float, float | None]:
    """Wall ms and device-busy ms (torch.profiler) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, (sum(e.self_device_time_total for e in events) / 1e3 if events else None)


def _timed_parts(module, names: tuple[str, ...], record: dict) -> dict:
    """Wrap each ``module.<name>`` to add its synchronized wall seconds to
    ``record[name]``; returns the originals (restore with ``setattr``)."""
    origs = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            record[name] = record.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for name, fn in origs.items():
        setattr(module, name, wrap(name, fn))
    return origs


def eval_full(card: str, tmp: Path) -> dict:
    """Phase 23 (b): the subcommands at 50,000 cells through the CLI on the
    card: seconds, peak memory, and the busy share of the UMAP layout and of
    the first MMD test (one profiled call each)."""
    from viscy_tpu_torch.evaluation import mmd as tmmd
    from viscy_tpu_torch.evaluation import phate_native as tphate
    from viscy_tpu_torch.evaluation import umap_native as tumap
    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr

    store = eval_full_store(tmp, card)
    steps = [
        ["reduce-dimensionality", "--embeddings", store, "--method", "pca", "--components", "8"],
        ["reduce-dimensionality", "--embeddings", store, "--method", "umap", "--components", "2"],
        ["reduce-dimensionality", "--embeddings", store, "--method", "phate", "--components", "2"],
        ["cross-validate", "--embeddings", store, "--label-column", "state", "--splits", "5"],
        ["train-mlp-embedder", "--embeddings", store, "--label-column", "state", "--output", tmp / "eval_full_mlp",
         "--epochs", str(EVAL_MLP_EPOCHS)],
        ["apply-mlp-embedder", "--embeddings", store, "--model", tmp / "eval_full_mlp"],
        ["compute-mmd", "--embeddings", store, "--group-column", "condition", "--permutations", "1000"],
        ["smoothness", "--embeddings", store],
        ["evaluate-tracking-accuracy", "--embeddings", store, "--spatial-gate", "50"],
    ]
    record, results, busy, parts = {}, {}, {}, {}
    umap_parts = ("exact_knn", "smooth_knn_dist", "fuzzy_simplicial_set", "_spectral_init", "find_ab_params",
                  "epoch_schedule", "draw_negatives")
    phate_parts = ("pca_fit", "_alpha_decay", "minibatch_kmeans", "metric_mds")
    restore = [(tumap, _timed_parts(tumap, umap_parts, parts.setdefault("umap", {}))),
               (tphate, _timed_parts(tphate, phate_parts, parts.setdefault("phate", {})))]
    calls: dict = {}
    layout = _capture_first(tumap, "optimize_layout", calls)
    test = _capture_first(tmmd, "mmd_permutation_test", calls)
    try:
        for args in steps:
            out, s, peak = eval_cli(args)
            name = args[0] + ("" if args[0] != "reduce-dimensionality" else f" {args[4]}")
            record[name] = (s, peak)
            said = out.strip().splitlines()[-1]
            if "{" in out or "[" in out:
                results[name] = _json_out(out)
                if not _finite(results[name]):
                    raise AssertionError(f"phase 23 (b): {name} printed a non-finite number")
                said = json.dumps(results[name])
            log(f"[dynaclr-eval] (b) {name}: {s:.2f} s, peak {peak:.2f} GiB; {said[:140]} ({card})")
    finally:
        tumap.optimize_layout, tmmd.mmd_permutation_test = layout, test
        for module, origs in restore:
            for name, fn in origs.items():
                setattr(module, name, fn)
    for method, nest in (("umap", "fuzzy_simplicial_set holds exact_knn and smooth_knn_dist; the rest is the "
                                  "layout, which holds epoch_schedule and draw_negatives, and the store's read and "
                                  "write"),
                         ("phate", "the rest: the diffusion operator, its spectrum and power, on the device, and "
                                   "the store's read and write")):
        total = record[f"reduce-dimensionality {method}"][0]
        log(f"[dynaclr-eval] (b) {method} parts: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in parts[method].items())
            + f" of {total:.2f} s ({nest}) ({card})")
    # one more call of each, profiled, with the arguments the subcommand gave it (the times above are unprofiled)
    for tag, name, fn in (("umap layout", "optimize_layout", layout), ("mmd test", "mmd_permutation_test", test)):
        a, k = calls[name]
        busy[tag] = _profiled(lambda: fn(*a, **k))
    for tag, (wall, dev_ms) in busy.items():
        share = "not measured (no device time recorded)" if dev_ms is None else f"{dev_ms / wall:.1%}"
        log(f"[dynaclr-eval] (b) {tag} (one more call, profiled): wall {wall:.1f} ms, device busy "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.1f} ms'}, busy share {share} ({card})")
    got = read_anndata_zarr(store)
    n = EVAL_FOVS * EVAL_TRACKS * EVAL_T
    shapes = {k: got.obsm[k].shape for k in ("PCA", "UMAP", "PHATE", "MLP")}
    if shapes != {"PCA": (n, 8), "UMAP": (n, 2), "PHATE": (n, 2), "MLP": (n, 128)} or not all(
            np.isfinite(got.obsm[k]).all() for k in shapes):
        raise AssertionError(f"phase 23 (b): obsm {shapes}")
    cv = results["cross-validate"]
    mmd_rows = results["compute-mmd"]
    link = results["evaluate-tracking-accuracy"]
    log(f"[dynaclr-eval] (b) probe accuracy {cv['accuracy_mean']:.4f} +- {cv['accuracy_std']:.4f}; MMD^2 "
        f"{[round(r['mmd2'], 6) for r in mmd_rows]}, p {[r['p_value'] for r in mmd_rows]}; smoothness score "
        f"{results['smoothness']['smoothness_score']:.4f}; link accuracy {link['link_accuracy']:.4f} of "
        f"{link['n_links']} links")
    if len(mmd_rows) != EVAL_CONDITIONS * (EVAL_CONDITIONS - 1) // 2 or link["n_links"] == 0:
        raise AssertionError("phase 23 (b): compute-mmd or tracking produced too little")
    shutil.rmtree(store)
    return dict(seconds=record, busy=busy, parts=parts)


def _xcheck(tag: str, err: float, bound: float, worst: dict, unit: str = "of range") -> None:
    log(f"[dynaclr-eval] (c) {tag}: card against CPU {err:.3e} {unit} (bound {bound:g})")
    worst[tag] = err
    if not err <= bound:
        raise AssertionError(f"phase 23 (c): {tag} card against CPU {err:.3e} > {bound:g}")


def _range_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.ptp(b), 1e-30))


def knn_preservation(X: np.ndarray, emb: np.ndarray, k: int = 10) -> float:
    """The mean share of each row's k nearest rows in ``X`` among its k
    nearest in ``emb`` (float64 on the card)."""
    from viscy_tpu_torch.evaluation._ops import exact_knn

    def nearest(a):
        t = torch.as_tensor(np.asarray(a, np.float64), device="cuda")
        return exact_knn(t, t, k + 1)[1][:, 1:].cpu().numpy()

    a, b = nearest(X), nearest(emb)
    return float(np.mean([len(set(r) & set(s)) / k for r, s in zip(a, b)]))


def eval_xcheck(card: str) -> dict:
    """Phase 23 (c): each function on the first EVAL_XCHECK cells of (b)'s
    data on the card and on the CPU with the same draws."""
    from viscy_tpu_torch.apps.dynaclr import mlp_embedder as tmlp
    from viscy_tpu_torch.apps.dynaclr.tracking import link_by_embedding
    from viscy_tpu_torch.evaluation import clustering as tclu
    from viscy_tpu_torch.evaluation import dimensionality_reduction as tdr
    from viscy_tpu_torch.evaluation import linear_classifier as tlin
    from viscy_tpu_torch.evaluation import mmd as tmmd
    from viscy_tpu_torch.evaluation import phate_native as tphate
    from viscy_tpu_torch.evaluation import smoothness as tsmooth
    from viscy_tpu_torch.evaluation import umap_native as tumap
    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr

    with tempfile.TemporaryDirectory(prefix="viscy-eval-x-") as d:
        ds = read_anndata_zarr(eval_full_store(Path(d), card))
    X, obs = ds.X[:EVAL_XCHECK], ds.obs.take(np.arange(EVAL_XCHECK))
    state, cond = np.asarray(obs["state"]), np.asarray(obs["condition"])
    worst: dict = {}
    both = lambda fn: (fn("cuda"), fn("cpu"))  # noqa: E731

    a, b = both(lambda dev: tdr.compute_pca(X, 8, device=dev)[0])
    _xcheck("PCA scores", _range_err(a, b), 1e-6, worst)
    um = tumap.NativeUMAP(device="cuda")
    pc, pp = um.prepare(X), tumap.NativeUMAP(device="cpu").prepare(X)
    same = np.array_equal(pc["head"], pp["head"]) and np.array_equal(pc["tail"], pp["tail"])
    _xcheck("UMAP graph weights", _range_err(pc["weights"], pp["weights"]) if same else np.inf, 1e-12, worst)
    _xcheck("UMAP spectral start", _range_err(pc["init"], pp["init"]), 1e-6, worst)
    args = (pc["init"], pc["head"], pc["tail"], pc["weights"])
    kw = dict(a=pc["a"], b=pc["b"], lr=1.0, negative_sample_rate=5, random_state=42)
    short = [tumap.optimize_layout(*args, n_epochs=5, device=dev, **kw) for dev in ("cuda", "cpu")]
    _xcheck("UMAP layout, 5 epochs", _range_err(*short), 1e-9, worst)
    exact = [tumap.optimize_layout(*args, n_epochs=pc["n_epochs"], device=dev, **dict(kw, b=1.0))
             for dev in ("cuda", "cpu")]
    log(f"[dynaclr-eval] (c) UMAP layout at b = 1 (no pow rounding), {pc['n_epochs']} epochs: card against CPU "
        f"{_range_err(*exact):.3e} of range (information: bit for bit only if CUDA's pow(x, 1) is x)")
    (one, t_det, _), (two, _, _) = [_timed(lambda: tumap.optimize_layout(*args, n_epochs=pc["n_epochs"],
                                                                         device="cuda", **kw)) for _ in range(2)]
    orig = tumap._add_rows
    tumap._add_rows = lambda x, rows, values: x.index_add_(0, rows, values)  # CUDA's atomic adds
    try:
        _, t_free, _ = _timed(lambda: tumap.optimize_layout(*args, n_epochs=pc["n_epochs"], device="cuda", **kw))
    finally:
        tumap._add_rows = orig
    cpu_layout = tumap.optimize_layout(*args, n_epochs=pc["n_epochs"], device="cpu", **kw)
    kc, kp = knn_preservation(X, one), knn_preservation(X, cpu_layout)
    log(f"[dynaclr-eval] (c) UMAP layout ({pc['n_epochs']} epochs, {len(pc['head'])} edges): two card calls "
        f"{'identical' if np.array_equal(one, two) else 'DIFFERENT'}; sorted index_put_ {t_det:.2f} s, "
        f"atomic index_add_ {t_free:.2f} s; 10-NN preservation card {kc:.4f}, CPU {kp:.4f} ({card})")
    if not np.array_equal(one, two):
        raise AssertionError("phase 23 (c): two card calls of the UMAP layout differ")
    _xcheck("UMAP 10-NN preservation at the fitted b", abs(kc - kp), 0.05, worst, "absolute")
    a, b = both(lambda dev: tphate.NativePHATE(device=dev).fit_transform(X))
    _xcheck("PHATE embedding (up to sign)", _range_err(a * np.sign((a * b).sum(0)), b), 1e-4, worst)
    xp = tdr.compute_pca(X, 100, device="cuda")[0]
    (la, ia), (lb, ib) = both(lambda dev: tphate.minibatch_kmeans(xp, 200, device=dev))
    # a near-tie's argmin flips with the product's rounding, and the mini-batch path then departs
    _xcheck("k-means inertia", abs(ia - ib) / ib, 0.02, worst, "relative")
    a, b = both(lambda dev: tmmd.mmd_permutation_test(X[cond == "cond0"], X[cond == "cond1"], 1000, device=dev))
    # the float32 exp differs by an ulp between CUDA and the CPU's vector library
    _xcheck("MMD^2, null mean and std", max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                                            for k in ("mmd2", "null_mean", "null_std")), 1e-4, worst, "relative")
    _xcheck("MMD p-value", abs(a["p_value"] - b["p_value"]), 0.005, worst, "absolute")
    a, b = both(lambda dev: tsmooth.compute_embeddings_smoothness(X, obs, device=dev))
    _xcheck("smoothness statistics", max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b), 1e-9, worst,
            "relative")
    a, b = both(lambda dev: tlin.cross_validate_classifier(X, state, 5, device=dev))
    _xcheck("probe cross-validation metrics", max(abs(a[k] - b[k]) for k in b), 0.01, worst, "absolute")
    init = tmlp._build(EVAL_DIM, (256, 128), EVAL_CLASSES, seed=7).state_dict()
    a, b = both(lambda dev: tmlp.train_mlp_embedder(X, state, epochs=5, init_state=init, device=dev)[1])
    _xcheck("MLP embedder validation loss per epoch", max(abs(p["val_loss"] - q["val_loss"]) / q["val_loss"]
                                                         for p, q in zip(a["history"], b["history"])), 1e-3, worst,
            "relative")
    a, b = both(lambda dev: link_by_embedding(X, obs, device=dev)["linked_prev_row"])
    _xcheck("tracking links differing", float((a != b).sum()), 2.0, worst, "links")
    a, b = both(lambda dev: tclu.knn_accuracy(X, state, device=dev))
    _xcheck("kNN accuracy", abs(a - b), 1e-3, worst, "absolute")
    return worst


def phase_dynaclr_eval(card: str, tmp: Path, plate: Path, tracks: Path, ckpt: Path,
                       plate_free: Path | None = None) -> dict:
    """Phase 23: DynaCLR's embedding evaluation on the card (see the module
    docstring). ``plate_free``, when given, is written once the plate has
    been read."""
    t0 = time.perf_counter()
    _zero_counts()
    store = eval_predict(card, tmp, plate, tracks, ckpt)
    if plate_free is not None:
        plate_free.touch()
    a = eval_subcommands(card, tmp, store)
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"phase 23 (a) launched {counts}; no kernel expected on this path")
    log(f"[dynaclr-eval] (a) the path from phase 14's checkpoint launched {counts} (the warp's launches that made "
        f"the checkpoint are phase 14's); (a) in {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(store)
    b = eval_full(card, tmp)
    c = eval_xcheck(card)
    total = time.perf_counter() - t0
    log(f"[phase 23] DynaCLR's embedding evaluation in {total:.1f} s ({card})")
    return dict(seconds=total, a=a, b=b, c=c, launches=counts)


# phase 24: the virtual-staining benchmark's `dynacell evaluate` on the cli phase's predict plate
DCE_NUCLEI = 300  # nucleus-like ellipsoids a FOV of the seeded GT plate
DCE_SPACING = [0.29, 0.1, 0.1]  # z, y, x (um): a 63x / 1.3 NA confocal's sampling
DCE_PATCH = 64  # feature_metrics.patch_size, JAX's default
DCE_WORKERS = 2  # FOV threads: host segmentation overlaps; the card's calls take the device lock
# the GT plate has both FOVs of the predict plate, so the flagship's plate is scored on two FOVs (its
# real-against-predicted probe needs two FOV groups); the noisy-GT plate has the first only (the first
# of the allowed cuts: the whole script took 1156.6 s on a slower host with two FOVs a plate)
DCE_GT_FOVS = CLI_PREDICT_FOVS
DCE_NOISY_FOVS = CLI_PREDICT_FOVS[:1]
# configs/dynaclr_fit.yml's encoder (convnext_tiny, 768, 128) on one 2-D crop: 1 channel, depth 1
DCE_ENCODER = dict(backbone="convnext_tiny", in_channels=1, in_stack_depth=1, stem_kernel_size=[1, 4, 4],
                    stem_stride=[1, 4, 4], embedding_dim=768, projection_dim=128)
DCE_VIT = dict(img_size=224, patch_size=16, embed_dim=384, depth=12, num_heads=6)  # ViT-S/16, as phase 22's
# the card-against-CPU pixel row runs on a FOV's centre square: a whole (20, 2048,
# 2048) FOV takes the card's host CPU 98.7 s (0.49 s on the card)
DCE_XCHECK_YX = 256
# segmentation, instances and CP features with the card's filters against scipy's on the host, bit for
# bit, on a FOV's centre (20, DCE_SEG_YX, DCE_SEG_YX) (scipy's distance transform of a whole FOV: 61 s)
DCE_SEG_YX = 320
DCE_PIXEL_KEYS = ("PCC", "SSIM", "NRMSE", "PSNR", "Spectral_PCC", "FSC_FSC_Resolution", "XY_FSC_Resolution",
                   "Z_FSC_Resolution", "Multiband_EV_NC")


def dynacell_cli(args: list) -> tuple[str, float]:
    """``python -m viscy_tpu_torch.apps.dynacell <args>`` in process: (its
    output, synchronized seconds)."""
    import contextlib
    import io

    from viscy_tpu_torch.apps.dynacell.__main__ import main as dynacell

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dynacell.main([str(a) for a in args], standalone_mode=False)
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def _blur(v: torch.Tensor, sigmas) -> torch.Tensor:
    """Separable Gaussian blur of a (Z, Y, X) volume on its device."""
    for axis, s in enumerate(sigmas):
        r = int(3 * s + 0.5)
        k = torch.exp(-0.5 * (torch.arange(-r, r + 1, device=v.device, dtype=v.dtype) / s) ** 2)
        k = (k / k.sum()).reshape(1, 1, -1)
        x = v.movedim(axis, -1)
        shape = x.shape
        x = torch.nn.functional.conv1d(torch.nn.functional.pad(x.reshape(-1, 1, shape[-1]), (r, r), mode="replicate"), k)
        v = x.reshape(shape).movedim(-1, axis)
    return v


def dce_gt_volume(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A seeded (Nucleus, Membrane) pair of (20, 2048, 2048) float32 volumes
    on the card: ``DCE_NUCLEI`` ellipsoids (radii 2.5-4.5 in Z, 14-26 px in
    YX, intensity 0.6-1.0), a membrane shell at 1.3-1.45 times each radius,
    blurred, with seeded noise."""
    zyx = np.asarray(CLI_PREDICT_ZYX)
    rng = np.random.default_rng(seed)
    nuc = torch.zeros(tuple(zyx), device="cuda")
    mem = torch.zeros_like(nuc)
    for _ in range(DCE_NUCLEI):
        c = rng.uniform((4, 40, 40), zyx - (4, 40, 40))
        r = rng.uniform((2.5, 14, 14), (4.5, 26, 26))
        amp = float(rng.uniform(0.6, 1.0))
        lo = np.maximum(np.floor(c - 1.5 * r), 0).astype(int)
        hi = np.minimum(np.ceil(c + 1.5 * r) + 1, zyx).astype(int)
        ax = [(torch.arange(lo[i], hi[i], device="cuda", dtype=torch.float32) - c[i]) / r[i] for i in range(3)]
        d2 = ax[0][:, None, None] ** 2 + ax[1][None, :, None] ** 2 + ax[2][None, None, :] ** 2
        sl = tuple(slice(lo[i], hi[i]) for i in range(3))
        nuc[sl] = torch.maximum(nuc[sl], amp * (d2 <= 1.0))
        mem[sl] = torch.maximum(mem[sl], 0.7 * ((d2 > 1.69) & (d2 <= 2.1)))
    g = torch.Generator(device="cuda").manual_seed(seed)
    nuc = _blur(nuc, (0.7, 1.5, 1.5)) + 0.03 * torch.randn(nuc.shape, device="cuda", generator=g)
    mem = _blur(mem, (0.7, 1.5, 1.5)) + 0.03 * torch.randn(mem.shape, device="cuda", generator=g)
    return nuc, mem


def dce_plates(tmp: Path, card: str) -> tuple[Path, Path]:
    """The seeded GT plate (``Nucleus``, ``Membrane``) at the predict plate's
    positions, and a prediction plate of its nuclei with seeded noise (as
    the JAX package's pipeline test builds its prediction)."""
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    t0 = time.perf_counter()
    gt = open_ome_zarr(tmp / "eval_gt.zarr", layout="hcs", mode="w-", channel_names=["Nucleus", "Membrane"])
    noisy = open_ome_zarr(tmp / "eval_noisy.zarr", layout="hcs", mode="w-", channel_names=["Nucleus"])
    for i, fov in enumerate(DCE_GT_FOVS):
        nuc, mem = dce_gt_volume(40 + i)
        gt.create_position("B", "2", fov).create_image("0", torch.stack([nuc, mem])[None].cpu().numpy())
        if fov in DCE_NOISY_FOVS:
            g = torch.Generator(device="cuda").manual_seed(50 + i)
            pred = nuc + 0.05 * torch.randn(nuc.shape, device="cuda", generator=g)
            noisy.create_position("B", "2", fov).create_image("0", pred[None, None].cpu().numpy())
            del pred
        del nuc, mem
    torch.cuda.empty_cache()
    log(f"[dynacell-eval] (b) GT plate of {len(DCE_GT_FOVS)} FOVs of (1, 2, {', '.join(map(str, CLI_PREDICT_ZYX))})"
        f" float32 ({DCE_NUCLEI} nuclei and their membranes a FOV) and the noisy-GT prediction plate of "
        f"{len(DCE_NOISY_FOVS)} written in {time.perf_counter() - t0:.1f} s ({card})")
    return tmp / "eval_gt.zarr", tmp / "eval_noisy.zarr"


def dce_checkpoints(tmp: Path) -> dict[str, Path]:
    """Seeded full-width extractor weights as a user names them: a ``.pt``
    state dict of the DynaCLR encoder and of the ViT-S/16."""
    from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder
    from viscy_tpu_torch.models.foundation.vit import DinoViT

    enc = ContrastiveEncoder(**{k: tuple(v) if isinstance(v, list) else v for k, v in DCE_ENCODER.items()},
                             generator=torch.Generator().manual_seed(24))
    vit = DinoViT(**DCE_VIT, generator=torch.Generator().manual_seed(25))
    out = {"dynaclr": tmp / "dynaclr_encoder.pt", "dinov3": tmp / "dinov3_vits16.pt"}
    torch.save(enc.state_dict(), out["dynaclr"])
    torch.save(vit.state_dict(), out["dinov3"])
    return out


def dce_config(tmp: Path, gt: Path, pred: Path, name: str, ckpts: dict) -> dict:
    """The leaf config of one evaluation (every tier); its outputs under
    ``tmp/eval/eval_<name>``, so that the grouped run finds them."""
    return {
        "io": {"pred_path": str(pred), "gt_path": str(gt), "pred_channel_name": "Nucleus",
               "gt_channel_name": "Nucleus", "gt_cache_dir": str(tmp / "eval_cache_gt"),
               "pred_cache_dir": str(tmp / f"eval_cache_{name}")},
        "target_name": "nucleus",
        "spacing": DCE_SPACING,
        "compute_feature_metrics": True,
        "compute_instance_ap": True,
        "cell_similarity": {"metrics": ["pcc", "ssim"], "reduce": ["mean", "median"]},
        "pixel_metrics": {"spectral_pcc": {}, "fsc": {}, "multiband_ev": True},
        "feature_metrics": {
            "patch_size": DCE_PATCH,
            "cp": {"glcm": {"enabled": True}},
            "dynaclr": {"type": "contrastive", "checkpoint": str(ckpts["dynaclr"]), "model_config": DCE_ENCODER},
            "dinov3": {"type": "dino", "checkpoint": str(ckpts["dinov3"]), "model_config": DCE_VIT},
        },
        "save": {"save_dir": str(tmp / "eval" / f"eval_{name}")},
        "runtime": {"executor": "thread", "workers": DCE_WORKERS},
        "build": {"masks": True, "instances": True, "cp_features": True, "deep_features": True},
    }


def _num(cell: str) -> float:
    """A CSV cell as a float (an empty cell is NaN)."""
    return float(cell) if cell != "" else float("nan")


def _csv_rows(path: Path) -> list[dict]:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def dce_timings(save_dir: Path) -> str:
    """Seconds per tier and FOV from an evaluation's ``timings.csv``."""
    per: dict = {}
    for r in _csv_rows(save_dir / "timings.csv"):
        per.setdefault(r["region"], {}).setdefault(r["position"], 0.0)
        per[r["region"]][r["position"]] += float(r["seconds"])
    return "; ".join(f"{region} " + ", ".join(f"{pos or '-'} {s:.2f}" for pos, s in fovs.items())
                     for region, fovs in per.items())


def dce_predict(card: str, tmp: Path, cli_info: dict) -> tuple[Path, int]:
    """(a) The flagship's prediction plate through ``python -m
    viscy_tpu_torch.apps.dynacell predict`` with ``configs/vscyto3d_predict.yml``
    and the cli phase's checkpoint; one FOV against the cli phase's store."""
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    store = tmp / "eval_flagship.zarr"
    cfg = _cli_config(tmp / "dce_predict.yml", {
        "data": {"init_args": {"data_path": str(cli_info["predict_plate"]), "num_workers": 8}},
        "trainer": {"callbacks": [{"class_path": "viscy_utils.callbacks.HCSPredictionWriter",
                                   "init_args": {"output_store": str(store), "overwrite": False}}]},
    }, ROOT / "configs/vscyto3d_predict.yml")
    _zero_counts()
    _, s = dynacell_cli(["predict", "-c", cfg, "--ckpt_path", cli_info["ckpt"]])
    launches = fb.launches
    if launches != cli_info["predict"]["fwd"] or fb.bwd_launches or fb.masked_launches:
        raise AssertionError(f"dynacell predict launched {_counts()}, expected {cli_info['predict']['fwd']} A + B")
    fov = f"B/2/{CLI_PREDICT_FOVS[0]}"
    got = open_ome_zarr(store)[fov]["0"][:]
    want = open_ome_zarr(cli_info["predict_store"])[fov]["0"][:]
    err, rng = float(np.abs(got - want).max()), float(want.max() - want.min())
    log(f"[dynacell-eval] (a) dynacell predict (configs/vscyto3d_predict.yml, the cli phase's checkpoint): "
        f"{s:.2f} s for {len(CLI_PREDICT_FOVS)} FOVs of (1, 1, {', '.join(map(str, CLI_PREDICT_ZYX))}); fused "
        f"forward A + B {launches}; {fov} against the cli phase's store max|d| {err:.3e} ({err / rng:.2e} of "
        f"range, bound 1e-6) ({card})")
    if not err <= 1e-6 * rng:
        raise AssertionError("dynacell predict disagrees with viscy-torch predict")
    shutil.rmtree(cli_info["predict_store"])
    return store, launches


def dce_pixel_checks(card: str, gt: Path, pred: Path, fov: str) -> float:
    """One FOV's pixel tier: its busy share on the card (one profiled call),
    and its row on the card against the CPU (the port's plain path) on the
    FOV's centre ``DCE_XCHECK_YX`` square at full depth."""
    from viscy_tpu_torch.apps.dynacell.eval.metrics import compute_pixel_metrics
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    p = open_ome_zarr(pred)[fov]["0"][0, 0]
    t = open_ome_zarr(gt)[fov]["0"][0, 0]
    kw = dict(spacing=DCE_SPACING, fsc_kwargs={}, spectral_pcc_kwargs={}, multiband_ev=True)
    wall, busy = _profiled(lambda: compute_pixel_metrics(p, t, device="cuda", **kw))
    share = "not measured (no device time recorded)" if busy is None else f"{busy / wall:.1%}"
    log(f"[dynacell-eval] pixel tier of {fov} (one profiled call): wall {wall:.1f} ms, device busy "
        f"{'n/a' if busy is None else f'{busy:.1f}'} ms, busy share {share} ({card})")
    y0 = (p.shape[-1] - DCE_XCHECK_YX) // 2
    crop = (slice(None), slice(y0, y0 + DCE_XCHECK_YX), slice(y0, y0 + DCE_XCHECK_YX))
    on_card = compute_pixel_metrics(p[crop], t[crop], device="cuda", **kw)
    t0 = time.perf_counter()
    cpu = compute_pixel_metrics(p[crop], t[crop], device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for k in DCE_PIXEL_KEYS:
        a, b = on_card[k], cpu[k]
        rel = abs(a - b) / max(abs(b), 1e-300)
        worst = max(worst, rel)
        if not rel <= 1e-8:
            raise AssertionError(f"pixel row {fov} {k}: card {a!r} against CPU {b!r} ({rel:.2e} relative, bound 1e-8)")
    log(f"[dynacell-eval] pixel row of {fov}'s centre (20, {DCE_XCHECK_YX}, {DCE_XCHECK_YX}), card against the "
        f"CPU ({cpu_s:.1f} s there): worst {worst:.2e} relative over {len(DCE_PIXEL_KEYS)} metrics (bound 1e-8)")
    return worst


def dce_segmentation_checks(card: str, gt: Path, noisy: Path, flagship: Path) -> dict:
    """The mask tier's host stages with the card's filters (``device="cuda"``)
    against scipy's (``device=None``), bit for bit, on the centre (20,
    ``DCE_SEG_YX``, ``DCE_SEG_YX``) of the first FOV: the nucleus mask and
    instances of the noisy GT and of the flagship's prediction, the GT's
    membrane mask, and the CP features (GLCM on) of both predictions at the
    noisy GT's instances, as the pipeline takes them at the GT's."""
    from viscy_tpu_torch.apps.dynacell.eval.metrics import cp_regionprops
    from viscy_tpu_torch.apps.dynacell.eval.segmentation import segment, segment_nucleus_instances
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    fov = f"B/2/{DCE_NOISY_FOVS[0]}"
    y0 = (CLI_PREDICT_ZYX[-1] - DCE_SEG_YX) // 2
    crop = (slice(None), slice(y0, y0 + DCE_SEG_YX), slice(y0, y0 + DCE_SEG_YX))

    def channel(plate: Path, name: str) -> np.ndarray:
        pos = open_ome_zarr(plate)[fov]
        return np.asarray(pos["0"][0, pos.get_channel_index(name)][crop], np.float32)

    seconds = {"card": 0.0, "host": 0.0}

    def both(fn, *args, **kwargs) -> list:
        out = []
        for where, dev in (("card", "cuda"), ("host", None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(fn(*args, device=dev, **kwargs))
            torch.cuda.synchronize()
            seconds[where] += time.perf_counter() - t0
        return out

    def same(what: str, a: np.ndarray, b: np.ndarray) -> None:
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            raise AssertionError(f"[dynacell-eval] {what}: the card's filters disagree with scipy's")

    imgs = {"noisy GT": channel(noisy, "Nucleus"), "flagship": channel(flagship, "Nucleus")}
    cells, inst = {}, None
    for name, img in imgs.items():
        same(f"{name} nucleus mask", *both(segment, img, "nucleus"))
        card_i, host_i = both(segment_nucleus_instances, img, DCE_SPACING)
        same(f"{name} nucleus instances", card_i, host_i)
        cells[name] = len(np.unique(host_i)) - 1
        inst = host_i if inst is None else inst
    same("GT membrane mask", *both(segment, channel(gt, "Membrane"), "membrane"))
    for name, img in imgs.items():
        card_cp, host_cp = both(cp_regionprops, img, inst, DCE_SPACING, glcm_cfg={"enabled": True})
        same(f"{name} CP features", card_cp, host_cp)
    log(f"[dynacell-eval] (c) {fov}'s centre ({CLI_PREDICT_ZYX[0]}, {DCE_SEG_YX}, {DCE_SEG_YX}), the card's filters against "
        f"scipy's: nucleus masks and instances ({', '.join(f'{k} {v} cells' for k, v in cells.items())}), the "
        f"GT's membrane mask and both predictions' CP features ({card_cp.shape[1]} with GLCM, at the noisy GT's "
        f"{cells['noisy GT']} cells) bit for bit; card {seconds['card']:.1f} s, host {seconds['host']:.1f} s ({card})")
    return cells


def dce_feature_checks(card: str, save_dir: Path, feature_row: dict) -> dict:
    """On an evaluation's saved DynaCLR cohorts (``embeddings/*.npz``, every
    FOV), the card against the CPU: the dataset-level similarity (FID of
    fewer cells than features, KID, precision / recall / F1, MIND, cosine)
    within 1e-8 relative each, a standard deviation over subsets within
    1e-8 of its metric (when every subset holds every cell, as here, the
    KID's subsets are one set and its spread is rounding alone); the
    FOV-grouped real-against-predicted probe (MAD scaling, a balanced
    L-BFGS logistic regression, group k-fold over the FOVs, AUROC), finite,
    within 1e-3, and within 1e-3 of the CSV's value."""
    from viscy_tpu_torch.apps.dynacell.eval.feature_metrics import compute_feature_similarity
    from viscy_tpu_torch.apps.dynacell.eval.linear_probe import paired_auroc

    def load(side: str) -> tuple[np.ndarray, np.ndarray]:
        with np.load(save_dir / "embeddings" / f"{side}_dynaclr_single_cell_embeddings.npz") as z:
            return np.asarray(z["embeddings"], np.float64), np.asarray(z["fov"])

    seconds = {"cuda": 0.0, "cpu": 0.0}

    def on_both(fn, *args) -> dict:
        out = {}
        for dev in seconds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[dev] = fn(*args, device=dev)
            torch.cuda.synchronize()
            seconds[dev] += time.perf_counter() - t0
        return out

    (pred, pred_fov), (gt, gt_fov) = load("pred"), load("gt")
    sims = on_both(compute_feature_similarity, pred, gt, "DynaCLR")
    worst = 0.0
    for k, b in sims["cpu"].items():
        a = sims["cuda"][k]
        if math.isnan(a) and math.isnan(b):
            continue
        scale = abs(sims["cpu"][k[:-4]]) if k.endswith("_std") else abs(b)
        rel = abs(a - b) / max(scale, 1e-300)
        worst = max(worst, rel)
        if not rel <= 1e-8:
            raise AssertionError(f"[dynacell-eval] {k}: card {a!r} against CPU {b!r} ({rel:.2e} of "
                                 f"{'its metric' if k.endswith('_std') else 'itself'}, bound 1e-8)")
    probes = on_both(paired_auroc, gt, pred, gt_fov, pred_fov)
    a, b = probes["cuda"]["auroc_mean"], probes["cpu"]["auroc_mean"]
    in_csv = _num(feature_row["Dataset_DynaCLR_RealVsPred_AUROC"])
    if not (math.isfinite(a) and abs(a - b) <= 1e-3 and abs(a - in_csv) <= 1e-3):
        raise AssertionError(f"[dynacell-eval] DynaCLR real-against-predicted probe: card {a!r}, CPU {b!r}, "
                             f"the evaluation's CSV {in_csv!r} (finite, within 1e-3)")
    log(f"[dynacell-eval] (c) {save_dir.name}'s DynaCLR cohorts ({len(gt)} GT and {len(pred)} predicted cells, "
        f"{pred.shape[1]} features, {len(np.unique(gt_fov))} FOVs), card against CPU: similarity worst {worst:.2e} "
        f"over {len(sims['cpu'])} metrics (bound 1e-8; FID {sims['cuda']['DynaCLR_FID']:.10g} against "
        f"{sims['cpu']['DynaCLR_FID']:.10g}); FOV-grouped probe AUROC card {a:.6f}, CPU {b:.6f} ({abs(a - b):.1e}), "
        f"the CSV {in_csv:.6f} (bound 1e-3), {probes['cuda']['n_folds']} folds; card {seconds['cuda']:.1f} s, CPU "
        f"{seconds['cpu']:.1f} s ({card})")
    return dict(similarity_worst=worst, auroc=a, auroc_cpu=b)


# spectral-eval of one flagship FOV: the optics the GT plate's sampling stands for (a 1.3 NA objective, GFP
# emission), the module's default batteries
DCE_SPECTRAL = {"fsc": {}, "dcr": {}, "spectral_pcc": {}, "bandlimited": {},
                "optics": {"numerical_aperture": 1.3, "wavelength_emission": 0.52}}
DCE_RESOLUTION_KEYS = ("FSC_", "DCR_")  # prefixes of the resolution columns: equal card and CPU (not DCR_A0, DCR_w)
# a float64 metric this close to 0 on the card and the CPU is 0 but for rounding (sums over a million voxels of
# magnitude 1 round at about 1e-13; the flagship's multiband EV of its crop is 5e-15 and -3e-17): no relative bound
DCE_ZERO = 1e-12


def _crop_plate(src: Path, dst: Path, fov: str, channel: str, crop: tuple) -> Path:
    """One FOV's ``channel`` cropped to ``crop`` (Z, Y, X slices) as a plate
    of its own, the source's scale kept."""
    from viscy_tpu_torch.zarr_io.store import TransformationMeta, open_ome_zarr

    pos = open_ome_zarr(src)[fov]
    data = pos["0"][:, pos.get_channel_index(channel)][(slice(None), *crop)][:, None]
    plate = open_ome_zarr(dst, layout="hcs", mode="w-", channel_names=[channel])
    row, col, name = fov.split("/")
    plate.create_position(row, col, name).create_image("0", np.ascontiguousarray(data),
                                                       transform=[TransformationMeta(scale=list(pos.scale))])
    return dst


def dce_spectral_eval(card: str, tmp: Path, gt: Path, flagship: Path) -> dict:
    """(d) ``dynacell spectral-eval --mode compute`` of the flagship's
    prediction of one whole (20, 2048, 2048) FOV against phase 24's GT
    (seconds, peak memory, finite rows); then on the FOV's centre (20,
    ``DCE_XCHECK_YX``, ``DCE_XCHECK_YX``) crop on the card and with
    ``--device cpu``: every float column within 1e-8 relative (or within
    ``DCE_ZERO`` of 0 on both), the resolution columns equal."""
    fov = f"B/2/{DCE_NOISY_FOVS[0]}"
    cfg = dict(DCE_SPECTRAL, input_zarr=str(gt), pred_zarr=str(flagship), gt_channel="Nucleus",
               pred_channel="Nucleus", positions=[fov], spacing=DCE_SPACING)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, s = dynacell_cli(["spectral-eval", "-c", _cli_config(tmp / "spectral_full.yml",
                                                              dict(cfg, output_dir=str(tmp / "spectral_full")))])
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = _csv_rows(tmp / "spectral_full" / fov / "metrics.csv")
    bad = [k for k, v in rows[0].items() if not math.isfinite(_num(v)) and k not in ("DCR_XY", "DCR_Z", "DCR_2D")]
    log(f"[dynacell-eval] (d) spectral-eval of {fov} (1, 1, {', '.join(map(str, CLI_PREDICT_ZYX))}): {s:.1f} s, "
        f"peak {peak:.2f} GiB, {len(rows)} row of {len(rows[0])} columns; PCC {_num(rows[0]['PCC']):.4f}, FSC XY "
        f"{_num(rows[0]['FSC_XY']):.4f} um, DCR XY {_num(rows[0]['DCR_XY']):.4f} um, spectral PCC "
        f"{_num(rows[0]['Spectral_PCC']):.4f}, BL PCC at the OTF {_num(rows[0].get('BL_PCC_OTF', '')):.4f}, "
        f"multiband {_num(rows[0]['Multiband_EV_NC']):.4f} ({card})")
    if len(rows) != 1 or bad:
        raise AssertionError(f"spectral-eval of {fov}: {len(rows)} rows, non-finite {bad}")

    y0 = (CLI_PREDICT_ZYX[-1] - DCE_XCHECK_YX) // 2
    crop = (slice(None), slice(y0, y0 + DCE_XCHECK_YX), slice(y0, y0 + DCE_XCHECK_YX))
    crop_cfg = dict(cfg, input_zarr=str(_crop_plate(gt, tmp / "spectral_gt.zarr", fov, "Nucleus", crop)),
                    pred_zarr=str(_crop_plate(flagship, tmp / "spectral_pred.zarr", fov, "Nucleus", crop)))
    secs, rows = [], []
    for dev in ("cuda", "cpu"):
        out_dir = tmp / f"spectral_{dev}"
        path = _cli_config(tmp / f"spectral_{dev}.yml", dict(crop_cfg, output_dir=str(out_dir)))
        secs.append(dynacell_cli(["--device", dev, "spectral-eval", "-c", path])[1])
        rows.append(_csv_rows(out_dir / fov / "metrics.csv"))
    card_rows, cpu_rows = rows
    worst, checked, zeros = 0.0, 0, []
    for a_row, b_row in zip(card_rows, cpu_rows):
        if list(a_row) != list(b_row):
            raise AssertionError("spectral-eval: the card's columns differ from the CPU's")
        for k, b in b_row.items():
            a, b = _num(a_row[k]), _num(b)
            if k == "timepoint" or (k.startswith(DCE_RESOLUTION_KEYS) and k not in ("DCR_A0", "DCR_w")):
                if not (a == b or (math.isnan(a) and math.isnan(b))):
                    raise AssertionError(f"spectral-eval {k}: card {a!r}, CPU {b!r} (equal expected)")
                continue
            if max(abs(a), abs(b)) <= DCE_ZERO:  # a metric that is 0 but for rounding on both sides
                zeros.append(k)
                continue
            rel = abs(a - b) / max(abs(b), 1e-300) if math.isfinite(b) else (0.0 if a == b else math.inf)
            worst, checked = max(worst, rel), checked + 1
            if not rel <= 1e-8:
                raise AssertionError(f"spectral-eval {k}: card {a!r} against CPU {b!r} ({rel:.2e} relative)")
    log(f"[dynacell-eval] (d) spectral-eval of {fov}'s centre (20, {DCE_XCHECK_YX}, {DCE_XCHECK_YX}), card "
        f"({secs[0]:.1f} s) against --device cpu ({secs[1]:.1f} s): {checked} float columns worst "
        f"{worst:.2e} relative (bound 1e-8), {zeros or 'none'} within {DCE_ZERO:g} of 0 on both, the resolution "
        f"columns equal")
    return dict(seconds=s, peak_gib=peak, worst=worst)


def dce_whole_cell(card: str, gt: Path) -> int:
    """(d) ``segment_whole_cell`` on the GT's centre (20, ``DCE_SEG_YX``,
    ``DCE_SEG_YX``) from its membrane and nucleus channels and its nucleus
    instances: the card's closing, Gaussian and distance transform against
    scipy's on the host, bit for bit. Returns the cells."""
    from viscy_tpu_torch.apps.dynacell.eval.segmentation import segment_nucleus_instances
    from viscy_tpu_torch.apps.dynacell.eval.segmentation_whole_cell import segment_whole_cell
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    pos = open_ome_zarr(gt)[f"B/2/{DCE_NOISY_FOVS[0]}"]
    y0 = (CLI_PREDICT_ZYX[-1] - DCE_SEG_YX) // 2
    crop = (slice(None), slice(y0, y0 + DCE_SEG_YX), slice(y0, y0 + DCE_SEG_YX))
    nuc, mem = (np.asarray(pos["0"][0, pos.get_channel_index(c)][crop], np.float32) for c in ("Nucleus", "Membrane"))
    seeds = segment_nucleus_instances(nuc, DCE_SPACING, device="cuda")
    out, seconds = {}, {}
    for where, dev in (("card", "cuda"), ("host", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[where] = segment_whole_cell(mem, nuc, seeds, DCE_SPACING, device=dev)
        torch.cuda.synchronize()
        seconds[where] = time.perf_counter() - t0
    cells = len(np.unique(out["host"])) - 1
    log(f"[dynacell-eval] (d) segment_whole_cell of the GT's centre ({CLI_PREDICT_ZYX[0]}, {DCE_SEG_YX}, "
        f"{DCE_SEG_YX}) from {int(seeds.max())} nuclei: {cells} cells; the card's filters against scipy's "
        f"{'bit for bit' if np.array_equal(out['card'], out['host']) else 'DIFFERENT'}; card {seconds['card']:.2f} s, "
        f"host {seconds['host']:.2f} s ({card})")
    if out["card"].dtype != out["host"].dtype or not np.array_equal(out["card"], out["host"]) or cells < 1:
        raise AssertionError("segment_whole_cell: the card's filters disagree with scipy's (or no cell)")
    return cells


def phase_dynacell_eval(card: str, tmp: Path, cli_info: dict) -> dict:
    """Phase 24 (see the module docstring)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flagship, launches = dce_predict(card, tmp, cli_info)
    shutil.rmtree(cli_info["predict_plate"])
    gt, noisy = dce_plates(tmp, card)
    ckpts = dce_checkpoints(tmp)
    cfgs = {"mock": dce_config(tmp, gt, flagship, "mock", ckpts), "denv": dce_config(tmp, gt, noisy, "denv", ckpts)}
    paths = {name: _cli_config(tmp / f"eval_{name}.yml", cfg) for name, cfg in cfgs.items()}

    out, s = dynacell_cli(["precompute-gt", "-c", paths["mock"]])
    counts = _json_out(out)
    log(f"[dynacell-eval] (c) precompute-gt: {s:.1f} s, {counts} ({card})")
    want = len(DCE_GT_FOVS)
    if counts != {"masks": want, "instances": want, "cp_features": want, "deep_features": 2 * want}:
        raise AssertionError(f"precompute-gt built {counts}")
    gt_cache = tmp / "eval_cache_gt"
    mtimes = {p: p.stat().st_mtime_ns for p in gt_cache.rglob("*.np*")}

    # the two evaluations run at once, as a lab scores two models on one machine: each one's FOV
    # threads keep the host busy, the card's calls take the runtime's device lock
    from concurrent.futures import ThreadPoolExecutor

    from viscy_tpu_torch.apps.dynacell.__main__ import main as dynacell

    def evaluate(name: str) -> float:
        t0 = time.perf_counter()
        dynacell.main(["evaluate", "-c", paths[name]], standalone_mode=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        seconds = dict(zip(cfgs, pool.map(evaluate, cfgs)))
    both_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[dynacell-eval] (c) evaluate of both plates at once: {both_s:.1f} s, peak {peak:.2f} GiB ({card})")
    rows = {}
    for name, label in (("mock", "the flagship's prediction"), ("denv", "the noisy GT")):
        s = seconds[name]
        save = Path(cfgs[name]["save"]["save_dir"])
        pixel, mask = _csv_rows(save / "pixel_metrics.csv"), _csv_rows(save / "mask_metrics.csv")
        feature = _csv_rows(save / "feature_metrics.csv")
        rows[name] = (pixel, mask, feature)
        if [p.stat().st_mtime_ns for p in mtimes] != list(mtimes.values()):
            raise AssertionError(f"evaluate of {label} rewrote a GT artifact")
        for r in pixel:
            if not all(math.isfinite(_num(r[k])) for k in DCE_PIXEL_KEYS):
                raise AssertionError(f"non-finite pixel metrics of {label}: {r}")
        cells = ", ".join(f"{r['FOV']} {r['n_gt']} GT / {r['n_pred']} predicted" for r in mask)
        log(f"[dynacell-eval] (c) evaluate {label}: {s:.1f} s; cells a FOV {cells}; seconds: {dce_timings(save)} "
            f"({card})")
        log(f"[dynacell-eval] (c) {label}: " + "; ".join(
            f"{r['FOV']} PCC {_num(r['PCC']):.4f} SSIM {_num(r['SSIM']):.4f} spectral PCC "
            f"{_num(r['Spectral_PCC']):.4f} FSC {_num(r['FSC_FSC_Resolution']):.4f} multiband "
            f"{_num(r['Multiband_EV_NC']):.4f} per-cell PCC {_num(r['PerCell_PCC_mean']):.4f}" for r in pixel)
            + "; " + "; ".join(f"{r['FOV']} Dice {_num(r['Dice']):.4f} mAP {_num(r['mAP']):.4f}" for r in mask)
            + "; dataset " + ", ".join(f"{k[8:]} {_num(feature[0][k]):.4g}" for k in (
                "Dataset_CP_FID", "Dataset_DINOv3_FID", "Dataset_DynaCLR_FID", "Dataset_DynaCLR_KID",
                "Dataset_DynaCLR_Precision", "Dataset_DynaCLR_MIND", "Dataset_CP_RealVsPred_AUROC",
                "Dataset_DINOv3_RealVsPred_AUROC", "Dataset_DynaCLR_RealVsPred_AUROC")))
    pixel, mask, _ = rows["denv"]
    if not all(_num(r["PCC"]) > 0.8 for r in pixel) or not all(_num(r["Dice"]) > 0.5 for r in mask):
        raise AssertionError("the noisy-GT plate scores PCC <= 0.8 or Dice <= 0.5")
    # the flagship's plate has two FOV groups: its probes score (the noisy plate's one FOV admits no fold)
    probe_keys = [f"Dataset_{k}_RealVsPred_AUROC" for k in ("CP", "DINOv3", "DynaCLR")]
    flagship_row = rows["mock"][2][0]
    if not all(math.isfinite(_num(flagship_row[k])) for k in probe_keys):
        raise AssertionError(f"the flagship's FOV-grouped probes: {[flagship_row[k] for k in probe_keys]}")
    seg_cells = dce_segmentation_checks(card, gt, noisy, flagship)
    feat = dce_feature_checks(card, Path(cfgs["mock"]["save"]["save_dir"]), flagship_row)

    grouped = {**cfgs["mock"], "save": {"save_dir": str(tmp / "eval")},
               "conditions": {name: {"io": {k: cfg["io"][k] for k in ("pred_path", "pred_cache_dir")}}
                              for name, cfg in cfgs.items()}}
    out, s = dynacell_cli(["evaluate-grouped", "-c", _cli_config(tmp / "eval_grouped.yml", grouped)])
    probe = _csv_rows(tmp / "eval" / "eval_denv" / "cross_condition_probe.csv")
    done = [r for r in probe if not r["skipped_reason"]]
    # each condition's FOVs fall in folds of their own, so no validation fold holds both conditions
    # and every row's AUROC is NaN, as in JAX: this probe is not exercised at these FOV counts
    log(f"[dynacell-eval] (c) evaluate-grouped (the final-metrics caches hit): {s:.1f} s; {out.strip()}; "
        f"cross-condition probe rows {len(probe)}, run {len(done)} (FOV groups {', '.join(r['n_fovs'] for r in done)}, "
        f"AUROC {', '.join(r['auroc_mean'] or 'NaN' for r in done)}: no validation fold holds both conditions)")
    if len(probe) != 8 or {r["feature_type"] for r in done} != {"cp", "dinov3", "dynaclr"}:
        raise AssertionError(f"cross-condition probe rows {probe}")
    worst = dce_pixel_checks(card, gt, noisy, f"B/2/{DCE_NOISY_FOVS[0]}")
    t_tail = time.perf_counter()
    spectral = dce_spectral_eval(card, tmp, gt, flagship)
    whole_cells = dce_whole_cell(card, gt)
    tail_s = time.perf_counter() - t_tail
    seconds = time.perf_counter() - t_phase
    log(f"[phase 24] dynacell evaluate in {seconds:.1f} s (spectral-eval and whole-cell legs {tail_s:.1f} s); fused "
        f"forward A + B {launches} ({card})")
    return dict(launches=launches, seconds=seconds, pixel_worst=worst, seg_cells=seg_cells, spectral=spectral,
                whole_cells=whole_cells, tail_s=tail_s, **feat)


# -- phase 25: cross-modal JointEncoderModule training from a plate -----------------------------------


# configs/dynaclr_fit.yml's encoder width (in_stack_depth 15, stem (5, 4, 4), embedding 768, projection 128)
# with one channel each and the v2 backbone, so that the fused kernels carry every block
JOINT_ENCODER = dict(backbone="convnextv2_tiny", in_channels=1, in_stack_depth=15, stem_kernel_size=[5, 4, 4],
                     stem_stride=[5, 4, 4], embedding_dim=768, projection_dim=128)
JOINT_BATCH = 32  # configs/dynaclr_fit.yml's batch
JOINT_YX = 224  # its final patch
JOINT_STEPS = 3
JOINT_VAL = 1
JOINT_XCHECK = 4  # the f32 step held card against CPU, at the fit's width
JOINT_PREDICT_ZYX = (15, 512, 512)  # one window a FOV


def joint_shapes(yx: int) -> list[tuple[int, int, int]]:
    """(S, C, M) of every fused block call of one encoder's forward at
    ``yx``^2 (the (5, 4, 4) stem: a quarter of the YX)."""
    from viscy_tpu_torch.models.components.blocks import convnext_arch

    depths, dims, v2 = convnext_arch(JOINT_ENCODER["backbone"])
    assert v2
    side = yx // JOINT_ENCODER["stem_stride"][-1]
    return [((side >> i) ** 2, d, 4 * d) for i, (n, d) in enumerate(zip(depths, dims)) for _ in range(n)]


def _joint_launches(yx: int, batch: int) -> int:
    """Forward (or backward) launches of one step of both encoders: two per
    launch of at most ``samples_per_launch`` samples, every fused call."""
    from viscy_tpu_torch.ops import fused_block as fb

    return 2 * sum(2 * -(-batch // fb.samples_per_launch(s, m)) for s, _, m in joint_shapes(yx))


def joint_module(device: str, seed: int = 25):
    from viscy_tpu_torch.apps.dynaclr.multi_modal import JointEncoderModule

    return JointEncoderModule(source_encoder=dict(JOINT_ENCODER), target_encoder=dict(JOINT_ENCODER),
                              temperature=0.07, lr=1e-3, seed=seed, device=device)


def joint_kernels(card: str) -> dict:
    """Phase 25 (a): the fused forward and backward kernels at the encoders'
    largest and smallest row counts (B = 32) against their plain versions,
    then f32 CUDA-event medians per train step of both encoders beside the
    plain versions and the bounds."""
    from viscy_tpu_torch.ops import fused_block as fb

    shapes = joint_shapes(JOINT_YX)
    distinct = sorted(set(shapes), key=shapes.index)
    worst: dict = {}
    bwd_worst = 0.0
    for k, (s, c, m) in enumerate((distinct[0], distinct[-1])):
        check_forward(JOINT_BATCH, s, c, m, 2500 + k, (False,), worst)
        bwd_worst = max(bwd_worst, check_backward(JOINT_BATCH, s, c, m, 2510 + k, False))
    log_worst(f"the joint encoders' largest and smallest rows (B={JOINT_BATCH}, {JOINT_YX}^2)", worst)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bwd_ms=0.0, bwd_plain_ms=0.0, bwd_bound_ms=0.0)
    for k, (s, c, m) in enumerate(distinct):
        args, _ = block_inputs(JOINT_BATCH, s, c, m, torch.float32, seed=2520 + k)
        x, sc, *params = args
        g = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(2530 + k), device="cuda")
        ss = fb._reference_ss(x, *params[:4], None, 1e-6)
        n = 2 * shapes.count((s, c, m))  # both encoders
        times = dict(
            ms=cuda_median_ms(lambda: fb.fused_mlp_grn(*args)),
            plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn(*args), runs=5),
            bound_ms=block_bound_ms(JOINT_BATCH, s, c, m, torch.float32)[0],
            bwd_ms=cuda_median_ms(lambda: fb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6)),
            bwd_plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn_bwd(x, g, *params, ss), runs=5),
            bwd_bound_ms=8.0 * JOINT_BATCH * s * c * m / PEAK_FLOPS[torch.float32] * 1e3,
        )
        for key, val in times.items():
            total[key] += val * n
        log(f"[joint] time S={s} C={c} M={m} B={JOINT_BATCH} f32 x{n}/step: forward {times['ms']:.3f} ms (plain "
            f"{times['plain_ms']:.3f}, bound {times['bound_ms']:.4f}), backward {times['bwd_ms']:.3f} ms (plain "
            f"{times['bwd_plain_ms']:.3f}, bound {times['bwd_bound_ms']:.4f})")
        del args, x, sc, params, g, ss
        torch.cuda.empty_cache()
    log(f"[joint] fused kernels per train step of both encoders ({2 * len(shapes)} calls, B={JOINT_BATCH}, f32): "
        f"A + B {total['ms']:.3f} ms (plain {total['plain_ms']:.3f}, bound {total['bound_ms']:.3f}), C + D "
        f"{total['bwd_ms']:.3f} ms (plain {total['bwd_plain_ms']:.3f}, bound {total['bwd_bound_ms']:.3f}); "
        f"CUDA-event medians ({card})")
    return dict(total, fwd_err=worst[torch.bfloat16][0], bwd_err=bwd_worst)


def joint_cross_check() -> None:
    """Phase 25 (b): one f32 step (TF32 off), card against CPU on the same
    weights (GRN gamma / beta non-zero) and batch (``JOINT_XCHECK`` pairs of
    (1, 15, 224, 224), each pair's windows at a brightness and contrast of
    their own): both embeddings and projections, the NT-Xent loss,
    every gradient (the shifts a train-mode BatchNorm removes 0 up to
    rounding on both) and both BatchNorms' running statistics after it;
    the step's launches on the card."""
    import copy

    on_cpu = joint_module("cpu")
    randomize_grn(on_cpu, 2540)
    on_card = copy.deepcopy(on_cpu).to("cuda")
    g = torch.Generator().manual_seed(2541)
    depth = JOINT_ENCODER["in_stack_depth"]
    shape = (JOINT_XCHECK, 1, depth, JOINT_YX, JOINT_YX)
    # each pair at a brightness and contrast of its own, as distinct cells are: i.i.d. uniform windows pool to
    # four nearly equal embeddings, and the projection's BatchNorm over them then divides f32 rounding by a
    # batch deviation near 0 (on an H100 one gradient landed 2.77e-3 of range apart)
    batch = {k: torch.rand(shape, generator=g) * (0.5 + 1.5 * torch.rand((JOINT_XCHECK, 1, 1, 1, 1), generator=g))
             + torch.randn((JOINT_XCHECK, 1, 1, 1, 1), generator=g) for k in ("source", "target")}
    outs, losses = [], []
    _zero_counts()
    for module, dev in ((on_card, "cuda"), (on_cpu, "cpu")):
        seen: dict = {}
        hooks = [getattr(module.model, n).register_forward_hook(lambda m, i, o, n=n: seen.__setitem__(n, o))
                 for n in ("source_encoder", "target_encoder")]
        module.train()
        t0 = time.perf_counter()
        loss = module.training_loss({k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        losses.append((float(loss.detach()), time.perf_counter() - t0))
        for h in hooks:
            h.remove()
        outs.append({f"{n}.{what}": t.detach().cpu() for n, (emb, proj) in seen.items()
                     for what, t in (("embedding", emb), ("projection", proj))})
        if dev == "cuda":
            counts = _counts()
    checks = {k: compare(outs[0][k], w) for k, w in outs[1].items()}
    state_g, state_c = on_card.model.state_dict(), on_cpu.model.state_dict()
    stats = [k for k in state_c if k.endswith(("running_mean", "running_var"))]
    checks.update({k: compare(state_g[k].cpu(), state_c[k]) for k in stats})
    (l_card, _), (l_cpu, cpu_s) = losses
    l_rel = abs(l_card - l_cpu) / abs(l_cpu)
    bad = {k: v for k, v in checks.items() if not (v[1] <= 2e-3 and v[2] > 0.9999)}
    want = _joint_launches(JOINT_YX, JOINT_XCHECK)
    log(f"[joint] f32 step ({JOINT_XCHECK} pairs of (1, {depth}, {JOINT_YX}, {JOINT_YX})), card vs CPU: "
        + ", ".join(f"{k} {v[1]:.2e}" for k, v in checks.items() if "running" not in k)
        + f" of range; NT-Xent {l_card:.7f} vs {l_cpu:.7f} (rel {l_rel:.2e}); {len(stats)} running statistics "
        f"after it worst {max(checks[k][1] for k in stats):.2e} of range; launches {counts} (expected {want} "
        f"forward and backward) (CPU {cpu_s:.1f} s)")
    if bad or l_rel > 2e-3 or len(stats) != 8 or counts["fwd"] != want or counts["bwd"] != want:
        raise AssertionError(f"JointEncoderModule f32 step on the card disagrees with the CPU: {bad}, loss rel "
                             f"{l_rel:.2e}, launches {counts}")
    zero = {f"model.{e}.{n}": f"model.{e}.{n.replace('bias', 'weight')}" for e in ("source_encoder", "target_encoder")
            for n in ("encoder.head.norm.bias", "projection.0.bias", "projection.3.bias")}
    n_grads, worst = _compare_grads(on_card, on_cpu, zero, "JointEncoderModule f32 step")
    log(f"[joint] f32 step: {n_grads} parameter gradients within 2e-3 of range and r > 0.9999, worst {worst[1]} "
        f"{worst[0]:.2e}; the six shifts a train-mode BatchNorm removes 0 up to rounding on both")
    del on_card, on_cpu
    torch.cuda.empty_cache()


def joint_cli(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 25 (c): ``viscy-torch fit`` of a ``JointEncoderModule`` config
    (``configs/dynaclr_fit.yml``'s recipe with the model and data replaced:
    ``HCSDataModule`` from Phase3D to RFP on phase 14's plate, windows 15
    deep, a host weighted crop of 8 patches a window to 224^2, a flip),
    3 steps and 1 validation batch, then ``viscy-torch predict`` from its
    ``last`` on a plate of two (2, 15, 512, 512) FOVs; launch counts per
    step of both encoders, finite losses, the predictions' shapes. (No
    resume here: with one, the whole script took 1186.8 s of its 1200 s on
    a slow host; the CPU test resumes this fit through the CLI.)"""
    from viscy_tpu_torch.apps.dynaclr.multi_modal import JointEncoderModule
    from viscy_tpu_torch.models.components.blocks import convnext_arch
    from viscy_tpu_torch.training import cli
    from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

    channels = list(DYNACLR_CHANNELS)
    depth = JOINT_ENCODER["in_stack_depth"]
    model = {"class_path": "dynaclr.multi_modal.JointEncoderModule",
             "init_args": {"source_encoder": dict(JOINT_ENCODER), "target_encoder": dict(JOINT_ENCODER),
                           "temperature": 0.07, "lr": 1e-3}}
    norm = {"class_path": "viscy_transforms.NormalizeSampled",
            "init_args": {"keys": channels, "level": "fov_statistics"}}
    crop = {"class_path": "viscy_tpu.data.host_transforms.HostRandWeightedCropd",
            "init_args": {"keys": [*channels, "weight"], "w_key": "weight",
                          "spatial_size": [depth, JOINT_YX, JOINT_YX], "num_samples": 8}}
    flip = {"class_path": "viscy_transforms.BatchedRandFlipd", "init_args": {"keys": ["source", "target"], "prob": 0.5}}
    data = {"class_path": "viscy_data.HCSDataModule", "init_args": {
        "data_path": str(plate), "source_channel": "Phase3D", "target_channel": "RFP", "z_window_size": depth,
        "split_ratio": 0.8, "batch_size": JOINT_BATCH, "num_workers": 8, "yx_patch_size": [JOINT_YX, JOINT_YX],
        "normalizations": [norm], "augmentations": [crop, flip]}}
    root = tmp / "joint_fit"

    def edit(cfg):
        cfg["data"] = data
        cfg["trainer"].update(default_root_dir=str(root), max_epochs=1, limit_train_batches=JOINT_STEPS,
                              limit_val_batches=JOINT_VAL, log_every_n_steps=1)

    fit_cfg = _composed(tmp, "dynaclr_fit.yml", "joint_fit.yml", model, edit)
    per = _joint_launches(JOINT_YX, JOINT_BATCH)
    want_fit = dict(fwd=per * (JOINT_STEPS + JOINT_VAL), bwd=per * JOINT_STEPS, masked_fwd=0, masked_bwd=0, warp=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer = cli.main(["fit", "-c", fit_cfg])
    seconds = time.perf_counter() - t0
    fit_counts = _counts()
    feed, metrics = trainer.feed_stats, trainer.logged_metrics
    loss, val = metrics.get("loss/train"), metrics.get("loss/validate")
    if fit_counts != want_fit or feed["steps"] != JOINT_STEPS or trainer.global_step != JOINT_STEPS \
            or not all(v is not None and math.isfinite(v) for v in (loss, val)):
        raise AssertionError(f"JointEncoderModule fit: launches {fit_counts} (expected {want_fit}), steps "
                             f"{feed['steps']}, global step {trainer.global_step}, losses {loss} / {val}")
    log(f"[joint] viscy-torch fit (JointEncoderModule, 2 x {JOINT_ENCODER['backbone']}, batch {JOINT_BATCH} of "
        f"(1, {depth}, {JOINT_YX}, {JOINT_YX}) pairs from phase 14's plate): {seconds:.1f} s in all, train loop "
        f"{feed['seconds']:.2f} s for {JOINT_STEPS} steps = {JOINT_STEPS * JOINT_BATCH / feed['seconds']:.3f} "
        f"pairs/s (first step included), waited {feed['wait_s'] / feed['seconds']:.1%} of the loop; loss/train "
        f"{loss:.5f}, loss/validate {val:.5f}; launches {fit_counts}: per step {per} forward and {per} backward of "
        f"both encoders; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    del trainer

    pred_plate = build_hcs_plate(tmp / "joint_predict.zarr", channels, zyx_shape=JOINT_PREDICT_ZYX, num_timepoints=1,
                                 rows=("A",), cols=("1",), fovs=("0", "1"), seed=2550, norm_meta=True)
    pred_data = {k: v for k, v in data["init_args"].items()
                 if k not in ("augmentations", "split_ratio", "yx_patch_size")}
    pred_cfg = _cli_config(tmp / "joint_predict.yml", {
        "model": model, "data": {"class_path": "viscy_data.HCSDataModule",
                                 "init_args": dict(pred_data, data_path=str(pred_plate), batch_size=2)},
        "trainer": {"default_root_dir": str(tmp / "joint_predict")}, "ckpt_path": str(root / "checkpoints/last")})
    preds: list = []
    restore = _spy(JointEncoderModule, "predict_step", lambda self, p: preds.append(p))
    _zero_counts()
    t0 = time.perf_counter()
    try:
        cli.main(["predict", "-c", pred_cfg])
        torch.cuda.synchronize()
    finally:
        restore()
    pred_s = time.perf_counter() - t0
    counts = _counts()
    want_pred = dict(fwd=_joint_launches(JOINT_PREDICT_ZYX[-1], 2), bwd=0, masked_fwd=0, masked_bwd=0, warp=0)
    shapes = {k: tuple(v.shape) for k, v in preds[0].items()} if preds else {}
    emb, proj = convnext_arch(JOINT_ENCODER["backbone"])[1][-1], JOINT_ENCODER["projection_dim"]
    want_shapes = {"features": (2, emb), "projections": (2, proj), "target_features": (2, emb),
                   "target_projections": (2, proj)}
    if len(preds) != 1 or counts != want_pred or shapes != want_shapes \
            or not all(torch.isfinite(v).all() for v in preds[0].values()):
        raise AssertionError(f"JointEncoderModule predict: {len(preds)} batches, {shapes}, launches {counts} "
                             f"(expected {want_pred})")
    log(f"[joint] viscy-torch predict from the fit's last (two (2, {depth}, {JOINT_PREDICT_ZYX[-1]}, "
        f"{JOINT_PREDICT_ZYX[-1]}) FOVs, source and target): {pred_s:.2f} s, {shapes}, finite; launches {counts} "
        f"({card})")
    shutil.rmtree(pred_plate)
    return {k: fit_counts[k] + counts[k] for k in counts}


def joint_busy(card: str) -> None:
    """Phase 25 (d): the busy share and top kernels of one profiled
    optimizer step at batch 32 of (1, 15, 224, 224) pairs (windows on the
    card: the step alone, without the plate's reads)."""
    module = joint_module("cuda").train()
    g = torch.Generator(device="cuda").manual_seed(2560)
    shape = (JOINT_BATCH, 1, JOINT_ENCODER["in_stack_depth"], JOINT_YX, JOINT_YX)
    batch = {k: torch.rand(shape, generator=g, device="cuda") for k in ("source", "target")}
    busy_share("joint", f"one JointEncoderModule step at batch {JOINT_BATCH} of {shape[1:]} pairs, f32",
               _engine_step(module, batch, g))
    del module, batch
    torch.cuda.empty_cache()


def phase_joint(card: str, tmp: Path, plate: Path) -> dict:
    """Phase 25: cross-modal JointEncoderModule training (see the module
    docstring)."""
    t0 = time.perf_counter()
    kernels = joint_kernels(card)
    joint_cross_check()
    launches = joint_cli(card, tmp, plate)
    joint_busy(card)
    seconds = time.perf_counter() - t0
    log(f"[phase 25] JointEncoderModule in {seconds:.1f} s; launches {launches} ({card})")
    return dict(kernels=kernels, launches=launches, seconds=seconds)


# -- phase 26: DynaCLR's CTC tracking benchmark and the config-driven evaluation subcommands -------------

CTC_FRAMES = 40  # Fluo-N2DH-GOWT1 has 92 frames a sequence; cut to keep the whole script inside its limit
CTC_SIDE = 1024  # GOWT1's frame
CTC_CELLS = 30
CTC_RADIUS = 18.0  # pixels: nuclei about 36 px across
CTC_ENCODER = dict(in_channels=1, in_stack_depth=1, stem_kernel_size=[1, 4, 4], stem_stride=[1, 4, 4],
                   embedding_dim=768)
CTC_BACKBONES = ("convnext_tiny", "convnextv2_tiny")
CTC_SHAPE = (160, 160)  # the config's model_input_shape (JAX's default)
CTC_BATCH = 128  # the config's batch_size (JAX's default)
CTC_XCHECK = 128  # crops embedded on the card and on the CPU
CTC_RESULTS = ["DET", "TRA", "LNK", "CT", "TF", "BC(0)", "CCA", "BIO(0)", "OP_CLB(0)", "CHOTA", "model", "dataset",
               "sequence"]
CTC_SUMMARY = ["model", "dataset", "LNK", "BIO(0)", "OP_CLB(0)", "CHOTA", "TRA", "DET"]
SUITE_MMD = dict(n_permutations=200, max_cells=1000)  # each comparison: 1000 cells a side, 200 permutations


def ctc_shapes() -> list[tuple[int, int, int]]:
    """(S, C, M) of every fused block call of the ``convnextv2_tiny``
    encoder's forward at ``CTC_SHAPE`` (a (1, 4, 4) stem)."""
    from viscy_tpu_torch.models.components.blocks import convnext_arch

    depths, dims, _ = convnext_arch("convnextv2_tiny")
    side = CTC_SHAPE[0] // CTC_ENCODER["stem_stride"][-1]
    return [((side >> i) ** 2, d, 4 * d) for i, (n, d) in enumerate(zip(depths, dims)) for _ in range(n)]


def _ctc_launches(n_crops: int) -> int:
    """Forward launches of embedding ``n_crops`` crops in batches of
    ``CTC_BATCH`` with the v2 encoder (the v1 encoder has no GRN block)."""
    from viscy_tpu_torch.ops import fused_block as fb

    sizes = [min(CTC_BATCH, n_crops - s) for s in range(0, n_crops, CTC_BATCH)]
    return sum(2 * -(-b // fb.samples_per_launch(s, m)) for b in sizes for s, _, m in ctc_shapes())


def ctc_kernels(card: str) -> dict:
    """Phase 26 (a): the forward kernels at every (S, C, M) of the v2
    encoder at B = 128 crops of 160^2 (204,800 rows a call at stage 1)
    against their plain version (f32 and bf16, as phase 3), then f32
    CUDA-event medians per call and per forward beside the plain version
    and the bound."""
    from viscy_tpu_torch.ops import fused_block as fb

    shapes = ctc_shapes()
    worst: dict = {}
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for k, (s, c, m) in enumerate(sorted(set(shapes), key=shapes.index)):
        check_forward(CTC_BATCH, s, c, m, 2600 + k, (False,), worst, ref_batch=32)
        args, _ = block_inputs(CTC_BATCH, s, c, m, torch.float32, seed=2610 + k)
        times = dict(ms=cuda_median_ms(lambda: fb.fused_mlp_grn(*args), runs=5),
                     plain_ms=cuda_median_ms(lambda: fb.reference_mlp_grn(*args), runs=3),
                     bound_ms=block_bound_ms(CTC_BATCH, s, c, m, torch.float32)[0])
        n = shapes.count((s, c, m))
        for key, val in times.items():
            total[key] += val * n
        log(f"[ctc] time S={s} C={c} M={m} B={CTC_BATCH} f32 x{n}/forward: A + B {times['ms']:.3f} ms a call (plain "
            f"{times['plain_ms']:.3f}, bound {times['bound_ms']:.4f}; {fb.samples_per_launch(s, m)} samples a launch)")
        del args
        torch.cuda.empty_cache()
    log(f"[ctc] fused forward per encoder forward of {CTC_BATCH} crops ({len(shapes)} calls, f32): A + B "
        f"{total['ms']:.3f} ms (plain {total['plain_ms']:.3f}, bound {total['bound_ms']:.3f}); CUDA-event medians "
        f"({card})")
    log_worst(f"the CTC crops (B={CTC_BATCH}, {CTC_SHAPE[0]}^2)", worst)
    return dict(total, fwd_err=worst[torch.bfloat16][0])


def _ctc_metric_row(masks, tracks, gt) -> dict:
    from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.metrics import TrackingAnnotation, evaluate_ctc_metrics

    return evaluate_ctc_metrics(TrackingAnnotation(masks, tracks), TrackingAnnotation(gt["gt"], gt["table"]))


def ctc_tracking(card: str, tmp: Path) -> dict:
    """Phase 26 (a): ``evaluate-tracking-accuracy -c`` on a seeded CTC
    sequence with the baseline and two encoders at full width (see the
    module docstring)."""
    import contextlib
    import copy
    import io

    import yaml

    from viscy_tpu_torch.apps.dynaclr.tracking_benchmark import ctc, embedding, evaluate
    from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.config import TrackingAccuracyConfig
    from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.graph import build_candidate_graph
    from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.solver import ilp_problem
    from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.synthetic import ctc_sequence
    from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder

    work = tmp / "ctc"
    root = work / "GOWT1-like"
    t0 = time.perf_counter()
    data = ctc_sequence(root, frames=CTC_FRAMES, side=CTC_SIDE, cells=CTC_CELLS, radius=CTC_RADIUS, divisions=3,
                        drops=4, merges=3, seed=26)
    log(f"[ctc] (a) seeded sequence 01 in the CTC layout: {CTC_FRAMES} frames of {CTC_SIDE}^2 uint16, "
        f"{len(data['tracks'])} tracks ({CTC_CELLS} nuclei, 3 divisions), the error segmentation with 4 dropped "
        f"and 3 merged detections; written in {time.perf_counter() - t0:.1f} s ({card})")
    encoders, models = {}, [{"path": None, "label": "baseline"}]
    for k, backbone in enumerate(CTC_BACKBONES):
        enc = ContrastiveEncoder(backbone=backbone, **CTC_ENCODER, generator=torch.Generator().manual_seed(2620 + k))
        randomize_grn(enc, 2630 + k)
        torch.save(enc.state_dict(), work / f"{backbone}.pt")
        encoders[backbone] = enc.eval()
        models.append({"path": str(work / f"{backbone}.pt"), "label": backbone,
                       "model_class": "viscy_tpu.models.contrastive.encoder.ContrastiveEncoder",
                       "model_init_args": dict(backbone=backbone, **CTC_ENCODER)})
    raw_cfg = dict(models=models, datasets=[{"path": str(root), "sequences": ["01"]}],
                   model_input_shape=list(CTC_SHAPE), batch_size=CTC_BATCH, output_dir=str(work / "results"))
    (work / "tracking.yml").write_text(yaml.safe_dump(raw_cfg))
    cfg = TrackingAccuracyConfig(**raw_cfg)
    gt = dict(gt=data["gt"], table=ctc.track_table(data["tracks"]))

    _zero_counts()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _, seconds, peak = eval_cli(["evaluate-tracking-accuracy", "-c", work / "tracking.yml"])
    counts = _counts()
    stats = [json.loads(line) for line in err.getvalue().splitlines() if line.startswith("{")]
    want = _ctc_launches(stats[-1]["nodes"])
    if counts["fwd"] != want or any(counts[k] for k in ("bwd", "masked_fwd", "masked_bwd", "warp")):
        raise AssertionError(f"phase 26 (a) launched {counts}; expected {want} forward (the v2 encoder's)")
    for st in stats:
        log(f"[ctc] (a) {st['model']}: {st['nodes']} nodes, {st['edges']} candidate edges; "
            + (f"crops {st['crops_s']:.2f} s (host), embedding {st['embedding_s']:.2f} s (card), "
               if "crops_s" in st else "IoU weights (host), ")
            + f"solve {st['solve_s']:.2f} s (host), objective {st['objective']:.6f}; every solution within the flow "
            f"constraints (checked by the solver)")
    rows = [r for r in csv_rows(work / "results" / "results.csv")]
    summary_header = next(iter(csv_rows(work / "results" / "summary.csv", header=True)))
    if list(rows[0]) != CTC_RESULTS or summary_header != CTC_SUMMARY or len(rows) != 3:
        raise AssertionError(f"phase 26 (a): results.csv {list(rows[0])} / summary.csv {summary_header}")
    for r in rows:
        if not all(0.0 <= float(r[k]) <= 1.0 for k in ("DET", "TRA", "LNK", "CHOTA")):
            raise AssertionError(f"phase 26 (a): metrics out of [0, 1]: {r}")
        log(f"[ctc] (a) {r['model']}: " + ", ".join(f"{k} {float(r[k]):.4f}" if r[k] else f"{k} nan"
                                                    for k in CTC_RESULTS[:10]))
    log(f"[ctc] (a) evaluate-tracking-accuracy -c, 3 models: {seconds:.1f} s, peak {peak:.2f} GiB; results.csv and "
        f"summary.csv with JAX's columns; the v2 encoder's fused forward {counts['fwd']} launches ({card})")
    # the baseline on the GT's own masks
    gt_check: dict = {}
    g, sol = evaluate.track_arrays(data["raw"], data["gt"], cfg, stats=gt_check)
    gm = _ctc_metric_row(*ctc.tracking_to_ctc(sol, g.node_pixels, g.frame_shape, CTC_FRAMES), gt)
    log(f"[ctc] (a) the baseline on the GT's own masks ({gt_check['nodes']} nodes, {gt_check['edges']} edges, solve "
        f"{gt_check['solve_s']:.2f} s): DET {gm['DET']}, TRA {gm['TRA']}, BC(0) {gm['BC(0)']}")
    if gm["DET"] != 1.0 or gm["TRA"] != 1.0:
        raise AssertionError(f"phase 26 (a): the baseline on the GT's masks gives DET {gm['DET']}, TRA {gm['TRA']}")

    # card against CPU: the first frames' crops (at most CTC_XCHECK), each encoder, and their ILP
    k = int(np.searchsorted(np.cumsum([len(np.unique(f)) - 1 for f in data["seg"]]), CTC_XCHECK, side="right"))
    graph = build_candidate_graph(data["seg"][:k], cfg.distance_threshold, cfg.n_neighbors, cfg.delta_t)
    batch = embedding.node_crops(graph, data["raw"][:k], CTC_SHAPE)[:, None, None]
    xcheck = {}
    for backbone, enc in encoders.items():
        on_cpu = embedding.make_torch_embedder(copy.deepcopy(enc), "cpu")(batch)
        on_card = embedding.make_torch_embedder(copy.deepcopy(enc), "cuda")(batch)
        err_, share, r = compare(torch.from_numpy(on_card), torch.from_numpy(on_cpu))
        sols = {}
        for dev, feats in (("card", on_card), ("cpu", on_cpu)):
            st: dict = {}
            g, sol = evaluate.track_arrays(data["raw"][:k], data["seg"][:k], cfg, embed_fn=lambda b, f=feats: f,
                                           stats=st)
            c, A, lb, ub = ilp_problem(g, division_weight=cfg.division_weight, node_weight=cfg.node_weight)
            ax = A @ st["x"]
            if not (np.all(ax >= lb - 1e-9) and np.all(ax <= ub + 1e-9)):
                raise AssertionError(f"phase 26 (a): the {dev} solution breaks the flow constraints")
            masks, tracks = ctc.tracking_to_ctc(sol, g.node_pixels, g.frame_shape, k)
            sols[dev] = (st["objective"], _ctc_metric_row(masks, tracks, dict(gt=data["gt"][:k],
                                                                                 table=gt["table"])))
        rel = abs(sols["card"][0] - sols["cpu"][0]) / abs(sols["cpu"][0])
        dm = max(abs(sols["card"][1][m] - sols["cpu"][1][m]) for m in ("DET", "TRA"))
        xcheck[backbone] = dict(share=share, r=r, objective_rel=rel)
        log(f"[ctc] (a) {backbone}: embeddings of {len(batch)} crops (frames 0-{k - 1}), card against CPU max|d| "
            f"{err_:.3e} ({share:.2e} of range, bound 2e-3) r={r:.8f}; their ILP's objective {sols['card'][0]:.9f} "
            f"against {sols['cpu'][0]:.9f} ({rel:.2e} relative, bound 1e-6), DET / TRA {sols['card'][1]['DET']:.4f} / "
            f"{sols['card'][1]['TRA']:.4f} against {sols['cpu'][1]['DET']:.4f} / {sols['cpu'][1]['TRA']:.4f}")
        # the same optimum up to rounding; DET / TRA may move by a near-tie that rounding flips
        if not (share <= 2e-3 and r > 0.9999 and rel <= 1e-6 and dm <= 0.02):
            raise AssertionError(f"phase 26 (a): {backbone} card against CPU fails its bounds")
    kern = ctc_kernels(card)
    return dict(seconds=seconds, peak_gib=peak, launches=counts["fwd"], stats=stats, rows=rows, xcheck=xcheck,
                gt=gm, kernels=kern, fwd_err=kern["fwd_err"])


def csv_rows(path: Path, header: bool = False):
    """The rows of a CSV file as dicts (or only its header)."""
    import csv

    with open(path, newline="") as f:
        reader = csv.reader(f)
        names = next(reader)
        if header:
            return [names]
        return [dict(zip(names, line)) for line in reader]


def _numeric_close(got: list[dict], want: list[dict], rel: float, tag: str) -> float:
    """Rows of two CSVs: equal text but in float cells (a p-value column
    equal), floats within ``rel`` relative; the worst relative difference."""
    if len(got) != len(want) or any(list(a) != list(b) for a, b in zip(got, want)):
        raise AssertionError(f"phase 26 (b) {tag}: the card's and the CPU's tables differ in shape")
    worst = 0.0
    for a, b in zip(got, want):
        for k in b:
            if a[k] == b[k]:
                continue
            try:
                x, y = float(a[k]), float(b[k])
            except ValueError:
                raise AssertionError(f"phase 26 (b) {tag}: {k} {a[k]!r} against {b[k]!r}") from None
            if k == "p_value" or "." not in b[k] + a[k] and "e" not in b[k] + a[k]:
                raise AssertionError(f"phase 26 (b) {tag}: {k} {a[k]} against {b[k]} (must be equal)")
            worst = max(worst, abs(x - y) / max(abs(y), 1e-300))
    if worst > rel:
        raise AssertionError(f"phase 26 (b) {tag}: card against CPU {worst:.3e} relative > {rel:g}")
    return worst


def suite_stores(tmp: Path, card: str) -> dict[str, Path]:
    """Phase 23 (b)'s 50,000-cell store, a copy with perturbed features, and
    the store split by FOV into two experiments (``experiment`` and
    ``marker`` columns) for the combined and pooled MMD."""
    from viscy_tpu_torch.evaluation.anndata_lite import Frame
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset, write_embedding_dataset

    store = eval_full_store(tmp, card)
    ds = read_embedding_dataset(store)
    feats, index = np.asarray(ds.X), ds.obs
    rng = np.random.default_rng(2640)
    perturbed = tmp / "eval_perturbed.zarr"
    write_embedding_dataset(perturbed, (feats + rng.normal(size=feats.shape) * 0.05).astype(np.float32), index)
    fov = np.asarray([int(str(v).rsplit("/", 1)[-1]) for v in index["fov_name"]])
    out = dict(store=store, perturbed=perturbed)
    for name, rows in (("exp_a", fov < EVAL_FOVS // 2), ("exp_b", fov >= EVAL_FOVS // 2)):
        part = Frame({k: v[rows] for k, v in index.columns.items()}, n_rows=int(rows.sum()))
        part["experiment"] = np.full(len(part), name, dtype=object)
        part["marker"] = np.full(len(part), "Phase3D", dtype=object)
        write_embedding_dataset(tmp / f"eval_{name}.zarr", feats[rows], part)
        out[name] = tmp / f"eval_{name}.zarr"
    return out


def suite_configs(tmp: Path, stores: dict[str, Path], dev: str) -> dict[str, Path]:
    """The YAMLs of phase 26 (b)'s subcommands, their outputs under
    ``suites_<dev>``."""
    import yaml

    out = tmp / f"suites_{dev}"
    out.mkdir(exist_ok=True)
    comparisons = [{"cond_a": "cond0", "cond_b": f"cond{i}", "label": f"cond0_vs_cond{i}"} for i in (1, 2, 3)]
    mmd = dict(group_by="condition", mmd=SUITE_MMD, output_dir=str(out / "mmd"))
    cfgs = {
        "smoothness": dict(models=[{"path": str(stores["store"]), "label": "full"},
                                   {"path": str(stores["perturbed"]), "label": "perturbed"}],
                           evaluation=dict(output_dir=str(out / "smoothness"), group_by="condition",
                                           save_distributions=True)),
        "compare": dict(result_files=[
            {"path": str(out / "smoothness" / f"{label}_{Path(stores[key]).stem}_smoothness_stats.csv"),
             "label": label} for label, key in (("full", "store"), ("perturbed", "perturbed"))],
            comparison=dict(output_path=str(out / "comparison.md"))),
        "per_experiment": dict(mmd, input_path=str(stores["store"]), comparisons=comparisons),
        "combined": dict(mmd, input_paths=[str(stores["exp_a"]), str(stores["exp_b"])]),
        "pooled": dict(mmd, input_paths=[str(stores["exp_a"]), str(stores["exp_b"])], comparisons=comparisons),
        "eval": dict(training_config=str(ROOT / "configs" / "dynaclr_fit.yml"), output_dir=str(out / "pipeline"),
                     label_columns=["state"], group_column="condition"),
    }
    paths = {}
    for name, cfg in cfgs.items():
        paths[name] = out / f"{name}.yml"
        paths[name].write_text(yaml.safe_dump(cfg))
    paths["out"] = out
    return paths


def ctc_suites(card: str, tmp: Path) -> dict:
    """Phase 26 (b): the config-driven subcommands on phase 23 (b)'s store,
    on the card and with ``--device cpu`` (see the module docstring)."""
    stores = suite_stores(tmp, card)
    results: dict = {}
    for dev in ("cuda", "cpu"):
        cfg = suite_configs(tmp, stores, dev)
        runs = [("evaluate-smoothness", ["evaluate-smoothness", "-c", cfg["smoothness"]]),
                ("compare-models", ["compare-models", "--embeddings", stores["store"], "--embeddings",
                                    stores["perturbed"], "--output", cfg["out"] / "live.md"]),
                ("compare-models -c", ["compare-models", "-c", cfg["compare"]])]
        runs += [(f"mmd-analysis {mode}", ["mmd-analysis", "-c", cfg[mode], "--mode", mode])
                 for mode in ("per_experiment", "combined", "pooled")]
        runs += [("prepare-eval-configs", ["prepare-eval-configs", "-c", cfg["eval"]]),
                 ("check-evals", ["check-evals", "--output-dir", cfg["out"] / "pipeline"])]
        for name, args in runs:
            out, s, peak = eval_cli(args, device=dev)
            results.setdefault(name, {})[dev] = dict(out=out, seconds=s, peak=peak)
            if dev == "cuda":
                log(f"[suites] (b) {name}: {s:.2f} s, peak {peak:.2f} GiB; {' '.join(out.split())[-160:]} ({card})")
    card_dir, cpu_dir = tmp / "suites_cuda", tmp / "suites_cpu"
    worst = {}
    for name in ("full_eval_full_smoothness_stats.csv", "perturbed_eval_perturbed_smoothness_stats.csv",
                 "full_eval_full_per_condition_smoothness.csv", "combined_smoothness_stats.csv"):
        worst[name] = _numeric_close(csv_rows(card_dir / "smoothness" / name), csv_rows(cpu_dir / "smoothness" / name),
                                     1e-6, name)
    for mode in ("per_experiment", "combined", "pooled"):
        got, want = csv_rows(card_dir / "mmd" / f"mmd_{mode}.csv"), csv_rows(cpu_dir / "mmd" / f"mmd_{mode}.csv")
        if not got or any(not math.isfinite(float(r["mmd2"])) for r in got):
            raise AssertionError(f"phase 26 (b): mmd-analysis {mode} wrote {len(got)} rows, not all finite")
        worst[f"mmd_{mode}"] = _numeric_close(got, want, 1e-6, f"mmd_{mode}")
    for name in ("live.md", "comparison.md"):
        if (card_dir / name).read_text() != (cpu_dir / name).read_text():
            raise AssertionError(f"phase 26 (b): {name} differs card against CPU")
    check = _json_out(results["check-evals"]["cuda"]["out"])
    status = next(iter(check.values()))
    if status != dict(manifest=True, embeddings=False, smoothness=False, mmd=False, linear_classifiers=False):
        raise AssertionError(f"phase 26 (b): check-evals {status}")
    manifest = _json_out(results["prepare-eval-configs"]["cuda"]["out"])
    if manifest["steps"] != ["predict", "smoothness", "mmd", "linear_classifiers"] or not all(
            Path(manifest[s]).exists() for s in manifest["steps"]):
        raise AssertionError(f"phase 26 (b): prepare-eval-configs {manifest}")
    log(f"[suites] (b) card against CPU: smoothness statistics worst {max(v for k, v in worst.items() if 'mmd' not in k):.2e}, "
        f"MMD values worst {max(v for k, v in worst.items() if 'mmd' in k):.2e} relative (bound 1e-6), permutation "
        f"p-values and counts equal, the comparison tables equal; check-evals {status} ({card})")
    return dict(worst=worst, seconds={k: v["cuda"]["seconds"] for k, v in results.items()})


def phase_ctc(card: str, tmp: Path) -> dict:
    """Phase 26: DynaCLR's CTC tracking benchmark and the config-driven
    evaluation subcommands (see the module docstring)."""
    t0 = time.perf_counter()
    a = ctc_tracking(card, tmp)
    b = ctc_suites(card, tmp)
    total = time.perf_counter() - t0
    log(f"[phase 26] CTC tracking and the config-driven subcommands in {total:.1f} s; fused forward A + B "
        f"{a['launches']} ({card})")
    return dict(seconds=total, launches=a["launches"], fwd_err=a["fwd_err"], kernels=a["kernels"], tracking=a,
                suites=b)


# -- phase 27: DynaCLR's dataset-level linear classifiers and DTW pseudotime ----------------------------------

LC_EXPERIMENTS = 5  # phase 23 (b)'s store split by FOV: two FOVs (10,000 cells) an experiment
LC_MARKERS = ("Phase3D", "RFP")  # by track parity
LC_XCHECK_CELLS = 2000  # (b)'s card-against-CPU copy: each experiment's first cells
LC_XCHECK_PCA = 16  # ... through PCA, so the CPU's multinomial Newton steps stay small
PT_FOVS = 4  # (c): the tracks CSV covers the first FOVs (1000 tracks)
PT_PCA = 20


def lc_experiments(tmp: Path, card: str) -> dict:
    """Phase 23 (b)'s seeded store split by FOV into ``LC_EXPERIMENTS``
    stores (``experiment`` and ``marker`` columns), each also as
    ``<exp>/Phase3D.zarr`` for the CV, and an annotation CSV each: ``treated``
    (conditions 2 and 3) and the 4-class ``state``, one label in 50 left
    empty and one ``unknown``."""
    import csv

    from viscy_tpu_torch.evaluation.anndata_lite import Frame
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset, write_embedding_dataset

    ds = read_embedding_dataset(eval_full_store(tmp, card))
    feats, obs = np.asarray(ds.X), ds.obs
    fov = np.asarray([int(str(v).rsplit("/", 1)[-1]) for v in obs["fov_name"]])
    root = tmp / "lc"
    out = dict(root=root, combined=root / "combined", experiments=[])
    t0 = time.perf_counter()
    for e in range(LC_EXPERIMENTS):
        name = f"exp{e}"
        rows = np.flatnonzero(fov // (EVAL_FOVS // LC_EXPERIMENTS) == e)
        part = Frame({k: obs[k][rows] for k in ("fov_name", "track_id", "t", "id", "y", "x")})
        part["experiment"] = np.full(len(rows), name, dtype=object)
        part["marker"] = np.asarray([LC_MARKERS[int(t) % 2] for t in part["track_id"]], dtype=object)
        write_embedding_dataset(out["combined"] / f"{name}.zarr", feats[rows], part)
        (root / name).mkdir(parents=True)
        (root / name / "Phase3D.zarr").symlink_to(out["combined"] / f"{name}.zarr")
        with open(root / f"{name}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["fov_name", "id", "t", "track_id", "treated", "state"])
            for k, i in enumerate(rows.tolist()):
                treated = "treated" if str(obs["condition"][i]) in ("cond2", "cond3") else "control"
                w.writerow([obs["fov_name"][i], obs["id"][i], obs["t"][i], obs["track_id"][i],
                            "" if k % 50 == 7 else "unknown" if k % 50 == 8 else treated, obs["state"][i]])
        out["experiments"].append(name)
    log(f"[lc] {LC_EXPERIMENTS} experiment stores of {len(feats) // LC_EXPERIMENTS} cells (two markers) and their "
        f"annotation CSVs written in {time.perf_counter() - t0:.1f} s ({card})")
    return out


def _lc_config(exp: dict, dev: str) -> Path:
    import yaml

    root = exp["root"]
    cfg = dict(embeddings_path=str(exp["combined"]), output_dir=str(root / f"lc_{dev}"),
               annotations=[dict(experiment=e, path=str(root / f"{e}.csv")) for e in exp["experiments"]],
               tasks=[dict(task="treated"), dict(task="state")], split_groups_by=["fov_name"],
               publish_dir=str(root / f"registry_{dev}"))
    path = root / f"lc_{dev}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _refused_figures(args: list, dev: str) -> float:
    """``run-linear-classifiers`` through the CLI: it must write everything
    and then raise at the figures; its seconds."""
    t0 = time.perf_counter()
    try:
        eval_cli(args, device=dev)
    except NotImplementedError as e:
        if "summary_treated.pdf" not in str(e):
            raise
    else:
        raise AssertionError("phase 27 (a): run-linear-classifiers did not refuse its figures")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _predictions_agree(card_pipe, cpu_pipe, X: np.ndarray, tag: str) -> tuple[float, int]:
    """Both pipelines' probabilities on the CPU on ``X``: their max|d| and
    the count of differing predictions, which must all be within 1e-6 of a
    tie in the card's decision (printed)."""
    card_pipe.device = cpu_pipe.device = torch.device("cpu")
    pa, pb = card_pipe.predict_proba(X), cpu_pipe.predict_proba(X)
    err = float(np.abs(pa - pb).max())
    if err > 1e-6:
        raise AssertionError(f"phase 27 {tag}: probabilities card against CPU {err:.3e} > 1e-6")
    differ = np.flatnonzero(card_pipe.predict(X) != cpu_pipe.predict(X))
    if len(differ):
        z = card_pipe.decision_function(X[differ]).numpy()
        margin = np.abs(z[:, 0]) if z.shape[1] == 1 else np.abs(np.diff(np.sort(z, axis=1)[:, -2:], axis=1)[:, 0])
        log(f"[lc] {tag}: {len(differ)} predictions differ card against CPU, decision margins {margin.tolist()}")
        if margin.max() >= 1e-6:
            raise AssertionError(f"phase 27 {tag}: a prediction differs at margin {margin.max():.3e} >= 1e-6")
    return err, len(differ)


def _cells_close(got: list[dict], want: list[dict], rel: float, tag: str, equal=("accuracy", "f1")) -> float:
    """Two CSVs' rows: the same columns and text but in numbers, which agree
    within ``rel`` relative (``temporal_metrics`` JSON parsed); accuracy and
    F1 columns equal. The worst relative difference."""
    if len(got) != len(want) or any(list(a) != list(b) for a, b in zip(got, want)):
        raise AssertionError(f"phase 27 {tag}: the card's and the CPU's tables differ in shape")

    def numbers(cell: str) -> list:
        if cell.startswith("{"):
            return [x for v in json.loads(cell).values() for x in v]
        return [float(cell)]

    worst = 0.0
    for a, b in zip(got, want):
        for k in b:
            if a[k] == b[k]:
                continue
            try:
                xs, ys = numbers(a[k]), numbers(b[k])
            except ValueError:
                raise AssertionError(f"phase 27 {tag}: {k} {a[k]!r} against {b[k]!r}") from None
            if any(e in k for e in equal) or len(xs) != len(ys) or [x is None for x in xs] != [y is None for y in ys]:
                raise AssertionError(f"phase 27 {tag}: {k} {a[k]} against {b[k]} (must be equal)")
            for x, y in zip(xs, ys):
                if x is not None:
                    worst = max(worst, abs(x - y) / max(abs(y), 1e-300))
    if worst > rel:
        raise AssertionError(f"phase 27 {tag}: card against CPU {worst:.3e} relative > {rel:g}")
    return worst


def lc_orchestrated(card: str, exp: dict) -> dict:
    """Phase 27 (a): ``run-linear-classifiers -c`` at JAX's defaults
    (liblinear; the split grouped by FOV; published), on the card and with
    ``--device cpu``."""
    from viscy_tpu_torch.evaluation.linear_classifier import LinearClassifierPipeline
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    seconds = {dev: _refused_figures(["run-linear-classifiers", "-c", _lc_config(exp, dev)], dev)
               for dev in ("cuda", "cpu")}
    root = exp["root"]
    rows = {dev: csv_rows(root / f"lc_{dev}" / "metrics_summary.csv") for dev in ("cuda", "cpu")}
    if [(r["task"], r["marker_filter"]) for r in rows["cuda"]] != [("treated", m) for m in LC_MARKERS]:
        raise AssertionError(f"phase 27 (a): trained {[(r['task'], r['marker_filter']) for r in rows['cuda']]}; "
                             "the binary task per marker, the 4-class one skipped (liblinear), as in JAX")
    latest = root / "registry_cuda" / "latest"
    if not (latest / "manifest.json").exists():
        raise AssertionError("phase 27 (a): no published bundle")
    X = np.concatenate([np.asarray(read_embedding_dataset(exp["combined"] / f"{e}.zarr").X)
                        for e in exp["experiments"]])
    worst_obj = worst_p = 0.0
    ties = 0
    for m in LC_MARKERS:
        a, b = (LinearClassifierPipeline.load(root / f"lc_{dev}" / "pipelines" / f"treated_{m}.npz", device="cpu")
                for dev in ("cuda", "cpu"))
        worst_obj = max(worst_obj, abs(a.objective - b.objective) / abs(b.objective))
        err, differ = _predictions_agree(a, b, X, f"(a) treated/{m}")
        worst_p, ties = max(worst_p, err), ties + differ
    if worst_obj > 1e-9:
        raise AssertionError(f"phase 27 (a): liblinear objective card against CPU {worst_obj:.3e} relative > 1e-9")
    # accuracy and F1 equal, unless a prediction sits within 1e-6 of a tie (printed above)
    worst_csv = _cells_close(rows["cuda"], rows["cpu"], 1e-6 if not ties else 1e-2, "(a) metrics_summary.csv",
                             equal=("accuracy", "f1") if not ties else ())
    r = rows["cuda"][0]
    log(f"[lc] (a) run-linear-classifiers -c (liblinear, grouped by FOV, published): {seconds['cuda']:.1f} s on the "
        f"card, {seconds['cpu']:.1f} s on the CPU; treated/{LC_MARKERS[0]} val accuracy {float(r['val_accuracy']):.4f}"
        f", AUROC {float(r['val_auroc']):.4f}; the 4-class task skipped as in JAX; card against CPU: objective "
        f"{worst_obj:.2e} relative (bound 1e-9), probabilities max|d| {worst_p:.2e} (bound 1e-6), the CSV's numbers "
        f"{worst_csv:.2e} relative; the figures refused by name ({card})")
    return dict(seconds=seconds, objective_rel=worst_obj, proba_err=worst_p)


def _cv_config(root: Path, exp: dict, dev: str, name: str, **extra) -> Path:
    import yaml

    datasets = [dict(name=e, embeddings_dir=str(root / e), annotations=str(exp["root"] / f"{e}.csv"))
                for e in exp["experiments"]]
    cfg = dict(models={"seeded": dict(datasets=datasets)}, output_dir=str(root / f"{name}_{dev}"), channels=["Phase3D"],
               solver="lbfgs", n_bootstrap=1, marker="Phase3D", **extra)
    path = root / f"{name}_{dev}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def lc_cross_validation(card: str, exp: dict) -> dict:
    """Phase 27 (b): ``cross-validate-datasets -c`` over the five stores
    (lbfgs, both tasks, one seed) on the card; then on a copy of each
    store's first ``LC_XCHECK_CELLS`` cells through a PCA, on the card and
    with ``--device cpu``."""
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset, write_embedding_dataset

    root = exp["root"]
    out, s, peak = eval_cli(["cross-validate-datasets", "-c", _cv_config(root, exp, "cuda", "cv")], device="cuda")
    res = csv_rows(root / "cv_cuda" / "cv_results.csv")
    summary = csv_rows(root / "cv_cuda" / "cv_summary.csv")
    if len(res) != 2 * LC_EXPERIMENTS * LC_EXPERIMENTS or any(r.get("error") for r in res) or not all(
            math.isfinite(float(r["auroc"])) for r in res):
        raise AssertionError(f"phase 27 (b): {len(res)} CV rows, errors or non-finite AUROCs")
    small = root / "small"
    for e in exp["experiments"]:
        ds = read_embedding_dataset(exp["combined"] / f"{e}.zarr")
        keep = np.arange(LC_XCHECK_CELLS)
        write_embedding_dataset(small / e / "Phase3D.zarr", np.asarray(ds.X)[keep], ds.obs.take(keep))
    t0 = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        eval_cli(["cross-validate-datasets", "-c", _cv_config(small, exp, dev, "cv", n_pca_components=LC_XCHECK_PCA)],
                 device=dev)
        t0[dev] = time.perf_counter() - t
    worst = {name: _cells_close(csv_rows(small / "cv_cuda" / name), csv_rows(small / "cv_cpu" / name), 1e-6,
                                f"(b) {name}") for name in ("cv_results.csv", "cv_summary.csv")}
    base = {(r["task"]): float(r["mean_auroc"]) for r in summary if r["excluded_dataset"] == "baseline"}
    log(f"[lc] (b) cross-validate-datasets -c (lbfgs, {len(res)} folds over {LC_EXPERIMENTS} stores of "
        f"{EVAL_T * EVAL_TRACKS * EVAL_FOVS // LC_EXPERIMENTS} cells, {EVAL_DIM} features): {s:.1f} s, peak {peak:.2f} GiB; "
        f"baseline AUROC {base}; impacts {[r['impact'] for r in summary if r['excluded_dataset'] != 'baseline']}; "
        f"the {LC_XCHECK_CELLS}-cell copy through PCA {LC_XCHECK_PCA}: {t0['cuda']:.1f} s on the card, "
        f"{t0['cpu']:.1f} s on the CPU, card against CPU {max(worst.values()):.2e} relative (bound 1e-6), accuracy "
        f"and F1 equal ({card})")
    return dict(seconds=s, peak=peak, xcheck_seconds=t0, worst=worst)


def pt_inputs(tmp: Path, exp: dict) -> tuple[Path, Path]:
    """(c)'s store and tracks CSV: the 50,000 cells with the features of
    infected frames shifted along one seeded direction; the tracks of the
    first ``PT_FOVS`` FOVs, three in four turning ``infected`` at a seeded
    onset (frames 5-14), every tenth a child of the track before it."""
    import csv

    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset, write_embedding_dataset

    ds = read_embedding_dataset(tmp / "eval_full.zarr")
    X, obs = np.asarray(ds.X).copy(), ds.obs
    rng = np.random.default_rng(27)
    shift = (rng.normal(size=X.shape[1]) * 0.15).astype(np.float32)
    onset = rng.integers(5, 15, size=(EVAL_FOVS, EVAL_TRACKS))
    fov = np.asarray([int(str(v).rsplit("/", 1)[-1]) for v in obs["fov_name"]])
    tr, t = np.asarray(obs["track_id"]), np.asarray(obs["t"])
    infected = (fov < PT_FOVS) & (tr % 4 != 0) & (t >= onset[fov, tr])
    X[infected] += shift
    store = tmp / "pt.zarr"
    write_embedding_dataset(store, X, obs)
    tracks = tmp / "pt_tracks.csv"
    with open(tracks, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fov_name", "track_id", "t", "parent_track_id", "infection_state"])
        for i in np.flatnonzero(fov < PT_FOVS).tolist():
            w.writerow([obs["fov_name"][i], tr[i], t[i], tr[i] - 1 if tr[i] % 10 == 5 else -1,
                        "infected" if infected[i] else "uninfected"])
    return store, tracks


def pt_template(card: str, tmp: Path, exp: dict) -> dict:
    """Phase 27 (c): ``build-pseudotime-template`` on the card (its DTW in
    host kernel H2, counted) and with ``--device cpu``; H2 against its plain
    version on every DP of the CPU build's first DBA iteration; then
    ``dtw_align_tracks`` of every track and ``evaluate_embedding``."""
    from viscy_tpu_torch.apps.dynaclr.pseudotime import dtw_core
    from viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_alignment import (alignment_results_to_dataframe,
                                                                       dtw_align_tracks)
    from viscy_tpu_torch.apps.dynaclr.pseudotime.evaluation import evaluate_embedding
    from viscy_tpu_torch.apps.dynaclr.pseudotime.io import load_template_flavor
    from viscy_tpu_torch.data._tracks import read_csv
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    store, tracks = pt_inputs(tmp, exp)
    args = ["build-pseudotime-template", "--embeddings", store, "--tracks-csv", tracks, "--pca-components", PT_PCA,
            "--propagate-columns", "infection_state"]
    dtw_core.launches["dtw_dp"] = 0
    out, s_card, peak = eval_cli([*args, "--output", tmp / "pt_cuda.zarr"], device="cuda")
    build_launches = dtw_core.launches["dtw_dp"]
    card_tpl, _ = load_template_flavor(tmp / "pt_cuda.zarr")
    n = card_tpl.n_input_tracks
    first = (50 * (n - 1) if n > 50 else n * (n - 1), (50 * (n - 1) if n > 50 else n * (n - 1)) + n)
    captured, calls, h2 = [], [0], dtw_core.dtw_accumulated_cost

    def capture(cost, subsequence=False):
        if first[0] <= calls[0] < first[1]:
            captured.append((np.array(cost, np.float64), subsequence))
        calls[0] += 1
        return h2(cost, subsequence)

    dtw_core.dtw_accumulated_cost = capture
    try:
        t0 = time.perf_counter()
        eval_cli([*args, "--output", tmp / "pt_cpu.zarr"], device="cpu")
        s_cpu = time.perf_counter() - t0
    finally:
        dtw_core.dtw_accumulated_cost = h2
    cpu_tpl, _ = load_template_flavor(tmp / "pt_cpu.zarr")
    span = float(cpu_tpl.template.max() - cpu_tpl.template.min())
    tpl_err = float(np.abs(card_tpl.template - cpu_tpl.template).max()) / span
    if card_tpl.template.shape != cpu_tpl.template.shape or tpl_err > 1e-6:
        raise AssertionError(f"phase 27 (c): template card against CPU {tpl_err:.3e} of range > 1e-6")
    # H2 against its plain version on the first DBA iteration's DPs, bit for bit; each one's time a call
    t0 = time.perf_counter()
    got = [h2(c, sub) for c, sub in captured]
    h2_us = (time.perf_counter() - t0) / len(captured) * 1e6
    t0 = time.perf_counter()
    want = [dtw_core.dtw_accumulated_cost_plain(c, sub) for c, sub in captured]
    plain_us = (time.perf_counter() - t0) / len(captured) * 1e6
    if len(captured) != n or any(g.tobytes() != w.tobytes() for g, w in zip(got, want)):
        raise AssertionError(f"phase 27 (c): H2 differs from its plain version on the first DBA iteration "
                             f"({len(captured)} DPs for {n} tracks)")
    adata, df = read_embedding_dataset(store), read_csv(tracks)
    dtw_core.launches["dtw_dp"] = 0  # the CPU build's and the comparison's calls are not the path's
    t0 = time.perf_counter()
    results = dtw_align_tracks(adata, df, card_tpl, "ds", device="cuda")
    s_align = time.perf_counter() - t0
    launches = build_launches + dtw_core.launches["dtw_dp"]
    cpu_results = dtw_align_tracks(adata, df, cpu_tpl, "ds", device="cpu")
    if len(results) != len(cpu_results) or any(not np.array_equal(a.warping_path, b.warping_path)
                                                for a, b in zip(results, cpu_results)):
        raise AssertionError("phase 27 (c): the warp paths differ card against CPU")
    table = alignment_results_to_dataframe(results)
    state = {k: v for k, v in zip(zip(df["fov_name"].tolist(), df["track_id"].tolist(), df["t"].tolist()),
                                  df["infection_state"].tolist())}
    table["infection_state"] = np.asarray([state[k] for k in zip(table["fov_name"].tolist(),
                                                                 table["track_id"].tolist(), table["t"].tolist())],
                                          dtype=object)
    scores = evaluate_embedding(table)
    if not all(math.isfinite(v) for v in scores.values()) or scores["auc"] < 0.6:
        raise AssertionError(f"phase 27 (c): evaluate_embedding {scores}")
    log(f"[pseudotime] (c) build-pseudotime-template (PCA {PT_PCA}, DBA at its defaults) from {n} infected tracks: "
        f"{s_card:.1f} s on the card (peak {peak:.2f} GiB), {s_cpu:.1f} s on the CPU; template {card_tpl.template.shape}"
        f", card against CPU {tpl_err:.2e} of range (bound 1e-6); H2 bit for bit against its plain version on the "
        f"{len(captured)} DPs of the first DBA iteration: {h2_us:.1f} us a call against {plain_us:.1f} us; "
        f"dtw_align_tracks of {len(results)} tracks {s_align:.1f} s, warp paths equal card against CPU; H2 launched "
        f"{launches} times on the path; evaluate_embedding: AUC {scores['auc']:.4f}, AP "
        f"{scores['average_precision']:.4f}, onset rho {scores['onset_concordance_rho']:.4f} over "
        f"{scores['onset_concordance_n_tracks']} tracks ({card})")
    cost = captured[0][0]
    T, N = cost.shape
    bound_ms = 8 * (T * N + (T + 1) * (N + 1)) / HBM_BYTES_PER_S * 1e3
    return dict(seconds=s_card, cpu_seconds=s_cpu, launches=launches, h2_ms=h2_us / 1e3, plain_ms=plain_us / 1e3,
                bound_ms=bound_ms, template_err=tpl_err, scores=scores, tracks=len(results))


def phase_lc_pseudotime(card: str, tmp: Path) -> dict:
    """Phase 27: DynaCLR's dataset-level linear classifiers and DTW
    pseudotime (see the module docstring)."""
    t0 = time.perf_counter()
    exp = lc_experiments(tmp, card)
    a = lc_orchestrated(card, exp)
    b = lc_cross_validation(card, exp)
    c = pt_template(card, tmp, exp)
    total = time.perf_counter() - t0
    log(f"[phase 27] linear classifiers and pseudotime in {total:.1f} s; H2 launches {c['launches']} ({card})")
    return dict(seconds=total, lc=a, cv=b, pseudotime=c)



# -- phase 28: the engineered cell features and the released-checkpoint parity harness ----------------------------

PARITY_INPUT = (1, 1, 15, 512, 512)  # one Z window of the harness's model at 512^2
FEATURE_CELLS, FEATURE_YX = 256, 128
LEG_28_PEAK_GIB = 6.0  # the leg's own device memory


def parity_report(card: str, tmp: Path) -> dict:
    """``python -m viscy_tpu_torch.training.parity --output <tmp>/parity.json``
    (on the card, without artifacts): the four dry runs must be ``ok``."""
    out = tmp / "parity.json"
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "viscy_tpu_torch.training.parity", "--output", str(out)], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"the parity command failed ({run.returncode}):\n{run.stderr[-4000:]}")
    report = json.loads(out.read_text())
    dry = report["converter_dryruns"]
    if report["status"] != "artifacts_unavailable" or any(v["status"] != "ok" for v in dry.values()):
        raise AssertionError(f"parity report: {report['status']}, dry runs {dry}")
    log(f"[features-parity] python -m viscy_tpu_torch.training.parity: {seconds:.1f} s (its interpreter included); "
        f"dry runs " + ", ".join(f"{k} {v['status']} {v['converted_leaves']}/{v['torch_keys']}" for k, v in dry.items())
        + f"; status {report['status']} ({card})")
    return dict(seconds=seconds, dryruns=dry)


def parity_capture(card: str) -> dict:
    """The harness's default model (``VSCYTO3D_MODEL_CONFIG``: FCMAE, dims
    96-768, depth 15, f32; seeded, GRN perturbed) captured on one seeded
    input on the card (the fused kernels) and on the CPU (their plain
    versions): every module's output within 2e-3 of its range, Pearson r >
    0.9999."""
    from viscy_tpu_torch.apps.cytoland.engine import FcmaeUNet
    from viscy_tpu_torch.training import parity

    torch.manual_seed(28)
    module = FcmaeUNet(model_config=dict(parity.VSCYTO3D_MODEL_CONFIG), device="cuda")
    randomize_grn(module.model, 28)
    cpu = FcmaeUNet(model_config=dict(parity.VSCYTO3D_MODEL_CONFIG), device="cpu")
    cpu.model.load_state_dict(module.model.state_dict())
    x = np.random.default_rng(28).normal(size=PARITY_INPUT).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts = parity.capture_activations(module.model, x, with_arrays=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = parity.capture_activations(cpu.model, x, with_arrays=True)
    cpu_s = time.perf_counter() - t0
    if set(acts) != set(ref):
        raise AssertionError(f"captured modules differ: card only {set(acts) - set(ref)}, CPU only {set(ref) - set(acts)}")
    worst = (0.0, 1.0, "")
    for name in acts:
        a, b = acts[name]["array"], ref[name]["array"]
        if a.shape != b.shape:
            raise AssertionError(f"{name}: card {a.shape} against CPU {b.shape}")
        err, r = _range_err(a, b), pearson(torch.from_numpy(a), torch.from_numpy(b))
        if err > 2e-3 or r <= 0.9999:
            raise AssertionError(f"{name}: card against CPU {err:.3e} of range, r {r:.8f}")
        worst = max(worst, (err, r, name))
    log(f"[features-parity] activation capture of the harness's model on {PARITY_INPUT}: {len(acts)} modules, card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s; every module card against CPU within 2e-3 of its "
        f"range and r > 0.9999, the worst {worst[2]} {worst[0]:.2e} (r {worst[1]:.8f}) ({card})")
    return dict(module=module, cpu=cpu, modules=len(acts), worst=worst[0], card_s=card_s, cpu_s=cpu_s)


def parity_checkpoint(card: str, tmp: Path, module, cpu) -> dict:
    """``run_checkpoint_parity`` on a fixture written here: the seeded model
    as a Lightning checkpoint (``state_dict`` under ``model.``), a one-FOV
    plate with its ``fov_statistics``, and a reference store of the
    ``--device cpu`` prediction (the same sliding-window path on the CPU).
    The contract must pass on the card."""
    from viscy_tpu_torch.apps.cytoland.prediction import AugmentedPredictionVSUNet
    from viscy_tpu_torch.data.utils import read_norm_meta
    from viscy_tpu_torch.training import parity
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    ckpt = tmp / "vscyto3d_seeded.ckpt"
    torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in module.model.state_dict().items()}, "epoch": 0}, ckpt)
    source = (np.random.default_rng(29).normal(size=PARITY_INPUT) * 40 + 300).astype(np.float32)
    plate = open_ome_zarr(tmp / "parity_data.zarr", mode="w", channel_names=[parity.SOURCE_CHANNEL])
    pos = plate.create_position("A", "1", "0")
    pos.create_image("0", source)
    pos.zattrs["normalization"] = {parity.SOURCE_CHANNEL: {"fov_statistics": {"mean": float(source.mean()),
                                                                               "std": float(source.std())}}}
    stats = read_norm_meta(pos)[parity.SOURCE_CHANNEL]["fov_statistics"]
    x = ((source[0, 0] - stats["mean"]) / stats["std"])[None, None]
    t0 = time.perf_counter()
    pred = AugmentedPredictionVSUNet(model=cpu.model).predict_sliding_windows(torch.from_numpy(x), out_channel=2)[0]
    cpu_s = time.perf_counter() - t0
    ref = open_ome_zarr(tmp / "parity_reference.zarr", mode="w", channel_names=parity.TARGET_CHANNELS)
    ref.create_position("A", "1", "0").create_image("0", pred[None])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = parity.run_checkpoint_parity(ckpt, tmp / "parity_data.zarr", tmp / "parity_reference.zarr")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    span = float(pred.max() - pred.min())
    worst = max(ch["max_abs_diff"] for ch in result["channels"].values()) / span
    if not (result["pass"] and result["weight_audit"]["ok"]):
        raise AssertionError(f"run_checkpoint_parity: {result}")
    log(f"[features-parity] run_checkpoint_parity (seeded full-width checkpoint, one (15, 512, 512) FOV, the reference "
        f"from the CPU): pass; per channel r " + ", ".join(f"{k} {v['pearson_r']:.8f}" for k, v in
                                                          result["channels"].items())
        + f"; max|d| / range {worst:.2e}; the weight audit ok ({result['weight_audit']['n_model_keys']} keys); card "
        f"{card_s:.2f} s, the CPU's prediction {cpu_s:.2f} s ({card})")
    return dict(worst=worst, card_s=card_s, cpu_s=cpu_s)


def _feature_cell(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """One seeded 128^2 cell: a blurred nucleus with noise and its mask
    (the nucleus and a neighbour's edge)."""
    y, x = np.indices((FEATURE_YX, FEATURE_YX))
    c = FEATURE_YX / 2 + rng.normal(0, 4, 2)
    r2 = ((y - c[0]) / rng.uniform(18, 30)) ** 2 + ((x - c[1]) / rng.uniform(18, 30)) ** 2
    img = (np.exp(-r2) * rng.uniform(200, 900) + rng.normal(100, 15, (FEATURE_YX, FEATURE_YX))).astype(np.float32)
    mask = np.zeros((FEATURE_YX, FEATURE_YX), np.int32)
    mask[r2 <= 1.0] = 1
    mask[(((y - 12) / 6.0) ** 2 + ((x - 100) / 12.0) ** 2) <= 1.0] = 2
    return img, mask


def feature_checks(card: str, tmp: Path) -> dict:
    """``CellFeatures.compute_all_features`` on FEATURE_CELLS seeded cells
    with masks; ``DynamicFeatures`` over phase 23 (b)'s 50,000-cell tracks,
    one FOV at a time; ``annotation.convert`` of that embedding set (a
    dict) to an AnnData store, read back equal. All on the host."""
    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr
    from viscy_tpu_torch.evaluation.annotation import convert
    from viscy_tpu_torch.evaluation.feature import CellFeatures, DynamicFeatures

    rng = np.random.default_rng(30)
    cells = [_feature_cell(rng) for _ in range(FEATURE_CELLS)]
    t0 = time.perf_counter()
    rows = [CellFeatures(img, mask).compute_all_features() for img, mask in cells]
    cell_ms = (time.perf_counter() - t0) / FEATURE_CELLS * 1e3
    names = rows[0].names
    if len(names) != 24 or not all(r.names == names and all(np.isfinite(r[k]).all() for k in names) for r in rows):
        raise AssertionError(f"CellFeatures: columns {names}, or a value not finite")
    store = eval_full_store(tmp, card)
    ds = read_anndata_zarr(store)
    obs = ds.obs
    t0 = time.perf_counter()
    tracks = 0
    for fov in dict.fromkeys(obs["fov_name"].tolist()):
        table = obs.take(obs["fov_name"] == fov)
        dyn = DynamicFeatures({k: table[k] for k in ("track_id", "t", "y", "x")}).to_df()
        if len(dyn) != EVAL_TRACKS or not all(np.isfinite(dyn[k]).all() for k in dyn.names if k != "track_id"):
            raise AssertionError(f"DynamicFeatures of {fov}: {len(dyn)} tracks, or a value not finite")
        tracks += len(dyn)
    track_ms = (time.perf_counter() - t0) / tracks * 1e3
    t0 = time.perf_counter()
    back = convert({"features": ds.X, "index": obs, "projections": ds.obsm["X_projections"]}, tmp / "converted.zarr",
                   return_anndata=True)
    convert_s = time.perf_counter() - t0
    same = (np.array_equal(back.X, ds.X) and back.obs.names == obs.names
            and all(back.obs[k].tolist() == obs[k].tolist() for k in obs.names)
            and np.array_equal(back.obsm["X_projections"], ds.obsm["X_projections"])
            and not (tmp / "converted.tmp_embeddings").exists())
    if not same:
        raise AssertionError("annotation.convert: the store read back differs from its input")
    log(f"[features-parity] CellFeatures.compute_all_features: {cell_ms:.2f} ms a cell ({FEATURE_CELLS} cells of "
        f"{FEATURE_YX}^2 with masks, {len(names)} features, all finite); DynamicFeatures: {track_ms:.3f} ms a track "
        f"({tracks} tracks of {EVAL_T} frames, {len(obs)} cells, one FOV at a time); annotation.convert of the "
        f"{len(obs)}-cell set: {convert_s:.2f} s, read back equal ({card})")
    shutil.rmtree(store)
    shutil.rmtree(tmp / "converted.zarr")
    return dict(cell_ms=cell_ms, track_ms=track_ms, convert_s=convert_s, cells=FEATURE_CELLS, tracks=tracks)


def phase_features_parity(card: str, tmp: Path) -> dict:
    """Phase 28: the parity harness's command, its activation capture and
    ``run_checkpoint_parity`` on the card, then the engineered features and
    ``annotation.convert`` on the host (see the module docstring)."""
    from viscy_tpu_torch.ops import fused_block as fb

    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fb.launches = 0
    report = parity_report(card, tmp)
    cap = parity_capture(card)
    ckpt = parity_checkpoint(card, tmp, cap.pop("module"), cap.pop("cpu"))
    torch.cuda.empty_cache()
    launches = fb.launches
    feats = feature_checks(card, tmp)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak > LEG_28_PEAK_GIB:
        raise AssertionError(f"phase 28 held {peak:.2f} GiB of the card > {LEG_28_PEAK_GIB:g}")
    total = time.perf_counter() - t0
    log(f"[phase 28] features and parity in {total:.1f} s; fused forward A + B {launches}; peak {peak:.2f} GiB "
        f"({card})")
    return dict(seconds=total, launches=launches, peak_gib=peak, report=report, capture=cap, checkpoint=ckpt,
                features=feats)


# -- legs beside the card-bound phases: host-bound phases in a process of their own on the same card ----------

BESIDE_LIMIT_GIB = 70.0  # the pair's device memory, both processes together
BESIDE_TIMEOUT_S = 900


class _MemoryWatch:
    """The device's used memory (``cudaMemGetInfo``: every process on the
    card) sampled every 0.2 s on a thread; ``peak`` in GiB."""

    def __init__(self) -> None:
        import threading

        self.peak = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="memory-watch", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            free, total = torch.cuda.mem_get_info()
            self.peak = max(self.peak, (total - free) / 2**30)
            self._stop.wait(0.2)

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return self.peak


class Beside:
    """Run the leg ``LEGS[leg]`` in a ``python3`` process of its own on the
    same card while the main process runs card-bound phases; its output goes
    to a log printed whole at :meth:`join`, every line marked ``note``. The
    device memory of the pair is watched and held under
    ``BESIDE_LIMIT_GIB``. On leaving the ``with`` block early the process is
    killed."""

    def __init__(self, leg: str, args: dict, out: Path, note: str, carriers: str) -> None:
        self.leg, self.out, self.carriers = leg, out, carriers
        out.mkdir(parents=True, exist_ok=True)
        (out / "args.json").write_text(json.dumps(_jsonable(args)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke as cs; "
                f"cs.beside_main({leg!r}, {str(out)!r}, {note!r})")
        self._fh = open(out / "leg.log", "w")
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), stdout=self._fh,
                                     stderr=subprocess.STDOUT)
        self.t0 = time.perf_counter()
        self.memory = _MemoryWatch()

    def __enter__(self) -> "Beside":
        return self

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.memory.stop()
        self._fh.close()

    def wait_for(self, marker: Path) -> None:
        """Block until the leg writes ``marker`` (raises if it ends first)."""
        while not marker.exists():
            if self.proc.poll() is not None:
                self.join()  # raises with its log when it failed
                return
            time.sleep(0.2)

    def join(self) -> dict:
        try:
            rc = self.proc.wait(timeout=max(1.0, BESIDE_TIMEOUT_S - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = f"killed after {BESIDE_TIMEOUT_S} s"
        window = time.perf_counter() - self.t0
        peak = self.memory.stop()
        self._fh.close()
        for line in (self.out / "leg.log").read_text().splitlines():
            print(line, flush=True)
        if rc != 0:
            raise AssertionError(f"[beside] the leg {self.leg} failed ({rc}); its log is above")
        result = json.loads((self.out / "result.json").read_text())
        PHASE_SECONDS.update(result["phase_seconds"])
        PHASE_SECONDS[f"window: {self.leg} beside {self.carriers}"] = round(window, 1)
        log(f"[beside] {self.leg} ({result['seconds']:.1f} s in its process) beside {self.carriers}: the window "
            f"{window:.1f} s; the pair's device memory at most {peak:.2f} GiB (cudaMemGetInfo every 0.2 s; limit "
            f"{BESIDE_LIMIT_GIB:g})")
        if peak > BESIDE_LIMIT_GIB:
            raise AssertionError(f"[beside] {self.leg}: the pair held {peak:.2f} GiB > {BESIDE_LIMIT_GIB:g} GiB")
        return result


def _jsonable(o):
    """``o`` as JSON can hold it: dict keys as strings, arrays as lists,
    numpy scalars as numbers, anything else unknown as its ``str``."""
    if isinstance(o, dict):
        return {str(k): _jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonable(v) for v in o]
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer, np.bool_)):
        return o.item()
    if o is None or isinstance(o, (bool, int, float, str)):
        return o
    return str(o)


def beside_main(leg: str, out: str, note: str) -> None:
    """The entry of a :class:`Beside` process: TF32 off (as :func:`main`
    sets it), every log line (and log record) marked ``note``; ``LEGS[leg]`` with the
    arguments in ``out/args.json``, its result to ``out/result.json``."""
    out = Path(out)
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    BESIDE["note"] = note
    # the library's log records and warnings carry the mark too
    logging.basicConfig(level=logging.WARNING, format="%(levelname)s %(name)s: %(message)s" + note.replace("%", "%%"),
                        force=True)
    logging.captureWarnings(True)
    t0 = time.perf_counter()
    result = LEGS[leg](card_line(), **json.loads((out / "args.json").read_text()))
    result.update(seconds=time.perf_counter() - t0, phase_seconds=dict(PHASE_SECONDS))
    (out / "result.json").write_text(json.dumps(_jsonable(result)))


def leg_24_21_22d(card: str, tmp: str, cli_info: dict, plate: str, plate_grown: str) -> dict:
    """Phase 24, then phases 21 and 22 (d) on phase 9's plate once phase 11
    has grown it (``plate_grown`` written), beside phases 20 (a), 11, 12,
    16 and 19."""
    p24 = timed_phase("phase_dynacell_eval", phase_dynacell_eval, card, Path(tmp), cli_info)
    while not Path(plate_grown).exists():
        time.sleep(0.2)
    t0 = time.perf_counter()
    p21 = timed_phase("phase_transforms", phase_transforms, card, Path(tmp), Path(plate))
    log(f"[phase 21] the remaining transforms in {time.perf_counter() - t0:.1f} s")
    p22 = timed_phase("phase_datamodules", phase_datamodules, card, Path(tmp), Path(plate))
    return dict(p24=p24, p21=p21, p22=p22)


def leg_23_26(card: str, tmp: str, plate: str, tracks: str, ckpt: str, plate_free: str) -> dict:
    """Phases 23 and 26, beside phases 17, 25 and 18: ``plate_free`` is
    written once phase 23 no longer reads phase 14's plate (phase 18
    removes it)."""
    p23 = timed_phase("phase_dynaclr_eval", phase_dynaclr_eval, card, Path(tmp), Path(plate), Path(tracks),
                      Path(ckpt), Path(plate_free))
    return dict(p23=p23, p26=timed_phase("phase_ctc", phase_ctc, card, Path(tmp)))


def leg_27(card: str, tmp: str) -> dict:
    """Phase 27, beside phases 9 and 10."""
    return dict(p27=timed_phase("phase_lc_pseudotime", phase_lc_pseudotime, card, Path(tmp)))


def leg_28(card: str, tmp: str) -> dict:
    """Phase 28, beside phase 14."""
    return dict(p28=timed_phase("phase_features_parity", phase_features_parity, card, Path(tmp)))


LEGS = {"leg_24_21_22d": leg_24_21_22d, "leg_23_26": leg_23_26, "leg_27": leg_27, "leg_28": leg_28}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    if not (ROOT / "viscy_tpu_torch").is_dir():
        raise RuntimeError(f"viscy_tpu_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    # f32 comparisons run in full f32 (cuBLAS and cuDNN would otherwise use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = timed_phase("phase_env", phase_env)
    # phase 22 (a)-(b) launch none of the port's kernels: they run on the card while nvcc compiles them

    def sampling_beside() -> tuple[dict, float]:
        t = time.perf_counter()
        return phase_celldiff_sampling(card), time.perf_counter() - t

    sampling, sampling_s = timed_phase("phase_build", phase_build, sampling_beside, "phase 22 (a)-(b)")
    PHASE_SECONDS["phase_celldiff_sampling"] = round(sampling_s, 1)
    # the phases behind the kernel table run alone
    kern = timed_phase("phase_kernel", phase_kernel)
    bwd = timed_phase("phase_kernel_bwd", phase_kernel_bwd)
    warp = timed_phase("phase_warp", phase_warp)
    sl = timed_phase("phase_slice", phase_slice, card)
    tr = timed_phase("phase_train", phase_train, card)
    fit = timed_phase("phase_fit", phase_fit, card)
    with tempfile.TemporaryDirectory(prefix="viscy-cli-") as tmp:
        # phase 27 (store reads, joins, splits and the DTW on the host; a few GiB on the card) beside 9 and 10;
        # beside phase 15 the pair held 71.61 GiB of the card (phase 15's fit reserves most of it)
        carriers = "phases 9, 10"
        with Beside("leg_27", dict(tmp=tmp), Path(tmp) / "beside_27", f" [beside {carriers}]", carriers) as side:
            BESIDE["note"] = " [beside phase 27]"
            cli = timed_phase("phase_cli", phase_cli, card, Path(tmp))
            stages = timed_phase("phase_stages", phase_stages, card, Path(tmp), cli)
            BESIDE["note"] = ""
            p27 = side.join()["p27"]
        # phase 24 (the host's watershed, labels and per-cell loops), then 21 and 22 (d) (host window reads and
        # host transforms) once 11 has grown the plate, beside 20 (a) and the card-bound 11, 12, 16, 19
        plate_grown = Path(tmp) / "plate_grown"
        leg = dict(tmp=tmp, cli_info={k: cli[k] for k in ("predict_plate", "predict_store", "ckpt", "predict")},
                   plate=cli["fit_plate"], plate_grown=plate_grown)
        carriers = "phases 20 (a), 11, 12, 16, 19"
        with Beside("leg_24_21_22d", leg, Path(tmp) / "beside_24", f" [beside {carriers}]", carriers) as side:
            BESIDE["note"] = " [beside phases 24, 21, 22 (d)]"
            qc = timed_phase("phase_qc", phase_qc, card, Path(tmp), cli["fit_plate"])
            pre = timed_phase("phase_pretrain", phase_pretrain, card, Path(tmp), cli["fit_plate"])
            plate_grown.touch()
            unext2 = timed_phase("phase_unext2", phase_unext2, card, Path(tmp), cli["fit_plate"])
            legacy = timed_phase("phase_legacy", phase_legacy, card, Path(tmp), cli["fit_plate"])
            ddp = timed_phase("phase_ddp", phase_ddp, card, Path(tmp), cli["fit_plate"])
            BESIDE["note"] = ""
            res = side.join()
        p24, p21, p22 = res["p24"], res["p21"], res["p22"]
        p22_s = PHASE_SECONDS["phase_datamodules"]
        with tempfile.TemporaryDirectory(prefix="viscy-dynaclr-") as tmp2:
            # phase 28 (the parity harness's captures and checkpoint on the card, a few GiB; the features and the
            # store conversion on the host) beside phase 14
            carriers = "phase 14"
            with Beside("leg_28", dict(tmp=str(Path(tmp2) / "features_parity")), Path(tmp2) / "beside_28",
                        f" [beside {carriers}]", carriers) as side:
                BESIDE["note"] = " [beside phase 28]"
                dynaclr_cli = timed_phase("phase_dynaclr_cli", phase_dynaclr_cli, card, Path(tmp2))
                BESIDE["note"] = ""
                p28 = side.join()["p28"]
            # phases 23 (UMAP's eigsh and the cross-checks on the host) and 26 (crops, the ILP, the suites' host
            # work) beside the card-bound 13, 20 (b)-(d), 22 (c), 17, 25 and 18; 18 removes phase 14's plate, so it
            # waits until 23 has read it
            plate_free = Path(tmp2) / "plate_free"
            leg = dict(tmp=tmp2, plate=dynaclr_cli["plate"], tracks=dynaclr_cli["tracks"],
                       ckpt=dynaclr_cli["affine_ckpt"], plate_free=plate_free)
            carriers = "phases 13, 20 (b)-(d), 22 (c), 17, 25, 18"
            with Beside("leg_23_26", leg, Path(tmp2) / "beside_23_26", f" [beside {carriers}]", carriers) as side:
                BESIDE["note"] = " [beside phases 23, 26]"
                dynaclr = timed_phase("phase_dynaclr", phase_dynaclr, card)
                tta = timed_phase("phase_tta", phase_tta, card)
                seg = timed_phase("phase_seg", phase_seg, card, Path(tmp))
                callbacks = timed_phase("phase_callbacks", phase_callbacks, card, Path(tmp2), dynaclr_cli["plate"],
                                        dynaclr_cli["tracks"])
                t0 = time.perf_counter()
                foundation = timed_phase("foundation_leg", foundation_leg, card, Path(tmp2), dynaclr_cli["plate"],
                                         dynaclr_cli["tracks"])
                classes = timed_phase("classification_leg", classification_leg, card, Path(tmp2),
                                      dynaclr_cli["plate"])
                p22_s += time.perf_counter() - t0
                gan = timed_phase("phase_gan", phase_gan, card, Path(tmp), cli["fit_plate"])
                p25 = timed_phase("phase_joint", phase_joint, card, Path(tmp2), dynaclr_cli["plate"])
                side.wait_for(plate_free)
                vae = timed_phase("phase_vae", phase_vae, card, Path(tmp2), dynaclr_cli["plate"],
                                  dynaclr_cli["tracks"])  # removes the plate
                BESIDE["note"] = ""
                res = side.join()
            p23, p26 = res["p23"], res["p26"]
    twenty_s = sum(PHASE_SECONDS[k] for k in ("phase_qc", "phase_tta", "phase_seg", "phase_callbacks"))
    with tempfile.TemporaryDirectory(prefix="viscy-celldiff-") as tmp:
        timed_phase("phase_celldiff", phase_celldiff, card, Path(tmp))
    p22_s += sampling_s  # phase 22 (a)-(b), beside the build
    log(f"[phase 20] qc, tta, seg and callbacks in {twenty_s:.1f} s (QC {qc['per_fov_s']:.3f} s a FOV, TTA "
        f"{tta['fov_s']:.3f} s a FOV, segmentation {seg['slice_s']:.3f} s a slice)")
    log(f"[phase 22] the sampler, tiled generation, the foundation extractors and the new datamodules in "
        f"{p22_s:.1f} s (likelihood peak {sampling['sampler']['methods']['likelihood']['peak_gib']:.2f} GiB; "
        f"foundation predict {foundation['cells_per_s']:.2f} cells/s; classification loader {classes:.2f} "
        f"batches/s; launches A + B {p22['launches']['fwd']}, C + D {p22['launches']['bwd']}, warp "
        f"{p22['launches']['warp']})")
    log(f"[phase 23] DynaCLR's evaluation: {p23['seconds']:.1f} s; launches on its path {p23['launches']}")
    log(f"[phase 24] dynacell evaluate: {p24['seconds']:.1f} s; fused forward A + B {p24['launches']}; card against "
        f"CPU: pixel row {p24['pixel_worst']:.2e} relative, DynaCLR similarity {p24['similarity_worst']:.2e} "
        f"relative, "
        f"probe AUROC {abs(p24['auroc'] - p24['auroc_cpu']):.1e}; segmentation and CP features bit for bit; "
        f"spectral-eval of a whole FOV {p24['spectral']['seconds']:.1f} s, peak {p24['spectral']['peak_gib']:.2f} GiB, "
        f"its crop card against CPU {p24['spectral']['worst']:.2e} relative; whole-cell labels bit for bit "
        f"({p24['whole_cells']} cells); those legs {p24['tail_s']:.1f} s")
    log(f"[phase 25] JointEncoderModule: {p25['seconds']:.1f} s; launches A + B {p25['launches']['fwd']}, C + D "
        f"{p25['launches']['bwd']}; per step of both encoders A + B {p25['kernels']['ms']:.3f} ms (bound "
        f"{p25['kernels']['bound_ms']:.3f}), C + D {p25['kernels']['bwd_ms']:.3f} ms (bound "
        f"{p25['kernels']['bwd_bound_ms']:.3f})")
    log(f"[phase 26] DynaCLR's CTC tracking benchmark and the config-driven subcommands: {p26['seconds']:.1f} s; "
        f"fused forward A + B {p26['launches']} (v2 encoder, {CTC_BATCH} crops of {CTC_SHAPE[0]}^2 a batch: "
        f"{p26['kernels']['ms']:.3f} ms a forward, bound {p26['kernels']['bound_ms']:.3f}, plain "
        f"{p26['kernels']['plain_ms']:.3f})")
    log(f"[phase 27] linear classifiers and pseudotime: {p27['seconds']:.1f} s; (a) liblinear objective card "
        f"against CPU {p27['lc']['objective_rel']:.1e} relative; H2 {p27['pseudotime']['h2_ms'] * 1e3:.1f} us a call "
        f"(plain {p27['pseudotime']['plain_ms'] * 1e3:.1f} us), {p27['pseudotime']['launches']} launches")
    h1, cached = stages["cached"]["h1"], stages["cached"]
    log(f"[phase 10] the cached fit: {PHASE_SECONDS['phase_stages']:.1f} s for phase 10 in all; H1 {h1['ms']:.3f} ms a "
        f"call (plain {h1['plain_ms']:.3f}, per-patch copies {h1['copies_ms']:.3f}, host bound {h1['bound_ms']:.3f}), "
        f"{cached['counts']['h1']} launches on the fit's path")
    log(f"[phase 28] features and parity: {p28['seconds']:.1f} s; activation capture card against CPU "
        f"{p28['capture']['worst']:.2e} of range over {p28['capture']['modules']} modules; run_checkpoint_parity "
        f"max|d| / range {p28['checkpoint']['worst']:.2e}; CellFeatures {p28['features']['cell_ms']:.2f} ms a cell, "
        f"DynamicFeatures {p28['features']['track_ms']:.3f} ms a track; fused forward A + B {p28['launches']}")
    PHASE_SECONDS["total"] = round(time.perf_counter() - t_start, 1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_seconds": PHASE_SECONDS}))
    print(card)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    records = [
        dict(
            name="fused_mlp_grn_fwd",
            route="cuda",
            source="viscy_tpu_torch/csrc/fused_mlp_grn.cu",
            replaces="viscy_tpu/ops/pallas/fused_block.py:164,183",
            launches=sl["launches"] + pre["launches"]["fwd"] + unext2["launches"]["fwd"] + gan["launches"]["fwd"]
            + vae["launches"]["fwd"] + ddp["launches"]["fwd"] + tta["launches"]["fwd"]
            + callbacks["launches"]["fwd"] + p21["launches"]["fwd"] + p22["launches"]["fwd"] + p24["launches"]
            + p25["launches"]["fwd"] + p26["launches"] + cached["counts"]["fwd"] + p28["launches"],
            **{k: kern[k] for k in keys if k != "max_abs_err"},
            max_abs_err=max(kern["max_abs_err"], pre["kernels"]["fwd_err"], pre["fwd_err"],
                            unext2["kernels"]["fwd_err"], gan["kernels"]["fwd_err"], vae["kernels"]["fwd_err"],
                            tta["max_abs_err"], p21["fwd_err"], p25["kernels"]["fwd_err"], p26["fwd_err"]),
            library_ms=None,
        ),
        dict(
            name="fused_mlp_grn_bwd",
            route="cuda",
            source="viscy_tpu_torch/csrc/fused_mlp_grn.cu",
            replaces="viscy_tpu/ops/pallas/fused_block.py:233,307",
            launches=tr["bwd_launches"] + pre["launches"]["bwd"] + unext2["launches"]["bwd"] + gan["launches"]["bwd"]
            + vae["launches"]["bwd"] + ddp["launches"]["bwd"] + p21["launches"]["bwd"] + p22["launches"]["bwd"]
            + p25["launches"]["bwd"] + cached["counts"]["bwd"],
            **{k: bwd[k] for k in keys if k != "max_abs_err"},
            max_abs_err=max(bwd["max_abs_err"], pre["kernels"]["bwd_err"], unext2["kernels"]["bwd_err"],
                            gan["kernels"]["bwd_err"], vae["kernels"]["bwd_err"], p25["kernels"]["bwd_err"]),
            library_ms=None,
        ),
        dict(
            name="affine_warp_3d",
            route="cuda",
            source="viscy_tpu_torch/csrc/affine_warp3d.cu",
            replaces="viscy_tpu/ops/pallas/warp3d.py:226,352",
            launches=tr["warp_launches"] + pre["launches"]["warp"] + unext2["launches"]["warp"]
            + dynaclr["warp_launches"] + dynaclr_cli["warp_launches"] + legacy["warp_launches"]
            + gan["launches"]["warp"] + ddp["launches"]["warp"] + p21["launches"]["warp"] + p22["launches"]["warp"]
            + cached["counts"]["warp"],
            **{k: warp[k] for k in keys if k != "max_abs_err"},
            max_abs_err=max(warp["max_abs_err"], fit["warp_max_abs_err"], pre["warp_err"], dynaclr["warp_err"],
                            dynaclr_cli["warp_err"], legacy["warp_err"], gan["warp_err"]),
            library_ms=warp["library_ms"],
        ),
    ]
    pt = p27["pseudotime"]
    host = [dict(name="dtw_dp", route="host", source="viscy_tpu_torch/csrc/dtw.cpp",
                 replaces="viscy_tpu/native/dtw.cpp:19", launches=pt["launches"], max_abs_err=0.0, ms=pt["h2_ms"],
                 plain_ms=pt["plain_ms"], bound_ms=pt["bound_ms"], bound_by="bytes", library_ms=None),
            dict(name="crop_norm", route="host", source="viscy_tpu_torch/csrc/crop_norm.cpp",
                 replaces="viscy_tpu/native/crop_norm.cpp:25", launches=cached["counts"]["h1"],
                 max_abs_err=h1["max_abs_err"], ms=h1["ms"], plain_ms=h1["plain_ms"], bound_ms=h1["bound_ms"],
                 bound_by="bytes", library_ms=None)]
    print(json.dumps({"kernels": records, "host_kernels": host}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
