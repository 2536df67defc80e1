"""On-card smoke test of the PyTorch port (``ich_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero before
its last line:

1. device: a CUDA card is required (no fallback to the CPU); prints its
   name and ``nvidia-smi``'s name and power limit, and looks up its
   data-sheet peaks by that name (a card without them stops the script);
2. build: compiles ``ich_tpu_torch/csrc/*.cu`` into ``build/ich_tpu_torch/``;
3. the two EDT kernels of ``csrc/edt.cu`` against their plain PyTorch
   versions on the card, with ``torch.equal``: the lower-envelope pass
   (``edt_pass_1d``) along W and along H of the GAN config's 16x256x256, of
   4x512x512 and of a ragged 3x100x37, and on random integer costs at
   (64, 4096); the whole transform from the mask
   (``distance_transform_edt_kernel``) at the same three shapes, with an
   all-ones and an all-zeros image; one 512^2 image against scipy within
   1e-3; ``discounted_l1_loss`` on the card against the CPU within rtol
   1e-5; then each kernel's time beside its plain version's and its byte
   bound at 16x256x256 and 4x512x512, and the loss's time;
4. main path: the full-width 2.5D net (UNet depth 5, top_filter 32,
   BatchNorm, midchannels_factor 2, float32) with seeded random weights
   serves three 512x512x40 head-CT NIfTIs through ``ich_tpu_torch.serve``,
   and the EDT leg runs ``discounted_l1_loss`` at the GAN shape; one volume
   is segmented again on the CPU and at least 99.99% of voxels must agree;
5. 3D path: the bench's net (3D UNet depth 4, top_filter 16, GroupNorm,
   midchannels_factor 2, bf16) with seeded random weights serves three
   512x512x64 head-CT NIfTIs through ``ich_tpu_torch.serve --mode 3d`` (64^3
   patches at overlap 0.5, 128 patches per call: the 64x512x512 volume of
   ``bench.py``), 2 fused GroupNorm+ReLU launches for each GroupNorm of
   each net call there and in one ``UNet3D.segment_volume``; an identity
   network blends a 64x512x512 volume back to
   itself on the card and on the CPU (within 1e-4 of the input, 1e-6 of
   each other); a 64x128x128 crop in float32 (TF32 off) agrees with the CPU
   on at least 99.99% of voxels and within 1e-4 in probability; bf16 is
   held against float32 on the card; then warm latency, pipelined seconds
   per volume, peak device memory, FLOP rate and a profiler breakdown;
6. 2.5D training at the width of ``configs/unet2d.json`` (UNet depth 5,
   top_filter 32, midchannels_factor 1, dropout 0.5, BatchNorm, float32,
   256x256 slices, batch 16, BinaryDiceLoss, Adam with L2 and ExponentialLR,
   the config's four affine augmentations): (a) the k-fold experiment
   ``run_supervised_2d`` end to end, 2 folds x 2 epochs with per-epoch
   validation, each fold training on 512 synthetic slices over 16 volumes
   kept on the card and testing on 128 over 4, its artifacts checked and
   the mean loss falling from epoch 1 to 2 in each fold, no GroupNorm
   launch on its BatchNorm net; (b) three train
   steps of the full-width net on a fixed batch of 4 (dropout and
   augmentation off, TF32 off) on the card and on the CPU, losses and
   weights within the printed tolerances; (c) the config's augmentation
   with one set of affine parameters injected, 16x256x256 on the card and
   on the CPU, masks equal and images within 1e-5; (d) warm train-step
   times at batch 16 and 128 (``configs/unet2d_throughput.json``) with TF32
   on and off, peak device memory, the FLOPs of a step and their rate, and
   the epoch time with and without validation; (e) a profiler breakdown of
   one warm step;
7. 3D patch training at the width of ``configs/unet3d.json`` (UNet depth 4,
   top_filter 16, midchannels_factor 1, GroupNorm, float32, 64x128x128
   patches, batch 4, pos_frac 0.5, BinaryDiceLoss p 2 alpha 0.2,
   sw_batch_size 8): (a) ``run_supervised_3d`` on a synthetic SegICH 3D
   tree of the config's five 512x512x32 CTs at 5 mm (resampled to 2.5 mm
   by the loader), 4 epochs x 25 steps, its artifacts checked and the mean
   loss falling, its GroupNorm launches 2 a GroupNorm a pass; (b) three
   full-width train steps (batch 2 of 32x64x64,
   TF32 off) on the card and on the CPU, held as phase 6's; (c)
   ``default_patch_augmentation`` (the ``AffineAugment3D`` warp and the
   brightness jitter) and the ``DevicePatchSampler``'s draws, starts and
   gather, each drawing from one key, card against CPU; (d)
   warm step times, patches/s, voxels/s, FLOP rate and peak memory at
   batch 4 of 64x128x128 in float32 with TF32, batch 8 and 64 of 64^3 in
   bf16, and batch 2 of 128^3 in bf16 with remat, the GroupNorm launches
   of the timed steps (2 a GroupNorm in the forward, in the backward and,
   with remat, in the recompute), and the host and device
   samplers' ms per batch; (e) a profiler breakdown of one warm step at
   batch 4;
8. SSL pretraining at the width of ``configs/context_restoration.json`` and
   ``configs/contrastive_global_local.json`` (UNet depth 5, top_filter 32,
   midchannels_factor 1, BatchNorm, no dropout, float32 with TF32, 256x256
   slices): (a) 256 synthetic RSNA DICOMs of 512x512 written, pivoted with
   ``write_rsna_slice_info`` and loaded with ``load_rsna_slices``, then
   ``pretrain_context_restoration`` (batch 32, 10 rotated swaps of 10-30 px)
   for 2 epochs, its artifacts and the falling restoration MSE checked, the
   bottleneck features of every slice, and ``run_supervised_2d_with_init``
   for 2 folds x 1 epoch on synthetic folds, its log naming every weight
   key moved; (b) ``pretrain_contrastive`` for 2 global epochs (batch 64,
   MLP head 256-128, tau 0.5) and 1 local epoch (n_decoder 3, head 64-32,
   K 3, 13 regions, the encoder frozen): the frozen encoder equal to the
   global weights, its running statistics moved, the decoder and head
   trained; (c) three full-width steps of each trainer (batch 2, the
   randomness injected, TF32 off) on the card and on the CPU, held as phase
   6's, and the patch swap (equal), the blur and the crop-resize warp
   (within 1e-5) at batch 32 of 256x256, card against CPU; (d) warm step
   times, slices/s, FLOP rate and peak memory of context restoration at
   batch 32 and global and local contrastive at batch 64; (e) a profiler
   breakdown of one context-restoration step (ranges ``corrupt``, ``net``,
   ``loss``) and of one global contrastive step (``views``, ``net``,
   ``loss``);
9. classification pretraining, the label-efficiency sweep and the
   brain-only workflow, at the width of
   ``configs/contrastive_global_local.json`` (encoder d5 f32 mcf1, BatchNorm,
   no dropout, float32 with TF32, 256x256 slices, batch 64,
   ``frac_negative`` 2), on phase 8's RSNA slices: (a) a SegICH 2D CSV tree
   written with the port's writer (``SEGICH2D_TREE``: 20 patients x 16
   slices of 512x512, cut from 24 slices; lesions in the 10 patients that
   ``SEGICH2D_SEED`` draws, on about a third of their slices, masks on the
   positive slices only) and ``python -m
   ich_tpu_torch.experiments.supervised2d`` on it (``configs/unet2d.json``
   cut to 2 folds x 1 epoch) with pandas, PIL and scikit-learn made
   unimportable, its aggregates checked; (b) ``pretrain_classifier`` of the
   encoder with the head 256-128-2 for 3 epochs, then 7-way for 1 epoch
   (the config: 100), the artifacts, the falling loss and finite AUCs
   checked; (c) ``label_efficiency_sweep`` from the binary weights at the
   fractions 0.1, 0.25, 0.5 and 1.0 with the low-label recipe on the CSV
   tree, 2 folds x 1 epoch (0.1 stretched to 2), each fraction timed, each
   fold's log naming the moved encoder keys and its training slices and
   positives equal to what the split, the draw ``default_rng(42 + k)`` and
   the negative cap give (with ``SEGICH2D_SEED`` every fold of every
   fraction keeps a patient with a lesion; at 0.1 one of its 10); (d)
   ``python -m ich_tpu_torch.experiments.binary_resnet`` (ResNet-18, 256x256,
   batch 64, 2 epochs) and its artifacts; (e) ``python -m
   ich_tpu_torch.experiments.brain_extraction`` on a tree whose masks are
   the head's interior (``BRAIN_TREE``), 2 folds x 1 epoch then 1 epoch on
   all; ``pred_on_brain`` on copies of (a)'s experiment with 512x512 brain
   BMPs: all ones leave every prediction BMP byte-equal and the CSVs those
   of evaluate, twice; all zeros empty every prediction and give each fold
   an empty prediction's positive Dice; ``segment_brain`` with the brain
   U-Net on two 512x512x40 NIfTIs; (f) three full-width steps (batch 2,
   TF32 off, nothing random) of ``BinaryClassifier`` and ``MultiClassifier``
   on the encoder and ``BinaryClassifier`` on ResNet-18, card against CPU,
   held as phase 8's; (g) warm step times, slices/s, FLOPs and their rate,
   and peak memory of ``cls_encoder_bs64`` and ``cls_resnet18_bs64`` with
   TF32, and a profile of one warm ResNet-18 step with the BatchNorm
   kernels cuDNN takes (NHWC or NCHW);
10. the SN-PatchGAN and the inpainting anomaly detector at the width of
   ``configs/inpainting_gan.json`` (``SAGatedGenerator`` lat 32, the
   spectral-norm ``PatchDiscriminator`` 64-128-256-256-256-256 with
   self-attention, batch 16 of 256x256, float32 with TF32, lr_g 1e-4, lr_d
   4e-4, lambda_L1 = lambda_gan = 0.5, gammaL1 0.99, the config's mask
   ranges), on phase 8's RSNA tree and phase 9's ResNet-18 weights: (a)
   ``python -m ich_tpu_torch.experiments.inpainting_gan`` on the non-ICH
   slices for ``GAN_EPOCHS`` epochs (the config: 50) with a checkpoint each
   epoch, the artifacts, finite losses and a falling L1 checked, and both
   EDT counters equal to 2 x the train steps; ``SNPatchGAN.validate`` of
   the saved generator (256 x 768 PNGs); (b) the CLI again with one more
   epoch, resumed from (a)'s checkpoint: exactly one epoch runs; (c) card
   against CPU with TF32 off: three full-width steps at batch 2 with
   injected masks drawn from one key (the step-1 D loss and L1; the 3-step
   D loss and L1
   within a quarter of what one optimizer step changes them by; 99% of each
   net's weights within a tenth of one Adam step and all within Adam's
   bound; the spectral-norm u and the BatchNorm statistics against the
   CPU's own thread-count spread), one forward and backward of
   ``GatedGenerator`` with contextual attention, the mask render (equal but
   at stroke-edge pixels), morphology and hysteresis (equal); (d) ``python
   -m ich_tpu_torch.experiments.ad_inpainting`` with (a)'s generator and the
   ResNet-18 gate (threshold 0: every slice scored) on a SegICH 2D tree of
   ``AD_TREE`` slices of 512^2 at the JAX defaults (holes 32x32, step 16,
   batch 16, n_iter 3, angles +-7.5 and +-15, flip), with
   ``--export-attention``; the CSVs, ``info.csv`` and the maps checked; one
   slice's ``robust_anomaly_detect`` and one ``detect`` timed with their
   generator calls counted; (e) ``gan_sa_bs16`` and ``gan_ctx_bs16``
   (``GatedGenerator`` with contextual attention): warm step times,
   slices/s, FLOPs and their rate, peak memory, the generator's inference
   at batch 16 and 1, and a profile of one warm ``gan_sa_bs16`` step
   (ranges ``masks``, ``d_step``, ``g_step``, ``edt_loss``);
11. the anomaly-detection suite, in phase 8-10's work dir: (a) ``python -m
   ich_tpu_torch.experiments.ae_ad`` on phase 8's non-ICH slices with an
   AE config written there (``AENet``'s defaults: latent 64, bottleneck 64,
   n_conv 3, kernel 5, transposed-conv decoder; ``configs/fcdd.json``'s
   batch 32 and lr 1e-4; ``AE_EPOCHS`` epochs with lambda_GDL {0: 0, 1: 1},
   the loss jumping at the switch), its artifacts, and ``AE.validate`` of
   the saved model (the CLI validates every 5 epochs); (b) ``ae_ad
   --detect`` on phase 9's SegICH 2D tree (CSVs, Dice, the pixel AUC of
   the slices with a lesion); (c) ``python -m
   ich_tpu_torch.experiments.fcdd`` with ``configs/fcdd.json`` at its width
   for ``FCDD_EPOCHS`` epochs (60), the AUC each epoch and the localization
   PNGs, then ``--eval-volumes`` on phase 9's tree; (d) the attention tree
   (the AE maps of (b) written as ``ad_inpainting --export-attention``
   writes them, their ``info.csv`` merged into the tree's by patient and
   slice) and ``python -m ich_tpu_torch.experiments.attention_unet2d``
   with ``configs/unet2d.json`` gated on 2 channels, ``ATTN_SPLIT`` folds and
   epochs, each fold's artifacts; (e) card against CPU with TF32 off: three
   full-width steps at batch 2 of the AE (lambda 1), FCDD (injected
   ellipses drawn from one key) and the gated U-Net, held as phase 10 (c)
   holds the GAN, the
   ellipse render (equal but at edge pixels), the receptive upsample and
   ``grad_heatmap`` (in float64; float32 printed); (f) ``ae_bs32``,
   ``fcdd_bs32`` and ``attn_unet2d_bs16``: warm step times with TF32,
   slices/s, FLOPs and their rate, peak memory, FCDD's heatmap ms per batch,
   and a profile of one ``ae_bs32`` step naming the transposed convs'
   backward kernels;
12. multi-GPU: one rank a card (``torch.cuda.device_count()``, 1 on a
   one-card machine), spawned with ``torch.multiprocessing``, NCCL through
   a file rendezvous in the work dir, every sub-phase in that one group:
   (a) ``UNet2D(mesh=)`` at ``configs/unet2d.json``'s width (global batch
   16 of 256x256), three steps on a fixed batch with augmentation and
   dropout off and TF32 off against the same trainer without a mesh on the
   card (:func:`_mg_hold`), then 2 epochs of ``train`` on phase 6's
   synthetic slices with the config's augmentation, the mean loss falling;
   (b) ``UNet3D(mesh=)`` at ``configs/unet3d.json``'s width (batch 4 of
   64x128x128), held the same way; (c) ``Contrastive(mesh=)`` global at
   batch 64 and ``ContextRestoration(mesh=)`` at batch 32 at their configs'
   width, held the same way; (d) the headline volume (64x512x512, 64^3
   patches at overlap 0.5, the d4f16 GroupNorm bf16 net, 128 patches a
   call) through ``sliding_window_inference_sharded`` against the serial
   sliding window away from the global H edges, the serial sliding window
   at batch 128 against batch 75 and against itself (batch size alone;
   printed), at world > 1 the disagreeing mask voxels by distance to the
   nearest slab boundary, an identity net within 1e-4 of the input, and
   ``UNet2D.segment_volumes`` /
   ``UNet3D.segment_volumes`` of three 512x512x40 and three 64x512x512
   volumes on the mesh and ``volume_parallel_map`` of the serial body, the
   masks equal to the serial path's; (e) the trained 2D state saved by the
   group to the DCP store and restored by a fresh world-1 group, every
   value equal; (f) warm ``train2d_bs16`` and
   ``ssl_contrastive_global_bs64`` steps of the data-parallel trainer
   beside the plain one, the gradient all-reduce's bytes and ms, a
   profile of one warm data-parallel ``train2d_bs16`` step, and the halo
   path's seconds a volume beside the serial sliding window's. The
   EDT launches over phase 12 read 0; a rank's failure raises in the
   parent;
13. the host-side remainder on a public-layout dataset: (a) three
   PhysioNet-layout NIfTIs of 512x512x16 (``synthetic_ich_volume``; CTs,
   lesion masks, brain masks) and a ``Patient_demographics.csv`` without
   the second patient, through ``python -m
   ich_tpu_torch.experiments.data_preparation gen-2d-seg`` and
   ``gen-2d-brain`` with pandas, PIL, scikit-learn and click unimportable:
   mask BMPs for the positive slices only, ``patient_info.csv`` merged as
   pandas' left merge, and ``load_segich_2d`` of the tree equal to the
   windowed NIfTIs; (b) the supervised2d CLI on that tree at
   ``configs/unet2d.json``'s width, 2 folds x 1 epoch, its analysis tables
   (``postprocessing/analyse_exp.supervised_tables``) held against a
   recomputation from the fold CSVs, the overlay triplets at 512^2, and
   ``results_overview.pdf`` (2 pages) where matplotlib is installed; (c) a
   CQ500 root of 2 series of 24 DICOMs of 512^2 through ``qure-extract``
   and one series through ``dicom-to-nifti`` (the same bytes), then
   ``segment_brain`` of the extracted volumes on the card with (b)'s fold-1
   weights (uint8 masks in {0, 255}); (d) the arrays of each ``figures``
   command (the window on the card against the CPU within 1e-6), and each
   command's file where matplotlib is installed; (e) the native loader
   built with g++, its decodes of (a)'s CTs (and gzip copies) equal to
   ``nifti.load``, ``window_resize_batch`` within 1e-4 of the window and
   resize on the card, and both decoders' ms per volume. The EDT launches
   over phase 13 read 0;
14. the paired label-efficiency study
   (``ich_tpu_torch.experiments.label_efficiency_study.main``) at its width
   (U-Net d4 f16 mcf1, dropout 0.1, BatchNorm, float32 with TF32, 64x64
   slices, batch 16, its 5 patient folds), seed 42, arms scratch,
   pretrained (context restoration) and contrastive_local (global then
   local contrastive), fractions 0.25 and 1.0, cut to 2 fine-tune epochs
   (40) and 1 pretraining epoch a phase (30), with pandas, PIL,
   scikit-learn, matplotlib and imageio unimportable: (a) ``results.json``
   holds 5 finite Dice in [0, 1] per arm x fraction, and each pretrained
   arm's fold-1 nets start from its ``pretrained.bin`` (every shared key
   equal) and not from scratch's; (b) the table and
   ``compare_to_reference`` against the JAX package's snapshots in
   ``docs/`` run, headed by the run's ``provenance.json``. The EDT
   launches over phase 14 read 0, the dropout kernel's do not. Its nets,
   augmentation, corruption, views, region cells and dropout masks are
   the JAX package's draws (``utils/rng.py``, ``ops/dropout.py``);
15. rng: jax.random's threefry streams computed on the card
   (``ich_tpu_torch.utils.rng``, int64 torch ops there for a draw of
   more than ``HOST_WORDS`` words): ``fold_in`` and ``split`` of
   ``PRNGKey(42)`` and 2^17 + 3 words of bits, ``uniform`` and
   ``truncated_normal`` held against ``RNG_KNOWN``, constants computed
   with JAX 0.9.0 on the CPU (integers equal; floats within ``RNG_ULPS``
   units in the last place, sums within that bound of each term), and
   ``torch.equal`` to the same draws on this machine's CPU; the keyed
   draws of the 3D, GAN, FCDD and detector paths (``path_draws``: the
   device sampler's (vi, start) over a 4-volume stack, the parameters of
   ``default_patch_augmentation`` at batch 4, ``draw_ff_masks`` at the GAN
   config's batch 16 of 256^2, ``draw_ellipse_params`` at
   ``configs/fcdd.json``'s batch 32 of 256^2 and with noise, the
   detector's W1 null sample) on the card, held against
   ``RNG_KNOWN["paths"]`` (the JAX package's draws from the same keys) and
   ``torch.equal`` to the same draws on this machine's CPU, with their
   times; the d4 f16 study U-Net and the ``configs/unet2d.json`` U-Net
   drawn from
   ``prng_key(42)`` on the card (``init_like_flax``), held against
   ``NET_KNOWN`` (flax's ``init`` checksums) and equal to the same nets
   drawn on the CPU; the draws' and the inits' times. The EDT launches
   over phase 15 read 0;
16. dropout: the keyed dropout kernel (``csrc/dropout.cu``, flax's
   ``nn.Dropout`` over XLA's Philox stream): (a) ``torch.equal`` to its
   plain version at ``configs/unet2d.json``'s five dropout shapes at batch
   16, a ragged (3, 5, 7, 9) and a bf16 NCDHW (2, 16, 64, 64, 64), each in
   NCHW and channels-last storage at stream offsets 0, 4 and 6, and its
   backward pass; (b) equal to flax's answers for ``DROPOUT_CASES``
   (``DROPOUT_KNOWN``, computed with JAX on the CPU); (c) its time at the
   five shapes against the plain version, ``F.dropout``, the parent
   commit's ``bernoulli_`` path and the byte bound; (d) its launches in
   one ``train2d_bs16`` step (5 forward, 5 backward); (e) that step's time
   with the parent's dropout (its module and per-step set-up) and with the
   kernel in 10 pairs of turns, alternating which runs first;
17. group_norm: the fused GroupNorm+ReLU kernels (``csrc/group_norm.cu``)
   at the 3D net's four GroupNorm shapes in a serve call of 128 64^3
   patches and a training step of 64, in bf16 and float32: (a) forward
   and backward, launched directly and through ``group_norm_relu`` with
   autograd, against the plain versions (bf16 in ulps of the float32
   plain value); (b) their launches in one forward and backward of the 3D
   net (28 and 28) and of a BatchNorm net (0); (c) the device ms of each
   forward and backward against the byte bound, the plain backward and
   torch's ``F.relu(F.group_norm(...))`` forward and its autograd backward
   (the library yardstick, which the port's card path never calls; it is
   also the plain forward), and their sums over one net forward of 14
   calls (bf16, 128 patches) and one training step's 14 forward and 14
   backward calls (bf16, 64 patches).

Each path is driven with the kernel launch counts set to 0 just before and
read just after (the training, SSL, phase 9, phase 11, 12, 13, 14 and 15
paths must read 0 EDT launches; the GAN path 0 dropout launches). The line
before the last is a JSON object with each kernel's launches on the path
that owns it (the GAN training of phase 10 (a) for the EDT kernels, phase
6 (a)'s k-fold training for dropout, phase 5's ``serve --mode 3d`` for
group_norm), its launches by path (phase 4's EDT leg and phases 14 and 15
too, for dropout the study and a train2d_bs16 step, for group_norm phase
7 (d)'s timed steps), its error against the plain version,
its times, its bound and, for dropout and group_norm, the library call's
time; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F

from ich_tpu_torch import parallel, serve
from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.bmp import read_bmp, save_bmp_gray
from ich_tpu_torch.data.core import LabeledSliceDataset, SliceDataset2D, VolumeDataset3D
from ich_tpu_torch.data.datasets import load_rsna_slices, load_segich_3d, write_rsna_slice_info
from ich_tpu_torch.data.patch_sampler import DevicePatchSampler
from ich_tpu_torch.data.synthetic import (
    synthetic_ich_slices,
    synthetic_ich_volume,
    write_cq500_tree,
    write_rsna_tree,
    write_segich_tree,
)
from ich_tpu_torch.data.png import read_png_gray
from ich_tpu_torch.data.segich import load_segich_2d
from ich_tpu_torch.data.table import pandas_float
from ich_tpu_torch.experiments import ad_inpainting, ae_ad, attention_unet2d, fcdd, inpainting_gan
from ich_tpu_torch.experiments import binary_resnet, brain_extraction, pred_on_brain, segment_brain
from ich_tpu_torch.experiments import data_preparation, figures, supervised2d
from ich_tpu_torch.experiments import label_efficiency_study as study
from ich_tpu_torch.experiments.label_efficiency import LOW_LABEL_RECIPE
from ich_tpu_torch.experiments.pretrain_finetune import (
    build_encoder,
    build_partial_unet,
    label_efficiency_sweep,
    pretrain_classifier,
    pretrain_context_restoration,
    pretrain_contrastive,
    run_supervised_2d_with_init,
)
from ich_tpu_torch.experiments.supervised2d import (
    build_unet_from_cfg,
    run_supervised_2d,
    stratified_kfold,
    subsample_label_fraction,
)
from ich_tpu_torch.experiments.supervised3d import (
    build_trainer3d,
    build_unet3d_from_cfg,
    run_supervised_3d,
    split_test,
)
from ich_tpu_torch import native
from ich_tpu_torch.kernels import _build
from ich_tpu_torch.models.fcdd import FCDD_CNN_VGG, receptive_upsample
from ich_tpu_torch.models.inpainting import GatedGenerator, PatchDiscriminator, SAGatedGenerator
from ich_tpu_torch.models.resnet import resnet18
from ich_tpu_torch.models.init import flax_fold
from ich_tpu_torch.models.layers import Dropout
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import ct, edt
from ich_tpu_torch.ops import dropout as dropout_ops
from ich_tpu_torch.ops import group_norm as gn_ops
from ich_tpu_torch.ops import losses as losses_mod
from ich_tpu_torch.ops import morphology as morph
from ich_tpu_torch.ops.masks import (
    draw_ellipse_params,
    draw_ellipses_batch,
    draw_ff_masks,
    random_ff_masks,
    render_ellipses,
    render_ff_masks,
)
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.ops.transforms import build_pipeline
from ich_tpu_torch.ops.transforms3d import default_patch_augmentation
from ich_tpu_torch.ops import sliding_window as sw
from ich_tpu_torch.ops.losses import discounted_l1_loss
from ich_tpu_torch.ops.metrics import batch_binary_confusion_matrix, dice_from_counts
from ich_tpu_torch.postprocessing import analyse_exp
from ich_tpu_torch.train import checkpoint as ckpt
from ich_tpu_torch.train.classifier import BinaryClassifier, MultiClassifier
from ich_tpu_torch.train.gan import SNPatchGAN
from ich_tpu_torch.train.inpaint_ad import InpaintAnomalyDetector, robust_anomaly_detect
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.train.segmentation3d import UNet3D, sample_patches
from ich_tpu_torch.train.ssl import ContextRestoration, Contrastive
from ich_tpu_torch.utils import rng as prng
from ich_tpu_torch.utils.profiling import compiled_flops, peak_hbm_tbs, peak_tflops, time_fn

SEED = 0
K = prng.prng_key  # a step's key from an int, as fit folds none
GAN_SHAPE = (16, 256, 256)  # configs/inpainting_gan.json: batch 16, size 256
BIG_SHAPE = (4, 512, 512)
RAGGED_SHAPE = (3, 100, 37)
COSTS_SHAPE = (64, 4096)  # the kernels' longest line
VOL_SHAPE = (512, 512, 40)  # (H, W, Z) HU volume, as a head CT is stored
N_VOLS = 3
WINDOW = (50.0, 200.0)  # serve defaults --win-center / --win-width
NET = dict(depth=5, top_filter=32, midchannels_factor=2, norm="batch", p_dropout=0.0)
MIN_AGREEMENT = 0.9999
# bench.py:62-65 and scripts/serve.py:107-110; configs/unet3d_throughput.json
VOL3D_SHAPE = (512, 512, 64)  # (H, W, Z); transposed, bench.py's 64x512x512
NET3D = dict(depth=4, ndim=3, top_filter=16, midchannels_factor=2, norm="group",
             p_dropout=0.0)
PATCH3D = 64
CROP3D = (slice(0, 64), slice(192, 320), slice(192, 320))  # 9 patches of 64^3
# the printed shares of peak and the byte bounds are of the card's dense
# data-sheet peaks (ich_tpu_torch/utils/profiling.PEAKS), looked up by
# phase 1 from its name: "bf16", "tf32", "fp32" TFLOP/s and "hbm_tbs" TB/s
PEAK: dict = {}
# phase 6: configs/unet2d.json at its width; (slices, volumes) per fold
TRAIN_CFG = "configs/unet2d.json"
TRAIN_FOLD, TEST_FOLD = (512, 16), (128, 4)
HOLD_BATCH = 4
TIMED_BATCHES = (16, 128)  # configs/unet2d.json, configs/unet2d_throughput.json
# phase 7: configs/unet3d.json at its width, on SegICH-like CTs (5 mm slices,
# which the loader resamples to the config's 2.5 mm)
TRAIN3D_CFG = "configs/unet3d.json"
CT3D_SHAPE, CT3D_SPACING = (512, 512, 32), (0.5, 0.5, 5.0)
TRAIN3D_EPOCHS, TRAIN3D_STEPS = 4, 25  # the config: 100 x 100
HOLD3D_PATCH, HOLD3D_BATCH = (32, 64, 64), 2  # the card/CPU hold (the CPU's step time)
# (cell, patch, batch, dtype, remat): configs/unet3d.json; the patch of
# configs/unet3d_throughput.json at batch 8 and 64 in the JAX bench arm's
# bf16; the bench's 128^3 arm with remat
TIMED3D = (("train3d_bs4_p64x128x128", (64, 128, 128), 4, torch.float32, False),
           ("train3d_bs8_p64", (64, 64, 64), 8, torch.bfloat16, False),
           ("train3d_bs64_p64", (64, 64, 64), 64, torch.bfloat16, False),
           ("train3d_bs2_p128_remat", (128, 128, 128), 2, torch.bfloat16, True))
SAMPLER_PATCH, SAMPLER_BATCH = (64, 64, 64), 8
# phase 8: SSL pretraining at the configs' width; RSNA-like DICOMs at 512^2
# loaded at the configs' 256^2
CR_CFG, CON_CFG = "configs/context_restoration.json", "configs/contrastive_global_local.json"
RSNA_SLICES, RSNA_SIZE = 256, 512
SSL_EPOCHS = (2, 2, 1)  # context restoration, global, local (the configs: 100, 100, 50)
SSL_FOLD = ((128, 4), (32, 2))  # the fine-tune's (slices, volumes): train, test per fold
SSL_HOLD_BATCH = 2  # the card/CPU hold (the CPU's step time)
SSL_TIMED = (("ssl_cr_bs32", "cr", 32), ("ssl_contrastive_global_bs64", "global", 64),
             ("ssl_contrastive_local_bs64", "local", 64))
# phase 9: classification pretraining, the label-efficiency sweep and the
# brain-only workflow at the width of configs/contrastive_global_local.json;
# a SegICH 2D CSV tree of (patients, slices each, side)
SEGICH2D_TREE = (20, 16, 512)  # cut from 24 slices a patient to keep the phase near 60 s
# lesions in half the patients, drawn from this seed: with the config's seed
# 42 and 2 folds, every fold of every sweep fraction keeps a patient with a
# lesion (the patients kept depend only on which have lesions)
SEGICH2D_SEED = 2
CLS_EPOCHS = (3, 1)  # binary, 7-way pretraining (the config: 100)
SWEEP_FRACTIONS = (0.1, 0.25, 0.5, 1.0)
RESNET_EPOCHS = 2
BRAIN_TREE = (6, 8, 512)  # the brain-extraction tree: patients, slices, side
BRAIN_VOLS = 2  # 512x512x40 NIfTIs for segment_brain
CLS_HOLD_BATCH = 2
CLS_TIMED = (("cls_encoder_bs64", "binary", 64), ("cls_resnet18_bs64", "resnet18", 64))
# the port runs without them (matplotlib and imageio draw the reports and
# figures, which are skipped without them; matplotlib needs PIL)
NOT_ON_THE_CARD = ("pandas", "PIL", "sklearn", "matplotlib", "imageio")
# phase 10: configs/inpainting_gan.json at its width on phase 8's RSNA slices
GAN_CFG = "configs/inpainting_gan.json"
GAN_EPOCHS = 2  # the config: 50
GAN_HOLD_BATCH = 2  # the card/CPU hold (the CPU's step time)
GAN_TIMED = (("gan_sa_bs16", True, 16), ("gan_ctx_bs16", False, 16))
AD_TREE = (2, 3, 512)  # the detector's SegICH 2D tree: patients, slices each, side
# phase 13: a public-layout dataset (PhysioNet's NIfTI release: patients, side,
# slices; 512^2 as the release, 16 slices of its ~34) to masks on the card
PREP_NIFTI = (3, 512, 16)
PREP_IDS = (49, 50, 51)  # the release's file names: 049.nii, ...
CQ500_TREE = (2, 24, 512)  # qureAI CQ500 DICOM series: patients, slices, side
NATIVE_ROUNDS = 3
# phase 14: the paired label-efficiency study at its width (d4 f16 mcf1,
# 64^2, its 5 folds), cut to 2 fine-tune epochs (40) and 1 pretraining epoch
# a phase (30); one arm per pretrainer
STUDY_SCALE = {"n_epoch": 2, "pretrain_epochs": 1}
# phase 15's known answers: jax.random (JAX 0.9.0, threefry partitionable)
# and flax 0.12.3's init on the CPU; tests/test_torch_rng.py holds them
# against JAX itself
RNG_WORDS = (1 << 17) + 3  # above utils/rng.HOST_WORDS: the card computes these draws
RNG_ULPS = 4  # the port's erf_inv against XLA's (tests/test_torch_rng.py)
RNG_KNOWN = {
    "fold_in_7": [2547012911, 1371500959],
    "split_3": [[1832780943, 270669613], [64467757, 2916123636], [2465931498, 255383827]],
    "bits_sum": 280865998819178,  # random_bits(PRNGKey(42), (RNG_WORDS,))
    "bits_head": [2098992034, 2919706841, 2646866425, 2409546199],
    "bits_tail": [3331942309, 1591767782, 236451054, 381254960],
    # uniform(fold_in(PRNGKey(42), 1), (RNG_WORDS,), -2.5, 4.0)
    "uniform_head": [2.2298173904418945, 2.6211390495300293, -1.318987250328064,
                     -0.7929035425186157],
    "uniform_sum": 99059.95593553782,
    # truncated_normal(fold_in(PRNGKey(42), 2), -2, 2, (RNG_WORDS,))
    "tn_head": [0.4114566743373871, 0.5575056672096252, -1.0635087490081787,
                -0.35603460669517517],
    "tn_sum": 173.10044755474286,
    # the keyed draws of the 3D, GAN, FCDD and detector paths (path_draws):
    # path_answers of the JAX package's draws from the same keys
    "paths": {
        "sampler_vi": {"n": 32, "sum": 44, "wsum": 697, "head": [0, 2, 3, 1]},
        "sampler_start": {"n": 96, "sum": 807, "wsum": 40552, "head": [0, 0, 0, 23]},
        "aug_m": {"n": 16, "sum": 2.4629910783842206,
                  "head": [0.98853999376297, 0.15095919370651245,
                           0.15095919370651245, -0.98853999376297]},
        "aug_apply": {"n": 4, "sum": 3, "wsum": 8, "head": [1, 0, 1, 1]},
        "aug_factor": {"n": 4, "sum": 0.04224950820207596,
                       "head": [0.09367463737726212, -0.046822525560855865,
                                -0.08913739025592804, 0.08453478664159775]},
        "ff_n_strokes": {"n": 16, "sum": 31, "wsum": 262, "head": [2, 3, 1, 2]},
        "ff_n_vert": {"n": 48, "sum": 461, "wsum": 11517, "head": [12, 8, 10, 14]},
        "ff_width": {"n": 48, "sum": 838, "wsum": 20565, "head": [19, 20, 15, 17]},
        "ff_sx": {"n": 48, "sum": 6149.1076736450195,
                  "head": [127.46029663085938, 142.79544067382812,
                           89.03985595703125, 146.97006225585938]},
        "ff_sy": {"n": 48, "sum": 5962.071632385254,
                  "head": [102.1013412475586, 27.953819274902344,
                           108.66366577148438, 109.00714111328125]},
        "ff_beta": {"n": 48, "sum": 143.2448899373412,
                    "head": [0.7599117755889893, 4.199215888977051,
                             5.332579612731934, 3.322474479675293]},
        "ff_angs": {"n": 672, "sum": 829.3682886958122,
                    "head": [1.4471261501312256, 1.172144889831543,
                             0.548515260219574, 1.5591049194335938]},
        "ff_lens": {"n": 672, "sum": 16350.0, "head": [30.0, 14.0, 18.0, 19.0]},
        "ff_n_sp": {"n": 16, "sum": 78, "wsum": 595, "head": [7, 6, 8, 8]},
        "ff_cy": {"n": 144, "sum": 19401.0, "head": [166.0, 98.0, 92.0, 227.0]},
        "ff_cx": {"n": 144, "sum": 18095.0, "head": [155.0, 94.0, 227.0, 163.0]},
        "ff_r": {"n": 144, "sum": 372.0, "head": [2.0, 4.0, 4.0, 4.0]},
        "ell_n": {"n": 32, "sum": 187, "wsum": 3225, "head": [2, 1, 2, 8]},
        "ell_cy": {"n": 288, "sum": 37095.40808105469,
                   "head": [120.0615234375, 125.65838623046875,
                            125.2942886352539, 162.4691619873047]},
        "ell_cx": {"n": 288, "sum": 36817.00456237793,
                   "head": [108.61370849609375, 94.18019104003906, 225.84375, 124.4522933959961]},
        "ell_major": {"n": 288, "sum": 3807.6905851364136,
                      "head": [13.408785820007324, 18.063026428222656,
                               1.6362972259521484, 16.17237091064453]},
        "ell_minor": {"n": 288, "sum": 2061.103354215622,
                      "head": [10.990674018859863, 10.796528816223145,
                               1.123619794845581, 10.391000747680664]},
        "ell_theta": {"n": 288, "sum": 870.5661054281518,
                      "head": [4.735177040100098, 6.195896148681641,
                               4.189301490783691, 0.2906826138496399]},
        "ell_value": {"n": 288, "sum": 156.8861337378621,
                      "head": [0.44482874870300293, 0.6658139228820801,
                               0.7056679725646973, 0.9721066951751709]},
        "ell_noise": {"n": 262144, "sum": 28.45164681020779,
                      "head": [0.011048129759728909, -0.00012823216093238443,
                               0.023718692362308502, 0.06125449016690254]},
        "null_first": {"n": 262144, "sum": -557.7616550581552,
                       "head": [-0.02830461598932743, 0.4671318531036377,
                                0.2957029640674591, 0.15354591608047485]},
        "null_cleanup": {"n": 262144, "sum": 357.9261533053859,
                         "head": [0.6057640314102173, 0.7990440726280212,
                                  -0.9089270234107971, -0.6352575421333313]},
    },
}
# phase 15's path draws, from fold_in(PRNGKey(PATH_SEED), i) for i = 0..4:
# the device sampler's (vi, start) over a 4-volume stack at the patch and
# pos_frac of configs/unet3d.json; default_patch_augmentation's parameters at
# its batch 4; the free-form masks of configs/inpainting_gan.json (batch 16
# of 256^2, its "mask"); the ellipses of configs/fcdd.json (batch 32 of
# 256^2, its "drawing_params"), and with noise at PATH_NOISE_BATCH; the
# detector's W1 null sample at the JAX script's defaults on 256^2 (holes
# 32x32, step 16: 4 samples a pixel), for PRNGKey(PATH_SEED) and fold_in(., 1)
PATH_SEED = 42
PATH_PATCH = (64, 128, 128)
PATH_POS_FRAC = 0.5
PATH_SAMPLER_BATCH = 32
# (shape, bleed box z0, z1, y0, y1, x0, x1 or None): shorter than the patch
# along D, exactly the patch, larger, and a bleed of more than max_pos voxels
PATH_SAMPLER_VOLS = (((70, 160, 144), (10, 30, 40, 80, 50, 70)), ((64, 128, 128), None),
                     ((96, 200, 180), (44, 56, 100, 140, 20, 60)),
                     ((40, 140, 150), (5, 8, 10, 20, 100, 140)))
PATH_AUG_BATCH = 4
PATH_GAN = (256, 16)  # (size, batch)
PATH_MASK_KW = {"n_draw": [1, 4], "vertex": [5, 15], "brush_width": [10, 25],
                "length": [10, 40], "n_salt_pepper": [0, 10], "salt_pepper_radius": [1, 5]}
PATH_FCDD = (256, 32)
PATH_ELLIPSE_KW = {"n_ellipse": [1, 10], "major_axis": [1, 25], "minor_axis": [1, 25],
                   "intensity": [0.1, 1.0]}
PATH_NOISE, PATH_NOISE_BATCH = 0.05, 4  # 4 x 256^2 words: rng's device path
PATH_NULL_SHAPE = (4, 256, 256)
# flax's init of the JAX UNet from PRNGKey(42), through from_jax: the count,
# sum and sum of squares of every float entry of the state_dict, and the
# first three weights of down_block.0.conv1
NET_KNOWN = {
    "study_d4f16": ({"depth": 4, "top_filter": 16, "midchannels_factor": 1}, {
        "n": 484561, "sum": 1399.6155412227508, "sumsq": 2223.1658765916654,
        "head": [0.19304624199867249, -0.307388037443161, -0.06207161024212837]}),
    "unet2d_config": ({"depth": 5, "top_filter": 32, "midchannels_factor": 1}, {
        "n": 7771297, "sum": 5893.321741513526, "sumsq": 9311.070218953422,
        "head": [0.19304624199867249, -0.06207161024212837, 0.24375410377979279]}),
}
STUDY_FRACTIONS = (0.25, 1.0)
STUDY_ARMS = ("scratch", "pretrained", "contrastive_local")
STUDY_SEED = 42
# phase 16's known answers: flax's nn.Dropout (flax 0.12.3 on JAX 0.9.0's
# CPU backend, whose rng_bit_generator is Philox4x32-10) under the key that
# flax gives the first make_rng of DROPOUT_PATH from
# dropout_key(PRNGKey(DROPOUT_SEED)), on dropout_input(shape) from position
# `offset` of the stream, as dropout_answers reads them
# (tests/test_torch_keyed_dropout.py recomputes them with flax)
DROPOUT_SEED = 42
DROPOUT_PATH = ("encoder", "down_0", "Dropout_0")
DROPOUT_CASES = (("f32_p05", "float32", (2, 6, 8, 8), 0.5, 0),
                 ("f32_p01_off6", "float32", (2, 6, 8, 8), 0.1, 6),
                 ("bf16_p01_off4", "bfloat16", (1, 6, 4, 8, 8), 0.1, 4))
DROPOUT_KNOWN = {
    "key": [478273173, 4266244382, 1499700442, 2953261298],
    "f32_p05": {"kept": 364, "sum": -143.5, "head": [-12.5, -3.25, 6.0, 0.0, -0.75, 8.5],
                "tail": [9.75, -6.25, 0.0, 0.0]},
    "f32_p01_off6": {"kept": 674, "sum": -62.77777951955795,
                     "head": [-6.94444465637207, -1.8055555820465088, 0.0, -5.555555820465088,
                              -0.4166666865348816, 4.722222328186035],
                     "tail": [5.4166669845581055, -3.472222328186035, 1.6666667461395264,
                              6.805555820465088]},
    "bf16_p01_off4": {"kept": 1350, "sum": -0.46484375,
                      "head": [-6.96875, -1.8125, 3.34375, -5.5625, 0.0, 4.71875],
                      "tail": [-3.75, 1.390625, 6.53125, -2.359375]},
}
# phase 16: configs/unet2d.json's dropout inputs at batch 16 (the four down
# blocks and the bottleneck of 256^2 slices), a ragged shape, and the 3D
# net's first block at a 64^3 patch in bf16
DROPOUT_SHAPES = ((16, 32, 256, 256), (16, 64, 128, 128), (16, 128, 64, 64), (16, 256, 32, 32),
                  (16, 512, 16, 16))
DROPOUT_RAGGED = (3, 5, 7, 9)
DROPOUT_BF16 = (2, 16, 64, 64, 64)
DROPOUT_OFFSETS = (0, 4, 6)
DROPOUT_TURN_STEPS = 15  # timed train2d_bs16 steps a turn
DROPOUT_PAIRS = 10  # pairs of parent and change turns
# (N, C, D, H, W, groups): the 3D net's GroupNorm shapes (configs/
# unet3d_throughput.json: depth 4, top filter 16, 16 channels a group), with
# the calls each shape takes in one net forward
GN_LEVELS = (((16, 64, 1), 4), ((32, 32, 2), 4), ((64, 16, 4), 4), ((128, 8, 8), 2))
GN_BATCHES = (("serve", 128), ("train", 64))  # a serve call's patches, a step's batch
GN_EPS = 1e-6
DEV = "cuda"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, *args, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn(*args)`` over ``iters`` launches
    after 3 warm-up launches (``time_fn``: CUDA events on the card)."""
    return time_fn(fn, *args, iters=iters, warmup=3, device=DEV)["mean_s"] * 1e3


# -- synthetic inputs ----------------------------------------------------------

def stroke_masks(rng: np.random.Generator, b: int, h: int, w: int) -> np.ndarray:
    """(b, h, w) float32 free-form brush-stroke masks, 1 inside a stroke, with
    the GAN config's mask ranges (configs/inpainting_gan.json "mask"):
    1-4 strokes of 5-15 vertices, segments 10-40 px, brush 10-25 px."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for _ in range(rng.integers(1, 5)):
            p = rng.uniform((0, 0), (h, w))
            radius = rng.uniform(10, 25) / 2
            for _ in range(rng.integers(5, 16)):
                ang = rng.uniform(0, 2 * np.pi)
                q = np.clip(p + rng.uniform(10, 40) * np.array([np.sin(ang), np.cos(ang)]),
                            0, (h - 1, w - 1))
                d = q - p
                t = np.clip(((yy - p[0]) * d[0] + (xx - p[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
                dist2 = (yy - p[0] - t * d[0]) ** 2 + (xx - p[1] - t * d[1]) ** 2
                out[i][dist2 <= radius**2] = 1.0
                p = q
    return out


def head_ct_and_mask(rng: np.random.Generator, shape=VOL_SHAPE) -> tuple:
    """(H, W, Z) float32 HU volume: air, an elliptic skull, brain with
    noise, and a few hyperdense bleeds; and the (H, W, Z) uint8 mask of the
    bleeds."""
    h, w, z = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = ((yy - h / 2) / (0.42 * h)) ** 2 + ((xx - w / 2) / (0.36 * w)) ** 2
    vol = np.full(shape, -1000.0, np.float32)
    vol[r <= 1.0] = 1000.0  # skull
    brain = r <= 0.85
    vol[brain] = 35.0
    vol += rng.normal(0, 8, shape).astype(np.float32) * brain[..., None]
    mask = np.zeros(shape, np.uint8)
    zz = np.arange(z, dtype=np.float32)
    for _ in range(rng.integers(2, 5)):
        cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.35, 0.65) * w
        cz, rad = rng.uniform(0.3, 0.7) * z, rng.uniform(0.03, 0.08) * h
        blob = (((yy - cy) ** 2 + (xx - cx) ** 2)[..., None] / rad**2
                + ((zz - cz) / (z / 6)) ** 2) <= 1.0
        bleed = blob & brain[..., None]
        vol[bleed] = rng.uniform(60, 85)
        mask[bleed] = 1
    return vol, mask


def head_ct(rng: np.random.Generator, shape=VOL_SHAPE) -> np.ndarray:
    """The volume of :func:`head_ct_and_mask`."""
    return head_ct_and_mask(rng, shape)[0]


def init_net(net: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: He-normal convs, zero conv biases, and
    BatchNorm / GroupNorm affine and BatchNorm running statistics away from
    their defaults."""
    convs = (torch.nn.Conv2d, torch.nn.Conv3d)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, convs + (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)):
                # a k2 s2 transposed conv feeds each output from in_channels taps
                fan_in = m.weight[0].numel() if isinstance(m, convs) else m.weight.shape[0]
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                m.bias.zero_()
            elif isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                    m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)


# -- phases ---------------------------------------------------------------------

def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the cards."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required")
    kind = torch.cuda.get_device_name(0)
    PEAK.update({p: peak_tflops(kind, p) for p in ("bf16", "tf32", "fp32")},
                hbm_tbs=peak_hbm_tbs(kind))
    if PEAK["hbm_tbs"] is None:
        raise SystemExit(f"chip_smoke: {kind!r} has no data-sheet peaks in "
                         f"ich_tpu_torch/utils/profiling.PEAKS; its bounds cannot be computed")
    smi = card_name_and_power()
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s))")
    print(smi)
    return kind


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    print(open(f"{lib_path}.log").read().strip())


def _equal_pass(g: torch.Tensor, label: str) -> tuple:
    """Kernel A on the rows of ``g`` against its plain version; returns the
    kernel's output and the max abs difference."""
    k, p = edt.edt_pass_1d(g), edt.edt_pass_1d_plain(g)
    torch.cuda.synchronize()
    check(torch.equal(k, p), f"edt_pass_1d differs from the plain pass at {label}")
    return k, float((k - p).abs().max())


def _timed(label: str, fn, plain, args: tuple, bound_ms: float) -> dict:
    """Kernel and plain times in turns (kernel, plain, plain, kernel), with
    the bound and the kernel's share of it."""
    ms = [cuda_ms(f, *args) for f in (fn, plain, plain, fn)]
    kernel_ms, plain_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    print(f"{label}: kernel {kernel_ms!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
          f"(bytes at {PEAK['hbm_tbs']} TB/s), kernel at {100 * bound_ms / kernel_ms:.1f}% of "
          f"the bound")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def _bytes_ms(n_bytes: int) -> float:
    return n_bytes / (PEAK["hbm_tbs"] * 1e12) * 1e3


def phase_edt(rng: np.random.Generator) -> dict:
    """Both EDT kernels against their plain versions, bit for bit, then
    their times; returns the two rows of the kernels line (but launches)."""
    dev = torch.device(DEV)
    launches0, mask_launches0 = edt.launches, edt.mask_launches
    err_a = err_b = 0.0
    masks_by_shape = {}
    for shape in (GAN_SHAPE, BIG_SHAPE, RAGGED_SHAPE):
        b, h, w = shape
        masks = stroke_masks(rng, b, h, w)
        masks[0] = 1.0  # no site: distances saturate at sqrt(1e10)
        masks[1] = 0.0  # all sites: distances are 0
        m = torch.from_numpy(masks).to(dev)
        g = torch.where(m > 0, edt.INF, 0.0).reshape(b * h, w)
        k1, e1 = _equal_pass(g, f"{shape} along W")
        gt = k1.reshape(b, h, w).transpose(1, 2).contiguous().reshape(b * w, h)
        _, e2 = _equal_pass(gt, f"{shape} along H")
        d, d_plain = edt.distance_transform_edt_kernel(m), edt.distance_transform_edt_plain(m)
        torch.cuda.synchronize()
        check(torch.equal(d, d_plain), f"distance_transform_edt_kernel differs from the "
              f"plain composition at {shape}")
        check(bool((d[0] == 1e5).all()) and bool((d[1] == 0).all()),
              "all-ones mask must saturate at 1e5 and all-zeros give 0")
        err_a = max(err_a, e1, e2)
        err_b = max(err_b, float((d - d_plain).abs().max()))
        print(f"edt {shape}: both passes and the transform torch.equal to plain")
        masks_by_shape[shape] = (masks, d)
    g = torch.from_numpy(rng.integers(0, 1 << 24, size=COSTS_SHAPE).astype(np.float32)).to(dev)
    _, e = _equal_pass(g, f"{COSTS_SHAPE} integer costs")
    err_a = max(err_a, e)
    print(f"edt_pass_1d {COSTS_SHAPE} random integer costs in [0, 2^24): torch.equal to plain")
    masks, d = masks_by_shape[BIG_SHAPE]
    err = float(np.abs(d[2].cpu().numpy() - ndi.distance_transform_edt(masks[2])).max())
    check(err <= 1e-3, f"EDT differs from scipy by {err} at 512^2")
    print(f"edt 512^2 vs scipy.ndimage.distance_transform_edt: max err {err}")

    b, h, w = GAN_SHAPE
    rec = rng.uniform(size=(b, h, w, 1)).astype(np.float32)
    im = rng.uniform(size=(b, h, w, 1)).astype(np.float32)
    mask = stroke_masks(rng, b, h, w)[..., None]
    args = [torch.from_numpy(a) for a in (rec, im, mask)]
    card_args = [a.to(dev) for a in args]
    on_card = float(discounted_l1_loss(*card_args))
    on_cpu = float(discounted_l1_loss(*args))
    check(abs(on_card - on_cpu) <= 1e-5 * abs(on_cpu),
          f"discounted_l1_loss card {on_card} vs cpu {on_cpu}")
    print(f"discounted_l1_loss {GAN_SHAPE}: card {on_card!r} cpu {on_cpu!r}")
    check(edt.launches > launches0 and edt.mask_launches > mask_launches0,
          "EDT launch counters did not move")

    # timed on what discounted_l1_loss hands the transform: sites on the
    # border of the strokes (a 3x3 dilation minus the mask), sparse
    times = {}
    for shape in (GAN_SHAPE, BIG_SHAPE):
        b, h, w = shape
        strokes = torch.from_numpy(stroke_masks(rng, b, h, w)).to(dev)[:, None]
        m = (1.0 - (F.max_pool2d(strokes, 3, stride=1, padding=1) - strokes))[:, 0].contiguous()
        g = torch.where(m > 0, edt.INF, 0.0).reshape(b * h, w)
        times["a", shape] = _timed(f"edt_pass_1d ({b * h}, {w})", edt.edt_pass_1d,
                                   edt.edt_pass_1d_plain, (g,), _bytes_ms(2 * 4 * g.numel()))
        times["b", shape] = _timed(f"distance_transform_edt_kernel {shape}",
                                   edt.distance_transform_edt_kernel,
                                   edt.distance_transform_edt_plain, (m,),
                                   _bytes_ms(2 * 4 * m.numel()))
    loss_ms = cuda_ms(discounted_l1_loss, *card_args)
    print(f"discounted_l1_loss {GAN_SHAPE}: {loss_ms!r} ms")
    return {"edt_envelope_pass": {"max_abs_err": err_a, **times["a", GAN_SHAPE]},
            "distance_transform_edt_kernel": {"max_abs_err": err_b, **times["b", GAN_SHAPE]}}


def _calibrate_final_bias(net: torch.nn.Module, vol: np.ndarray) -> None:
    """Shift the final bias so that about a tenth of the middle slices'
    pixels score >= 0.5: random weights otherwise give an all-0 or all-1
    mask, whose Dice says nothing."""
    z = vol.shape[2]
    x = torch.from_numpy(vol[:, :, z // 2 - 8: z // 2 + 8]).to(DEV)
    x = ct.resize(ct.window_ct(torch.rot90(x, 1, dims=(0, 1)), *WINDOW), (256, 256, 16), order=1)
    net.use_final_activation = False
    with torch.inference_mode():
        logits = net(x.permute(2, 0, 1).unsqueeze(1).contiguous())
    net.use_final_activation = True
    q = float(torch.quantile(logits.flatten()[::7], 0.9))
    with torch.no_grad():
        net.final_conv.bias -= q


def phase_main(rng: np.random.Generator, work: str) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    watch, out = os.path.join(work, "watch"), os.path.join(work, "out")
    os.makedirs(watch)
    vols = []
    for i in range(N_VOLS):
        vols.append(head_ct(rng))
        nifti.save(os.path.join(watch, f"ct{i}.nii.gz"), vols[-1])

    net = UNet(**NET)
    init_net(net, torch.Generator().manual_seed(SEED))
    trainer = UNet2D(net, device=DEV)
    _calibrate_final_bias(trainer.unet, vols[0])
    model_fn = os.path.join(work, "model.pt")
    trainer.save_model(model_fn)

    edt.launches = edt.mask_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.main(["--watch-dir", watch, "--output-dir", out, "--model", model_fn,
                "--size", "256", "--win-center", str(WINDOW[0]),
                "--win-width", str(WINDOW[1]), "--device", DEV, "--once"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    b, h, w = GAN_SHAPE
    rec, im = (torch.from_numpy(rng.uniform(size=(b, h, w, 1)).astype(np.float32)).to(DEV)
               for _ in range(2))
    mask = torch.from_numpy(stroke_masks(rng, b, h, w)[..., None]).to(DEV)
    loss = float(discounted_l1_loss(rec, im, mask))
    launches = {"edt_envelope_pass": edt.launches,
                "distance_transform_edt_kernel": edt.mask_launches}

    check(np.isfinite(loss), f"discounted_l1_loss not finite: {loss}")
    masks = []
    for i in range(N_VOLS):
        mask_fn = os.path.join(out, f"ct{i}_mask.nii.gz")
        check(os.path.exists(mask_fn) and os.path.exists(os.path.join(out, f"ct{i}.done")),
              f"ct{i}: mask or .done marker missing")
        m, _, _ = nifti.load(mask_fn)
        check(m.shape == VOL_SHAPE and m.dtype == np.uint8 and set(np.unique(m)) <= {0, 255},
              f"ct{i}: mask {m.shape} {m.dtype} {np.unique(m)[:4]}")
        masks.append(m)
    positive = float(np.mean(masks[0] == 255))
    check(0.0 < positive < 1.0, f"degenerate mask: positive share {positive}")

    # where a served volume's time goes: file decode, device path, file encode
    t0 = time.perf_counter()
    nifti.load(os.path.join(watch, "ct0.nii.gz"))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nifti.save(os.path.join(work, "mask.nii.gz"), masks[0])
    encode_s = time.perf_counter() - t0
    segvol_s = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        # warm-up: cuDNN picks its algorithms anew for each math mode
        trainer.segment_volume(vols[0], window=WINDOW, input_size=(256, 256))
        t0 = time.perf_counter()
        trainer.segment_volumes(iter(vols), window=WINDOW, input_size=(256, 256))
        torch.cuda.synchronize()
        segvol_s[tf32] = (time.perf_counter() - t0) / N_VOLS
    torch.backends.cudnn.allow_tf32 = False

    cpu = UNet2D(UNet(**NET), device="cpu")
    cpu.load_model(model_fn)
    ref = cpu.segment_volume(vols[0], window=WINDOW, input_size=(256, 256), return_pred=True)
    agree = float(np.mean(ref == masks[0]))
    tn, fp, fn, tp = batch_binary_confusion_matrix(
        torch.from_numpy(masks[0][None] > 0), torch.from_numpy(ref[None] > 0))
    dice = float(dice_from_counts(tp, fp, fn)[0])
    print(f"serve: {N_VOLS} volumes {VOL_SHAPE} in {serve_s!r} s = "
          f"{serve_s / N_VOLS!r} s/volume (first call: decode + segment + encode, "
          f"cuDNN TF32 off)")
    print(f"per volume: decode {decode_s!r} s, encode {encode_s!r} s; segment_volumes "
          f"without file I/O {segvol_s[False]!r} s (TF32 off), {segvol_s[True]!r} s "
          f"(cuDNN TF32 on, torch's default)")
    print(f"card vs cpu mask: agreement {agree:.6f}, dice {dice:.6f}, "
          f"positive share {positive:.4f}; discounted_l1_loss {loss!r}; "
          f"EDT launches on the main path {launches}")
    check(agree >= MIN_AGREEMENT, f"card/cpu voxel agreement {agree} < {MIN_AGREEMENT}")
    check(all(n > 0 for n in launches.values()), "the main path skipped an EDT kernel")
    return launches


def _calibrate_final_bias_3d(net: torch.nn.Module, vol_dhw: np.ndarray) -> None:
    """The 3D net's counterpart of ``_calibrate_final_bias``: about a tenth
    of the voxels of four central 64^3 patches score >= 0.5."""
    p = PATCH3D
    d, h, w = vol_dhw.shape
    x = torch.from_numpy(vol_dhw[:p, h // 2 - p: h // 2 + p, w // 2 - p: w // 2 + p].copy())
    x = ct.window_ct(x.to(DEV), *WINDOW)
    x = x.reshape(p, 2, p, 2, p).permute(1, 3, 0, 2, 4).reshape(4, 1, p, p, p)
    net.use_final_activation = False
    with torch.inference_mode():
        logits = net(x)
    net.use_final_activation = True
    q = float(torch.quantile(logits.float().flatten()[::7], 0.9))
    with torch.no_grad():
        net.final_conv.bias -= q


def _probs(trainer: UNet3D, vol_dhw: np.ndarray) -> torch.Tensor:
    """Windowed sliding-window probabilities of a (D, H, W) HU volume, on
    the trainer's device."""
    x = ct.window_ct(torch.from_numpy(vol_dhw).to(trainer.device), *WINDOW)
    with torch.inference_mode():
        return sw.sliding_window_inference(trainer.unet, x, patch_size=trainer.patch_size,
                                           overlap=trainer.sw_overlap)[..., 0]


def _agreement(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Share of equal voxels and Dice of two boolean masks."""
    a, b = a.flatten().cpu(), b.flatten().cpu()
    agree = float((a == b).float().mean())
    tn, fp, fn, tp = batch_binary_confusion_matrix(a[None], b[None])
    return agree, float(dice_from_counts(tp, fp, fn)[0])


class _Annotated(torch.nn.Module):
    """The net inside a profiler range, so its device time can be told from
    the blend's."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.profiler.record_function("unet3d"):
            return self.net(x)


# aten ops by what they do, matched on the op's name: the 3D path's and a
# train step's
OP_GROUPS_3D = (("conv", ("conv",)), ("group_norm", ("group_norm",)),
                ("relu", ("relu", "threshold", "clamp_min")), ("max_pool", ("max_pool",)),
                ("cat", ("aten::cat",)), ("copy", ("copy_", "to_copy")))
OP_GROUPS_TRAIN = (("conv backward", ("convolution_backward",)), ("conv forward", ("conv",)),
                   ("batch_norm", ("batch_norm",)), ("adam", ("_foreach_",)),
                   ("copy", ("copy_", "to_copy")))


def _profile_summary(prof, wall_ms: float, label: str, groups: tuple, ranges: tuple) -> str:
    """Device time of one profiled call: busy share, the device time inside
    each ``record_function`` range, aten ops by group (``other`` for the
    rest) and by name, and the top kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    ev = prof.key_averages()
    # a range's own device-side annotation is a span, not a kernel
    kernels = [e for e in ev if e.device_type == cuda and e.key not in ranges]
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        return f"{label}: no device time recorded"
    ops = [e for e in ev if e.device_type != cuda and e.key not in ranges
           and e.self_device_time_total > 0]
    by_group = defaultdict(float)
    for e in ops:
        by_group[next((g for g, keys in groups if any(k in e.key for k in keys)), "other")] += (
            e.self_device_time_total)

    def shares(items, n):
        return ", ".join(f"{k[:60]} {100 * v / total:.1f}%"
                         for k, v in sorted(items, key=lambda kv: -kv[1])[:n])

    in_ranges = [(r, sum(e.device_time_total for e in ev if e.key == r and e.device_type != cuda))
                 for r in ranges]
    return (f"{label}: wall {wall_ms:.2f} ms, device time {total / 1e3:.2f} ms (busy "
            f"{100 * total / 1e3 / wall_ms:.1f}%)\n"
            f"{label} ranges (device time inside): {shares(in_ranges, len(ranges))}\n"
            f"{label} ops by group: {shares(by_group.items(), len(groups) + 1)}\n"
            f"{label} top ops: {shares(((e.key, e.self_device_time_total) for e in ops), 12)}\n"
            f"{label} top kernels: "
            f"{shares(((e.key, e.self_device_time_total) for e in kernels), 8)}")


@contextlib.contextmanager
def _gn_counted():
    """Sets the group_norm launch count to 0 and yields a dict that holds,
    once the block ends, ``launches`` (read after a sync) and ``want``: 2
    launches for each GroupNorm of each ``UNet`` forward call made inside
    the block (a global forward hook counts them)."""
    norms = []

    def hook(m, args, out):
        if isinstance(m, UNet):
            norms.append(sum(isinstance(k, torch.nn.GroupNorm) for k in m.modules()))

    out = {}
    gn_ops.launches = 0
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield out
    finally:
        handle.remove()
        torch.cuda.synchronize()
        out.update(launches=gn_ops.launches, want=2 * sum(norms), net_calls=len(norms))


def phase_3d(rng: np.random.Generator, work: str) -> dict:
    """5. The 3D path; returns the group_norm launches of ``serve --mode
    3d`` and of one ``UNet3D.segment_volume``."""
    watch, out = os.path.join(work, "watch"), os.path.join(work, "out")
    os.makedirs(watch)
    vols = []  # (D, H, W), as the 3D path takes them
    for i in range(N_VOLS):
        vol = head_ct(rng, VOL3D_SHAPE)
        nifti.save(os.path.join(watch, f"ct{i}.nii.gz"), vol)
        vols.append(np.ascontiguousarray(np.transpose(vol, (2, 0, 1))))
    patch = (PATCH3D,) * 3

    net = UNet(**NET3D, dtype=torch.bfloat16)
    init_net(net, torch.Generator().manual_seed(SEED + 1))
    trainer = UNet3D(net, patch_size=patch, device=DEV)
    _calibrate_final_bias_3d(trainer.unet, vols[0])
    model_fn = os.path.join(work, "model3d.pt")
    trainer.save_model(model_fn)

    # the path: serve --mode 3d, counts at 0 just before and read just after
    edt.launches = edt.mask_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _gn_counted() as gn_serve:
        serve.main(["--watch-dir", watch, "--output-dir", out, "--model", model_fn,
                    "--mode", "3d", "--depth", str(NET3D["depth"]),
                    "--top-filter", str(NET3D["top_filter"]), "--patch", str(PATCH3D),
                    "--win-center", str(WINDOW[0]), "--win-width", str(WINDOW[1]),
                    "--device", DEV, "--once"])
    serve_s = time.perf_counter() - t0
    launches = {"edt_envelope_pass": edt.launches, "edt_mask_rows": edt.mask_launches,
                "group_norm_relu": gn_serve["launches"]}

    masks = []
    for i in range(N_VOLS):
        mask_fn = os.path.join(out, f"ct{i}_mask.nii.gz")
        check(os.path.exists(mask_fn) and os.path.exists(os.path.join(out, f"ct{i}.done")),
              f"3d ct{i}: mask or .done marker missing")
        m, _, _ = nifti.load(mask_fn)
        check(m.shape == VOL3D_SHAPE and m.dtype == np.uint8 and set(np.unique(m)) <= {0, 255},
              f"3d ct{i}: mask {m.shape} {m.dtype} {np.unique(m)[:4]}")
        masks.append(m)
    positive = float(np.mean(masks[0] == 255))
    check(0.0 < positive < 1.0, f"3d: degenerate mask: positive share {positive}")
    with _gn_counted() as gn_one:
        one = trainer.segment_volume(vols[0], window=WINDOW)
    served = float(np.mean(np.transpose(masks[0], (2, 0, 1)) == one))
    for label, c in (("serve --mode 3d", gn_serve), ("UNet3D.segment_volume", gn_one)):
        check(c["net_calls"] > 0 and c["launches"] == c["want"],
              f"3d: {label}: {c['launches']} group_norm launches for {c['net_calls']} net "
              f"calls, not {c['want']} (2 a GroupNorm)")
    check(served >= MIN_AGREEMENT, f"3d: served mask vs UNet3D.segment_volume {served}")
    t0 = time.perf_counter()
    nifti.load(os.path.join(watch, "ct0.nii.gz"))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nifti.save(os.path.join(work, "mask3d.nii.gz"), masks[0])
    encode_s = time.perf_counter() - t0
    print(f"serve --mode 3d: {N_VOLS} volumes {VOL3D_SHAPE} in {serve_s!r} s = "
          f"{serve_s / N_VOLS!r} s/volume (first call); per volume: decode {decode_s!r} s, "
          f"encode {encode_s!r} s; positive share {positive:.4f}; agreement with "
          f"UNet3D.segment_volume {served:.6f}; port kernel launches on the 3D path "
          f"{launches} ({gn_serve['net_calls']} net calls; one segment_volume: "
          f"{gn_one['launches']} group_norm launches in {gn_one['net_calls']} net calls)")

    # blend geometry at full size: an identity network, card and CPU
    x = torch.from_numpy(rng.uniform(size=vols[0].shape).astype(np.float32))
    on_card = sw.sliding_window_inference(lambda p: p, x.to(DEV), patch_size=patch,
                                          overlap=0.5)[..., 0].cpu()
    on_cpu = sw.sliding_window_inference(lambda p: p, x, patch_size=patch, overlap=0.5)[..., 0]
    err_cc, err_id = float((on_card - on_cpu).abs().max()), float((on_card - x).abs().max())
    print(f"blend identity {tuple(x.shape)}: card vs cpu max err {err_cc!r}, "
          f"vs input {err_id!r}")
    check(err_cc <= 1e-6 and err_id <= 1e-4, "3d: identity blend is off")
    del x, on_card, on_cpu

    # float32 card vs CPU on a crop (the whole volume is too slow on the CPU)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {}
    for dev in (DEV, "cpu"):
        f32[dev] = UNet3D(UNet(**NET3D), patch_size=patch, device=dev)
        f32[dev].unet.load_state_dict(trainer.get_state_dict())
    crop = np.ascontiguousarray(vols[0][CROP3D])
    p_card, p_cpu = _probs(f32[DEV], crop).cpu(), _probs(f32["cpu"], crop)
    err = float((p_card - p_cpu).abs().max())
    agree, dice = _agreement(p_card >= 0.5, p_cpu >= 0.5)
    print(f"3d float32 crop {crop.shape} card (TF32 off) vs cpu: probability max err "
          f"{err!r}, mask agreement {agree:.6f}, dice {dice:.6f}")
    check(err <= 1e-4 and agree >= MIN_AGREEMENT, "3d: float32 card and cpu disagree")

    # bf16 against float32, on the card, whole volume
    p_bf16, p_f32 = _probs(trainer, vols[0]), _probs(f32[DEV], vols[0])
    agree, dice = _agreement(p_bf16 >= 0.5, p_f32 >= 0.5)
    print(f"3d bf16 vs float32 (TF32 off) on the card {vols[0].shape}: probability max diff "
          f"{float((p_bf16 - p_f32).abs().max())!r}, mask agreement {agree:.6f}, dice {dice:.6f}")
    del f32, p_bf16, p_f32
    torch.backends.cudnn.allow_tf32 = True  # torch's default, the serve's setting
    torch.backends.cuda.matmul.allow_tf32 = False

    # warm times in bf16 (one warm-up call first)
    trainer.segment_volume(vols[0], window=WINDOW)
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for v in vols:
        t0 = time.perf_counter()
        trainer.segment_volume(v, window=WINDOW)
        lat.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    trainer.segment_volumes(iter(vols), window=WINDOW)
    torch.cuda.synchronize()
    pipe_s = (time.perf_counter() - t0) / N_VOLS
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    n_patches = len(sw.make_patch_coords(vols[0].shape, patch, 0.5))
    with torch.inference_mode():
        flops = compiled_flops(trainer.unet, torch.zeros((1, 1) + patch, device=DEV)) * n_patches
    tflops = flops / min(lat) / 1e12
    print(f"3d bf16 warm: segment_volume latency {lat!r} s; segment_volumes pipelined "
          f"{pipe_s!r} s/volume; peak device memory {peak_gb:.2f} GiB "
          f"(max_memory_allocated); network {flops / 1e12:.2f} TFLOP per volume "
          f"({n_patches} patches) = {tflops:.1f} TFLOP/s at the best latency, "
          f"{100 * tflops / PEAK['bf16']:.2f}% of the dense bf16 peak; "
          f"nvidia-smi after: {smi}")

    trainer.unet = _Annotated(trainer.unet)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.segment_volume(vols[1], window=WINDOW)
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(_profile_summary(prof, wall_ms, "3d profile (bf16, one warm segment_volume)",
                           OP_GROUPS_3D, ("unet3d",)))
    return {"serve3d": gn_serve["launches"], "segment_volume": gn_one["launches"]}


def load_train_cfg(out_dir: str) -> dict:
    """``configs/unet2d.json`` cut to 2 folds of 2 epochs, writing under
    ``out_dir``."""
    with open(TRAIN_CFG) as f:
        cfg = json.load(f)
    cfg["path"] = {"DATA": out_dir, "OUTPUT": out_dir}
    cfg["split"]["n_fold"] = 2
    cfg["train"]["n_epoch"] = 2
    return cfg


def _fold_data(cfg: dict):
    size = cfg["data"]["size"]
    return [(synthetic_ich_slices(n_slices=TRAIN_FOLD[0], size=size, n_volumes=TRAIN_FOLD[1],
                                  seed=SEED + k),
             synthetic_ich_slices(n_slices=TEST_FOLD[0], size=size, n_volumes=TEST_FOLD[1],
                                  seed=SEED + 100 + k))
            for k in range(cfg["split"]["n_fold"])]


def _trainer(cfg: dict, device, net: dict | None = None, mesh=None, **overrides) -> UNet2D:
    """A trainer of the config's net and training settings, ``net`` and
    ``overrides`` replacing some of them, on ``mesh`` if given."""
    tr = {**cfg["train"], **overrides}
    return UNet2D(build_unet_from_cfg({**cfg["net"], **(net or {})}, seed=SEED, device=device),
                  n_epoch=tr["n_epoch"], batch_size=tr["batch_size"], lr=tr["lr"],
                  lr_scheduler=tr["lr_scheduler"], lr_scheduler_kwargs=tr["lr_scheduler_kwargs"],
                  loss_fn=tr["loss_fn"], loss_fn_kwargs=tr["loss_fn_kwargs"],
                  weight_decay=tr["weight_decay"], seed=SEED,
                  augment_fn=tr.get("augment_fn"), device=device, mesh=mesh)


def _train_kfold(cfg: dict, folds: list) -> None:
    """(a) the k-fold experiment end to end; returns the keyed dropout
    kernel's launches on it."""
    edt.launches = edt.mask_launches = dropout_ops.launches = gn_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_supervised_2d(cfg, datasets_by_fold=lambda k: folds[k], device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in range(cfg["split"]["n_fold"]):
        fold = os.path.join(out, f"Fold_{k + 1}")
        for name in ("outputs.json", "trained_unet.bin", "log.txt",
                     "pred/slice_prediction_scores.csv", "pred/volume_prediction_scores.csv"):
            check(os.path.exists(os.path.join(fold, name)), f"train2d fold {k + 1}: no {name}")
        check(not os.path.exists(os.path.join(fold, "checkpoint.bin")),
              f"train2d fold {k + 1}: checkpoint not deleted")
        bmps = sum(f.endswith(".bmp") for _, _, fs in os.walk(os.path.join(fold, "pred"))
                   for f in fs)
        check(bmps == TEST_FOLD[0], f"train2d fold {k + 1}: {bmps} BMPs, not {TEST_FOLD[0]}")
        with open(os.path.join(fold, "pred/slice_prediction_scores.csv")) as f:
            n_rows = sum(1 for _ in f) - 1
        check(n_rows == TEST_FOLD[0], f"train2d fold {k + 1}: {n_rows} slice rows")
        with open(os.path.join(fold, "outputs.json")) as f:
            o = json.load(f)
        hist = o["train"]["evolution"]
        losses = [row[1] for row in hist]
        print(f"train2d fold {k + 1}: epoch losses {losses!r}, validation Dice per epoch "
              f"{[row[2] for row in hist]!r}, test Dice {o['eval']['dice']['all']!r} "
              f"(positive {o['eval']['dice']['positive']!r}), train time "
              f"{o['train']['time']!r} s, evaluate {o['eval']['time']!r} s")
        check(all(np.isfinite(losses)) and losses[1] < losses[0],
              f"train2d fold {k + 1}: the mean loss did not fall {losses}")
    for name in ("average_scores.txt", "all_volume_prediction.csv", "config.json"):
        check(os.path.exists(os.path.join(out, name)), f"train2d: no {name}")
    with open(os.path.join(out, "average_scores.txt")) as f:
        avg = f.read().strip().replace("\n", "; ")
    print(f"train2d k-fold: {cfg['split']['n_fold']} folds x {cfg['train']['n_epoch']} epochs "
          f"in {wall!r} s ({avg}); port kernel launches on the training path "
          f"{{'edt_envelope_pass': {edt.launches}, 'edt_mask_rows': {edt.mask_launches}, "
          f"'keyed_dropout': {dropout_ops.launches}, 'group_norm_relu': {gn_ops.launches}}}")
    check(gn_ops.launches == 0, "train2d: the group_norm kernels ran on a BatchNorm net")
    drops = cfg["net"]["depth"]  # the down blocks and the bottleneck
    check(dropout_ops.launches > 0 and dropout_ops.launches % (2 * drops) == 0,
          f"train2d: {dropout_ops.launches} dropout launches, not 2 x {drops} a step")
    return dropout_ops.launches


def _hold_run(cfg: dict, dev, x, threads: int) -> dict:
    """The step-1 loss and gradient at the fresh weights, then three steps
    on a fresh copy of the same weights, with ``threads`` CPU threads."""
    torch.set_num_threads(threads)
    t = _trainer(cfg, dev, batch_size=HOLD_BATCH, net={"p_dropout": 0.0})
    t.unet.train()
    xb, yb = (torch.from_numpy(a)[..., None].to(t.device) for a in (x.images, x.masks))
    loss = t.loss(t.unet(xb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), yb)
    loss.backward()
    grad = torch.cat([p.grad.flatten().cpu() for p in t.unet.parameters()])
    t = _trainer(cfg, dev, n_epoch=3, batch_size=HOLD_BATCH, net={"p_dropout": 0.0})
    t.train(x.device_cache(t.device))
    flat = lambda ts: torch.cat([v.detach().flatten().cpu() for v in ts])  # noqa: E731
    return {"loss1": float(loss.detach()), "grad": grad,
            "losses": [row[1] for row in t.outputs["train"]["evolution"]],
            "params": flat(t.unet.parameters()),
            "stats": flat(b for b in t.unet.buffers() if b.is_floating_point()),
            "lrs": [t.state.schedule(i) for i in range(3)]}


def _train_hold(cfg: dict, fold) -> None:
    """(b) three full-width train steps on the card and on the CPU.

    At the fresh weights the Dice loss's gradient is nearly constant over
    the pixels and BatchNorm's backward subtracts that constant, so most
    weight gradients are mostly float32 rounding: two CPU runs that differ
    only in their thread count already disagree by a few percent. The card
    is held against the CPU as closely as the CPU agrees with itself under
    another summation order, and Adam bounds what is left."""
    torch.backends.cudnn.allow_tf32 = False
    x = fold.subset(np.arange(HOLD_BATCH))
    n = torch.get_num_threads()
    card = _hold_run(cfg, DEV, x, n)
    cpu = _hold_run(cfg, "cpu", x, n)
    ref = _hold_run(cfg, "cpu", x, max(1, n // 2))
    torch.set_num_threads(n)
    torch.backends.cudnn.allow_tf32 = True

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    loss1 = abs(card["loss1"] - cpu["loss1"]) / abs(cpu["loss1"])
    traj = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    traj_ref = max(abs(a - b) / abs(b) for a, b in zip(ref["losses"], cpu["losses"]))
    g, g_ref = rel(card["grad"], cpu["grad"]), rel(ref["grad"], cpu["grad"])
    st, st_ref = rel(card["stats"], cpu["stats"]), rel(ref["stats"], cpu["stats"])
    w, w_ref = rel(card["params"], cpu["params"]), rel(ref["params"], cpu["params"])
    d = (card["params"] - cpu["params"]).abs()
    # bias-corrected Adam moves a weight by at most 1.004 lr a step for t <= 3
    bound = 2 * 1.005 * sum(cpu["lrs"]) + 1e-6
    print(f"train2d step hold, full width, batch {HOLD_BATCH}, TF32 off, card vs cpu "
          f"({n} threads; reference: cpu with {max(1, n // 2)} threads vs {n}): step-1 loss rel "
          f"diff {loss1!r} (tolerance 1e-6); losses over 3 steps card {card['losses']!r} cpu "
          f"{cpu['losses']!r}, max rel diff {traj!r} (reference {traj_ref!r}, tolerance 2e-4); "
          f"step-1 gradient rel L2 diff {g!r} (reference {g_ref!r}, tolerance 10x the "
          f"reference); running stats rel L2 diff after 3 steps {st!r} (reference {st_ref!r}, "
          f"tolerance 10x); weights rel L2 diff {w!r} (reference {w_ref!r}), max |diff| "
          f"{float(d.max())!r}, share within 1e-4 {float((d <= 1e-4).float().mean())!r} "
          f"(tolerance: all within {bound!r}, Adam's bound)")
    check(loss1 <= 1e-6 and traj <= 2e-4, "train2d: card and cpu losses disagree")
    check(g <= max(10 * g_ref, 1e-6) and st <= max(10 * st_ref, 1e-6),
          "train2d: card and cpu gradients disagree")
    check(float(d.max()) <= bound, "train2d: a weight moved beyond Adam's bound")


def _warp_hold(cfg: dict, fold) -> None:
    """(c) the config's Compose with injected (m, o), card against CPU."""
    spec = cfg["data"]["augmentation"]["train"]
    keys = prng.split(K(SEED), len(spec))
    b, size = TIMED_BATCHES[0], cfg["data"]["size"]
    params = [t.affine_params(k, b, (size, size))
              for k, t in zip(keys, build_pipeline(spec).transforms)]

    def injected():
        pipe = build_pipeline(spec)
        for t, (m, o) in zip(pipe.transforms, params):
            t.affine_params = lambda key, bb, hw, m=m, o=o: (m, o)
        return pipe

    img, mask = (torch.from_numpy(a[:b]) for a in (fold.images, fold.masks))
    want = injected()(K(SEED), img, mask)
    got = injected()(K(SEED), img.to(DEV), mask.to(DEV))
    err = float((got[0].cpu() - want[0]).abs().max())
    mask_eq = bool(torch.equal(got[1].cpu(), want[1]))
    print(f"train2d warp hold {tuple(img.shape)}: masks equal {mask_eq}, image max err {err!r} "
          f"(tolerance 1e-5)")
    check(mask_eq and err <= 1e-5, "train2d: card and cpu warps disagree")


def _step_times(cfg: dict, fold) -> dict:
    """(d) warm ms per step at each batch with TF32 on and off, peak memory
    and FLOPs; returns the warm trainer at batch 16 with TF32 on."""
    aug = build_pipeline(cfg["data"]["augmentation"]["train"])
    data = fold.device_cache(DEV)
    out = {}
    for bs in TIMED_BATCHES:
        t = _trainer(cfg, DEV, batch_size=bs, augment_fn=aug)
        state = t._train_state(max(1, len(fold) // bs))
        plan = np.random.default_rng(SEED).integers(0, len(fold), size=(4, bs))
        batches = list(t._batches(data, plan))
        t.unet.train()
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            n = 10 if bs <= 16 else 4
            for i in range(3):  # warm-up: cuDNN picks its algorithms per math mode
                t._train_step(state, batches[i % 4], K(i))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(n):
                t._train_step(state, batches[i % 4], K(i))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n * 1e3
            out[(bs, tf32)] = (ms, torch.cuda.max_memory_allocated() / 2**30)
        flops = compiled_flops(t._train_step, state, batches[0], K(0))
        for tf32 in (True, False):
            ms, peak = out[(bs, tf32)]
            print(f"train2d step, batch {bs}, cuDNN TF32 {'on' if tf32 else 'off'}: "
                  f"{ms!r} ms/step = {bs / ms * 1e3!r} slices/s; peak device memory "
                  f"{peak!r} GiB; {flops / 1e9!r} GFLOP per step (FlopCounterMode, forward and "
                  f"backward) = {flops / ms / 1e9!r} TFLOP/s, "
                  f"{100 * flops / ms / 1e9 / (PEAK['tf32'] if tf32 else PEAK['fp32'])!r}%"
                  f" of the dense {'TF32' if tf32 else 'float32'} peak")
        t.unet.eval()
        if bs == TIMED_BATCHES[0]:
            warm = t
        del t, state, batches
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"train2d nvidia-smi after the timed steps: {smi}")
    return warm


def _epoch_times(cfg: dict, train, test) -> None:
    aug = build_pipeline(cfg["data"]["augmentation"]["train"])
    train, test = train.device_cache(DEV), test.device_cache(DEV)
    times = {}
    _trainer(cfg, DEV, n_epoch=1, augment_fn=aug).train(train)  # warm-up
    for valid in (None, test):
        t = _trainer(cfg, DEV, n_epoch=1, augment_fn=aug)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(train, valid_dataset=valid)
        torch.cuda.synchronize()
        times[valid is not None] = time.perf_counter() - t0
    print(f"train2d epoch of {len(train)} slices at batch {cfg['train']['batch_size']}, TF32 on: "
          f"{times[False]!r} s without validation, {times[True]!r} s with validation of "
          f"{len(test)} slices")


TRAIN_RANGES = ("augment", "loss", "dropout", "Optimizer.step#Adam.step")


def _train_profile(t: UNet2D, fold) -> None:
    """(e) one warm step (batch 16, TF32 on) under torch.profiler; the warp
    is the ``augment`` range."""
    data = fold.device_cache(DEV)
    state = t._train_state(max(1, len(fold) // t.batch_size))
    batch = next(t._batches(data, np.arange(t.batch_size)[None]))
    t.unet.train()
    for i in range(3):
        t._train_step(state, batch, K(i))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t._train_step(state, batch, K(3))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t.unet.eval()
    print(_profile_summary(prof, wall_ms, f"train2d profile (one warm step, batch {t.batch_size}, "
                           f"TF32 on)", OP_GROUPS_TRAIN, TRAIN_RANGES))


def phase_train2d(work: str) -> int:
    cfg = load_train_cfg(work)
    t0 = time.perf_counter()
    folds = _fold_data(cfg)
    print(f"train2d data: {len(folds)} folds of {TRAIN_FOLD[0]} + {TEST_FOLD[0]} synthetic "
          f"slices at {cfg['data']['size']}^2 in {time.perf_counter() - t0!r} s")
    launches = _train_kfold(cfg, folds)
    _train_hold(cfg, folds[0][0])
    _warp_hold(cfg, folds[0][0])
    warm = _step_times(cfg, folds[0][0])
    _epoch_times(cfg, *folds[0])
    _train_profile(warm, folds[0][0])
    return launches


def load_train3d_cfg(work: str) -> dict:
    """``configs/unet3d.json`` cut to ``TRAIN3D_EPOCHS`` epochs of
    ``TRAIN3D_STEPS`` steps, reading and writing under ``work``."""
    with open(TRAIN3D_CFG) as f:
        cfg = json.load(f)
    cfg["path"] = {"DATA": os.path.join(work, "data"), "OUTPUT": os.path.join(work, "out")}
    cfg["train"]["n_epoch"] = TRAIN3D_EPOCHS
    cfg["train"]["steps_per_epoch"] = TRAIN3D_STEPS
    return cfg


def _write_segich3d(rng: np.random.Generator, cfg: dict) -> None:
    """A SegICH 3D tree of the config's patients: ``ct_scans/<pid>.nii``
    (int16 HU) and ``masks/<pid>.nii`` at ``CT3D_SPACING``."""
    affine = np.diag(list(CT3D_SPACING) + [1.0])
    for pid in cfg["dataset"]["patient_numbers"]:
        vol, mask = head_ct_and_mask(rng, CT3D_SHAPE)
        nifti.save(os.path.join(cfg["path"]["DATA"], "ct_scans", f"{pid:03}.nii"),
                   vol.astype(np.int16), affine)
        nifti.save(os.path.join(cfg["path"]["DATA"], "masks", f"{pid:03}.nii"), mask, affine)


def _trainer3d(cfg: dict, device, patch, batch: int, dtype=torch.float32, remat=False,
               augment_fn=None) -> UNet3D:
    """The config's trainer and net (seeded), at another patch, batch,
    dtype or remat, with ``augment_fn``."""
    net = build_unet3d_from_cfg(cfg["net"], seed=SEED, device=device, dtype=dtype, remat=remat)
    return build_trainer3d(cfg, net, device, patch_size=patch, batch_size=batch,
                           augment_fn=augment_fn)


def _train3d_driver(cfg: dict) -> None:
    """(a) ``run_supervised_3d`` end to end: its artifacts and a falling
    mean loss."""
    edt.launches = edt.mask_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _gn_counted() as gn_run:
        trainer = run_supervised_3d(cfg, device=DEV)
    wall = time.perf_counter() - t0
    out = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    for name in ("volume_prediction_scores.csv", "trained_unet3d.bin", "outputs.json"):
        check(os.path.exists(os.path.join(out, name)), f"train3d: no {name}")
    with open(os.path.join(out, "volume_prediction_scores.csv")) as f:
        n_rows = sum(1 for _ in f) - 1
    n_test = max(1, int(0.2 * len(cfg["dataset"]["patient_numbers"])))
    check(n_rows == n_test, f"train3d: {n_rows} test rows, not {n_test}")
    with open(os.path.join(out, "outputs.json")) as f:
        o = json.load(f)
    losses = [row[1] for row in o["train"]["evolution"]]
    print(f"train3d run_supervised_3d: {cfg['train']['n_epoch']} epochs x "
          f"{cfg['train']['steps_per_epoch']} steps at batch {cfg['train']['batch_size']}, "
          f"patch {tuple(cfg['data']['patch_size'])}, float32 (TF32 on), in {wall!r} s (load, "
          f"train, evaluate, save); epoch losses {losses!r}; test Dice "
          f"{o['eval']['dice']['all']!r}, IoU {o['eval']['iou']['all']!r}; train time "
          f"{o['train']['time']!r} s, evaluate {o['eval']['time']!r} s; the net in eval mode "
          f"after training {not trainer.unet.training}; port kernel launches on the path "
          f"{{'edt_envelope_pass': {edt.launches}, 'edt_mask_rows': {edt.mask_launches}, "
          f"'group_norm_relu': {gn_run['launches']}}} in {gn_run['net_calls']} net calls")
    check(gn_run["net_calls"] > 0 and gn_run["launches"] > 0
          and gn_run["launches"] % (gn_run["want"] // gn_run["net_calls"]) == 0,
          f"train3d: {gn_run['launches']} group_norm launches, not 2 a GroupNorm a pass")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train3d: the mean loss did not fall {losses}")
    check(not trainer.unet.training, "train3d: the net is left in train mode")


def _hold3d_run(cfg: dict, dev, imgs: np.ndarray, msks: np.ndarray, threads: int) -> dict:
    """Three train steps on one batch from the seeded weights (no
    augmentation, no dropout), with ``threads`` CPU threads: the losses,
    the step-1 gradient and the weights after."""
    torch.set_num_threads(threads)
    t = _trainer3d(cfg, dev, HOLD3D_PATCH, HOLD3D_BATCH)
    state = t._train_state(t.steps_per_epoch_cfg)
    t.unet.train()
    x, y = (torch.from_numpy(a).to(t.device) for a in (imgs, msks))
    losses = []
    for i in range(3):
        losses.append(float(t._step(state, x, y, K(i))))
        if i == 0:
            grad = torch.cat([p.grad.flatten().cpu() for p in t.unet.parameters()])
    return {"losses": losses, "grad": grad,
            "params": torch.cat([p.detach().flatten().cpu() for p in t.unet.parameters()]),
            "lrs": [state.schedule(i) for i in range(3)]}


def _train3d_hold(cfg: dict, train) -> None:
    """(b) three full-width train steps on the card and on the CPU, TF32
    off, held against the CPU's own spread across thread counts (as phase
    6's hold) and Adam's bound."""
    imgs, msks = sample_patches(np.random.default_rng(SEED), train, HOLD3D_BATCH, HOLD3D_PATCH,
                                cfg["train"]["pos_frac"])
    torch.backends.cudnn.allow_tf32 = False
    n = torch.get_num_threads()
    card = _hold3d_run(cfg, DEV, imgs, msks, n)
    cpu = _hold3d_run(cfg, "cpu", imgs, msks, n)
    ref = _hold3d_run(cfg, "cpu", imgs, msks, max(1, n // 2))
    torch.set_num_threads(n)
    torch.backends.cudnn.allow_tf32 = True

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    loss1 = abs(card["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    traj = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    traj_ref = max(abs(a - b) / abs(b) for a, b in zip(ref["losses"], cpu["losses"]))
    g, g_ref = rel(card["grad"], cpu["grad"]), rel(ref["grad"], cpu["grad"])
    w, w_ref = rel(card["params"], cpu["params"]), rel(ref["params"], cpu["params"])
    d = (card["params"] - cpu["params"]).abs()
    bound = 2 * 1.005 * sum(cpu["lrs"]) + 1e-6
    print(f"train3d step hold, full width, batch {HOLD3D_BATCH} of {HOLD3D_PATCH}, TF32 off, "
          f"card vs cpu ({n} threads; reference: cpu with {max(1, n // 2)} threads vs {n}): "
          f"step-1 loss rel diff {loss1!r} (tolerance 1e-5); losses over 3 steps card "
          f"{card['losses']!r} cpu {cpu['losses']!r}, max rel diff {traj!r} (reference "
          f"{traj_ref!r}, tolerance 2e-4); step-1 gradient rel L2 diff {g!r} (reference "
          f"{g_ref!r}, tolerance 10x the reference); weights rel L2 diff {w!r} (reference "
          f"{w_ref!r}), max |diff| {float(d.max())!r}, share within 1e-4 "
          f"{float((d <= 1e-4).float().mean())!r} (tolerance: all within {bound!r}, Adam's "
          f"bound)")
    check(loss1 <= 1e-5 and traj <= 2e-4, "train3d: card and cpu losses disagree")
    check(g <= max(10 * g_ref, 1e-6), "train3d: card and cpu gradients disagree")
    check(float(d.max()) <= bound, "train3d: a weight moved beyond Adam's bound")


def _train3d_aug_sampler_hold(cfg: dict, train) -> None:
    """(c) ``default_patch_augmentation`` and the device sampler, each
    drawing from one key, card against CPU: the augmented batch (the
    ``AffineAugment3D`` warp and the brightness jitter) and the sampler's
    draws, starts and gathered patches."""
    _, patch, b, _, _ = TIMED3D[0]
    aug = default_patch_augmentation()
    imgs, msks = sample_patches(np.random.default_rng(SEED + 1), train, b, patch,
                                cfg["train"]["pos_frac"])
    x, y = torch.from_numpy(imgs)[..., None], torch.from_numpy(msks)[..., None]
    want = aug(K(SEED), x, y)
    got = aug(K(SEED), x.to(DEV), y.to(DEV))
    err = float((got[0].cpu() - want[0]).abs().max())
    mask_eq = bool(torch.equal(got[1].cpu(), want[1]))
    print(f"train3d default_patch_augmentation hold {tuple(x.shape)} from one key: masks equal "
          f"{mask_eq}, image max err {err!r} (tolerance 1e-5)")
    check(mask_eq and err <= 1e-5, "train3d: card and cpu augmentations disagree")

    out = {}
    for dev in ("cpu", DEV):
        s = DevicePatchSampler(train, patch, cfg["train"]["pos_frac"], device=dev)
        draws = s.draw(K(SEED), 64)
        vi, start = s.starts(draws)
        out[dev] = [draws, vi.cpu(), start.cpu()] + [a.cpu() for a in s.gather(vi, start)]
        del s
    equal = all(torch.equal(a, c) for a, c in zip(out["cpu"], out[DEV]))
    print(f"train3d DevicePatchSampler hold, 64 draws of {patch} over {len(train)} volumes from "
          f"one key: draws, starts and patches equal on card and cpu {equal}")
    check(equal, "train3d: card and cpu patch samplers disagree")


def _train3d_step_times(cfg: dict, train):
    """(d) warm ms per step of each ``TIMED3D`` cell through the trainer's
    step (device sampler, the JAX bench arm's default patch augmentation),
    FLOPs and their rate, peak memory; the host and device samplers' ms
    per batch; the group_norm launches of the timed steps, 2 a GroupNorm in
    the forward, as many in the backward and, with remat, in the recompute.
    Returns the warm (trainer, draw, state) of the first cell and the
    launches by cell."""
    torch.backends.cudnn.allow_tf32 = True
    samplers, warm, gn_launches = {}, None, {}
    for cell, patch, bs, dtype, remat in TIMED3D:
        if patch not in samplers:
            samplers[patch] = DevicePatchSampler(train, patch, cfg["train"]["pos_frac"],
                                                 device=DEV)
        t = _trainer3d(cfg, DEV, patch, bs, dtype, remat,
                       augment_fn=default_patch_augmentation())
        state = t._train_state(t.steps_per_epoch_cfg)
        draw = lambda gen, s=samplers[patch], bs=bs: s(gen, bs)  # noqa: E731
        t.unet.train()
        for i in range(3):  # warm-up: cuDNN picks its algorithms
            t._sample_step(state, draw, K(i))
        n = 4 if bs >= 64 else 10
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _gn_counted() as c:
            for i in range(n):
                t._sample_step(state, draw, K(3 + i))
        ms = (time.perf_counter() - t0) / n * 1e3
        gn_launches[cell] = c["launches"]
        check(c["net_calls"] == n and c["launches"] == c["want"] * (2 + remat),
              f"{cell}: {c['launches']} group_norm launches in {n} steps, not "
              f"{c['want'] * (2 + remat)} ({c['net_calls']} net calls)")
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops = compiled_flops(t._sample_step, state, draw, K(99))
        peak_tf, peak_name = ((PEAK["tf32"], "TF32") if dtype == torch.float32
                              else (PEAK["bf16"], "bf16"))
        tflops = flops / ms / 1e9
        print(f"{cell}: patch {patch} batch {bs} {str(dtype)[6:]}"
              f"{' (TF32 on)' if dtype == torch.float32 else ''}{' remat' if remat else ''}: "
              f"{ms!r} ms/step = {bs / ms * 1e3!r} patches/s = "
              f"{bs * int(np.prod(patch)) / ms / 1e3!r} Mvoxels/s; {flops / 1e12!r} TFLOP per "
              f"step (FlopCounterMode: forward, backward{', the recompute' if remat else ''}) "
              f"= {tflops!r} TFLOP/s, {100 * tflops / peak_tf!r}% of the dense {peak_name} peak; "
              f"peak device memory {peak!r} GiB; group_norm launches over the {n} timed steps "
              f"{c['launches']}")
        if cell == TIMED3D[0][0]:
            warm = (t, draw, state)
        elif patch == SAMPLER_PATCH and bs == SAMPLER_BATCH:
            _sampler_times(t, train, samplers[patch], cfg["train"]["pos_frac"])
        t.unet.eval()
        del t, state
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"train3d nvidia-smi after the timed steps: {smi}")
    return warm, gn_launches


def _sampler_times(t: UNet3D, train, sampler, pos_frac: float) -> None:
    """Host ``sample_patches`` (with the copy to the card) against the
    device sampler, ms per batch of ``SAMPLER_BATCH`` x ``SAMPLER_PATCH``."""
    rng = np.random.default_rng(SEED)
    times = {}
    for name in ("host", "device"):
        def one(i):
            if name == "host":
                return [t._to_device(a) for a in sample_patches(
                    rng, train, SAMPLER_BATCH, SAMPLER_PATCH, pos_frac)]
            return sampler(K(i), SAMPLER_BATCH)

        one(0)  # warm-up (the host sampler's positive-voxel cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            one(i)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / 10 * 1e3
    print(f"train3d patch samplers, batch {SAMPLER_BATCH} of {SAMPLER_PATCH} from "
          f"{len(train)} volumes: host sample_patches + copy {times['host']!r} ms/batch, "
          f"DevicePatchSampler {times['device']!r} ms/batch")


OP_GROUPS_TRAIN3D = (("conv backward", ("convolution_backward",)), ("conv forward", ("conv",)),
                     ("group_norm", ("group_norm",)), ("adam", ("_foreach_",)),
                     ("gather", ("index", "gather")), ("copy", ("copy_", "to_copy")))
TRAIN3D_RANGES = ("sample", "augment", "loss", "Optimizer.step#Adam.step")


def _train3d_profile(t: UNet3D, draw, state) -> None:
    """(e) one warm step of the config's cell under torch.profiler."""
    t.unet.train()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t._sample_step(state, draw, K(200))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t.unet.eval()
    print(_profile_summary(prof, wall_ms, f"train3d profile (one warm step, {TIMED3D[0][0]}, "
                           f"TF32 on)", OP_GROUPS_TRAIN3D, TRAIN3D_RANGES))


def phase_train3d(rng: np.random.Generator, work: str) -> dict:
    """7. 3D patch training; returns the group_norm launches of the timed
    steps by cell."""
    cfg = load_train3d_cfg(work)
    t0 = time.perf_counter()
    _write_segich3d(rng, cfg)
    print(f"train3d data: {len(cfg['dataset']['patient_numbers'])} synthetic CTs {CT3D_SHAPE} at "
          f"spacing {CT3D_SPACING} written in {time.perf_counter() - t0!r} s")
    _train3d_driver(cfg)
    t0 = time.perf_counter()
    ds = load_segich_3d(cfg["path"]["DATA"], cfg["dataset"]["patient_numbers"],
                        window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
                        out_spacing=tuple(cfg["data"]["out_spacing"]))
    train, _ = split_test(ds)
    print(f"train3d load_segich_3d: {len(ds)} volumes, resampled to {ds.volumes[0].shape}, in "
          f"{time.perf_counter() - t0!r} s; {len(train)} train volumes")
    _train3d_hold(cfg, train)
    _train3d_aug_sampler_hold(cfg, train)
    warm, gn_launches = _train3d_step_times(cfg, train)
    _train3d_profile(*warm)
    return gn_launches


# -- phase 8: SSL pretraining ---------------------------------------------------------

def load_ssl_cfg(path: str, work: str) -> dict:
    """An SSL config (its width as it is) reading the RSNA slices under
    ``work/rsna`` and writing under ``work/out``."""
    with open(path) as f:
        cfg = json.load(f)
    cfg["path"] = {"RSNA_DATA": os.path.join(work, "rsna", "stage_2_train"),
                   "DATA": work, "OUTPUT": os.path.join(work, "out")}
    cfg["split"]["n_fold"] = 2
    return cfg


def _rsna_data(cfg: dict, work: str) -> LabeledSliceDataset:
    """``RSNA_SLICES`` synthetic RSNA DICOMs of ``RSNA_SIZE``^2 written,
    pivoted and loaded at the config's size."""
    t0 = time.perf_counter()
    label_csv = write_rsna_tree(os.path.join(work, "rsna"), n_slices=RSNA_SLICES, size=RSNA_SIZE,
                                seed=SEED)
    t1 = time.perf_counter()
    n = write_rsna_slice_info(label_csv, os.path.join(cfg["path"]["RSNA_DATA"], "slice_info.csv"))
    data = load_rsna_slices(cfg["path"]["RSNA_DATA"],
                            window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
                            size=cfg["data"]["size"])
    t2 = time.perf_counter()
    check(n == RSNA_SLICES and data.images.shape == (RSNA_SLICES,) + (cfg["data"]["size"],) * 2,
          f"ssl: RSNA slices {n} rows, images {data.images.shape}")
    check(float(data.images.std()) > 0.05 and 0 < data.labels[:, 0].sum() < len(data),
          "ssl: degenerate RSNA slices or labels")
    print(f"ssl data: write_rsna_tree {RSNA_SLICES} DICOMs of {RSNA_SIZE}^2 in {t1 - t0!r} s; "
          f"write_rsna_slice_info + load_rsna_slices at {cfg['data']['size']}^2 in {t2 - t1!r} s; "
          f"{int(data.labels[:, 0].sum())} positive slices")
    return data


def _ssl_folds(cfg: dict) -> list:
    size = cfg["data"]["size"]
    return [(synthetic_ich_slices(n_slices=SSL_FOLD[0][0], size=size, n_volumes=SSL_FOLD[0][1],
                                  seed=SEED + 200 + k).device_cache(DEV),
             synthetic_ich_slices(n_slices=SSL_FOLD[1][0], size=size, n_volumes=SSL_FOLD[1][1],
                                  seed=SEED + 300 + k))
            for k in range(cfg["split"]["n_fold"])]


def _edt_launches() -> dict:
    return {"edt_envelope_pass": edt.launches, "distance_transform_edt_kernel": edt.mask_launches}


def _ssl_cr_driver(cfg: dict, data) -> dict:
    """(a) context restoration cut to ``SSL_EPOCHS[0]`` epochs, then the
    k-fold fine-tune from its weights; returns the weights."""
    cfg = {**cfg, "train": {**cfg["train"], "n_epoch": SSL_EPOCHS[0]}}
    edt.launches = edt.mask_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    weights = pretrain_context_restoration(cfg, data.device_cache(DEV), device=DEV)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"], "pretrain")
    for name in ("pretrained.bin", "outputs.json", "checkpoint.bin"):
        check(os.path.exists(os.path.join(pre, name)), f"ssl cr: no {name}")
    with open(os.path.join(pre, "outputs.json")) as f:
        hist = json.load(f)["train"]["evolution"]
    mse = [row[1] for row in hist]
    check(all(np.isfinite(mse)) and mse[-1] < mse[0], f"ssl cr: the restoration MSE did not fall {mse}")

    folds = _ssl_folds(cfg)
    ft = {**cfg, "train": {**cfg["train"], "n_epoch": 1}}
    t0 = time.perf_counter()
    out = run_supervised_2d_with_init(ft, weights, lambda k: folds[k], device=DEV)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    launches = _edt_launches()
    for name in ("average_scores.txt", "all_volume_prediction.csv", "Fold_1/outputs.json",
                 "Fold_2/trained_unet.bin"):
        check(os.path.exists(os.path.join(out, name)), f"ssl cr fine-tune: no {name}")
    with open(os.path.join(out, "Fold_1", "log.txt")) as f:
        line = next((ln for ln in f if "matching weight keys" in ln), "")
    check(line.split("|")[-1].split()[:1] == [str(len(weights))],
          f"ssl cr fine-tune: the log does not name {len(weights)} moved keys: {line!r}")
    with open(os.path.join(out, "average_scores.txt")) as f:
        avg = f.read().strip().replace("\n", "; ")
    print(f"ssl context restoration ({CR_CFG}: d{cfg['net']['depth']} f{cfg['net']['top_filter']} "
          f"mcf{cfg['net']['midchannels_factor']}, batch {cfg['train']['batch_size']}, "
          f"{cfg['corruption']['n_swap']} swaps of {cfg['corruption']['swap_w']} px rotated): "
          f"{SSL_EPOCHS[0]} epochs of {len(data) // cfg['train']['batch_size']} steps in "
          f"{pre_s!r} s (with the t-SNE attempt), restoration MSE per epoch {mse!r}; fine-tune "
          f"{cfg['split']['n_fold']} folds x 1 epoch in {ft_s!r} s ({avg}); fine-tune log: "
          f"{line.split('|')[-1].strip()!r}; EDT launches on the path {launches}")
    check(not any(launches.values()), "ssl cr: an EDT kernel ran on the SSL path")
    return weights


def _ssl_contrastive_driver(cfg: dict, data) -> None:
    """(b) global then local contrastive, cut to ``SSL_EPOCHS[1:]`` epochs:
    the frozen encoder equal to the global weights bit for bit, its running
    statistics moved, the decoder and head trained."""
    cfg = {**cfg, "train": {**cfg["train"], "n_epoch": SSL_EPOCHS[1]},
           "local": {**cfg["local"], "n_epoch": SSL_EPOCHS[2]}}
    edt.launches = edt.mask_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    weights = pretrain_contrastive(cfg, data.device_cache(DEV), device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _edt_launches()
    out = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    hist = {}
    for phase in ("pretrain_global", "pretrain_local"):
        for name in ("pretrained.bin", "outputs.json"):
            check(os.path.exists(os.path.join(out, phase, name)), f"ssl {phase}: no {name}")
        with open(os.path.join(out, phase, "outputs.json")) as f:
            hist[phase] = [row[1] for row in json.load(f)["train"]["evolution"]]
    glob = torch.load(os.path.join(out, "pretrain_global", "pretrained.bin"), weights_only=True)
    part = build_partial_unet(cfg)  # the local phase's initial weights
    init = part.state_dict()
    part_params = [k for k, _ in part.named_parameters()]
    frozen = [k for k in part_params if k in glob]
    equal = all(torch.equal(weights[k].cpu(), glob[k]) for k in frozen)
    stats = [k for k in weights if k in glob and "running" in k]
    stats_moved = sum(not torch.equal(weights[k].cpu(), glob[k]) for k in stats)
    trained = [k for k in part_params if k not in glob]
    moved = sum(not torch.equal(weights[k].cpu(), init[k]) for k in trained)
    print(f"ssl contrastive ({CON_CFG}: global batch {cfg['train']['batch_size']}, MLP head "
          f"{cfg['net']['MLP_head']}, tau {cfg['tau']}; local n_decoder "
          f"{cfg['local']['n_decoder']}, head {cfg['local']['head_channel']}, K "
          f"{cfg['local']['K']}, n_region {cfg['local']['n_region']}): {SSL_EPOCHS[1]} global + "
          f"{SSL_EPOCHS[2]} local epochs in {wall!r} s; losses per epoch {hist!r}; local phase: "
          f"{len(frozen)} frozen parameters equal to the global weights {equal}, "
          f"{stats_moved}/{len(stats)} of their running statistics moved, {moved}/"
          f"{len(trained)} decoder and head parameters trained; EDT launches on the path "
          f"{launches}")
    check(all(np.isfinite(v).all() for v in hist.values()), "ssl contrastive: a loss is not finite")
    check(frozen and equal, "ssl contrastive: the frozen encoder moved in the local phase")
    check(stats_moved == len(stats) > 0, "ssl contrastive: the frozen encoder's statistics stayed")
    check(moved == len(trained) > 0, "ssl contrastive: a decoder or head parameter did not train")
    check(not any(launches.values()), "ssl contrastive: an EDT kernel ran on the SSL path")


class _TwoViews:
    """Fixed views: the batch, then its left-right mirror, call by call."""

    def __init__(self):
        self.calls = 0

    def __call__(self, gen, x):
        self.calls += 1
        return x if self.calls % 2 else x.flip(2)


def _ssl_trainer(kind: str, cfg: dict, device, batch: int, n_epoch: int = 1, mesh=None):
    """A full-width trainer of ``kind`` from the seeded nets, on ``mesh`` if
    given; the local one with the seeded encoder transferred and frozen."""
    tr = dict(n_epoch=n_epoch, batch_size=batch, lr=cfg["train"]["lr"], seed=SEED, device=device,
              mesh=mesh)
    if kind == "cr":
        c = cfg["corruption"]
        return ContextRestoration(
            build_unet_from_cfg({**cfg["net"], "use_final_activation": False}, seed=cfg["seed"],
                                device=device),
            n_swap=c["n_swap"], swap_w=c["swap_w"], swap_h=c["swap_h"], swap_rotate=c["rotate"],
            **tr)
    if kind == "global":
        return Contrastive(build_encoder(cfg, device=device), tau=cfg["tau"], **tr)
    lc = cfg["local"]
    t = Contrastive(build_partial_unet(cfg, device=device), is_global=False, tau=lc["tau"],
                    K=lc["K"], n_region=lc["n_region"], **tr)
    t.transfer_weights(build_encoder(cfg, device=device).state_dict(), freeze=True)
    return t


def _ssl_hold_run(kind: str, cfg: dict, dev, x, inject, threads: int) -> dict:
    """Three steps on one batch with the randomness injected (the
    patch-swap geometry; two fixed views and the region cells): the losses
    and the weights after."""
    torch.set_num_threads(threads)
    t = _ssl_trainer(kind, cfg, dev, len(x), n_epoch=3)
    if kind == "cr":
        swap = t.corrupt
        t.corrupt = lambda g, b: swap.apply(b, tuple(a.to(b.device) for a in inject))
    else:
        t.aug = _TwoViews()
    orig = losses_mod.sample_region_cells
    if kind == "local":
        losses_mod.sample_region_cells = lambda key, b, n, r: inject
    try:
        t.train(x.device_cache(t.device))
    finally:
        losses_mod.sample_region_cells = orig
    return {"losses": [row[1] for row in t.outputs["train"]["evolution"]],
            "params": torch.cat([p.detach().flatten().cpu() for p in t.net.parameters()]),
            "frozen": {k: v.detach().cpu() for k, v in t.net.state_dict().items() if k in t.frozen},
            "lrs": [t.state.schedule(i) for i in range(3)]}


def _patch_swap(cfg: dict) -> T.RandomPatchSwap:
    c = cfg["corruption"]
    return T.RandomPatchSwap(n=c["n_swap"], w=c["swap_w"], h=c["swap_h"], rotate=c["rotate"])


def _ssl_holds(cfgs: dict, data) -> None:
    """(c) card against CPU with TF32 off: three steps of each trainer,
    held against the CPU's own spread across thread counts and Adam's
    bound; the patch swap, the blur and the crop-resize warp at the
    configs' batch and size."""
    torch.backends.cudnn.allow_tf32 = False
    n = torch.get_num_threads()
    x = LabeledSliceDataset(data.images[:SSL_HOLD_BATCH], data.labels[:SSL_HOLD_BATCH])
    size = tuple(data.images.shape[1:3])
    k_cr, k_local, k_swap, k_blur, k_crop = prng.split(K(SEED), 5)
    lc = cfgs["con"]["local"]
    side = size[0] // 2 ** (cfgs["con"]["net"]["depth"] - 1 - lc["n_decoder"]) // lc["K"]
    injected = {"cr": _patch_swap(cfgs["cr"]).draw_geometry(k_cr, len(x), size), "global": None,
                "local": losses_mod.sample_region_cells(k_local, len(x), side * side,
                                                        lc["n_region"])}
    for kind, cfg in (("cr", cfgs["cr"]), ("global", cfgs["con"]), ("local", cfgs["con"])):
        card = _ssl_hold_run(kind, cfg, DEV, x, injected[kind], n)
        cpu = _ssl_hold_run(kind, cfg, "cpu", x, injected[kind], n)
        ref = _ssl_hold_run(kind, cfg, "cpu", x, injected[kind], max(1, n // 2))
        torch.set_num_threads(n)
        loss1 = abs(card["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
        traj = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
        traj_ref = max(abs(a - b) / abs(b) for a, b in zip(ref["losses"], cpu["losses"]))
        d = (card["params"] - cpu["params"]).abs()
        bound = 2 * 1.005 * sum(cpu["lrs"]) + 1e-6
        frozen_eq = all(torch.equal(v, cpu["frozen"][k]) for k, v in card["frozen"].items())
        print(f"ssl {kind} step hold, full width, batch {len(x)} of {size}, TF32 off, card vs cpu "
              f"({n} threads; reference: cpu with {max(1, n // 2)} threads vs {n}): step-1 loss "
              f"rel diff {loss1!r} (tolerance 1e-5); losses over 3 steps card {card['losses']!r} "
              f"cpu {cpu['losses']!r}, max rel diff {traj!r} (reference {traj_ref!r}, tolerance "
              f"max(2e-4, 10x the reference)); weights max |diff| {float(d.max())!r}, share within "
              f"1e-4 {float((d <= 1e-4).float().mean())!r} (tolerance: all within {bound!r}, "
              f"Adam's bound); {len(card['frozen'])} frozen parameters equal {frozen_eq}")
        check(loss1 <= 1e-5 and traj <= max(2e-4, 10 * traj_ref),
              f"ssl {kind}: card and cpu losses disagree")
        check(float(d.max()) <= bound and frozen_eq, f"ssl {kind}: card and cpu weights disagree")

    b = cfgs["cr"]["train"]["batch_size"]
    imgs = torch.from_numpy(data.images[:b, ..., None])
    swap = _patch_swap(cfgs["cr"])
    geom = swap.draw_geometry(k_swap, b, size)
    swap_eq = torch.equal(swap.apply(imgs.to(DEV), tuple(g.to(DEV) for g in geom)).cpu(),
                          swap.apply(imgs, geom))
    blur = T.GaussianBlur(0.5, (0.1, 2.0))
    flags, sig = blur.draw(k_blur, b)
    blur_err = float((blur.apply_params(imgs.to(DEV), flags.to(DEV), sig.to(DEV)).cpu()
                      - blur.apply_params(imgs, flags, sig)).abs().max())
    crop = T.RandomCropResize((0.4, 0.8))
    m, o = crop.affine_params(k_crop, b, size)
    crop.affine_params = lambda key, bb, hw: (m, o)
    crop_err = float((crop(k_crop, imgs.to(DEV)).cpu() - crop(k_crop, imgs)).abs().max())
    torch.backends.cudnn.allow_tf32 = True
    print(f"ssl transforms card vs cpu at {tuple(imgs.shape)}: RandomPatchSwap with injected "
          f"geometry equal {swap_eq}; GaussianBlur with injected draws max err {blur_err!r}; "
          f"RandomCropResize with injected (m, o) max err {crop_err!r} (tolerance 1e-5)")
    check(swap_eq and blur_err <= 1e-5 and crop_err <= 1e-5, "ssl: card and cpu transforms disagree")


def _ssl_warm_ms(t, state, batches: list, n: int = 10) -> float:
    """Mean ms of ``n`` steps over ``batches`` after three warm-up steps
    (cuDNN picks its algorithms), the peak memory counter reset after the
    warm-up."""
    for i in range(3):
        t._train_step(state, batches[i % len(batches)], K(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(n):
        t._train_step(state, batches[i % len(batches)], K(3 + i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _ssl_step_times(cfgs: dict, data) -> dict:
    """(d) warm ms per step of each ``SSL_TIMED`` cell (TF32 on), FLOPs and
    their rate, peak memory; returns the warm (trainer, state, batch) of
    context restoration and of global contrastive by kind."""
    torch.backends.cudnn.allow_tf32 = True
    cached = data.device_cache(DEV)
    warm = {}
    for cell, kind, bs in SSL_TIMED:
        t = _ssl_trainer(kind, cfgs["cr" if kind == "cr" else "con"], DEV, bs)
        state = t._train_state(max(1, len(data) // bs))
        plan = np.random.default_rng(SEED).integers(0, len(data), size=(4, bs))
        batches = list(t._batches(cached.images, list(plan)))
        t.net.train()
        ms = _ssl_warm_ms(t, state, batches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops = compiled_flops(t._train_step, state, batches[0], K(99))
        tflops = flops / ms / 1e9
        print(f"{cell}: batch {bs} of {tuple(data.images.shape[1:3])}, float32 (TF32 on): {ms!r} "
              f"ms/step = {bs / ms * 1e3!r} slices/s; {flops / 1e12!r} TFLOP per step "
              f"(FlopCounterMode: forward{'s' if kind != 'cr' else ''} and backward) = "
              f"{tflops!r} TFLOP/s, {100 * tflops / PEAK['tf32']!r}% of the dense TF32 peak; "
              f"peak device memory {peak!r} GiB")
        if kind in ("cr", "global"):
            warm[kind] = (t, state, batches[0])
        else:
            t.net.eval()
            del t, state, batches
            torch.cuda.empty_cache()
    # a layout probe (the trainer is unchanged): the blur leaves each view
    # with NCHW strides, so cuDNN runs the global net NCHW, where context
    # restoration's corrupted batch (a slice of the padded buffer) has
    # channels-last strides; the global step again with each view copied to
    # fresh (B, H, W, 1) strides, which are channels-last as (B, 1, H, W)
    t, state, batch = warm["global"]
    aug = t.aug
    t.aug = lambda g, x: aug(g, x).clone(memory_format=torch.contiguous_format)
    ms = _ssl_warm_ms(t, state, [batch])
    t.aug = aug
    print(f"ssl_contrastive_global_bs64 layout probe, the views with channels-last strides: "
          f"{ms!r} ms/step")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"ssl nvidia-smi after the timed steps: {smi}")
    return warm


OP_GROUPS_SSL = OP_GROUPS_TRAIN + (("swap gather/scatter", ("index",)),)
SSL_RANGES = ("corrupt", "views", "net", "loss", "Optimizer.step#Adam.step")


def _ssl_profile(t, state, batch) -> None:
    """(e) one warm step under torch.profiler."""
    label = "context-restoration" if isinstance(t, ContextRestoration) else "global contrastive"
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t._train_step(state, batch, K(200))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t.net.eval()
    print(_profile_summary(prof, wall_ms, f"ssl profile (one warm {label} step, batch "
                           f"{t.batch_size}, TF32 on)", OP_GROUPS_SSL, SSL_RANGES))


def phase_ssl(work: str) -> LabeledSliceDataset:
    cfgs = {"cr": load_ssl_cfg(CR_CFG, work), "con": load_ssl_cfg(CON_CFG, work)}
    data = _rsna_data(cfgs["cr"], work)
    weights = _ssl_cr_driver(cfgs["cr"], data)
    t = _ssl_trainer("cr", cfgs["cr"], DEV, cfgs["cr"]["train"]["batch_size"])
    t.net.load_state_dict(weights)
    t0 = time.perf_counter()
    feats = t.bottleneck_features(data)
    torch.cuda.synchronize()
    print(f"ssl bottleneck_features of {len(data)} slices: {feats.shape} in "
          f"{time.perf_counter() - t0!r} s")
    check(feats.shape[0] == len(data) and np.isfinite(feats).all(), "ssl: bottleneck features")
    del t
    _ssl_contrastive_driver(cfgs["con"], data)
    torch.cuda.empty_cache()
    _ssl_holds(cfgs, data)
    warm = _ssl_step_times(cfgs, data)
    _ssl_profile(*warm["cr"])
    _ssl_profile(*warm["global"])
    return data


# -- phase 9: classification pretraining, the sweep, the brain-only workflow -------

@contextlib.contextmanager
def _unimportable(names: tuple):
    """``names`` (and their submodules) cannot be imported inside the block,
    whatever is installed; the modules are restored after."""
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m.split(".")[0] in names}
    sys.modules.update({n: None for n in names})
    try:
        yield
    finally:
        for n in names:
            sys.modules.pop(n, None)
        sys.modules.update(saved)


def load_cls_cfgs(work: str) -> dict:
    """The contrastive config (its width as it is; 2 folds) and
    ``configs/unet2d.json`` cut to 2 folds of 1 epoch, both reading the
    trees under ``work``."""
    con = load_ssl_cfg(CON_CFG, work)
    con["path"]["DATA"] = os.path.join(work, "segich2d")
    con["train"]["n_epoch"] = 1
    with open(TRAIN_CFG) as f:
        seg = json.load(f)
    seg["path"] = {"DATA": os.path.join(work, "segich2d"), "OUTPUT": os.path.join(work, "out")}
    seg["split"]["n_fold"] = 2
    seg["train"]["n_epoch"] = 1
    return {"con": con, "seg": seg}


def _write_cfg(cfg: dict, fn: str) -> str:
    with open(fn, "w") as f:
        json.dump(cfg, f)
    return fn


def _segich2d_tree(root: str) -> tuple:
    """``SEGICH2D_TREE`` written with the port's writer: a random half of
    the patients (from ``SEGICH2D_SEED``) with lesions on about a third of
    their slices, the others with none. Returns the slices and the lesion
    patients."""
    n_pat, n_slices, size = SEGICH2D_TREE
    lesion = sorted(np.random.default_rng(SEGICH2D_SEED).choice(n_pat, n_pat // 2,
                                                                replace=False).tolist())
    parts = [synthetic_ich_slices(n_slices=n_slices, size=size, n_volumes=1,
                                  seed=1000 * SEGICH2D_SEED + p,
                                  positive_frac=0.5 if p in lesion else 0.0)
             for p in range(n_pat)]
    ds = SliceDataset2D(np.concatenate([p.images for p in parts]),
                        np.concatenate([p.masks for p in parts]),
                        np.repeat(np.arange(n_pat), n_slices), np.tile(np.arange(n_slices), n_pat))
    has = [int(ds.masks[ds.vol_ids == p].max() > 0) for p in range(n_pat)]
    check(has == [int(p in lesion) for p in range(n_pat)], f"cls: lesion patients {has}")
    write_segich_tree(ds, root)
    return ds, lesion


def _cls_csv_path(cfgs: dict, work: str, tree_ds) -> str:
    """(a) ``python -m ich_tpu_torch.experiments.supervised2d`` on the CSV
    tree, with pandas, PIL and scikit-learn unimportable; returns the
    experiment dir."""
    cfg = cfgs["seg"]
    fn = _write_cfg(cfg, os.path.join(work, "unet2d_csv.json"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _unimportable(NOT_ON_THE_CARD):
        out = supervised2d.main([fn, "--device", DEV])
        loaded = [m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD
                  and sys.modules[m] is not None]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not loaded, f"cls: the CSV path imported {loaded}")
    for name in ("average_scores.txt", "all_volume_prediction.csv", "config.json"):
        check(os.path.exists(os.path.join(out, name)), f"cls csv path: no {name}")
    with open(os.path.join(out, "all_volume_prediction.csv"), newline="") as f:
        vols = sorted(int(r[1]) for r in list(csv.reader(f))[1:])
    check(vols == list(range(SEGICH2D_TREE[0])), f"cls csv path: tested volumes {vols}")
    n_bmp = sum(f.endswith(".bmp") for _, _, fs in os.walk(out) for f in fs)
    check(n_bmp == len(tree_ds), f"cls csv path: {n_bmp} prediction BMPs, not {len(tree_ds)}")
    with open(os.path.join(out, "average_scores.txt")) as f:
        avg = f.read().strip().replace("\n", "; ")
    print(f"cls (a) supervised2d CLI on the CSV tree ({TRAIN_CFG}: {cfg['split']['n_fold']} folds "
          f"x {cfg['train']['n_epoch']} epoch, {len(tree_ds)} slices of "
          f"{SEGICH2D_TREE[2]}^2 read at {cfg['data']['size']}^2) in {wall!r} s with "
          f"{', '.join(NOT_ON_THE_CARD)} unimportable: {avg}")
    return out


def _cls_pretrain(cfg: dict, data) -> dict:
    """(b) binary pretraining for ``CLS_EPOCHS[0]`` epochs, 7-way for
    ``CLS_EPOCHS[1]``; returns the binary weights."""
    cached = data.device_cache(DEV)
    weights = {}
    for multi, n_epoch in ((False, CLS_EPOCHS[0]), (True, CLS_EPOCHS[1])):
        kind = "7-way" if multi else "binary"
        c = {**cfg, "exp_name": f"cls_{'multi' if multi else 'binary'}",
             "train": {**cfg["train"], "n_epoch": n_epoch}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weights[multi] = pretrain_classifier(c, cached, multi=multi, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pre = os.path.join(c["path"]["OUTPUT"], c["exp_name"], "pretrain_classifier")
        for name in ("pretrained.bin", "outputs.json", "classifier_scores.json"):
            check(os.path.exists(os.path.join(pre, name)), f"cls {kind}: no {name}")
        with open(os.path.join(pre, "outputs.json")) as f:
            losses = [row[1] for row in json.load(f)["train"]["evolution"]]
        with open(os.path.join(pre, "classifier_scores.json")) as f:
            scores = json.load(f)
        auc = scores["auc_macro" if multi else "auc"]
        head = tuple(weights[multi][f"mlp_head.fc_layers.{len(cfg['net']['MLP_head'])}.weight"].shape)
        print(f"cls (b) {kind} pretraining (encoder d{cfg['net']['depth']} f"
              f"{cfg['net']['top_filter']} mcf{cfg['net']['midchannels_factor']}, head "
              f"{cfg['net']['MLP_head']}+{head[0]}, batch {cfg['train']['batch_size']}, "
              f"{len(data)} slices): {n_epoch} epochs in {wall!r} s, losses {losses!r}, "
              f"metrics {scores}")
        check(all(np.isfinite(losses)) and np.isfinite(auc), f"cls {kind}: loss or AUC not finite")
        if not multi:
            check(losses[-1] < losses[0], f"cls {kind}: the mean loss did not fall {losses}")
    return weights[False]


def _kept(cfg: dict, tree_ds, lesion: list, frac: float) -> list:
    """Per fold, the training patients the CSV path keeps at ``frac`` and
    the slices (all, positive) it trains on after the negative cap: the
    split and draws of ``run_supervised_2d`` recomputed from the tree."""
    n_pat = SEGICH2D_TREE[0]
    hem = np.isin(np.arange(n_pat), lesion).astype(int)
    cap = (LOW_LABEL_RECIPE["frac_negative"] if frac < LOW_LABEL_RECIPE["below"]
           else cfg["dataset"]["frac_negative"])
    pos = np.array([int(m.max() > 0) for m in tree_ds.masks])
    out = []
    for k, (train, _) in enumerate(stratified_kfold(hem, cfg["split"]["n_fold"], True,
                                                    cfg["seed"])):
        keep = train if frac >= 1.0 else subsample_label_fraction(
            train, frac, np.random.default_rng(cfg["seed"] + k))
        rows = np.isin(tree_ds.vol_ids, keep)
        n_pos, n_neg = int(pos[rows].sum()), int((1 - pos[rows]).sum())
        n_neg -= int(max(0, n_neg - cap * n_pos))
        out.append((sorted(int(p) for p in keep), n_pos + n_neg, n_pos))
    return out


def _cls_sweep(cfg: dict, weights: dict, tree_ds, lesion: list) -> None:
    """(c) the sweep from the binary weights on the CSV tree, one fraction
    at a time (timed), the low-label recipe on."""
    n_enc = len([k for k, v in build_unet_from_cfg(cfg["net"]).state_dict().items()
                 if k in weights and tuple(weights[k].shape) == tuple(v.shape)])
    for frac in SWEEP_FRACTIONS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = label_efficiency_sweep(cfg, weights, None, fractions=(frac,), seed=cfg["seed"],
                                     low_label_recipe=LOW_LABEL_RECIPE, device=DEV)[frac]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "average_scores.txt")) as f:
            avg = f.read().strip().replace("\n", "; ")
        with open(os.path.join(out, "config.json")) as f:
            saved = json.load(f)
        want = _kept(cfg, tree_ds, lesion, frac)
        folds = []
        for k, (keep, n_train, n_pos) in enumerate(want):
            with open(os.path.join(out, f"Fold_{k + 1}", "log.txt")) as f:
                log = f.read().splitlines()
            moved = next((ln for ln in log if "matching weight keys" in ln), "")
            train = next(ln for ln in log if ln.startswith("Train")).split()[1:4]
            got = (int(train[0]), int(train[2]))
            folds.append(f"fold {k + 1}: patients {keep} ({len(keep)} of "
                         f"{SEGICH2D_TREE[0] // cfg['split']['n_fold']}), {got[0]} training "
                         f"slices, {got[1]} positive; {moved.split('|')[-1].strip()!r}")
            check(got == (n_train, n_pos) and n_pos > 0,
                  f"cls sweep {frac}: fold {k + 1} trained on {got}, expected {(n_train, n_pos)}")
            check(moved.split("|")[-1].split()[:1] == [str(n_enc)],
                  f"cls sweep {frac}: fold {k + 1} log does not name {n_enc} moved keys")
        print(f"cls (c) sweep fraction {frac}: {saved['split']['n_fold']} folds x "
              f"{saved['train']['n_epoch']} epochs, frac_negative "
              f"{saved['dataset']['frac_negative']}, wall {wall!r} s; {avg}; "
              + "; ".join(folds))
        if frac == SWEEP_FRACTIONS[0]:
            check(all(len(k) == 1 for k, _, _ in want), "cls sweep: 0.1 keeps one patient")


def _cls_resnet(cfg: dict, work: str) -> None:
    """(d) ``python -m ich_tpu_torch.experiments.binary_resnet`` (ResNet-18
    at the config's size and batch, ``RESNET_EPOCHS`` epochs)."""
    c = {**cfg, "exp_name": "resnet18_triage", "net": {"name": "ResNet18"},
         "train": {**cfg["train"], "n_epoch": RESNET_EPOCHS}}
    fn = _write_cfg(c, os.path.join(work, "resnet18.json"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = binary_resnet.main([fn, "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("resnet_classifier.bin", "classifier_scores.json", "outputs.json"):
        check(os.path.exists(os.path.join(out, name)), f"cls resnet: no {name}")
    with open(os.path.join(out, "outputs.json")) as f:
        losses = [row[1] for row in json.load(f)["train"]["evolution"]]
    with open(os.path.join(out, "classifier_scores.json")) as f:
        scores = json.load(f)
    print(f"cls (d) binary_resnet CLI (ResNet-18, {c['data']['size']}^2, batch "
          f"{c['train']['batch_size']}): {RESNET_EPOCHS} epochs with the RSNA load in {wall!r} s, "
          f"losses {losses!r}, metrics {scores}")
    check(len(losses) == RESNET_EPOCHS and all(np.isfinite(losses)) and np.isfinite(scores["auc"]),
          "cls resnet: losses or AUC not finite")


def _brain_dir(root: str, tree_ds, value: int) -> str:
    """A brain BMP of the tree's side, all ``value``, per slice."""
    img = np.full(tree_ds.images.shape[1:], value, np.uint8)
    for v, s in zip(tree_ds.vol_ids, tree_ds.slice_nbrs):
        os.makedirs(os.path.join(root, str(int(v))), exist_ok=True)
        save_bmp_gray(os.path.join(root, f"{int(v)}/{int(s)}.bmp"), img)
    return root


def _pred_files(exp: str, suffix: str) -> dict:
    return {os.path.relpath(os.path.join(r, f), exp): open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(exp) for f in fs if f.endswith(suffix)}


def _cls_brain(cfgs: dict, work: str, exp: str, tree_ds) -> None:
    """(e) brain extraction on a tree whose masks are the head's interior,
    the brain-only post-filter of (a)'s predictions with all-ones and
    all-zeros brains, and segment_brain on two NIfTIs."""
    n_pat, n_slices, size = BRAIN_TREE
    ds = synthetic_ich_slices(n_slices=n_pat * n_slices, size=size, n_volumes=n_pat,
                              seed=SEED + 500)
    yy, xx = np.mgrid[0:size, 0:size]
    head = ((yy - size / 2) ** 2 + (xx - size / 2) ** 2 < (0.42 * size) ** 2).astype(np.float32)
    write_segich_tree(SliceDataset2D(ds.images, np.broadcast_to(head, ds.masks.shape),
                                     ds.vol_ids, ds.slice_nbrs), os.path.join(work, "brain_tree"))
    seg = cfgs["seg"]
    cfg = {**seg, "exp_name": "brain_extraction",
           "path": {"DATA": os.path.join(work, "brain_tree"), "OUTPUT": os.path.join(work, "out")}}
    fn = _write_cfg(cfg, os.path.join(work, "brain.json"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = brain_extraction.main([fn, "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("average_scores.txt", "Fold_2/trained_unet.bin", "final_brain_unet.bin"):
        check(os.path.exists(os.path.join(out, name)), f"cls brain extraction: no {name}")
    with open(os.path.join(out, "average_scores.txt")) as f:
        avg = f.read().strip().replace("\n", "; ")
    print(f"cls (e) brain_extraction CLI ({n_pat * n_slices} slices of {size}^2, 2 folds then "
          f"all, {cfg['train']['n_epoch']} epoch each) in {wall!r} s: {avg}")

    n_fold, in_size = seg["split"]["n_fold"], str(seg["data"]["size"])
    tree = seg["path"]["DATA"]
    for value in (255, 0):
        copy = shutil.copytree(exp, os.path.join(work, f"pred_on_brain_{value}"))
        brain = _brain_dir(os.path.join(work, f"brain_{value}"), tree_ds, value)
        before = _pred_files(copy, ".bmp")
        csvs = _pred_files(copy, "prediction_scores.csv")
        argv = ["--exp-dir", copy, "--data-dir", tree, "--brain-dir", brain, "--n-fold",
                str(n_fold), "--size", in_size]
        t0 = time.perf_counter()
        pred_on_brain.main(argv)
        wall = time.perf_counter() - t0
        after = _pred_files(copy, ".bmp")
        check(after.keys() == before.keys() and len(after) == len(tree_ds),
              "cls pred_on_brain: prediction BMPs lost")
        if value:
            first = _pred_files(copy, "prediction_scores.csv")
            pred_on_brain.main(argv)
            same = first == _pred_files(copy, "prediction_scores.csv")
            as_evaluate = first == csvs
            print(f"cls (e) pred_on_brain, all-ones brain of {size}^2: {wall!r} s; every BMP "
                  f"byte-equal {after == before}; a second pass gives the same CSVs {same}; the "
                  f"CSVs equal evaluate's {as_evaluate}")
            check(after == before and same and as_evaluate, "cls pred_on_brain: all-ones brain")
            continue
        empty = all(not read_bmp(os.path.join(copy, f)).any() for f in after)
        dice = []
        for k in range(n_fold):
            with open(os.path.join(exp, f"Fold_{k + 1}/pred/volume_prediction_scores.csv")) as f:
                rows = list(csv.DictReader(f))
            want = float(np.mean([1.0 / (1.0 + float(r["TP"]) + float(r["FN"])) for r in rows
                                  if r["label"] == "1"]))
            with open(os.path.join(copy, f"Fold_{k + 1}/outputs.json")) as f:
                dice.append((json.load(f)["eval"]["dice"]["positive"], want))
        print(f"cls (e) pred_on_brain, all-zeros brain: {wall!r} s; every BMP empty {empty}; "
              f"positive Dice per fold (got, an empty prediction's) {dice!r}")
        check(empty and all(g == w for g, w in dice), "cls pred_on_brain: all-zeros brain")

    rng = np.random.default_rng(SEED + 9)
    vols = []
    for i in range(BRAIN_VOLS):
        vols.append(os.path.join(work, f"head{i}.nii.gz"))
        nifti.save(vols[-1], head_ct(rng, VOL_SHAPE))
    net = cfg["net"]
    t0 = time.perf_counter()
    outs = segment_brain.main(vols + ["-o", os.path.join(work, "brain_masks"), "-m",
                                      os.path.join(out, "final_brain_unet.bin"),
                                      "--depth", str(net["depth"]),
                                      "--top-filter", str(net["top_filter"]),
                                      "--midchannels-factor", str(net["midchannels_factor"]),
                                      "--size", in_size, "--device", DEV])
    wall = time.perf_counter() - t0
    masks = [nifti.load(fn)[0] for fn in outs]
    print(f"cls (e) segment_brain CLI on {BRAIN_VOLS} volumes of {VOL_SHAPE}: {wall!r} s, "
          f"brain share per volume {[float((m == 255).mean()) for m in masks]!r}")
    check(all(m.shape == VOL_SHAPE and set(np.unique(m)) <= {0, 255} for m in masks),
          "cls segment_brain: masks")


def _cls_trainer(kind: str, cfg: dict, device, batch: int, n_epoch: int = 1):
    """A full-width classifier from seeded weights: ``binary`` / ``multi``
    on the config's encoder (head ``MLP_head`` + 2 or 7), ``resnet18``."""
    tr = dict(n_epoch=n_epoch, batch_size=batch, lr=cfg["train"]["lr"], seed=SEED, device=device)
    if kind == "resnet18":
        with torch.device(device):
            return BinaryClassifier(resnet18(num_classes=2, key=K(SEED)), **tr)
    n_out = 7 if kind == "multi" else 2
    enc = build_encoder(cfg, tuple(cfg["net"]["MLP_head"]) + (n_out,), device=device)
    return (MultiClassifier if kind == "multi" else BinaryClassifier)(enc, **tr)


def _cls_labels(kind: str, data) -> LabeledSliceDataset:
    labels = data.labels if kind == "multi" else data.labels[:, 0].astype(np.int32)
    return LabeledSliceDataset(data.images, labels)


def _cls_holds(cfg: dict, data) -> None:
    """(f) three full-width steps of each classifier (batch 2, TF32 off,
    nothing random) on the card and on the CPU, held as phase 8's."""
    torch.backends.cudnn.allow_tf32 = False
    n = torch.get_num_threads()
    for kind in ("binary", "multi", "resnet18"):
        x = _cls_labels(kind, LabeledSliceDataset(data.images[:CLS_HOLD_BATCH],
                                                  data.labels[:CLS_HOLD_BATCH]))
        runs = []
        for dev, threads in ((DEV, n), ("cpu", n), ("cpu", max(1, n // 2))):
            torch.set_num_threads(threads)
            t = _cls_trainer(kind, cfg, dev, CLS_HOLD_BATCH, n_epoch=3)
            t.train(x.device_cache(t.device))
            runs.append({"losses": [row[1] for row in t.outputs["train"]["evolution"]],
                         "params": torch.cat([p.detach().flatten().cpu()
                                              for p in t.net.parameters()]),
                         "lrs": [t.state.schedule(i) for i in range(3)]})
        torch.set_num_threads(n)
        card, cpu, ref = runs
        loss1 = abs(card["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
        traj = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
        traj_ref = max(abs(a - b) / abs(b) for a, b in zip(ref["losses"], cpu["losses"]))
        d = (card["params"] - cpu["params"]).abs()
        bound = 2 * 1.005 * sum(cpu["lrs"]) + 1e-6
        print(f"cls (f) {kind} step hold, full width, batch {CLS_HOLD_BATCH} of "
              f"{tuple(data.images.shape[1:3])}, TF32 off, card vs cpu ({n} threads; reference: "
              f"cpu with {max(1, n // 2)} threads vs {n}): step-1 loss rel diff {loss1!r} "
              f"(tolerance 1e-5); losses over 3 steps card {card['losses']!r} cpu "
              f"{cpu['losses']!r}, max rel diff {traj!r} (reference {traj_ref!r}, tolerance "
              f"max(2e-4, 10x the reference)); weights max |diff| {float(d.max())!r}, share "
              f"within 1e-4 {float((d <= 1e-4).float().mean())!r} (tolerance: all within "
              f"{bound!r}, Adam's bound)")
        check(loss1 <= 1e-5 and traj <= max(2e-4, 10 * traj_ref),
              f"cls {kind}: card and cpu losses disagree")
        check(float(d.max()) <= bound, f"cls {kind}: card and cpu weights disagree")
    torch.backends.cudnn.allow_tf32 = True


def _cls_step_times(cfg: dict, data) -> tuple:
    """(g) warm ms per step of each ``CLS_TIMED`` cell (TF32 on), FLOPs and
    their rate, peak memory; returns the warm ResNet (trainer, state,
    batch)."""
    torch.backends.cudnn.allow_tf32 = True
    cached = data.device_cache(DEV)
    warm = None
    for cell, kind, bs in CLS_TIMED:
        t = _cls_trainer(kind, cfg, DEV, bs)
        state = t._train_state(max(1, len(data) // bs))
        plan = list(np.random.default_rng(SEED).integers(0, len(data), size=(4, bs)))
        batches = list(t._labelled_batches(_cls_labels(kind, cached), plan))
        t.net.train()
        ms = _ssl_warm_ms(t, state, batches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops = compiled_flops(t._train_step, state, batches[0], K(99))
        tflops = flops / ms / 1e9
        print(f"{cell}: {'ResNet-18' if kind == 'resnet18' else 'encoder + MLP head'}, batch "
              f"{bs} of {tuple(data.images.shape[1:3])}, float32 (TF32 on): {ms!r} ms/step = "
              f"{bs / ms * 1e3!r} slices/s; {flops / 1e12!r} TFLOP per step (FlopCounterMode: "
              f"forward and backward) = {tflops!r} TFLOP/s, "
              f"{100 * tflops / PEAK['tf32']!r}% of the dense TF32 peak; peak device "
              f"memory {peak!r} GiB")
        if kind == "resnet18":
            warm = (t, state, batches[0])
        else:
            t.net.eval()
            del t, state, batches
            torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"cls nvidia-smi after the timed steps: {smi}")
    return warm


CLS_RANGES = ("augment", "net", "loss", "Optimizer.step#Adam.step")


def _cls_profile(t, state, batch) -> None:
    """One warm ResNet-18 step under torch.profiler, and which BatchNorm
    kernels cuDNN takes (NHWC or NCHW)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t._train_step(state, batch, K(300))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t.net.eval()
    print(_profile_summary(prof, wall_ms, f"cls profile (one warm ResNet-18 step, batch "
                           f"{t.batch_size}, TF32 on)", OP_GROUPS_TRAIN, CLS_RANGES))
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == cuda and e.key not in CLS_RANGES]
    total = sum(v for _, v in kernels) or 1.0
    bn = [(k, v) for k, v in kernels
          if any(n in k.lower() for n in ("batchnorm", "batch_norm", "bn_fw", "bn_bw"))]
    layout = {"NHWC": sum(v for k, v in bn if "nhwc" in k.lower() or "channels_last" in k),
              "NCHW": sum(v for k, v in bn if "NCHW" in k or "1C11_kernel_new" in k)}
    print(f"cls profile BatchNorm kernels: "
          + ", ".join(f"{k[:70]} {100 * v / total:.1f}%" for k, v in sorted(bn, key=lambda kv: -kv[1]))
          + f"; by layout: NCHW {100 * layout['NCHW'] / total:.1f}%, NHWC "
            f"{100 * layout['NHWC'] / total:.1f}% of device time")


def phase_cls(work: str, data) -> None:
    """Phase 9 on phase 8's RSNA slices (and its tree under ``work``)."""
    cfgs = load_cls_cfgs(work)
    edt.launches = edt.mask_launches = 0
    t0 = time.perf_counter()
    tree_ds, lesion = _segich2d_tree(cfgs["con"]["path"]["DATA"])
    print(f"cls data: SegICH 2D tree of {SEGICH2D_TREE[0]} patients x {SEGICH2D_TREE[1]} slices "
          f"of {SEGICH2D_TREE[2]}^2 written in {time.perf_counter() - t0!r} s, lesions in patients "
          f"{lesion}, {int((tree_ds.masks.reshape(len(tree_ds), -1).max(1) > 0).sum())} positive "
          f"slices")
    exp = _cls_csv_path(cfgs, work, tree_ds)
    weights = _cls_pretrain(cfgs["con"], data)
    _cls_sweep(cfgs["con"], weights, tree_ds, lesion)
    _cls_resnet(cfgs["con"], work)
    _cls_brain(cfgs, work, exp, tree_ds)
    torch.cuda.empty_cache()
    _cls_holds(cfgs["con"], data)
    _cls_profile(*_cls_step_times(cfgs["con"], data))
    launches = _edt_launches()
    print(f"cls EDT launches on phase 9's paths {launches}")
    check(not any(launches.values()), "cls: an EDT kernel ran on phase 9's paths")


# -- phase 10: the SN-PatchGAN and the inpainting anomaly detector ------------------

def load_gan_cfg(work: str) -> dict:
    """``configs/inpainting_gan.json`` (its width as it is) reading phase 8's
    RSNA tree, cut to ``GAN_EPOCHS`` epochs with a checkpoint every epoch."""
    with open(GAN_CFG) as f:
        cfg = json.load(f)
    cfg["path"] = {"RSNA_DATA": os.path.join(work, "rsna", "stage_2_train"),
                   "OUTPUT": os.path.join(work, "out")}
    cfg["train"].update(n_epoch=GAN_EPOCHS, checkpoint_freq=1)
    return cfg


def _train_history(out: str) -> list:
    with open(os.path.join(out, "outputs.json")) as f:
        return json.load(f)["train"]["evolution"]


def _gan_train(cfg: dict, work: str, normal: np.ndarray) -> tuple:
    """(a) the GAN CLI for ``GAN_EPOCHS`` epochs and the saved generator's
    validation, then (b) once more with one epoch more, resumed; returns
    the output dir and the EDT launches and train steps of (a)."""
    bs = cfg["train"]["batch_size"]
    n_normal = len(normal)
    spe = n_normal // bs
    fn = _write_cfg(cfg, os.path.join(work, "gan.json"))
    edt.launches = edt.mask_launches = dropout_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = inpainting_gan.main([fn, "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, dropout_launches = _edt_launches(), dropout_ops.launches
    steps = spe * GAN_EPOCHS
    for name in ("checkpoint.bin", "snpatchgan.bin", "outputs.json"):
        check(os.path.exists(os.path.join(out, name)), f"gan: no {name}")
    hist = _train_history(out)
    # the CLI validates every 5 epochs: validate the saved generator instead
    gan = inpainting_gan.build_gan(cfg, DEV)
    gan.load_model(os.path.join(out, "snpatchgan.bin"))
    valid_dir = os.path.join(work, "gan_valid")
    l1_valid = gan.validate(LabeledSliceDataset(normal, np.zeros(n_normal, np.int32)),
                            save_path=valid_dir, epoch=GAN_EPOCHS)
    pngs = [read_png_gray(os.path.join(valid_dir, f"valid_ep{GAN_EPOCHS}_{i}.png"))
            for i in range(min(8, bs))]
    png = pngs[0]
    del gan
    n = cfg["net"]
    print(f"gan (a) inpainting_gan CLI ({GAN_CFG}: SAGatedGenerator lat {n['lat_channels']}, "
          f"PatchDiscriminator {n['disc_channels']} with SN and self-attention, batch {bs} of "
          f"{cfg['data']['size']}^2, lr_g {cfg['train']['lr_g']}, lr_d {cfg['train']['lr_d']}): "
          f"{n_normal} non-ICH slices, {GAN_EPOCHS} epochs x {spe} steps with a checkpoint each "
          f"epoch in {wall!r} s (RSNA load included); [epoch, G, D, L1] {hist!r}; the saved "
          f"generator's validation masked L1 {l1_valid!r}, {len(pngs)} PNGs of {png.shape}; EDT "
          f"launches on the path {launches} for {steps} steps, keyed dropout launches "
          f"{dropout_launches}")
    check(len(hist) == GAN_EPOCHS and all(np.isfinite(r[1:]).all() for r in hist),
          f"gan: losses not finite {hist}")
    check(hist[-1][3] < hist[0][3], f"gan: L1 did not fall {hist}")
    check(np.isfinite(l1_valid) and all(p.shape == (cfg["data"]["size"], 3 * cfg["data"]["size"])
                                        for p in pngs), f"gan: validation {l1_valid} {png.shape}")
    check(all(v == 2 * steps for v in launches.values()),
          f"gan: EDT launches {launches} != 2 x {steps} steps")

    resumed = {**cfg, "train": {**cfg["train"], "n_epoch": GAN_EPOCHS + 1}}
    fn = _write_cfg(resumed, os.path.join(work, "gan_resume.json"))
    edt.launches = edt.mask_launches = 0
    t0 = time.perf_counter()
    inpainting_gan.main([fn, "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist2, more = _train_history(out), _edt_launches()
    print(f"gan (b) resumed to {GAN_EPOCHS + 1} epochs in {wall!r} s: [epoch, G, D, L1] "
          f"{hist2!r}; EDT launches {more}")
    check(len(hist2) == GAN_EPOCHS + 1 and hist2[:GAN_EPOCHS] == hist,
          "gan: the resume did not run exactly one more epoch")
    check(all(v == 2 * spe for v in more.values()), f"gan resume: EDT launches {more}")
    check(dropout_launches == 0, "gan: the dropout kernel ran on the GAN path")
    return out, {**launches, "keyed_dropout": dropout_launches}, steps


def _gan_trainer(cfg: dict, device, batch: int, self_attention: bool = True,
                 n_epoch: int = 1) -> SNPatchGAN:
    """A full-width SN-PatchGAN from seeded weights."""
    n, tr = cfg["net"], cfg["train"]
    g_cls = SAGatedGenerator if self_attention else GatedGenerator
    kg, kd = prng.split(K(SEED))
    g = g_cls(lat_channels=n["lat_channels"], key=kg)
    d = PatchDiscriminator(out_channels=tuple(n["disc_channels"]), key=kd)
    return SNPatchGAN(g, d, n_epoch=n_epoch, batch_size=batch, lr_g=tr["lr_g"], lr_d=tr["lr_d"],
                      lambda_L1=tr["lambda_L1"], lambda_gan=tr["lambda_gan"],
                      gammaL1=tr["gammaL1"], mask_kwargs=cfg["mask"], seed=SEED, device=device)


def _gan_hold_run(cfg: dict, dev, x: np.ndarray, masks: torch.Tensor, threads: int) -> dict:
    """Three steps on one batch with the masks injected: the losses, both
    nets' weights before the first step, after it and after the third, the
    spectral-norm u and the BatchNorm statistics after the third."""
    torch.set_num_threads(threads)
    t = _gan_trainer(cfg, dev, len(x))
    state = t._train_state(1)
    t.generator.train(), t.discriminator.train()
    imgs = torch.from_numpy(x).to(t.device)

    def cat(net, keep):
        return torch.cat([v.detach().flatten().cpu() for k, v in net.state_dict().items()
                          if keep(k)])

    def params(suffix=""):
        return {"g" + suffix: torch.cat([p.detach().flatten().cpu()
                                         for p in t.generator.parameters()]),
                "d" + suffix: torch.cat([p.detach().flatten().cpu()
                                         for p in t.discriminator.parameters()])}

    losses, first = [], params("0")
    for i in range(3):
        losses.append([float(v) for v in t._step(state, imgs, None, masks=masks.to(t.device))])
        if i == 0:
            first.update(params("1"))
    return {"losses": losses, **first, **params(),
            "u": cat(t.discriminator, lambda k: k.endswith((".u", ".sigma"))),
            "stats": torch.cat([cat(net, lambda k: "running" in k)
                                for net in (t.generator, t.discriminator)]),
            "lrs": {"g": [state.g_schedule(i) for i in range(3)],
                    "d": [state.d_schedule(i) for i in range(3)]}}


def adam_bound(lrs, beta1: float, beta2: float = 0.999) -> float:
    """Twice the most Adam can move one weight over ``len(lrs)`` steps (L2
    decay aside): step t moves it by at most c_t lr_t, c_t = sqrt(sum_i
    a_i^2 / b_i) over the bias-corrected weights a_i of the first moment and
    b_i of the second (Cauchy-Schwarz): 1, 1.054, 1.133 for beta1 0.5."""
    out = 0.0
    for t, lr in enumerate(lrs, start=1):
        a = [(1 - beta1) * beta1 ** (t - i) / (1 - beta1 ** t) for i in range(1, t + 1)]
        b = [(1 - beta2) * beta2 ** (t - i) / (1 - beta2 ** t) for i in range(1, t + 1)]
        out += lr * sum(x * x / y for x, y in zip(a, b)) ** 0.5
    return 2 * out


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))


def _share_within(a: torch.Tensor, b: torch.Tensor, atol: float) -> float:
    return float(((a - b).abs() <= atol).double().mean())


def _quantile(x: torch.Tensor, q: float) -> float:
    return float(np.quantile(x.abs().numpy(), q))


def _stroke_edges(draws: dict, shape) -> np.ndarray:
    """(B, H, W): pixels within 1e-4 of a valid stroke segment's edge, from
    the draws in float64 (the render's float32 may fall either side)."""
    h, w = shape
    d = {k: v.cpu().numpy().astype(np.float64) for k, v in draws.items()}
    b, _, v = d["angs"].shape
    a = d["beta"][..., None] + d["angs"] + np.where(np.arange(v) % 2 == 0, np.pi, 0.0)
    ys = np.concatenate([d["sy"][..., None], d["sy"][..., None]
                         + np.cumsum(d["lens"] * np.cos(a), -1)], -1)
    xs = np.concatenate([d["sx"][..., None], d["sx"][..., None]
                         + np.cumsum(d["lens"] * np.sin(a), -1)], -1)
    py, px = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((b, h, w), bool)
    for i in range(b):
        for s in range(int(d["n_strokes"][i])):
            for j in range(int(d["n_vert"][i, s])):
                y0, x0 = ys[i, s, j], xs[i, s, j]
                dy, dx = ys[i, s, j + 1] - y0, xs[i, s, j + 1] - x0
                t = np.clip(((py - y0) * dy + (px - x0) * dx) / (dy * dy + dx * dx + 1e-8), 0, 1)
                dist = np.hypot(py - y0 - t * dy, px - x0 - t * dx)
                out[i] |= np.abs(dist - d["width"][i, s] / 2.0) < 1e-4
    return out


def _gan_holds(cfg: dict, normal: np.ndarray) -> None:
    """(c) card against CPU with TF32 off: three full-width steps, the
    contextual-attention generator's forward and backward, the mask
    render, morphology and hysteresis."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.get_num_threads()
    size = cfg["data"]["size"]
    x = normal[:GAN_HOLD_BATCH]
    masks = random_ff_masks(K(SEED), len(x), (size, size), **cfg["mask"])
    card, cpu, ref = (_gan_hold_run(cfg, dev, x, masks, threads)
                      for dev, threads in ((DEV, n), ("cpu", n), ("cpu", max(1, n // 2))))
    torch.set_num_threads(n)
    step1 = max(abs(a - b) / abs(b) for a, b in zip(card["losses"][0][1:], cpu["losses"][0][1:]))
    # the 3-step D loss and L1 (the G loss sits near 0: its relative gap
    # says little): a skipped or wrong optimizer step moves the card's
    # trajectory by about what one step changes it by on the CPU, and the
    # limit is a quarter of the least such change
    traj, traj_ref, traj_lim = {}, {}, {}
    for col, name in ((1, "D"), (2, "L1")):
        c = [row[col] for row in cpu["losses"]]
        traj[name] = _rel([row[col] for row in card["losses"]], c)
        traj_ref[name] = _rel([row[col] for row in ref["losses"]], c)
        traj_lim[name] = min(abs(b - a) / abs(b) for a, b in zip(c, c[1:])) / 4
    # the weights: Adam's first step moves every weight by lr times the sign
    # of its gradient, whatever the gradient's size, so after one step two
    # runs agree to rounding wherever the signs agree and differ by 2 lr
    # where a gradient at float32's noise floor flips (a conv bias before
    # BatchNorm; about 0.7% of G's weights and 0.4% of D's CPU against CPU):
    # 98% of each net's weights within a tenth of lr after the first step
    # (a skipped step leaves only those its first step moved by less, a
    # sign-flipped one almost none); after the
    # third, where the discriminator's noisy biases have reached the
    # generator's gradient through D's eval-mode output, all within Adam's
    # bound
    bounds = {k: adam_bound(cpu["lrs"][k], 0.5) + 1e-6 for k in ("g", "d")}
    tight = {k: cpu["lrs"][k][0] / 10 for k in ("g", "d")}
    share = {k: _share_within(card[k + "1"], cpu[k + "1"], tight[k]) for k in ("g", "d")}
    share_ref = {k: _share_within(ref[k + "1"], cpu[k + "1"], tight[k]) for k in ("g", "d")}
    share_skip = {k: _share_within(cpu[k + "0"], cpu[k + "1"], tight[k]) for k in ("g", "d")}
    share3 = {k: _share_within(card[k], cpu[k], tight[k]) for k in ("g", "d")}
    share3_ref = {k: _share_within(ref[k], cpu[k], tight[k]) for k in ("g", "d")}
    q99 = {k: _quantile(card[k] - cpu[k], 0.99) for k in ("g", "d")}
    q99_ref = {k: _quantile(ref[k] - cpu[k], 0.99) for k in ("g", "d")}
    diffs = {k: float((card[k] - cpu[k]).abs().max()) for k in ("g", "d", "u", "stats")}
    refs = {k: float((ref[k] - cpu[k]).abs().max()) for k in ("g", "d", "u", "stats")}
    print(f"gan (c) step hold, full width, batch {len(x)} of {size}^2, injected masks from one "
          f"key, TF32 off, "
          f"card vs cpu ({n} threads; reference: cpu with {max(1, n // 2)} threads vs {n}): "
          f"step-1 D loss and L1 rel diff {step1!r} (tolerance 1e-5); [G, D, L1] over 3 steps "
          f"card {card['losses']!r} cpu {cpu['losses']!r}; D loss and L1 max rel diff {traj!r} "
          f"(reference {traj_ref!r}; tolerance a quarter of the least step-to-step change on the "
          f"cpu {traj_lim!r}); share of the weights within {tight} (a tenth of one Adam step) "
          f"after step 1: card {share!r} (reference {share_ref!r}; a skipped step: {share_skip!r}; "
          f"tolerance 0.98); after step 3: "
          f"card {share3!r} (reference {share3_ref!r}), 99th percentile |diff| {q99!r} (reference "
          f"{q99_ref!r}), max |diff| G {diffs['g']!r} D {diffs['d']!r} (reference G {refs['g']!r} "
          f"D {refs['d']!r}; tolerance: Adam's bounds at betas (0.5, 0.999) {bounds}); "
          f"spectral-norm u and sigma {diffs['u']!r} (reference {refs['u']!r}), BatchNorm "
          f"statistics {diffs['stats']!r} (reference {refs['stats']!r}; tolerance max(1e-4, 10x "
          f"the reference))")
    check(step1 <= 1e-5 and all(traj[k] <= traj_lim[k] for k in traj),
          "gan: card and cpu losses disagree")
    check(all(share[k] >= 0.98 and diffs[k] <= bounds[k] for k in ("g", "d")),
          "gan: card and cpu weights disagree")
    check(all(diffs[k] <= max(1e-4, 10 * refs[k]) for k in ("u", "stats")),
          "gan: card and cpu spectral-norm or BatchNorm statistics disagree")

    # contextual attention: one forward and backward, card against cpu, in
    # float64: the attention's softmax (scale 10) over near-equal patch
    # similarities turns float32 rounding into differences of 1e-2 in the
    # gradient, and two CPU thread counts do not show that spread
    imgs = torch.from_numpy(x[..., None]).double()
    m = masks[..., None].double()
    runs = []
    for dev, threads in ((DEV, n), ("cpu", n), ("cpu", max(1, n // 2))):
        torch.set_num_threads(threads)
        g = GatedGenerator(lat_channels=cfg["net"]["lat_channels"], key=K(SEED))
        g = g.double().to(dev).train()
        fine, coarse = g(imgs.to(dev), m.to(dev))
        loss = torch.mean(torch.abs(fine - imgs.to(dev)) * m.to(dev)) + torch.mean(
            torch.abs(coarse - imgs.to(dev)) * m.to(dev))
        loss.backward()
        runs.append((torch.cat([fine.detach().flatten(), coarse.detach().flatten()]).cpu(),
                     torch.cat([p.grad.flatten() for p in g.parameters()]).cpu()))
        del g, fine, coarse, loss
    torch.set_num_threads(n)
    (oc, gc), (o1, g1), (o2, g2) = runs
    out_err, out_ref = float((oc - o1).abs().max()), float((o2 - o1).abs().max())
    scale = float(g1.abs().max())
    grad_err, grad_ref = float((gc - g1).abs().max()) / scale, float((g2 - g1).abs().max()) / scale
    print(f"gan (c) GatedGenerator with contextual attention, lat {cfg['net']['lat_channels']}, "
          f"batch {len(x)} of {size}^2, train mode, float64, card vs cpu: outputs max |diff| "
          f"{out_err!r} (reference {out_ref!r}; tolerance 1e-9), gradients max |diff| / max "
          f"|grad| {grad_err!r} (reference {grad_ref!r}; tolerance 1e-8)")
    check(out_err <= 1e-9 and grad_err <= 1e-8,
          "gan: contextual-attention generator card and cpu disagree")

    b = cfg["train"]["batch_size"]
    draws = draw_ff_masks(K(SEED + 1), b, (size, size), **cfg["mask"])
    on_cpu = render_ff_masks(draws, (size, size))
    card_draws = {k: v.to(DEV) for k, v in draws.items()}
    on_card = render_ff_masks(card_draws, (size, size)).cpu()
    render_ms = cuda_ms(render_ff_masks, card_draws, (size, size))
    edges = _stroke_edges(draws, (size, size))
    diff = (on_card != on_cpu).numpy()
    mk = (torch.from_numpy(np.random.default_rng(SEED).uniform(size=(b, size, size))) > 0.7).float()
    morph_eq = all(torch.equal(f(mk, k), f(mk.to(DEV), k).cpu())
                   for f in (morph.dilation, morph.erosion, morph.opening, morph.closing)
                   for k in (3, 5, 7))
    dmap = torch.from_numpy(np.random.default_rng(SEED + 1).gamma(1.5, size=(size, size))
                            .astype(np.float32))
    hyst_eq = torch.equal(morph.hysteresis_threshold(dmap, 2.0, 4.0),
                          morph.hysteresis_threshold(dmap.to(DEV), 2.0, 4.0).cpu())
    print(f"gan (c) mask render {b}x{size}^2 with the config's ranges, draws from one key: "
          f"{int(diff.sum())} pixels differ card vs cpu, all within 1e-4 of a "
          f"stroke's edge {not (diff & ~edges).any()} ({int(edges.sum())} such pixels); mask "
          f"share {float(on_cpu.mean())!r}; render on the card {render_ms!r} ms; dilation, "
          f"erosion, opening, closing at 3, 5, 7 equal {morph_eq}; hysteresis equal {hyst_eq}")
    check(not (diff & ~edges).any() and morph_eq and hyst_eq,
          "gan: card and cpu masks or morphology disagree")
    torch.backends.cudnn.allow_tf32 = True


def _ad_detect(cfg: dict, work: str, gan_out: str) -> None:
    """(d) the AD CLI with (a)'s generator and phase 9's ResNet-18 gate on a
    SegICH 2D tree, with the attention export; one slice's
    ``robust_anomaly_detect`` and one ``detect`` timed."""
    torch.backends.cudnn.allow_tf32 = True
    n_pat, n_slices, side = AD_TREE
    root = os.path.join(work, "ad_segich")
    ds = synthetic_ich_slices(n_slices=n_pat * n_slices, size=side, n_volumes=n_pat,
                              seed=SEED + 600)
    write_segich_tree(ds, root)
    gate = os.path.join(work, "out", "resnet18_triage", "resnet_classifier.bin")
    check(os.path.exists(gate), "ad: phase 9's ResNet-18 weights are missing")
    ad_cfg = {"exp_name": "ad_inpainting", "path": {"DATA": root, "OUTPUT": os.path.join(work, "out")},
              "data": cfg["data"], "net": cfg["net"],
              "ad": {"generator_path": os.path.join(gan_out, "snpatchgan.bin"),
                     "classifier_path": gate, "gate_threshold": 0.0}}
    fn = _write_cfg(ad_cfg, os.path.join(work, "ad.json"))
    att = os.path.join(work, "attention")
    edt.launches = edt.mask_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ad_inpainting.main([fn, "--device", DEV, "--export-attention", att])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "slice_prediction_scores.csv"), newline="") as f:
        slices = list(csv.DictReader(f))
    with open(os.path.join(out, "volume_prediction_scores.csv"), newline="") as f:
        vols = list(csv.DictReader(f))
    with open(os.path.join(att, "info.csv"), newline="") as f:
        info = list(csv.reader(f))
    maps = [read_png_gray(os.path.join(att, r[3])) for r in info[1:]]
    flagged = [float(r["TP"]) + float(r["FP"]) for r in slices]
    print(f"ad (d) ad_inpainting CLI on {n_pat} patients x {n_slices} slices of {side}^2 read at "
          f"{cfg['data']['size']}^2 (gate threshold 0, JAX defaults: holes 32x32, step 16, batch "
          f"16, n_iter 3, angles [-15, -7.5, 7.5, 15], flip) with --export-attention: {wall!r} s "
          f"= {wall / len(ds)!r} s a slice (the load, the gate and the exports included); "
          f"pixels flagged per slice {flagged}; volume Dice {[r['Dice'] for r in vols]}; "
          f"info.csv {info[0]} + {len(info) - 1} rows; EDT launches {_edt_launches()}")
    check(len(slices) == len(ds) and len(vols) == n_pat, "ad: CSV rows")
    check(info[0] == ["", "PatientNumber", "SliceNumber", "attention_fn"]
          and [r[0] for r in info[1:]] == [str(i) for i in range(len(ds))], "ad: info.csv")
    check(all(m.shape == (cfg["data"]["size"],) * 2 for m in maps), "ad: attention maps")

    det = ad_inpainting.build_detector(ad_cfg, DEV)
    calls = []
    inpaint = det.inpaint_fn

    def counted(imgs, masks):
        calls.append(len(imgs))
        return inpaint(imgs, masks)

    det.inpaint_fn = counted
    test = load_segich_2d(root, window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
                          size=cfg["data"]["size"])
    img = test.images[int(np.argmax(test.masks.reshape(len(test), -1).sum(1)))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.detect(img)
    torch.cuda.synchronize()
    detect_s, detect_calls = time.perf_counter() - t0, list(calls)
    secs = detector_seconds(det, img, "ad (d)", warm=False)
    calls.clear()
    t0 = time.perf_counter()
    final, amap = robust_anomaly_detect(img, det)
    torch.cuda.synchronize()
    robust_s = time.perf_counter() - t0
    print(f"ad (d) one slice with a lesion: detect {detect_s!r} s cold, {secs['kl']!r} s warm "
          f"(W1 {secs['w1']!r} s) with {len(detect_calls)} "
          f"generator calls (batch sizes {sorted(set(detect_calls))}, "
          f"{sum(c == 1 for c in detect_calls)} of batch 1); robust_anomaly_detect {robust_s!r} "
          f"s with {len(calls)} generator calls ({sum(c == 1 for c in calls)} of batch 1); "
          f"anomaly-map share above 0 {float((amap > 0).mean())!r}, final mask share "
          f"{float(final.mean())!r}")
    check(final.shape == img.shape and np.isfinite(amap).all(), "ad: robust_anomaly_detect")


def detector_seconds(det, image: np.ndarray, label: str, warm: bool = True) -> dict:
    """Wall seconds of one ``det.detect(image)`` with the KL distance
    (``"kl"``) and one with W1 (``"w1"``, its null sample drawn on the
    detector's device), after a warm-up detect unless ``warm`` is false;
    printed under ``label``. ``det``'s own distance is restored."""
    w1 = det.use_wasserstein
    out = {}
    if warm:
        det.detect(image)
    for name, flag in (("kl", False), ("w1", True)):
        det.use_wasserstein = flag
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.detect(image)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    det.use_wasserstein = w1
    print(f"{label} detector seconds a slice of {image.shape}, warm: detect with KL "
          f"{out['kl']!r} s, with W1 {out['w1']!r} s")
    return out


OP_GROUPS_GAN = (("conv backward", ("convolution_backward",)), ("conv forward", ("conv",)),
                 ("batch_norm", ("batch_norm",)), ("attention bmm/softmax", ("bmm", "softmax")),
                 ("gating sigmoid/mul", ("sigmoid", "aten::mul")),
                 ("reflect pad and upsample", ("reflection_pad", "index_select", "upsample")),
                 ("adam", ("_foreach_",)), ("copy", ("copy_", "to_copy")))
GAN_RANGES = ("masks", "d_step", "g_step", "edt_loss")


def _gan_step_times(cfg: dict, normal: np.ndarray):
    """(e) warm ms per step of each ``GAN_TIMED`` cell (TF32 on for convs
    and matmuls), FLOPs and their rate, peak memory, the generator's
    inference at batch 16 and 1; returns the warm (trainer, state, batch)
    of ``gan_sa_bs16``."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    images = torch.from_numpy(normal).to(DEV)
    size = cfg["data"]["size"]
    warm = None
    for cell, sa, bs in GAN_TIMED:
        t = _gan_trainer(cfg, DEV, bs, self_attention=sa)
        state = t._train_state(max(1, len(normal) // bs))
        t.generator.train(), t.discriminator.train()
        plan = np.random.default_rng(SEED).integers(0, len(normal), size=(4, bs))
        batches = [images.index_select(0, torch.as_tensor(p, device=images.device)) for p in plan]
        ms = _ssl_warm_ms(t, state, batches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops = compiled_flops(t._train_step, state, batches[0], K(99))
        tflops = flops / ms / 1e9
        g = t.generator.eval()
        m = random_ff_masks(K(SEED), bs, (size, size), DEV, **cfg["mask"])[..., None]
        x = batches[0][..., None]

        def infer(k):
            with torch.inference_mode():
                return g(x[:k], m[:k])

        infer_flops = compiled_flops(infer, 1)
        inf16, inf1 = cuda_ms(infer, bs, iters=10), cuda_ms(infer, 1, iters=10)
        g.train()
        print(f"{cell}: {'SAGatedGenerator' if sa else 'GatedGenerator with contextual attention'} "
              f"lat {cfg['net']['lat_channels']} + PatchDiscriminator, batch {bs} of {size}^2, "
              f"float32 (TF32 on for convs and matmuls): {ms!r} ms/step = {bs / ms * 1e3!r} "
              f"slices/s; {flops / 1e12!r} TFLOP per step (FlopCounterMode: G forward without "
              f"grad, D forward and backward twice, G forward and backward through D) = "
              f"{tflops!r} TFLOP/s, {100 * tflops / PEAK['tf32']!r}% of the dense TF32 peak; "
              f"peak device memory {peak!r} GiB; generator inference {inf16!r} ms at batch {bs} "
              f"({bs / inf16 * 1e3!r} slices/s), {inf1!r} ms at batch 1 ({infer_flops / 1e9!r} "
              f"GFLOP a slice)")
        if sa:
            warm = (t, state, batches[0])
        else:
            del t, state, batches
            torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"gan nvidia-smi after the timed steps: {smi}")
    return warm


def _gan_profile(t, state, batch) -> None:
    """(e) one warm ``gan_sa_bs16`` step under torch.profiler, and the EDT
    kernels' share of its device time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t._train_step(state, batch, K(400))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(_profile_summary(prof, wall_ms, f"gan profile (one warm gan_sa_bs16 step, batch "
                           f"{t.batch_size}, TF32 on)", OP_GROUPS_GAN, GAN_RANGES))
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == cuda and e.key not in GAN_RANGES]
    total = sum(v for _, v in kernels) or 1.0
    edt_us = sum(v for k, v in kernels if "envelope" in k or "mask_rows" in k)
    print(f"gan profile EDT kernels: {edt_us!r} us = {100 * edt_us / total:.3f}% of the step's "
          f"device time")
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_gan(work: str, data) -> dict:
    """Phase 10 on phase 8's RSNA tree and phase 9's ResNet-18 weights;
    returns the EDT launches of the GAN training path (a)."""
    cfg = load_gan_cfg(work)
    normal = np.ascontiguousarray(data.images[np.asarray(data.labels)[:, 0] == 0])
    check(data.images.shape[1] == cfg["data"]["size"], "gan: phase 8's slices are not the config's size")
    out, launches, steps = _gan_train(cfg, work, normal)
    torch.cuda.empty_cache()
    _gan_holds(cfg, normal)
    torch.cuda.empty_cache()
    _ad_detect(cfg, work, out)
    torch.cuda.empty_cache()
    _gan_profile(*_gan_step_times(cfg, normal))
    return launches


# -- phase 11: the AE, FCDD and the attention U-Net -----------------------------------

AE_EPOCHS = 2  # the repo states no epoch count for the AE
AE_LAMBDA_GDL = {"0": 0.0, "1": 1.0}  # both branches of the AE step run
FCDD_CFG = "configs/fcdd.json"
FCDD_EPOCHS = 2  # the config: 60
ATTN_SPLIT = (2, 1)  # the attention U-Net's folds and epochs (configs/unet2d.json: 10, 100)
AD_HOLD_BATCH = 2  # the card/CPU holds (the CPU's step time)
AD_TIMED = (("ae_bs32", "ae", 32), ("fcdd_bs32", "fcdd", 32), ("attn_unet2d_bs16", "attn", 16))
AD_CELLS = {"ae": "AENet defaults (transposed-conv decoder), lambda_GDL 1",
            "fcdd": f"FCDD_CNN_VGG ({FCDD_CFG}, its ellipses drawn each step)",
            "attn": "gated U-Net (configs/unet2d.json) on 2 channels with its augmentation"}


def load_ad_cfgs(work: str) -> dict:
    """Three configs reading phase 8's RSNA tree and phase 9's SegICH 2D tree
    under ``work`` and writing under ``work/out``: the AE's (``AENet``'s
    defaults, the reference ``AE_net``'s; ``configs/fcdd.json``'s data,
    batch and lr; ``AE_EPOCHS`` epochs with ``AE_LAMBDA_GDL``),
    ``configs/fcdd.json`` (its width as it is) cut to ``FCDD_EPOCHS``
    epochs, and ``configs/unet2d.json`` cut to ``ATTN_SPLIT``."""
    paths = {"RSNA_DATA": os.path.join(work, "rsna", "stage_2_train"),
             "DATA": os.path.join(work, "segich2d"), "OUTPUT": os.path.join(work, "out")}
    with open(FCDD_CFG) as f:
        fc = json.load(f)
    fc["path"] = dict(paths)
    fc["train"]["n_epoch"] = FCDD_EPOCHS
    fc["ad"]["model_path"] = os.path.join(paths["OUTPUT"], fc["exp_name"], "fcdd.bin")
    ae = {"exp_name": "AE", "seed": fc["seed"], "path": dict(paths), "data": dict(fc["data"]),
          "net": {"latent_channels": 64, "bottelneck_channels": 64, "n_conv": 3,
                  "bilinear": False, "kernel_size": 5},
          "train": {"n_epoch": AE_EPOCHS, "batch_size": fc["train"]["batch_size"],
                    "lr": fc["train"]["lr"], "lambda_GDL": dict(AE_LAMBDA_GDL)},
          "ad": {"model_path": os.path.join(paths["OUTPUT"], "AE", "ae.bin"), "alpha": 1.5}}
    with open(TRAIN_CFG) as f:
        un = json.load(f)
    un["exp_name"] = "attention_unet2d"
    un["path"] = {"DATA": paths["DATA"], "OUTPUT": paths["OUTPUT"]}
    un["split"]["n_fold"], un["train"]["n_epoch"] = ATTN_SPLIT
    return {"ae": ae, "fcdd": fc, "unet": un}


def _read_rows(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _scores(out: str, n_slices: int, n_vols: int) -> tuple:
    """The volume Dice and the pixel AUCs of the slices with a lesion from a
    detector's two CSVs, their row counts checked."""
    slices = _read_rows(os.path.join(out, "slice_prediction_scores.csv"))
    vols = _read_rows(os.path.join(out, "volume_prediction_scores.csv"))
    check(len(slices) == n_slices and len(vols) == n_vols,
          f"ad: {len(slices)} slice and {len(vols)} volume rows in {out}")
    auc = [float(r["pixel_AUC"]) for r in slices if r["label"] == "1"]
    dice = [float(r["Dice"]) for r in vols]
    check(auc and np.isfinite(auc).all() and np.isfinite(dice).all(),
          f"ad: pixel AUC {auc} or Dice {dice} not finite in {out}")
    return dice, auc


def _ad_ae(cfg: dict, work: str, normal: np.ndarray, n_tree: tuple) -> None:
    """(a) the AE CLI on the non-ICH slices and the saved model's
    validation, (b) ``--detect`` on phase 9's tree."""
    fn = _write_cfg(cfg, os.path.join(work, "ae.json"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ae_ad.main([fn, "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("checkpoint.bin", "ae.bin", "outputs.json"):
        check(os.path.exists(os.path.join(out, name)), f"ae: no {name}")
    hist = _train_history(out)
    # the CLI validates every 5 epochs: validate the saved model instead
    ae = ae_ad.build_ae(cfg, DEV)
    ae.load_model(os.path.join(out, "ae.bin"))
    valid_dir = os.path.join(work, "ae_valid")
    l1 = ae.validate(LabeledSliceDataset(normal, np.zeros(len(normal))), save_path=valid_dir,
                     epoch=AE_EPOCHS)
    pngs = [read_png_gray(os.path.join(valid_dir, f"rec_ep{AE_EPOCHS}_{i}.png"))
            for i in range(8)]
    del ae
    n, tr, size = cfg["net"], cfg["train"], cfg["data"]["size"]
    print(f"ad (a) ae_ad CLI (AENet latent {n['latent_channels']}, bottleneck "
          f"{n['bottelneck_channels']}, n_conv {n['n_conv']}, kernel {n['kernel_size']}, "
          f"transposed-conv decoder; batch {tr['batch_size']} of {size}^2, lr {tr['lr']}, "
          f"lambda_GDL {tr['lambda_GDL']}): {len(normal)} non-ICH slices, {AE_EPOCHS} epochs x "
          f"{len(normal) // tr['batch_size']} steps in {wall!r} s (RSNA load included); [epoch, "
          f"loss] {hist!r}; the saved model's validation L1 {l1!r}, {len(pngs)} PNGs of "
          f"{pngs[0].shape}")
    check(len(hist) == AE_EPOCHS and np.isfinite([r[1] for r in hist]).all(),
          f"ae: losses {hist}")
    check(hist[1][1] > 10 * hist[0][1], f"ae: no GDL jump at the lambda switch {hist}")
    check(np.isfinite(l1) and all(p.shape == (size, 2 * size) for p in pngs),
          f"ae: validation {l1} {pngs[0].shape}")

    fn = _write_cfg(cfg, os.path.join(work, "ae_detect.json"))
    t0 = time.perf_counter()
    out = ae_ad.main([fn, "--detect", "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dice, auc = _scores(out, *n_tree)
    print(f"ad (b) ae_ad --detect on phase 9's tree ({n_tree[0]} slices of "
          f"{SEGICH2D_TREE[2]}^2 read at {size}^2, alpha {cfg['ad']['alpha']}) in {wall!r} s: "
          f"volume Dice mean {float(np.mean(dice))!r}, pixel AUC on the {len(auc)} slices with a "
          f"lesion mean {float(np.mean(auc))!r}")


def _ad_fcdd(cfg: dict, work: str, n_tree: tuple) -> None:
    """(c) the FCDD CLI, then ``--eval-volumes`` on phase 9's tree."""
    fn = _write_cfg(cfg, os.path.join(work, "fcdd.json"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fcdd.main([fn, "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("checkpoint.bin", "fcdd.bin", "outputs.json"):
        check(os.path.exists(os.path.join(out, name)), f"fcdd: no {name}")
    hist = _train_history(out)
    size = cfg["data"]["size"]
    pngs = [read_png_gray(os.path.join(out, "localization", f"anomaly_{i}.png"))
            for i in range(8)]
    tr = cfg["train"]
    print(f"ad (c) fcdd CLI ({FCDD_CFG}: FCDD_CNN_VGG, batch {tr['batch_size']} of {size}^2, lr "
          f"{tr['lr']}, ellipses {cfg['anomaly']['drawing_params']} with proba "
          f"{cfg['anomaly']['proba']}, gauss_std {cfg['anomaly']['gauss_std']}) for "
          f"{FCDD_EPOCHS} epochs in {wall!r} s (RSNA load, the AUC each epoch, the heatmap range "
          f"and the localization PNGs included); [epoch, loss, AUC] {hist!r}; {len(pngs)} PNGs "
          f"of {pngs[0].shape}")
    check(len(hist) == FCDD_EPOCHS and all(np.isfinite(r[1]) and 0 <= r[2] <= 1 for r in hist),
          f"fcdd: losses or AUCs {hist}")
    check(all(p.shape == (size, 2 * size) for p in pngs), "fcdd: localization PNGs")
    t0 = time.perf_counter()
    out = fcdd.main([fn, "--eval-volumes", "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dice, auc = _scores(out, *n_tree)
    print(f"ad (c) fcdd --eval-volumes on phase 9's tree (threshold {cfg['ad']['threshold']}) in "
          f"{wall!r} s: volume Dice mean {float(np.mean(dice))!r}, pixel AUC on the {len(auc)} "
          f"slices with a lesion mean {float(np.mean(auc))!r}")


def merge_attention_info(data_dir: str, export_dir: str) -> None:
    """``data_dir/info.csv``: the rows of ``ct_info.csv`` with the export's
    ``attention_fn`` (made relative to ``data_dir``) merged in by
    (PatientNumber, SliceNumber), the step that the reference's
    ``update_publicDataset.py`` does between the export and the attention
    U-Net."""
    rel = os.path.relpath(export_dir, data_dir)
    att = {(r["PatientNumber"], r["SliceNumber"]): os.path.join(rel, r["attention_fn"])
           for r in _read_rows(os.path.join(export_dir, "info.csv"))}
    with open(os.path.join(data_dir, "ct_info.csv"), newline="") as f:
        rows = list(csv.reader(f))
    with open(os.path.join(data_dir, "info.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(rows[0] + ["attention_fn"])
        w.writerows(r + [att[(r[1], r[2])]] for r in rows[1:])


def _ad_attention(cfgs: dict, work: str) -> np.ndarray:
    """(d) the attention tree (the AE maps of (b) exported as
    ``ad_inpainting --export-attention`` writes them, merged into phase 9's
    tree) and the attention U-Net CLI on it; returns the tree's two-channel
    images (slice, exported map)."""
    ae_cfg, un = cfgs["ae"], cfgs["unet"]
    tree = un["path"]["DATA"]
    ae = ae_ad.build_ae(ae_cfg, DEV)
    ae.load_model(ae_cfg["ad"]["model_path"])
    win = (ae_cfg["data"]["win_center"], ae_cfg["data"]["win_width"])
    test = load_segich_2d(tree, window=win, size=ae_cfg["data"]["size"])
    amaps = ae.anomaly_map(test.images)
    del ae
    export = os.path.join(tree, "attention")
    ad_inpainting.write_attention_info(export, [
        (int(v), int(s), ad_inpainting.save_attention_map(export, int(v), int(s), m))
        for v, s, m in zip(test.vol_ids, test.slice_nbrs, amaps)])
    merge_attention_info(tree, export)
    fn = _write_cfg(un, os.path.join(work, "attention_unet2d.json"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = attention_unet2d.main([fn, "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tested = []
    for k in range(un["split"]["n_fold"]):
        fold = os.path.join(out, f"Fold_{k + 1}")
        for name in ("outputs.json", "trained_unet.bin", "log.txt",
                     "pred/slice_prediction_scores.csv", "pred/volume_prediction_scores.csv"):
            check(os.path.exists(os.path.join(fold, name)), f"attention fold {k + 1}: no {name}")
        tested += [int(r["volID"]) for r in
                   _read_rows(os.path.join(fold, "pred/volume_prediction_scores.csv"))]
        conv1 = torch.load(os.path.join(fold, "trained_unet.bin"),
                           weights_only=True)["down_block.0.conv1.weight"]
        mid = un["net"]["top_filter"] // un["net"]["midchannels_factor"]
        check(tuple(conv1.shape[:2]) == (2 * mid, 2),  # features and gate, on 2 channels
              f"attention fold {k + 1}: first conv {tuple(conv1.shape)}")
    with open(os.path.join(out, "config.json")) as f:
        net = json.load(f)["net"]
    with open(os.path.join(out, "average_scores.txt")) as f:
        avg = f.read().strip().replace("\n", "; ")
    print(f"ad (d) attention tree: {len(amaps)} AE maps exported (max {float(amaps.max())!r}) "
          f"and merged into info.csv; attention_unet2d CLI ({TRAIN_CFG} gated on 2 channels, "
          f"{un['split']['n_fold']} folds x {un['train']['n_epoch']} epoch) in {wall!r} s: {avg}; "
          f"first conv {tuple(conv1.shape)}")
    check(net.get("gated") is True and net.get("in_channels") == 2, f"attention: net {net}")
    check(sorted(tested) == list(range(SEGICH2D_TREE[0])), f"attention: tested volumes {tested}")
    return np.stack([test.images, np.clip(amaps, 0, 1)], axis=-1), test.masks


def _ad_trainer(kind: str, cfgs: dict, device, batch: int, hold: bool = False):
    """A full-width trainer of ``kind`` from seeded weights: the AE at lambda
    1, FCDD, or the gated U-Net on two channels (with the config's
    augmentation and dropout, or with neither for a ``hold``)."""
    if kind == "attn":
        un = cfgs["unet"]
        aug = None if hold else build_pipeline(un["data"]["augmentation"]["train"])
        net = {"gated": True, "in_channels": 2, **({"p_dropout": 0.0} if hold else {})}
        return _trainer(un, device, net=net, batch_size=batch, augment_fn=aug)
    cfg = {**cfgs[kind], "train": {**cfgs[kind]["train"], "batch_size": batch}}
    if kind == "fcdd":
        return fcdd.build_fcdd(cfg, device)
    t = ae_ad.build_ae(cfg, device)
    t.lambda_gdl = 1.0
    return t


def _net_of(t) -> torch.nn.Module:
    return t.unet if isinstance(t, UNet2D) else t.net


def _ad_inputs(kind: str, cfgs: dict, images: np.ndarray, masks: np.ndarray) -> list:
    """The hold's batch of ``kind``: the images (and the masks, or the
    labels, one ellipse image each with the config's drawing params and the
    uniforms that corrupt the first slice but not the second)."""
    b, size = len(images), images.shape[1]
    if kind == "ae":
        return [torch.from_numpy(images[..., 0])]
    if kind == "fcdd":
        ell = draw_ellipses_batch(K(SEED + 11), b, (size, size),
                                  **cfgs["fcdd"]["anomaly"]["drawing_params"])
        return [torch.from_numpy(images[..., 0]), torch.zeros(b, dtype=torch.int32), ell,
                torch.tensor([0.2, 0.7] * (b // 2))]
    return [torch.from_numpy(images), torch.from_numpy(masks)]


def _ad_hold_step(kind: str, t, state, args: list):
    if kind == "ae":
        return t._step(state, args[0], K(SEED))  # the key seeds dropout's generator
    if kind == "fcdd":
        return t._step(state, args[0], args[1], None, ellipses=args[2], u=args[3])
    return t._step(state, args[0], args[1], K(SEED))


def _ad_hold_run(kind: str, cfgs: dict, dev, inputs: list, threads: int) -> dict:
    """Three steps on one batch: the losses, the weights before the first
    step, after it and after the third, the running statistics after the
    third."""
    torch.set_num_threads(threads)
    t = _ad_trainer(kind, cfgs, dev, AD_HOLD_BATCH, hold=True)
    net = _net_of(t)
    state = t._train_state(1)
    net.train()
    args = [a.to(t.device) for a in inputs]

    def params():
        return torch.cat([p.detach().flatten().cpu() for p in net.parameters()])

    out = {"p0": params(), "losses": []}
    for i in range(3):
        out["losses"].append(float(_ad_hold_step(kind, t, state, args)))
        if i == 0:
            out["p1"] = params()
    out.update(p3=params(), lrs=[state.schedule(i) for i in range(3)],
               stats=torch.cat([b.detach().flatten().cpu() for k, b in net.named_buffers()
                                if "running" in k]))
    net.eval()
    return out


def _ellipse_edges(draws: dict, shape) -> np.ndarray:
    """(B, H, W): pixels whose ellipse equation is within 1e-4 of 1 for a
    valid ellipse, from the draws in float64 (the render's float32 may fall
    either side)."""
    h, w = shape
    d = {k: v.cpu().numpy().astype(np.float64) for k, v in draws.items()}
    py, px = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((len(d["n"]), h, w), bool)
    for i in range(len(d["n"])):
        for j in range(int(d["n"][i])):
            dy, dx = py - d["cy"][i, j], px - d["cx"][i, j]
            c, s = np.cos(d["theta"][i, j]), np.sin(d["theta"][i, j])
            q = (((dy * c + dx * s) / max(d["minor"][i, j], 1e-3)) ** 2
                 + ((-dy * s + dx * c) / max(d["major"][i, j], 1e-3)) ** 2)
            out[i] |= np.abs(q - 1.0) < 1e-4
    return out


def _ad_holds(cfgs: dict, images: np.ndarray, masks: np.ndarray) -> None:
    """(e) card against CPU with TF32 off: three full-width steps of each
    trainer, the ellipse render, the receptive upsample and grad_heatmap."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.get_num_threads()
    size = cfgs["fcdd"]["data"]["size"]
    x, y = images[:AD_HOLD_BATCH], masks[:AD_HOLD_BATCH]
    for kind, name in (("ae", "AE (AENet defaults, lambda 1)"),
                       ("fcdd", "FCDD (configs/fcdd.json, injected ellipses)"),
                       ("attn", "gated U-Net (configs/unet2d.json on 2 channels)")):
        inputs = _ad_inputs(kind, cfgs, x, y)
        card, cpu, ref = (_ad_hold_run(kind, cfgs, dev, inputs, threads)
                          for dev, threads in ((DEV, n), ("cpu", n), ("cpu", max(1, n // 2))))
        torch.set_num_threads(n)
        c = cpu["losses"]
        step1 = abs(card["losses"][0] - c[0]) / abs(c[0])
        traj, traj_ref = _rel(card["losses"], c), _rel(ref["losses"], c)
        traj_lim = min(abs(b - a) / abs(b) for a, b in zip(c, c[1:])) / 4
        lr = cpu["lrs"][0]
        share, share_ref = (_share_within(r["p1"], cpu["p1"], lr / 10) for r in (card, ref))
        share_skip = _share_within(cpu["p0"], cpu["p1"], lr / 10)
        bound = adam_bound(cpu["lrs"], 0.9) + 1e-6
        diff, diff_ref = (float((r["p3"] - cpu["p3"]).abs().max()) for r in (card, ref))
        st, st_ref = (float((r["stats"] - cpu["stats"]).abs().max()) for r in (card, ref))
        print(f"ad (e) step hold {name}, batch {AD_HOLD_BATCH} of {size}^2, TF32 off, card vs "
              f"cpu ({n} threads; reference: cpu with {max(1, n // 2)} threads vs {n}): step-1 "
              f"loss rel diff {step1!r} (tolerance 1e-5); losses over 3 steps card "
              f"{card['losses']!r} cpu {c!r}, max rel diff {traj!r} (reference {traj_ref!r}; "
              f"tolerance a quarter of the least step-to-step change on the cpu {traj_lim!r}); "
              f"share of the weights within lr/10 = {lr / 10!r} after step 1: card {share!r} "
              f"(reference {share_ref!r}; a skipped step: {share_skip!r}; tolerance 0.98); max "
              f"|diff| after step 3 {diff!r} (reference {diff_ref!r}; tolerance Adam's bound "
              f"{bound!r}); running statistics max |diff| {st!r} (reference {st_ref!r}; "
              f"tolerance max(1e-4, 10x the reference))")
        check(step1 <= 1e-5 and traj <= traj_lim, f"ad {kind}: card and cpu losses disagree")
        check(share >= 0.98 and diff <= bound, f"ad {kind}: card and cpu weights disagree")
        check(st <= max(1e-4, 10 * st_ref), f"ad {kind}: card and cpu statistics disagree")

    b = cfgs["fcdd"]["train"]["batch_size"]
    params = cfgs["fcdd"]["anomaly"]["drawing_params"]
    draws = draw_ellipse_params(K(SEED + 12), b, (size, size), **params)
    on_cpu = render_ellipses(draws, (size, size))
    card_draws = {k: v.to(DEV) for k, v in draws.items()}
    on_card = render_ellipses(card_draws, (size, size)).cpu()
    render_ms = cuda_ms(render_ellipses, card_draws, (size, size))
    edges = _ellipse_edges(draws, (size, size))
    differ = (on_card != on_cpu).numpy()
    s = torch.randn(b, 1, size // 8, size // 8, generator=torch.Generator().manual_seed(SEED))
    std = cfgs["fcdd"]["anomaly"]["gauss_std"]
    up_cpu = receptive_upsample(s, (size, size), std=std)
    up_card = receptive_upsample(s.to(DEV), (size, size), std=std).cpu()
    up_err = float((up_card - up_cpu).abs().max() / up_cpu.abs().max())
    print(f"ad (e) ellipse render {b}x{size}^2 with {FCDD_CFG}'s drawing params, draws from one "
          f"key: {int(differ.sum())} pixels differ card vs cpu, all within 1e-4 of an "
          f"ellipse's edge {not (differ & ~edges).any()} ({int(edges.sum())} such pixels); "
          f"ellipse share {float((on_cpu > 0).float().mean())!r}; render on the card "
          f"{render_ms!r} ms; receptive upsample of {tuple(s.shape)} to {size}^2 (gauss_std "
          f"{std}) max |diff| / max {up_err!r} (tolerance 1e-5)")
    check(not (differ & ~edges).any(), "ad: card and cpu ellipse renders disagree")
    check(up_err <= 1e-5, "ad: card and cpu receptive upsamples disagree")

    # grad_heatmap in float32 and float64: the input gradient passes three
    # max-pools, whose argmax a float32 rounding can move between two
    # near-equal inputs, and such a flip moves a gradient to another pixel
    # (the CPU, whose result does not depend on its thread count, shows no
    # spread); in float64 no flip is left, and the card holds to the CPU
    heat = {}
    for dtype in (torch.float32, torch.float64):
        for dev, threads in ((DEV, n), ("cpu", n), ("cpu", max(1, n // 2))):
            torch.set_num_threads(threads)
            f = _ad_trainer("fcdd", cfgs, dev, 4)
            f.net.to(dtype)
            heat.setdefault(dtype, []).append({
                m: torch.from_numpy(f.grad_heatmap(images[:4, ..., 0].astype(np.float64), m))
                for m in ("grad", "xgrad")})
    torch.set_num_threads(n)

    def spread(a, b):
        return {m: float((a[m] - b[m]).abs().max() / b[m].abs().max()) for m in a}

    (c32, p32, _), (c64, p64, r64) = heat[torch.float32], heat[torch.float64]
    l2_32 = {m: float((c32[m] - p32[m]).norm() / p32[m].norm()) for m in c32}
    errs, refs = spread(c64, p64), spread(r64, p64)
    print(f"ad (e) FCDD grad_heatmap of 4 slices of {size}^2, card vs cpu: float32 max |diff| / "
          f"max {spread(c32, p32)!r}, rel L2 {l2_32!r} (max-pool argmax flips; not held); "
          f"float64 max |diff| / max {errs!r} (reference {refs!r}; tolerance max(1e-9, 10x "
          f"the reference))")
    check(all(errs[m] <= max(1e-9, 10 * refs[m]) for m in errs),
          "ad: card and cpu grad_heatmap disagree")
    torch.backends.cudnn.allow_tf32 = True


def _ad_step_times(cfgs: dict, rsna: np.ndarray, labels: np.ndarray, att_images: np.ndarray,
                   att_masks: np.ndarray):
    """(f) warm ms per step of each ``AD_TIMED`` cell (TF32 on), FLOPs and
    their rate, peak memory, and FCDD's heatmap ms per batch; returns the
    warm (trainer, state, batch) of ``ae_bs32``."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    size = cfgs["fcdd"]["data"]["size"]
    warm = None
    for cell, kind, bs in AD_TIMED:
        t = _ad_trainer(kind, cfgs, DEV, bs)
        net = _net_of(t)
        src = att_images if kind == "attn" else rsna
        state = t._train_state(max(1, len(src) // bs))
        plan = np.random.default_rng(SEED).integers(0, len(src), size=(4, bs))
        if kind == "ae":
            batches = [torch.from_numpy(rsna[p]).to(DEV) for p in plan]
        elif kind == "fcdd":
            batches = [(torch.from_numpy(rsna[p]).to(DEV),
                        torch.from_numpy(labels[p].astype(np.int32)).to(DEV)) for p in plan]
        else:
            batches = [(torch.from_numpy(att_images[p]).to(DEV),
                        torch.from_numpy(att_masks[p]).to(DEV)) for p in plan]
        net.train()
        ms = _ssl_warm_ms(t, state, batches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops = compiled_flops(t._train_step, state, batches[0], K(99))
        tflops = flops / ms / 1e9
        extra = ""
        if kind == "fcdd":
            x = batches[0][0][:, None]
            net.eval()

            def heatmap():
                with torch.inference_mode():
                    return FCDD_CNN_VGG.heatmap(net(x), (size, size), std=t.gauss_std)

            extra = (f"; heatmap (forward and receptive upsample, eval) {cuda_ms(heatmap)!r} ms "
                     f"per batch of {bs}")
        print(f"{cell}: {AD_CELLS[kind]}, batch {bs} of {size}^2, float32 (TF32 on): {ms!r} ms/step = {bs / ms * 1e3!r} slices/s; "
              f"{flops / 1e12!r} TFLOP per step (FlopCounterMode: forward and backward) = "
              f"{tflops!r} TFLOP/s, {100 * tflops / PEAK['tf32']!r}% of the dense TF32 peak; "
              f"peak device memory {peak!r} GiB{extra}")
        if kind == "ae":
            warm = (t, state, batches[0])
        else:
            net.eval()
            del t, state, batches
            torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"ad nvidia-smi after the timed steps: {smi}")
    return warm


AD_RANGES = ("anomalies", "net", "loss", "Optimizer.step#Adam.step")


def _ad_profile(t, state, batch) -> None:
    """One warm ``ae_bs32`` step under torch.profiler, and the kernels that
    the transposed convs' backward launched (the ``convolution_backward``
    calls whose weight has a ``ConvTranspose2d``'s shape)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        t0 = time.perf_counter()
        t._train_step(state, batch, K(500))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t.net.eval()
    print(_profile_summary(prof, wall_ms, f"ad profile (one warm ae_bs32 step, batch "
                           f"{t.batch_size}, TF32 on)", OP_GROUPS_TRAIN, AD_RANGES))
    shapes = {tuple(m.weight.shape) for m in t.net.modules()
              if isinstance(m, torch.nn.ConvTranspose2d)}
    found = defaultdict(float)

    def walk(e):
        for k in e.kernels:
            found[k.name] += k.duration
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if (e.name == "aten::convolution_backward" and len(e.input_shapes) > 2
                and tuple(e.input_shapes[2]) in shapes):
            walk(e)
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == cuda and e.key not in AD_RANGES) or 1.0
    print("ad profile transposed-conv backward kernels: " + (", ".join(
        f"{k[:80]} {100 * v / total:.1f}%" for k, v in sorted(found.items(), key=lambda kv: -kv[1]))
        or "none linked to their convolution_backward calls")
        + f"; {100 * sum(found.values()) / total:.1f}% of the step's device time")


def phase_ad(work: str, data) -> None:
    """Phase 11 on phase 8's RSNA slices and phase 9's SegICH 2D tree."""
    cfgs = load_ad_cfgs(work)
    labels = np.asarray(data.labels)[:, 0]
    normal = np.ascontiguousarray(data.images[labels == 0])
    check(data.images.shape[1] == cfgs["fcdd"]["data"]["size"],
          "ad: phase 8's slices are not the config's size")
    n_tree = (SEGICH2D_TREE[0] * SEGICH2D_TREE[1], SEGICH2D_TREE[0])
    edt.launches = edt.mask_launches = 0
    _ad_ae(cfgs["ae"], work, normal, n_tree)
    torch.cuda.empty_cache()
    _ad_fcdd(cfgs["fcdd"], work, n_tree)
    torch.cuda.empty_cache()
    att_images, att_masks = _ad_attention(cfgs, work)
    torch.cuda.empty_cache()
    _ad_holds(cfgs, att_images, att_masks)
    torch.cuda.empty_cache()
    _ad_profile(*_ad_step_times(cfgs, np.ascontiguousarray(data.images), labels, att_images,
                                att_masks))
    launches = _edt_launches()
    print(f"ad EDT launches on phase 11's paths {launches}")
    check(not any(launches.values()), "ad: an EDT kernel ran on phase 11's paths")


# -- phase 12: multi-GPU -----------------------------------------------------------

MG_WALL_S = 420  # the spawned group's limit
MG_HOLD_STEPS = 3
MG_TIMED_STEPS = 10
# the synced BatchNorm's statistics and normalisation are these aten ops
OP_GROUPS_MG = OP_GROUPS_TRAIN + (("collectives", ("nccl", "c10d", "all_reduce")),
                                  ("elementwise and sums", ("aten::mul", "aten::add", "aten::sum",
                                                            "aten::sub", "aten::rsqrt")))
MG_RANGES = ("augment", "loss", "grad_all_reduce", "Optimizer.step#Adam.step")


def _mg_steps(t, steps_per_epoch: int, step_fn) -> dict:
    """``MG_HOLD_STEPS`` steps of trainer ``t`` through ``step_fn(t, state,
    i)``: the losses, the weights and running statistics after step 1 (the
    statistics of step 1's forward, taken at the shared starting weights),
    and the step size."""
    state = t._train_state(steps_per_epoch)
    state.model.train()
    flat = lambda ts: torch.cat([v.detach().flatten().float().cpu() for v in ts])  # noqa: E731
    losses = []
    for i in range(MG_HOLD_STEPS):
        loss = step_fn(t, state, i)  # under a mesh, this rank's slice's loss
        losses.append(float(loss if t.mesh is None else parallel.all_reduce_mean(loss, t.mesh)))
        if i == 0:
            step1 = flat(state.model.parameters())
            stats = [b for b in state.model.buffers() if b.is_floating_point()]
            stats = flat(stats) if stats else torch.zeros(0)
    state.model.eval()
    return {"losses": losses, "step1": step1, "stats": stats, "lr": state.schedule(0)}


def _mg_hold(label: str, plain: dict, dp: dict, log) -> None:
    """The data-parallel trainer against the trainer without a mesh on the
    card, TF32 off, the same global batch and draws: the step-1 loss within
    rtol 1e-5 and the 3-step losses within 2e-4 (phase 6 (b)); the weights
    after step 1 within Adam's first-step bound (2 lr) and 95% within
    lr / 10 (a gradient of float32 rounding can flip its sign under
    another summation order); the running statistics after step 1 within
    1e-3 in relative L2 (one-pass global statistics against cuDNN's; after
    more steps they also follow the conv biases before each BatchNorm,
    whose gradient is rounding and whose Adam step is ±lr)."""
    loss1 = abs(dp["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
    traj = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"], plain["losses"]))
    d = (dp["step1"] - plain["step1"]).abs()
    share, lr = float((d <= plain["lr"] / 10).float().mean()), plain["lr"]
    st = (float((dp["stats"] - plain["stats"]).norm() / plain["stats"].norm())
          if plain["stats"].numel() else 0.0)
    log(f"multigpu {label} hold, TF32 off: losses dp {dp['losses']!r} plain "
        f"{plain['losses']!r} (step-1 rel diff {loss1!r}, max {traj!r}); step-1 weights max "
        f"|diff| {float(d.max())!r} (bound {2 * lr!r}), share within lr/10 {share!r}; step-1 "
        f"running stats rel L2 diff {st!r}")
    check(loss1 <= 1e-5 and traj <= 2e-4, f"multigpu {label}: losses disagree")
    check(float(d.max()) <= 2 * lr and share >= 0.95, f"multigpu {label}: weights disagree")
    check(st <= 1e-3, f"multigpu {label}: running statistics disagree")


def _mg_turns(fns: dict, n: int) -> dict:
    """Warm ms a call of each of ``fns`` over ``n`` calls, taken in turns
    a, b, b, a (host clock around work that ends in a synchronize)."""
    names = list(fns)
    order = names + names[::-1]
    for name in names:  # warm-up: cuDNN picks its algorithms
        for i in range(3):
            fns[name](i)
    times = defaultdict(list)
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fns[name](i)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / n * 1e3)
    return dict(times)


def _mg_unet2d(mesh, work: str, log) -> UNet2D:
    """(a) ``UNet2D(mesh=)`` at ``configs/unet2d.json``'s width; (f) its
    warm step beside the plain step and the gradient all-reduce; returns
    the warm data-parallel trainer."""
    dev = mesh.device
    cfg = load_train_cfg(work)
    bs = cfg["train"]["batch_size"]
    train = synthetic_ich_slices(n_slices=TRAIN_FOLD[0], size=cfg["data"]["size"],
                                 n_volumes=TRAIN_FOLD[1], seed=SEED)
    x, y = (torch.from_numpy(a[:bs]).to(dev) for a in (train.images, train.masks))
    torch.backends.cudnn.allow_tf32 = False
    step = lambda t, state, i: t._step(state, x, y, K(i))  # noqa: E731
    runs = [_mg_steps(_trainer(cfg, dev, net={"p_dropout": 0.0}, mesh=m), 1, step)
            for m in (None, mesh)]
    _mg_hold(f"train2d (batch {bs} of {cfg['data']['size']}^2, world {mesh.size})", *runs, log)
    torch.backends.cudnn.allow_tf32 = True

    aug = build_pipeline(cfg["data"]["augmentation"]["train"])
    data = train.device_cache(dev)
    t = _trainer(cfg, dev, n_epoch=2, augment_fn=aug, mesh=mesh)
    t0 = time.perf_counter()
    t.train(data)
    wall = time.perf_counter() - t0
    losses = [row[1] for row in t.outputs["train"]["evolution"]]
    log(f"multigpu train2d: UNet2D(mesh=).train, 2 epochs of {len(train)} slices at global "
        f"batch {bs} with the config's augmentation and dropout, world {mesh.size}: epoch "
        f"losses {losses!r} in {wall!r} s")
    check(all(np.isfinite(losses)) and losses[1] < losses[0],
          f"multigpu train2d: the mean loss did not fall {losses}")

    trainers = {name: _trainer(cfg, dev, augment_fn=aug, mesh=m)
                for name, m in (("plain", None), ("dp", mesh))}
    states = {name: t._train_state(len(train) // bs) for name, t in trainers.items()}
    plan = np.random.default_rng(SEED).integers(0, len(train), size=(4, bs))
    batches = list(trainers["plain"]._batches(data, plan))
    for t in trainers.values():
        t.unet.train()
    ms = _mg_turns({name: (lambda i, name=name: trainers[name]._train_step(
        states[name], batches[i % 4], K(i))) for name in trainers}, MG_TIMED_STEPS)
    params = list(trainers["dp"].unet.parameters())
    n_bytes = parallel.average_gradients(params, mesh)
    ar_ms = cuda_ms(lambda: parallel.average_gradients(params, mesh))
    log(f"multigpu train2d_bs16 warm step, TF32 on, world {mesh.size}: dp {ms['dp']!r} ms, plain "
        f"{ms['plain']!r} ms (turns plain, dp, dp, plain); gradient all-reduce of "
        f"{n_bytes} bytes ({n_bytes / 2**20:.2f} MiB, one float32 bucket): {ar_ms!r} ms "
        f"(CUDA events, 20 calls)")
    t = trainers["dp"]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t._train_step(states["dp"], batches[0], K(MG_TIMED_STEPS))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(_profile_summary(prof, wall_ms, f"multigpu train2d_bs16 dp profile (one warm step, "
                         f"world {mesh.size}, TF32 on)", OP_GROUPS_MG, MG_RANGES))
    for t in trainers.values():
        t.unet.eval()
    return trainers["dp"]


def _mg_unet3d(mesh, work: str, log) -> None:
    """(b) ``UNet3D(mesh=)`` at ``configs/unet3d.json``'s width."""
    dev = mesh.device
    cfg = load_train3d_cfg(work)
    rng = np.random.default_rng(SEED)
    vol, mask = head_ct_and_mask(rng, (256, 256, 64))
    vol = np.clip((np.transpose(vol, (2, 0, 1)) - (WINDOW[0] - WINDOW[1] / 2)) / WINDOW[1], 0, 1)
    mask = np.transpose(mask, (2, 0, 1)).astype(np.float32)
    pd, ph, pw = cfg["data"]["patch_size"]
    # the config's batch of 4, rounded up to a multiple of the world
    bs = parallel.pad_to_multiple(cfg["train"]["batch_size"], mesh.size)
    starts = [(0, 64 * (i // 2 % 2), 64 * (i % 2)) for i in range(bs)]
    x, y = (torch.from_numpy(np.stack([a[z:z + pd, h:h + ph, w:w + pw] for z, h, w in starts])
                             .astype(np.float32)).to(dev) for a in (vol, mask))
    torch.backends.cudnn.allow_tf32 = False
    step = lambda t, state, i: t._step(state, x, y, K(i))  # noqa: E731
    runs = [_mg_steps(build_trainer3d(cfg, build_unet3d_from_cfg(cfg["net"], seed=SEED,
                                                                 device=dev), dev,
                                      batch_size=bs, mesh=m), cfg["train"]["steps_per_epoch"],
                      step)
            for m in (None, mesh)]
    torch.backends.cudnn.allow_tf32 = True
    _mg_hold(f"train3d (batch {bs} of {pd}x{ph}x{pw}, world {mesh.size})", *runs, log)


def _mg_ssl(mesh, work: str, log) -> None:
    """(c) ``Contrastive(mesh=)`` global at batch 64 and
    ``ContextRestoration(mesh=)`` at batch 32; (f) the global step's warm
    time beside the plain step's."""
    dev = mesh.device
    cfgs = {"cr": load_ssl_cfg(CR_CFG, work), "global": load_ssl_cfg(CON_CFG, work)}
    data = synthetic_ich_slices(n_slices=64, size=cfgs["cr"]["data"]["size"], n_volumes=2,
                                seed=SEED + 12)
    torch.backends.cudnn.allow_tf32 = False
    for kind, bs in (("global", 64), ("cr", 32)):
        x = torch.from_numpy(data.images[:bs]).to(dev)
        step = lambda t, state, i: t._step(state, x, K(i))  # noqa: E731
        runs = [_mg_steps(_ssl_trainer(kind, cfgs[kind], dev, bs, mesh=m), 1, step)
                for m in (None, mesh)]
        _mg_hold(f"ssl {kind} (batch {bs}, world {mesh.size})", *runs, log)
    torch.backends.cudnn.allow_tf32 = True
    x = torch.from_numpy(data.images).to(dev)
    trainers = {name: _ssl_trainer("global", cfgs["global"], dev, 64, mesh=m)
                for name, m in (("plain", None), ("dp", mesh))}
    states = {name: t._train_state(1) for name, t in trainers.items()}
    for t in trainers.values():
        t.net.train()
    ms = _mg_turns({name: (lambda i, name=name: trainers[name]._train_step(states[name], x, K(i)))
                    for name in trainers}, MG_TIMED_STEPS)
    log(f"multigpu ssl_contrastive_global_bs64 warm step, TF32 on, world {mesh.size}: dp "
        f"{ms['dp']!r} ms, plain {ms['plain']!r} ms (turns plain, dp, dp, plain)")


def _mg_inference(mesh, work: str, log) -> None:
    """(d) the headline volume through ``sliding_window_inference_sharded``,
    the identity net, and ``segment_volumes`` of both trainers on a mesh
    against the serial path."""
    dev = mesh.device
    rng = np.random.default_rng(SEED + 12)
    patch = (PATCH3D,) * 3
    vols3d = [np.ascontiguousarray(np.transpose(head_ct(rng, VOL3D_SHAPE), (2, 0, 1)))
              for _ in range(N_VOLS)]
    net = UNet(**NET3D, dtype=torch.bfloat16)
    init_net(net, torch.Generator().manual_seed(SEED + 1))
    t3 = UNet3D(net, patch_size=patch, device=dev, mesh=mesh)
    _calibrate_final_bias_3d(t3.unet, vols3d[0])
    parallel.replicate(t3.unet, mesh)  # rank 0's calibration on every rank
    plain3 = UNet3D(UNet(**NET3D, dtype=torch.bfloat16), patch_size=patch, device=dev)
    plain3.unet.load_state_dict(t3.unet.state_dict())

    x = ct.window_ct(torch.from_numpy(vols3d[0]).to(dev), *WINDOW)
    halo = lambda: parallel.sliding_window_inference_sharded(  # noqa: E731
        t3.unet, x, mesh, patch_size=patch, overlap=0.5, batch_size=128)
    probs, ref = halo(), _probs(t3, vols3d[0])
    s = {"halo": [], "serial": []}
    for name in ("halo", "serial", "serial", "halo"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        halo() if name == "halo" else _probs(t3, vols3d[0])
        torch.cuda.synchronize()
        s[name].append(time.perf_counter() - t0)
    # batch size alone, on the serial path: the halo path at world 4 runs one
    # call of 75 patches a rank where the serial path runs 128 and 97; a
    # second run at 128 shows whether one batch size repeats itself
    with torch.inference_mode():
        by_batch = [sw.sliding_window_inference(t3.unet, x, patch_size=patch, overlap=0.5,
                                                batch_size=b)[..., 0] for b in (128, 75, 128)]
    agree_b = _agreement(by_batch[0] >= 0.5, by_batch[1] >= 0.5)[0]
    err_b = float((by_batch[0] - by_batch[1]).abs().max())
    err_rep = float((by_batch[0] - by_batch[2]).abs().max())
    log(f"multigpu serial sliding_window_inference of {tuple(x.shape)}, the same bf16 net, "
        f"batch 128 against batch 75: mask agreement {agree_b!r}, probability max |diff| "
        f"{err_b!r}; batch 128 run twice: max |diff| {err_rep!r}")
    del by_batch
    ident = parallel.sliding_window_inference_sharded(
        lambda p: p, x, mesh, patch_size=patch, overlap=0.5, batch_size=128)
    check(probs.shape == x.shape + (1,) and bool(torch.isfinite(probs).all()),
          f"multigpu: sharded output {tuple(probs.shape)} or not finite")
    # the halo is one stride, so the sharded grid is the serial one shifted by a
    # whole stride: away from the global edges along H the voxels blend the
    # same patches, each run by the bf16 net in other batches (cuDNN may take
    # other algorithms); a wrong halo would differ by far more than bf16's
    # rounding near every slab boundary. Batch size alone moves the serial
    # path as much as world 4 moved the halo path: on one H100 the serial
    # sliding window at batch 75 against 128 agreed on 99.973% of the mask
    # voxels, probabilities within 8.35e-3, while batch 128 repeated itself
    # exactly (world 4: 99.971%, 8.4e-3). So the check is bf16's 2e-2 and
    # 99.9% of the masks, and the comparison above prints the serial spread.
    inner = slice(PATCH3D, x.shape[1] - PATCH3D)
    agree = _agreement(probs[:, inner, :, 0] >= 0.5, ref[:, inner] >= 0.5)[0]
    err = float((probs[:, inner, :, 0] - ref[:, inner]).abs().max())
    err_id = float((ident[..., 0] - x).abs().max())
    log(f"multigpu sliding_window_inference_sharded, {tuple(x.shape)}, 64^3 patches at overlap "
        f"0.5, batch 128, d4f16 GroupNorm bf16, world {mesh.size}: {s['halo']!r} s a volume "
        f"against the serial sliding window's {s['serial']!r} s (turns halo, serial, serial, "
        f"halo); against the serial path on H in [{PATCH3D}, {x.shape[1] - PATCH3D}): "
        f"probability max |diff| {err!r} (tolerance 2e-2, bf16's), mask agreement {agree!r} "
        f"(tolerance 0.999); identity net max |err| {err_id!r} (tolerance 1e-4)")
    check(err_id <= 1e-4, "multigpu: the sharded identity blend is not the input")
    check(err <= 2e-2 and agree >= 0.999,
          f"multigpu: the sharded blend differs from the serial path ({err}, {agree})")

    net2 = UNet(**NET)
    init_net(net2, torch.Generator().manual_seed(SEED))
    t2 = UNet2D(net2, device=dev, mesh=mesh)
    vols2d = [head_ct(rng) for _ in range(N_VOLS)]
    _calibrate_final_bias(t2.unet, vols2d[0])
    parallel.replicate(t2.unet, mesh)
    plain2 = UNet2D(UNet(**NET), device=dev)
    plain2.unet.load_state_dict(t2.unet.state_dict())
    for label, t, plain, vols, kw in (
            ("UNet2D", t2, plain2, vols2d, dict(window=WINDOW, input_size=(256, 256))),
            ("UNet3D", t3, plain3, vols3d, dict(window=WINDOW))):
        t0 = time.perf_counter()
        got = t.segment_volumes(vols, return_preds=True, **kw)
        wall = time.perf_counter() - t0
        want = plain.segment_volumes(vols, return_preds=True, **kw)
        body = (lambda v, t=t, kw=kw: t._enqueue(v, kw["window"], 0.5)) if label == "UNet3D" \
            else (lambda v, t=t, kw=kw: t._enqueue(v, kw["input_size"], kw["window"]))
        vpm = list(parallel.volume_parallel_map(body, vols, mesh))
        equal = all(np.array_equal(a, b) for a, b in zip(got, want))
        vpm_equal = all(np.array_equal(a * np.uint8(255), b) for a, b in zip(vpm, want))
        pos = float(np.mean(want[0] == 255))
        log(f"multigpu {label}.segment_volumes of {N_VOLS} {vols[0].shape} volumes on the mesh "
            f"(world {mesh.size}: {'one volume a rank' if mesh.size > 1 else 'the serial path'})"
            f" in {wall!r} s: masks equal to the serial path's {equal}; volume_parallel_map of "
            f"the serial body equal {vpm_equal}; positive share {pos!r}")
        check(equal and vpm_equal and 0 < pos < 1, f"multigpu {label}: masks differ")


def _mg_dcp(mesh, work: str, trainer: UNet2D, log) -> str:
    """(e) the trained 2D state saved by the group to the DCP store; its
    values for the restore."""
    path = os.path.join(work, "mg_ckpt") + "/"
    state = trainer.state.state_dict()
    t0 = time.perf_counter()
    ckpt.save_checkpoint_auto(path, state, 1, [[1, 0.5]], mesh)
    save_s = time.perf_counter() - t0
    if mesh.rank == 0:
        torch.save({"model": {k: v.cpu() for k, v in state["model"].items()},
                    "optimizer": state["optimizer"], "step": state["step"]},
                   os.path.join(work, "mg_saved.pt"))
    log(f"multigpu DCP save of the trained train2d state by world {mesh.size}: {save_s!r} s")
    return path


def _mg_restore(work: str, path: str, log) -> None:
    """(e) the DCP checkpoint restored by a fresh world-1 group: every value
    equal to the saved one."""
    mesh = parallel.init_distributed(device=_mg_device(0),
                                     init_method=f"file://{os.path.join(work, 'mg_store1')}",
                                     world_size=1, rank=0)
    try:
        restored, epoch, history = ckpt.load_checkpoint_auto(path, mesh)
        saved = torch.load(os.path.join(work, "mg_saved.pt"), map_location="cpu")
        model_eq = all(torch.equal(restored["model"][k].cpu(), v) for k, v in saved["model"].items())
        opt_eq = all(torch.equal(restored["optimizer"]["state"][i][k].cpu(), v.cpu())
                     for i, s in saved["optimizer"]["state"].items() for k, v in s.items())
        log(f"multigpu DCP restore by a fresh world-1 group: epoch {epoch}, model equal "
            f"{model_eq}, Adam state equal {opt_eq}, step {restored['step']!r}")
        check(epoch == 1 and history == [[1, 0.5]] and model_eq and opt_eq
              and int(restored["step"]) == saved["step"], "multigpu: the DCP restore differs")
    finally:
        torch.distributed.destroy_process_group()


def _mg_device(rank: int) -> torch.device:
    return torch.device("cuda", rank) if DEV == "cuda" else torch.device(DEV)


def _mg_rank(rank: int, world: int, work: str) -> None:
    """One rank of phase 12: every sub-phase at world ``world`` over NCCL."""
    mesh = parallel.init_distributed(device=_mg_device(rank),
                                     init_method=f"file://{os.path.join(work, 'mg_store')}",
                                     world_size=world, rank=rank)
    log = functools.partial(print, flush=True) if rank == 0 else (lambda *a, **k: None)
    check(mesh.backend == ("nccl" if DEV == "cuda" else "gloo"), f"multigpu: {mesh.backend}")
    edt.launches = edt.mask_launches = 0
    t0 = time.perf_counter()
    trainer = _mg_unet2d(mesh, work, log)
    _mg_unet3d(mesh, work, log)
    _mg_ssl(mesh, work, log)
    _mg_inference(mesh, work, log)
    path = _mg_dcp(mesh, work, trainer, log)
    launches = _edt_launches()
    log(f"multigpu sub-phases at world {world} in {time.perf_counter() - t0!r} s; EDT launches "
        f"{launches}")
    check(not any(launches.values()), "multigpu: an EDT kernel ran on phase 12's paths")
    torch.distributed.destroy_process_group()
    if rank == 0:
        _mg_restore(work, path, log)


def phase_multigpu(work: str) -> None:
    """Phase 12: one rank a card, spawned with ``torch.multiprocessing``,
    joined through a file rendezvous in ``work``; a rank's failure raises
    here."""
    world = torch.cuda.device_count()
    before = _edt_launches()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(_mg_rank, args=(world, work), nprocs=world,
                                                join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t0 < MG_WALL_S,
                  f"multigpu: the group passed its {MG_WALL_S} s limit")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    print(f"multigpu: phase 12 at world {world} (NCCL) in {time.perf_counter() - t0!r} s, "
          f"process start-up included")
    check(_edt_launches() == before, "multigpu: the parent's EDT counters moved")


# -- phase 13: the host-side remainder on a public-layout dataset --------------------

NOT_ON_THE_CARD_PREP = NOT_ON_THE_CARD + ("click",)  # the JAX scripts' CLI library


def _matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _physionet_demographics(fn: str, ids: list) -> None:
    """``Patient_demographics.csv`` in PhysioNet's layout (a title row, a
    row of subtype names under three empty cells, a row per patient, two
    footer rows) with ``ids`` only."""
    rows = ['Patient Number,"Age\n(years)",Gender,Hemorrhage type,,,,,Fracture',
            ",,,Intraventricular,Intraparenchymal,Subarachnoid,Epidural,Subdural,"]
    rows += [f"{pid},{30 + 11 * i},{('Male', 'Female')[i % 2]},0,1,0,0,0,0"
             for i, pid in enumerate(ids)]
    rows += ["Total,,,0,2,0,0,0,0", ",,,,,,,,"]
    with open(fn, "w", newline="") as f:
        f.write("\n".join(rows) + "\n")


def load_prep_cfg(work: str) -> dict:
    """``configs/unet2d.json`` at its width, cut to 2 folds of 1 epoch, on
    (a)'s tree."""
    with open(TRAIN_CFG) as f:
        cfg = json.load(f)
    cfg["exp_name"] = "prep"
    cfg["path"] = {"DATA": os.path.join(work, "seg2d"), "OUTPUT": os.path.join(work, "out")}
    cfg["split"]["n_fold"] = 2
    cfg["train"]["n_epoch"] = 1
    return cfg


def _prep_trees(work: str) -> dict:
    """(a) the NIfTI release (CTs, lesion masks, brain masks, demographics)
    to SegICH 2D trees through ``data_preparation``'s CLI, with pandas, PIL,
    scikit-learn and click unimportable; the masks and the windowed slices
    checked."""
    n_pat, side, depth = PREP_NIFTI
    src = os.path.join(work, "nifti")
    for sub in ("ct_scans", "masks", "brain_masks"):
        os.makedirs(os.path.join(src, sub))
    vols = {}
    for pid in PREP_IDS[:n_pat]:
        vol, mask = synthetic_ich_volume(size=side, depth=depth, seed=pid)
        brain = (vol > -40).astype(np.uint8)
        brain[:, :, :2] = 0  # slices below the brain
        name = f"{pid:03d}.nii"
        nifti.save(os.path.join(src, "ct_scans", name), vol, np.diag([0.45, 0.45, 5.0, 1.0]))
        nifti.save(os.path.join(src, "masks", name), mask.astype(np.uint8))
        nifti.save(os.path.join(src, "brain_masks", name), brain)
        vols[pid] = (vol, mask, brain)
    demo = os.path.join(work, "Patient_demographics.csv")
    _physionet_demographics(demo, [PREP_IDS[0], PREP_IDS[2]])  # the second has no row
    t0 = time.perf_counter()
    with _unimportable(NOT_ON_THE_CARD_PREP):
        data_preparation.main(["gen-2d-seg", "--data-dir", src, "--out-dir",
                               os.path.join(work, "seg2d"), "--demographics-csv", demo])
        data_preparation.main(["gen-2d-brain", "--data-dir", src, "--out-dir",
                               os.path.join(work, "brain2d")])
        loaded = [m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD_PREP
                  and sys.modules[m] is not None]
    wall = time.perf_counter() - t0
    check(not loaded, f"prep: data_preparation imported {loaded}")
    for tree, which in (("seg2d", 1), ("brain2d", 2)):
        with open(os.path.join(work, tree, "ct_info.csv"), newline="") as f:
            rows = list(csv.reader(f))[1:]
        check(len(rows) == n_pat * depth, f"prep {tree}: {len(rows)} slice rows")
        for r in rows:
            pid, z, pos = int(r[1]), int(r[2]), int(r[5])
            want_pos = int(np.rot90(vols[pid][which], axes=(0, 1))[:, :, z].max() > 0)
            has_file = os.path.exists(os.path.join(work, tree, f"{pid}/mask/{z}.bmp"))
            check(pos == want_pos and has_file == bool(pos) and (r[4] == "-") == (not pos),
                  f"prep {tree}: patient {pid} slice {z}: label {pos}, mask file {has_file}")
    with open(os.path.join(work, "seg2d", "patient_info.csv")) as f:
        patients = f.read()
    want = ",PatientNumber,Hemorrhage,Age,Gender\n" + "".join(
        f"{i},{pid},1,{age},{gender}\n" for i, (pid, age, gender) in enumerate(
            [(PREP_IDS[0], "30.0", "Male"), (PREP_IDS[1], "", ""),
             (PREP_IDS[2], "41.0", "Female")][:n_pat]))
    check(patients == want, f"prep: patient_info.csv is\n{patients}")
    ds = load_segich_2d(os.path.join(work, "seg2d"), window=WINDOW, size=side)
    want_img = np.concatenate([np.clip((np.rot90(vols[p][0], axes=(0, 1)).astype(np.int32)
                                        - (WINDOW[0] - WINDOW[1] / 2)) / WINDOW[1], 0, 1)
                               .transpose(2, 0, 1) for p in PREP_IDS[:n_pat]])
    want_msk = np.concatenate([np.rot90(vols[p][1], axes=(0, 1)).transpose(2, 0, 1) > 0
                               for p in PREP_IDS[:n_pat]])
    err = float(np.abs(np.asarray(ds.images) - want_img).max())
    n_pos = int(want_msk.reshape(len(want_msk), -1).any(1).sum())
    print(f"prep (a) gen-2d-seg and gen-2d-brain on {n_pat} NIfTIs of {side}x{side}x{depth} "
          f"in {wall!r} s with {', '.join(NOT_ON_THE_CARD_PREP)} unimportable: {len(ds)} "
          f"slices, {n_pos} with a lesion (mask BMPs for those only); load_segich_2d of the "
          f"tree against the windowed NIfTIs: max |diff| {err!r} (tolerance 1e-6), masks equal "
          f"{bool(np.array_equal(np.asarray(ds.masks) > 0, want_msk))}; patient_info.csv "
          f"merged as pandas' left merge (the patient without demographics empty, Age float)")
    check(err <= 1e-6 and np.array_equal(np.asarray(ds.masks) > 0, want_msk),
          "prep: the tree does not load as the windowed NIfTIs")
    return vols


def _prep_report(work: str) -> str:
    """(b) the supervised2d CLI on (a)'s tree at ``configs/unet2d.json``'s
    width on the card; the analysis tables held against a recomputation
    from the fold CSVs; returns the experiment dir."""
    cfg = load_prep_cfg(work)
    fn = _write_cfg(cfg, os.path.join(work, "unet2d_prep.json"))
    t0 = time.perf_counter()
    with _unimportable(NOT_ON_THE_CARD):
        out = supervised2d.main([fn, "--device", DEV])
    wall = time.perf_counter() - t0
    n_fold = cfg["split"]["n_fold"]
    tab = analyse_exp.supervised_tables(out, n_fold)
    # the CSVs read again with the csv module; floats as pandas reads them
    # (not always correctly rounded: ``table.pandas_float``)
    num = pandas_float
    with open(os.path.join(out, "all_volume_prediction.csv"), newline="") as f:
        vol_rows = list(csv.DictReader(f))
    cm = np.asarray([[num(r[c]) for c in analyse_exp.CM_COLUMNS] for r in vol_rows])
    lab = np.asarray([int(r["label"]) for r in vol_rows])
    slices = []
    for k in range(n_fold):
        with open(os.path.join(out, f"Fold_{k + 1}/pred/slice_prediction_scores.csv"),
                  newline="") as f:
            slices += [dict(r, Fold=k + 1) for r in csv.DictReader(f)]
    dice = np.asarray([num(r["Dice"]) for r in slices])
    slab = np.asarray([int(r["label"]) for r in slices])
    ich = np.sort(dice[slab == 1])
    held = {
        "confusion": all(np.array_equal(a, b) for a, b in zip(
            tab["confusion"], (cm, cm[lab == 1], cm[lab == 0]))),
        "volume dice": np.array_equal(tab["dice_groups"][0][:, 0],
                                      [num(r["Dice"]) for r in vol_rows]),
        "slice dice": np.array_equal(tab["dice_groups"][1][:, 0], dice),
        "folds": np.array_equal(tab["slices"]["Fold"], [r["Fold"] for r in slices]),
        "picks": np.array_equal(dice[tab["picks"]], np.r_[ich[:2], ich[-1:]]),
        "grid": all(np.array_equal(dice[rows], np.sort(dice[slab == lb])[::1 if asc else -1]
                                   [:len(rows)]) and np.all(slab[rows] == lb)
                    for (asc, lb, _), rows in zip(analyse_exp.GRID_SPECS, tab["grid"])),
        "histories": [h.shape[0] for h in tab["hist"]] == [cfg["train"]["n_epoch"]] * n_fold,
    }
    ok = all(held.values())
    trip = [analyse_exp.load_overlay_triplet(out, cfg["path"]["DATA"],
                                             analyse_exp.slice_row(tab["slices"], i),
                                             tab["window"]) for i in tab["picks"]]
    side = PREP_NIFTI[1]
    ok_trip = all(c.shape == t.shape == p.shape == (side, side) and t.dtype == p.dtype == bool
                  for c, t, p in trip)
    pdf = os.path.join(out, "results_overview.pdf")
    check(not os.path.exists(pdf), "prep: a PDF from the CLI without matplotlib")
    if _matplotlib():  # the k-fold experiment's call, with matplotlib (and PIL) importable
        import re

        analyse_exp.analyse_supervised_exp(out, cfg["path"]["DATA"], n_fold, save_fn=pdf)
        with open(pdf, "rb") as f:
            pages = len(re.findall(rb"/Type\s*/Page\b(?!s)", f.read()))
        check(pages == 2, f"prep: results_overview.pdf has {pages} pages")
        drawn = f"results_overview.pdf written, {pages} pages"
    else:
        drawn = "matplotlib is not installed here: the k-fold CLI logged that it skipped the PDF"
    print(f"prep (b) supervised2d CLI on (a)'s tree ({TRAIN_CFG} at its width: "
          f"{n_fold} folds x {cfg['train']['n_epoch']} epoch, {side}^2 slices read at "
          f"{cfg['data']['size']}^2) in {wall!r} s; analysis tables against the fold CSVs: "
          f"{held}; {len(slices)} slice rows, picks {tab['picks']}, overlay triplets at "
          f"{side}^2 with the prediction resized: {ok_trip}; {drawn}")
    check(ok and ok_trip, "prep: the analysis tables differ from the fold CSVs")
    return out


def _prep_cq500(work: str, exp: str) -> list:
    """(c) a CQ500 root through ``qure-extract``, one series through
    ``dicom-to-nifti``, then the extracted volumes segmented on the card by
    the ``segment_brain`` CLI with (b)'s fold-1 weights; returns the
    extracted NIfTIs."""
    n_pat, n_slices, side = CQ500_TREE
    root = os.path.join(work, "cq500")
    write_cq500_tree(root, n_patients=n_pat, n_slices=n_slices, size=side, seed=SEED + 13)
    qure = os.path.join(work, "qure")
    t0 = time.perf_counter()
    with _unimportable(NOT_ON_THE_CARD_PREP):
        data_preparation.main(["qure-extract", "--input-path", root, "--out-folder", qure])
        data_preparation.main(["dicom-to-nifti", "--series-dir", os.path.join(root, "1"),
                               "--out-fn", os.path.join(work, "series1.nii")])
    wall = time.perf_counter() - t0
    with open(os.path.join(work, "series1.nii"), "rb") as a, \
            open(os.path.join(qure, "1.nii"), "rb") as b:
        same = a.read() == b.read()
    with open(os.path.join(qure, "info.csv"), newline="") as f:
        info = list(csv.reader(f))
    check(same and info[0] == ["", "id", "filename", "n_slice", "ICH", "IPH"]
          and [r[1:4] for r in info[1:]] == [[str(i), f"{i}.nii", str(n_slices)]
                                             for i in range(n_pat)],
          f"prep: qure-extract wrote {info}, dicom-to-nifti equal {same}")
    vols = [os.path.join(qure, f"{i}.nii") for i in range(n_pat)]
    cfg = load_prep_cfg(work)
    net = cfg["net"]
    t0 = time.perf_counter()
    outs = segment_brain.main(
        vols + ["-o", os.path.join(work, "qure_masks"), "-m",
                os.path.join(exp, "Fold_1", "trained_unet.bin"), "--depth", str(net["depth"]),
                "--top-filter", str(net["top_filter"]), "--midchannels-factor",
                str(net.get("midchannels_factor", 1)), "--size", str(cfg["data"]["size"]),
                "--device", DEV])
    seg_wall = time.perf_counter() - t0
    masks = [nifti.load(o)[0] for o in outs]
    ok = all(m.shape == (side, side, n_slices) and m.dtype == np.uint8
             and set(np.unique(m).tolist()) <= {0, 255} for m in masks)
    print(f"prep (c) qure-extract of {n_pat} CQ500 series of {n_slices} DICOMs of {side}^2 "
          f"and dicom-to-nifti in {wall!r} s (the NIfTIs equal byte for byte; info.csv merged "
          f"with ICH_probabilities.csv); segment_brain of the extracted volumes with (b)'s "
          f"Fold_1 weights on the card in {seg_wall!r} s: uint8 masks in {{0, 255}} of "
          f"{masks[0].shape}: {ok}, positive shares "
          f"{[float(np.mean(m == 255)) for m in masks]!r}")
    check(ok, "prep: segment_brain's masks are not uint8 {0, 255} of the volumes' shape")
    return vols


def _prep_figures(work: str, extracted: list) -> None:
    """(d) each figures command's arrays on (a)'s and (c)'s files (the
    window on the card against the CPU), and each command's file where
    matplotlib is installed."""
    tree = os.path.join(work, "seg2d")
    st = figures.dataset_stats_arrays(tree)
    meta = figures.metadata_arrays(tree)
    imgs, masks = figures.gif_frames(tree, PREP_IDS[0])
    vol, mask, affine = figures.load_windowed(extracted[0], None, WINDOW, DEV)
    cpu = figures.load_windowed(extracted[0], None, WINDOW, "cpu")[0]
    err = float(np.abs(vol - cpu).max())
    views = figures.mip_views(vol, mask, affine)
    ok = (st["slices_per_patient"].tolist() == [PREP_NIFTI[2]] * PREP_NIFTI[0]
          and int(st["label_counts"].sum()) == PREP_NIFTI[0] * PREP_NIFTI[2]
          and meta["gender"] == ["Male", "Female"] and len(imgs) == len(masks) == PREP_NIFTI[2]
          and [v[3] for v in views] == [1.0, 10.0, 10.0] and err <= 1e-6)
    print(f"prep (d) figures' arrays: slices per patient {st['slices_per_patient'].tolist()}, "
          f"slice labels {st['label_counts'].tolist()}, genders {meta['gender']} "
          f"{meta['gender_counts'].tolist()}, {len(imgs)} GIF frames, MIP aspects "
          f"{[float(v[3]) for v in views]}; window on the card against the CPU max |diff| {err!r} "
          f"(tolerance 1e-6): {ok}")
    check(ok, "prep: the figures' arrays")
    if not _matplotlib():
        print("prep (d) figures: skipped drawing, matplotlib is not installed here")
        return
    rsna = os.path.join(work, "rsna")
    write_rsna_slice_info(write_rsna_tree(rsna, n_slices=24, size=64, seed=SEED),
                          os.path.join(rsna, "slice_info.csv"))
    figs = os.path.join(work, "figs")
    outs = [os.path.join(figs, n) for n in ("stats.pdf", "metadata_stat.pdf",
                                            f"{PREP_IDS[0]}_CT.gif", "rsna.pdf", "montage.png",
                                            "mip.png")]
    os.makedirs(figs)
    figures.main(["dataset-stats", "--data-dir", tree, "--out-fn", outs[0]])
    figures.main(["explore", "--data-dir", tree, "--out-dir", figs, "--gif-patient",
                  str(PREP_IDS[0])])
    figures.main(["rsna-stats", "--csv-path", os.path.join(rsna, "slice_info.csv"),
                  "--out-fn", outs[3]])
    for mode, fn in (("montage", outs[4]), ("3d", outs[5])):
        figures.main(["view-volume", extracted[0], "--mode", mode, "--out-fn", fn,
                      "--device", DEV])
    sizes = [os.path.getsize(o) if os.path.exists(o) else 0 for o in outs]
    print(f"prep (d) figures written: {dict(zip(map(os.path.basename, outs), sizes))}")
    check(all(n > 1000 for n in sizes), f"prep: a figure is missing or empty: {sizes}")


def _prep_native(work: str) -> None:
    """(e) the native loader built with g++, its decodes held equal to the
    Python codec, its window + resize to the card's, and both decoders
    timed per volume."""
    t0 = time.perf_counter()
    lib = native.build()
    check(native.available(), f"prep: the native loader did not load: {native._error}")
    build_s = time.perf_counter() - t0
    src = os.path.join(work, "nifti", "ct_scans")
    paths = [os.path.join(src, n) for n in sorted(os.listdir(src))]
    gz = []
    for p in paths:  # gzip-compressed copies: the decode then inflates
        gz.append(os.path.join(work, os.path.basename(p) + ".gz"))
        nifti.save(gz[-1], nifti.load(p)[0], nifti.load(p)[1])
    equal = True
    for p in paths + gz:
        got, pixdim = native.load_nifti_f32(p)
        want, _, hdr = nifti.load(p)
        equal &= bool(np.array_equal(got, want)) and bool(
            np.allclose(pixdim[:3], nifti.pixdim(hdr)))
    batch = native.load_nifti_batch(paths + gz)
    equal &= all(np.array_equal(v, nifti.load(p)[0]) for (v, _), p in zip(batch, paths + gz))
    vol = nifti.load(paths[0])[0]
    slices = np.ascontiguousarray(np.moveaxis(vol, 2, 0))
    size = 256
    got = native.window_resize_batch(slices, *WINDOW, (size, size))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the resize's contractions in float32
    try:
        want = ct.resize(ct.window_ct(torch.from_numpy(slices).to(DEV), *WINDOW),
                         (len(slices), size, size), order=1).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float(np.abs(got - want).max())

    def per_volume(fn, files):
        t = []
        for _ in range(NATIVE_ROUNDS):
            t0 = time.perf_counter()
            fn(files)
            t.append((time.perf_counter() - t0) * 1e3 / len(files))
        return sorted(t)

    times = {
        "native .nii": per_volume(lambda fs: [native.load_nifti_f32(f) for f in fs], paths),
        "python .nii": per_volume(lambda fs: [nifti.load(f) for f in fs], paths),
        "native batch .nii": per_volume(native.load_nifti_batch, paths),
        "native .nii.gz": per_volume(lambda fs: [native.load_nifti_f32(f) for f in fs], gz),
        "python .nii.gz": per_volume(lambda fs: [nifti.load(f) for f in fs], gz),
        "native batch .nii.gz": per_volume(native.load_nifti_batch, gz),
    }
    n, side, depth = PREP_NIFTI
    print(f"prep (e) native loader built with g++ in {build_s!r} s -> {lib}; decodes of "
          f"{len(paths)} .nii and {len(gz)} .nii.gz equal to nifti.load: {equal}; "
          f"window_resize_batch {slices.shape} -> {size}^2 against window_ct + resize on the "
          f"card: max |diff| {err!r} (tolerance 1e-4)")
    print(f"prep (e) host decode ms per {side}x{side}x{depth} float32 volume ({NATIVE_ROUNDS} "
          f"rounds over {n} files each, sorted; host CPU, {os.cpu_count()} cores; the card: "
          f"{card_name_and_power()}): {json.dumps(times)}")
    check(equal and err <= 1e-4, "prep: the native loader differs from the Python paths")


def phase_prep(work: str) -> None:
    """Phase 13: a public-layout dataset to masks on the card, through the
    host-side modules; no EDT kernel runs on it."""
    edt.launches = edt.mask_launches = 0
    t0 = time.perf_counter()
    _prep_trees(work)
    exp = _prep_report(work)
    extracted = _prep_cq500(work, exp)
    _prep_figures(work, extracted)
    _prep_native(work)
    launches = _edt_launches()
    print(f"prep: phase 13 in {time.perf_counter() - t0!r} s; EDT launches {launches}")
    check(not any(launches.values()), "prep: an EDT kernel ran on phase 13's path")


# -- phase 14: the paired label-efficiency study -------------------------------

@contextlib.contextmanager
def _fold1_starts(starts: dict):
    """Inside the block, each fine-tune's fold-1 net is recorded as it
    starts training: ``starts[<arm>_frac<N>]`` = its weights on the host."""
    train = UNet2D.train

    def recording(self, dataset, valid_dataset=None, checkpoint_path=None):
        fold_dir = os.path.dirname(checkpoint_path)
        if os.path.basename(fold_dir) == "Fold_1":
            starts[os.path.basename(os.path.dirname(fold_dir))] = {
                k: v.detach().cpu().clone() for k, v in self.unet.state_dict().items()}
        return train(self, dataset, valid_dataset, checkpoint_path)

    UNet2D.train = recording
    try:
        yield starts
    finally:
        UNet2D.train = train


def _study_transfers(out: str, starts: dict) -> None:
    """Each pretrained arm's fold-1 nets start from its pretrained weights
    (every key the U-Net shares with them, equal) and not from scratch's."""
    for arm in STUDY_ARMS[1:]:
        phase = study.PRETRAIN_PHASES[arm][-1]
        pre = ckpt.load_params(os.path.join(out, phase, "pretrained.bin"))
        for frac in STUDY_FRACTIONS:
            tag = f"_frac{int(frac * 100)}"
            start, scratch = starts[arm + tag], starts["scratch" + tag]
            moved = [k for k in start
                     if k in pre and tuple(pre[k].shape) == tuple(start[k].shape)]
            equal = all(torch.equal(start[k], pre[k].cpu()) for k in moved)
            differ = sum(not torch.equal(start[k], scratch[k]) for k in moved
                         if start[k].is_floating_point())
            print(f"study: {arm}{tag} fold 1 starts from {phase}/pretrained.bin: "
                  f"{len(moved)} of {len(start)} keys moved, all equal: {equal}; "
                  f"{differ} differ from scratch's fold-1 start")
            check(moved and equal and differ, f"study: {arm}{tag}'s fold 1 does not start "
                                              f"from the pretrained weights")


def _ulps(a, b) -> int:
    """The largest distance between two float32 sequences in units in the
    last place."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int(np.abs(ia - ib).max())


def _sum_bound(x: torch.Tensor) -> float:
    """How far a float64 sum of float32 terms may move when each term is
    ``RNG_ULPS`` units in the last place off."""
    return float(x.double().abs().sum()) * RNG_ULPS * 2.0 ** -23


def sampler_stack() -> tuple:
    """The volumes and masks of ``PATH_SAMPLER_VOLS``: 0.25 outside the
    bleed, 0.75 inside."""
    vols, masks = [], []
    for shape, box in PATH_SAMPLER_VOLS:
        m = np.zeros(shape, np.float32)
        if box is not None:
            z0, z1, y0, y1, x0, x1 = box
            m[z0:z1, y0:y1, x0:x1] = 1.0
        vols.append(0.25 + 0.5 * m)
        masks.append(m)
    return vols, masks


def path_draws(dev, sampler: DevicePatchSampler) -> tuple:
    """The keyed draws of the 3D, GAN, FCDD and detector paths through the
    port's draw functions, on ``dev`` (``sampler`` a ``sampler_stack``
    sampler there); returns the draws by name and each group's wall ms."""
    key = prng.prng_key(PATH_SEED)
    ks = [prng.fold_in(key, i) for i in range(5)]
    hw_gan, hw_fcdd = (PATH_GAN[0],) * 2, (PATH_FCDD[0],) * 2
    det = InpaintAnomalyDetector(lambda a, b: a, device=dev, seed=PATH_SEED)

    def augmentation():
        aug = default_patch_augmentation()  # AffineAugment3D, AdjustBrightness
        ka, kb = prng.split(ks[1], len(aug.transforms))
        m, _ = aug.transforms[0].affine_params(ka, PATH_AUG_BATCH)
        apply, factor = aug.transforms[1]._factors(kb, PATH_AUG_BATCH)
        return {"aug_m": m.to(dev), "aug_apply": apply.to(dev), "aug_factor": factor.to(dev)}

    groups = {
        "sampler": lambda: dict(zip(("sampler_vi", "sampler_start"), sampler.starts(
            sampler.draw(ks[0], PATH_SAMPLER_BATCH)))),
        "augmentation": augmentation,
        "ff_masks": lambda: {"ff_" + k: v for k, v in draw_ff_masks(
            ks[2], PATH_GAN[1], hw_gan, device=dev, **PATH_MASK_KW).items()},
        "ellipses": lambda: {"ell_" + k: v for k, v in draw_ellipse_params(
            ks[3], PATH_FCDD[1], hw_fcdd, device=dev, **PATH_ELLIPSE_KW).items()},
        "ellipse_noise": lambda: {"ell_noise": draw_ellipse_params(
            ks[4], PATH_NOISE_BATCH, hw_fcdd, noise=PATH_NOISE, device=dev,
            **PATH_ELLIPSE_KW)["noise"]},
        "null_sample": lambda: {
            "null_first": det._null_normals(key, PATH_NULL_SHAPE),
            "null_cleanup": det._null_normals(prng.fold_in(key, 1), PATH_NULL_SHAPE)},
    }
    out, ms = {}, {}
    for name, fn in groups.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.update(fn())
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    return out, ms


def path_answers(draws: dict) -> dict:
    """``RNG_KNOWN["paths"]``'s form of ``draws`` (arrays by name): the size,
    sum and first four values of each, and for integers and flags also the
    sum weighted by position."""
    out = {}
    for name, x in draws.items():
        a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        flat = a.reshape(-1)
        if a.dtype.kind == "f":
            flat = flat.astype(np.float32)
            out[name] = {"n": int(flat.size), "sum": float(flat.astype(np.float64).sum()),
                         "head": [float(v) for v in flat[:4]]}
        else:
            flat = flat.astype(np.int64)
            out[name] = {"n": int(flat.size), "sum": int(flat.sum()),
                         "wsum": int((flat * np.arange(1, flat.size + 1)).sum()),
                         "head": [int(v) for v in flat[:4]]}
    return out


def _hold_paths(draws: dict) -> list:
    """The names of ``draws`` that miss ``RNG_KNOWN["paths"]``: integers
    must be equal, floats within ``RNG_ULPS`` on the head and the sum within
    that bound of each term."""
    got, known = path_answers(draws), RNG_KNOWN["paths"]
    missed = sorted(set(known) ^ set(got))
    for name in sorted(set(known) & set(got)):
        g, k = got[name], known[name]
        if "wsum" in k:
            ok = g == k
        else:
            x = draws[name].float()
            ok = (g["n"] == k["n"] and _ulps(g["head"], k["head"]) <= RNG_ULPS
                  and abs(g["sum"] - k["sum"]) <= _sum_bound(x))
        if not ok:
            missed.append(name)
    return missed


def _phase_rng_paths() -> None:
    """15 (c): the paths' keyed draws on the card against JAX's answers and
    against the same draws on this machine's CPU, with their times."""
    vols, masks = sampler_stack()
    data = VolumeDataset3D(vols, masks, np.arange(len(vols)))
    samplers = {dev: DevicePatchSampler(data, PATH_PATCH, PATH_POS_FRAC, device=dev)
                for dev in (DEV, "cpu")}
    path_draws(DEV, samplers[DEV])  # warm-up
    card, card_ms = path_draws(DEV, samplers[DEV])
    cpu, cpu_ms = path_draws("cpu", samplers["cpu"])
    on_card = all(v.device.type == "cuda" for v in card.values())
    missed = _hold_paths(card)
    differ = [k for k in card if not torch.equal(card[k].cpu(), cpu[k])]
    n_pos = int(card["sampler_vi"].numel())
    print(f"rng paths: {len(card)} keyed draws of the 3D, GAN, FCDD and detector paths from "
          f"fold_in(PRNGKey({PATH_SEED}), i) (the device sampler's (vi, start), {n_pos} draws "
          f"over {len(vols)} volumes at patch {PATH_PATCH}; default_patch_augmentation at batch "
          f"{PATH_AUG_BATCH}; free-form masks {PATH_GAN[1]} x {PATH_GAN[0]}^2; ellipses "
          f"{PATH_FCDD[1]} x {PATH_FCDD[0]}^2 and noise at batch {PATH_NOISE_BATCH}; the W1 null "
          f"sample {PATH_NULL_SHAPE} twice), on the card {on_card}: against JAX's answers "
          f"(integers equal, floats within {RNG_ULPS} ulp) missed {missed}; card equals this "
          f"machine's CPU (torch.equal) but for {differ}; ms on the card "
          f"{ {k: round(v, 3) for k, v in card_ms.items()} }, on the CPU "
          f"{ {k: round(v, 3) for k, v in cpu_ms.items()} }")
    check(on_card, "rng: a path draw did not land on the card")
    check(not missed, f"rng: path draws differ from jax.random's: {missed}")
    check(not differ, f"rng: card and cpu path draws differ: {differ}")


def phase_rng() -> dict:
    """15. jax.random's threefry streams and flax's init on the card, held
    against JAX's constants and this machine's CPU; returns the EDT
    launches over the phase."""
    edt.launches = edt.mask_launches = 0
    key = prng.prng_key(42)
    keys_ok = (prng.fold_in(key, 7).tolist() == RNG_KNOWN["fold_in_7"]
               and prng.split(key, 3).tolist() == RNG_KNOWN["split_3"])
    print(f"rng keys of PRNGKey(42): fold_in(., 7) and split(., 3) equal JAX's {keys_ok}")
    check(keys_ok, "rng: keys differ from jax.random's")

    def draws(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (prng.random_bits(key, (RNG_WORDS,), device=dev),
               prng.uniform(prng.fold_in(key, 1), (RNG_WORDS,), -2.5, 4.0, device=dev),
               prng.truncated_normal(prng.fold_in(key, 2), -2.0, 2.0, (RNG_WORDS,), device=dev))
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    draws(DEV)  # warm-up
    (bits, u, tn), card_ms = draws(DEV)
    (bits_c, u_c, tn_c), cpu_ms = draws("cpu")
    check(bits.device.type == "cuda", "rng: the draws did not run on the card")
    bits_ok = (int(bits.sum()) == RNG_KNOWN["bits_sum"]
               and bits[:4].tolist() == RNG_KNOWN["bits_head"]
               and bits[-4:].tolist() == RNG_KNOWN["bits_tail"])
    floats = {}
    for name, x in (("uniform", u), ("tn", tn)):
        dsum = abs(float(x.double().sum()) - RNG_KNOWN[f"{name}_sum"])
        floats[name] = (_ulps(x[:4].cpu(), RNG_KNOWN[f"{name}_head"]), dsum, _sum_bound(x))
    same = all(torch.equal(a.cpu(), b) for a, b in ((bits, bits_c), (u, u_c), (tn, tn_c)))
    print(f"rng draws on the card, {RNG_WORDS} words each: bits equal JAX's (sum, head, tail) "
          f"{bits_ok}; uniform head {floats['uniform'][0]} ulp, sum off by "
          f"{floats['uniform'][1]!r} (bound {floats['uniform'][2]!r}); truncated_normal head "
          f"{floats['tn'][0]} ulp, sum off by {floats['tn'][1]!r} (bound {floats['tn'][2]!r}); "
          f"tolerance {RNG_ULPS} ulp; card equals this machine's CPU (torch.equal) {same}; "
          f"the three draws {card_ms!r} ms on the card, {cpu_ms!r} ms on the CPU")
    check(bits_ok, "rng: the card's bits differ from jax.random's")
    check(all(h <= RNG_ULPS and d <= b for h, d, b in floats.values()),
          "rng: the card's floats differ from jax.random's")
    check(same, "rng: card and cpu draws differ")

    _phase_rng_paths()
    for name, (net_cfg, known) in NET_KNOWN.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = supervised2d.build_unet_from_cfg(net_cfg, seed=42, device=DEV)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cpu = supervised2d.build_unet_from_cfg(net_cfg, seed=42)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        sd, sd_c = card.state_dict(), cpu.state_dict()
        check(next(card.parameters()).device.type == "cuda", "rng: the net was not on the card")
        equal = sd.keys() == sd_c.keys() and all(torch.equal(sd[k].cpu(), sd_c[k]) for k in sd)
        flat = torch.cat([v.flatten().double() for v in sd.values() if v.is_floating_point()])
        dsum = abs(float(flat.sum()) - known["sum"])
        dsq = abs(float((flat ** 2).sum()) - known["sumsq"]) / known["sumsq"]
        head = _ulps(sd["down_block.0.conv1.weight"].flatten()[:3].cpu(), known["head"])
        n_params = sum(p.numel() for p in card.parameters())
        print(f"rng init {name} ({net_cfg}, {n_params} parameters) from prng_key(42): "
              f"{flat.numel()} float entries (JAX {known['n']}), sum off by {dsum!r} (bound "
              f"{_sum_bound(flat)!r}), sum of squares rel diff {dsq!r} (tolerance 1e-6), head "
              f"{head} ulp; card equals this machine's CPU (torch.equal) {equal}; init "
              f"{card_ms!r} ms on the card, {cpu_ms!r} ms on the CPU")
        check(flat.numel() == known["n"] and dsum <= _sum_bound(flat) and dsq <= 1e-6
              and head <= RNG_ULPS, f"rng: {name} differs from flax's init")
        check(equal, f"rng: {name} drawn on the card differs from the CPU's")
        del card, cpu, sd, sd_c
    launches = _edt_launches()
    print(f"rng port kernel launches over the phase {launches}")
    check(not any(launches.values()), "rng: an EDT kernel launched")
    return launches


# -- phase 16: keyed dropout -------------------------------------------------------

def dropout_known_key() -> tuple:
    """The op's key of ``DROPOUT_KNOWN``: ``PRNGKey(DROPOUT_SEED)``'s words
    and ``DROPOUT_PATH``'s fold word."""
    return (*prng.prng_key(DROPOUT_SEED).tolist(), flax_fold(DROPOUT_PATH, 1))


def dropout_input(shape) -> np.ndarray:
    """Phase 16's known-answer input in channels-last order: ``((37 j) %
    101 - 50) / 8`` at position j, float32 (exact in bf16 too)."""
    n = int(np.prod(shape))
    return (((np.arange(n) * 37) % 101 - 50) / 8).astype(np.float32)


def dropout_tensor(v: np.ndarray, shape, dtype, device="cpu") -> torch.Tensor:
    """``v`` (channels-last order) as a channels-first tensor of ``shape``
    (a channels-last view)."""
    last = (shape[0], *shape[2:], shape[1])
    return torch.from_numpy(v).reshape(last).to(device, dtype).movedim(-1, 1)


def dropout_answers(y) -> dict:
    """What phase 16 compares of a dropout output ``y``, flat in
    channels-last order: the kept count, the float64 sum, the first six
    and the last four values."""
    if isinstance(y, torch.Tensor):
        y = y.detach().float().cpu().numpy()
    y = np.asarray(y, np.float64).ravel()
    return {"kept": int((y != 0).sum()), "sum": float(y.sum()),
            "head": [float(a) for a in y[:6]], "tail": [float(a) for a in y[-4:]]}


class ParentDropout(torch.nn.Module):
    """The parent commit's Dropout, for the parent turns of phase 16 (e): a
    mask that ``bernoulli_`` draws from ``self.generator``, divided by the
    keep rate and multiplied in, the mask saved for the backward pass."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        keep = 1.0 - self.p
        with torch.profiler.record_function("dropout"):
            mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
            return x * mask.div_(keep)


def parent_set_dropout(net: torch.nn.Module, key, mesh=None) -> None:
    """The parent commit's per-step dropout set-up: a generator on the card
    seeded with the key's 64 bits, given to every Dropout."""
    gen = None
    if key is not None:
        k0, k1 = (int(v) & 0xFFFFFFFF for v in torch.as_tensor(key).reshape(2).tolist())
        gen = torch.Generator(device=DEV)
        gen.manual_seed((k0 << 32) | k1)
    for m in net.modules():
        if isinstance(m, ParentDropout):
            m.generator = gen


def _dropout_equal(key) -> float:
    """(a) the kernel ``torch.equal`` to its plain version, NCHW and
    channels-last, at every offset; the backward pass; returns the max
    abs difference."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    cases = ([(s, torch.float32, (0.5,)) for s in DROPOUT_SHAPES]
             + [(DROPOUT_RAGGED, torch.float32, (0.5, 0.1)),
                (DROPOUT_BF16, torch.bfloat16, (0.5, 0.1))])
    err, n = 0.0, 0
    t0 = time.perf_counter()
    for shape, dtype, rates in cases:
        x = torch.randn(shape, device=DEV, generator=gen).to(dtype)
        last = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
        for xl in (x, x.contiguous(memory_format=last)):
            for off in DROPOUT_OFFSETS:
                for rate in rates:
                    before = dropout_ops.launches
                    k = dropout_ops.keyed_dropout(xl, key, rate, off)
                    p = dropout_ops.keyed_dropout_plain(xl, key, rate, off)
                    torch.cuda.synchronize()
                    err = max(err, float((k.float() - p.float()).abs().max()))
                    check(dropout_ops.launches == before + 1 and k.stride() == xl.stride()
                          and torch.equal(k, p),
                          f"dropout: the kernel differs from the plain version at {shape} "
                          f"{dtype} strides {xl.stride()} offset {off} rate {rate}")
                    n += 1
        del x
    x = torch.randn(DROPOUT_SHAPES[0], device=DEV, generator=gen, requires_grad=True)
    g = torch.randn(DROPOUT_SHAPES[0], device=DEV, generator=gen)
    before = dropout_ops.launches
    y = dropout_ops.keyed_dropout(x, key, 0.5, 4)
    y.backward(g)
    torch.cuda.synchronize()
    back = (dropout_ops.launches == before + 2
            and torch.equal(x.grad, dropout_ops.keyed_dropout_plain(g, key, 0.5, 4)))
    print(f"dropout (a) kernel against its plain version: {n} cases (the five "
          f"configs/unet2d.json shapes at batch 16, rate 0.5; {DROPOUT_RAGGED} float32 and "
          f"{DROPOUT_BF16} bfloat16 at rates 0.5 and 0.1; each NCHW and channels-last, offsets "
          f"{DROPOUT_OFFSETS}) torch.equal, max abs diff {err!r}; the backward pass at "
          f"{DROPOUT_SHAPES[0]} is the kernel on the gradient (torch.equal, 2 launches) {back}; "
          f"{time.perf_counter() - t0!r} s")
    check(back, "dropout: the backward pass differs from the kernel on the gradient")
    return err


def _dropout_known() -> None:
    """(b) the kernel against flax's answers, computed with JAX on the CPU."""
    key = dropout_known_key()
    check(list(dropout_ops.flax_dropout_key(key)) == DROPOUT_KNOWN["key"],
          "dropout: the flax key differs from flax's")
    oks = []
    for name, dt, shape, rate, off in DROPOUT_CASES:
        x = dropout_tensor(dropout_input(shape), shape, getattr(torch, dt), DEV)
        for xl in (x, x.contiguous()):
            y = dropout_ops.keyed_dropout(xl, key, rate, off)
            oks.append(dropout_answers(y.movedim(1, -1).reshape(-1)) == DROPOUT_KNOWN[name])
    print(f"dropout (b) the kernel on the card against flax's nn.Dropout (JAX's CPU answers) "
          f"under the flax key of {'/'.join(DROPOUT_PATH)} from dropout_key(PRNGKey("
          f"{DROPOUT_SEED})), {[c[0] for c in DROPOUT_CASES]} in both layouts: equal {oks}")
    check(all(oks), "dropout: the kernel differs from flax's answers")


def _kernel_device_ms(fn, x, n: int = 20) -> float:
    """Mean device ms a call of ``fn(x)`` over ``n`` calls queued behind a
    spin of the card (``torch.cuda._sleep``), so that CUDA events time the
    kernels back to back and not the host's launch work."""
    fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # some 60 ms: far longer than queueing the calls
    start.record()
    for _ in range(n):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _dropout_times(key) -> dict:
    """(c) kernel, plain, ``F.dropout`` and the parent's ``bernoulli_``
    path at the five shapes, in NCHW and in channels-last storage (the
    train step's: its activations are channels-last), in turns (CUDA
    events over back-to-back calls: what a caller waits, the host's launch
    work included where it is the longer), and the kernel's device time
    alone; returns the channels-last sums over one forward pass (the
    kernels line's numbers) and the byte bound."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    fns = {
        "ms": lambda x: dropout_ops.keyed_dropout(x, key, 0.5),
        "plain_ms": lambda x: dropout_ops.keyed_dropout_plain(x, key, 0.5),
        "library_ms": lambda x: F.dropout(x, 0.5, training=True),
        "parent_ms": lambda x: x * torch.empty_like(x).bernoulli_(0.5, generator=gen).div_(0.5),
    }
    iters = {"ms": 50, "plain_ms": 5, "library_ms": 50, "parent_ms": 50}
    totals = {}
    for layout in ("NCHW", "channels_last"):
        total = dict.fromkeys((*fns, "device_ms", "bound_ms"), 0.0)
        for shape in DROPOUT_SHAPES:
            x = torch.randn(shape, device=DEV, generator=gen)
            if layout == "channels_last":
                x = x.contiguous(memory_format=torch.channels_last)
            row = dict.fromkeys(fns, 0.0)
            for name in (*fns, *reversed(fns)):  # in turns, forth and back
                row[name] += cuda_ms(fns[name], x, iters=iters[name]) / 2
            row["bound_ms"] = _bytes_ms(2 * x.numel() * 4)  # x read once, y written once
            row["device_ms"] = _kernel_device_ms(fns["ms"], x)
            print(f"dropout (c) {shape} {layout} float32, rate 0.5: kernel {row['ms']!r} ms a "
                  f"call ({row['device_ms']!r} ms on the device, "
                  f"{100 * row['bound_ms'] / max(row['device_ms'], 1e-9):.1f}% of the bound), "
                  f"plain {row['plain_ms']!r} ms, F.dropout {row['library_ms']!r} ms, the "
                  f"parent's bernoulli_ path {row['parent_ms']!r} ms, bound {row['bound_ms']!r} "
                  f"ms (bytes at {PEAK['hbm_tbs']} TB/s)")
            total = {k: total[k] + row[k] for k in total}
            del x
        print(f"dropout (c) one forward pass's five launches at batch 16, {layout}: "
              f"{json.dumps(total)}")
        totals[layout] = total
    return totals["channels_last"]


def _dropout_steps(work: str) -> int:
    """(d) the keyed dropout launches of one ``train2d_bs16`` step
    (configs/unet2d.json, TF32 on); (e) its step time with the parent's
    dropout (P: its module and its per-step set-up swapped in) and this
    tree's (C), in ``DROPOUT_PAIRS`` pairs of turns, alternating which runs
    first; returns (d)."""
    cfg = load_train_cfg(work)
    bs = TIMED_BATCHES[0]
    fold = synthetic_ich_slices(n_slices=4 * bs, size=cfg["data"]["size"], n_volumes=4, seed=SEED)
    aug = build_pipeline(cfg["data"]["augmentation"]["train"])
    torch.backends.cudnn.allow_tf32 = True
    t = _trainer(cfg, DEV, batch_size=bs, augment_fn=aug)
    state = t._train_state(4)
    batches = list(t._batches(fold.device_cache(DEV), np.arange(4 * bs).reshape(4, bs)))
    t.unet.train()
    for i in range(3):
        t._train_step(state, batches[i % 4], K(i))
    torch.cuda.synchronize()
    dropout_ops.launches = 0
    t._train_step(state, batches[0], K(3))
    torch.cuda.synchronize()
    launches = dropout_ops.launches
    blocks = [b for b in (*t.unet.down_block, t.unet.bottleneck_block) if isinstance(b.dropout, Dropout)]
    print(f"dropout (d) launches of one train2d_bs{bs} step: {launches} ({len(blocks)} "
          f"Dropout layers, forward and backward)")
    check(launches == 2 * len(blocks) == 10, "dropout: not 5 forward and 5 backward launches")

    keyed = [b.dropout for b in blocks]
    parent = [ParentDropout(b.dropout.p) for b in blocks]
    step_mod = sys.modules[UNet2D.__module__]
    change_set = step_mod.set_dropout_keys

    gc_s = {True: 0.0, False: 0.0}  # seconds in the cyclic GC over the timed steps
    gc_at = [None, None]  # (side being timed, start of the running collection)

    def on_gc(phase, info):
        if gc_at[0] is None:
            return
        if phase == "start":
            gc_at[1] = time.perf_counter()
        elif gc_at[1] is not None:
            gc_s[gc_at[0]] += time.perf_counter() - gc_at[1]
            gc_at[1] = None

    def turn(parent_turn: bool) -> float:
        for b, k, p in zip(blocks, keyed, parent):
            b.dropout = p if parent_turn else k
        step_mod.set_dropout_keys = parent_set_dropout if parent_turn else change_set
        try:
            for i in range(2):
                t._train_step(state, batches[i % 4], K(i))
            torch.cuda.synchronize()
            gc_at[0] = parent_turn
            t0 = time.perf_counter()
            for i in range(DROPOUT_TURN_STEPS):
                t._train_step(state, batches[i % 4], K(i))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / DROPOUT_TURN_STEPS * 1e3
        finally:
            gc_at[0] = None
            step_mod.set_dropout_keys = change_set
            for b, k in zip(blocks, keyed):
                b.dropout = k

    pairs = []
    gc.callbacks.append(on_gc)
    try:
        for i in range(DROPOUT_PAIRS):
            first = i % 2 == 0  # the parent first in even pairs
            a = turn(first)
            b = turn(not first)
            pairs.append((a, b) if first else (b, a))  # (P, C)
    finally:
        gc.callbacks.remove(on_gc)
    p_ms, c_ms = np.array(pairs).T
    q1, q3 = np.percentile(p_ms, [25, 75])
    wins = int((c_ms < p_ms).sum())
    print(f"dropout (e) train2d_bs{bs} step, TF32 on, {DROPOUT_PAIRS} pairs of turns of "
          f"{DROPOUT_TURN_STEPS} steps, (P, C) ms a step: {[(float(p), float(c)) for p, c in pairs]}; "
          f"median P {float(np.median(p_ms))!r} ms, C {float(np.median(c_ms))!r} ms, C/P of the "
          f"medians {float(np.median(c_ms) / np.median(p_ms))!r}; C faster in {wins} of "
          f"{DROPOUT_PAIRS} pairs; the parent's own spread (IQR) {float(q3 - q1)!r} ms; "
          f"{card_name_and_power()}")
    print(f"dropout (e) seconds in the cyclic GC over the timed steps: P {gc_s[True]!r}, "
          f"C {gc_s[False]!r} (objects tracked: {len(gc.get_objects())}); the process's "
          f"threads: {[th.name for th in threading.enumerate()]}")
    t.unet.eval()
    return launches


def phase_dropout(work: str) -> dict:
    """16. The keyed dropout kernel: (a) ``torch.equal`` to its plain
    version, (b) flax's answers, (c) its times, (d) its launches a
    ``train2d_bs16`` step and (e) that step against the parent's dropout;
    returns the kernels line's numbers."""
    key = dropout_known_key()
    err = _dropout_equal(key)
    _dropout_known()
    row = _dropout_times(key)
    step = _dropout_steps(work)
    return {**row, "max_abs_err": err, "step_launches": step}


def _gn_case(n: int, level: tuple, dtype, gen) -> tuple:
    (c, side, groups), _ = level
    x = (torch.randn((n, c, side, side, side), device=DEV, generator=gen) * 2 + 0.5).to(dtype)
    w = torch.rand(c, device=DEV, generator=gen) + 0.5
    b = torch.randn(c, device=DEV, generator=gen) * 0.3
    dy = torch.randn(x.shape, device=DEV, generator=gen).to(dtype)
    return x, groups, w, b, dy


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest distance of a bf16 tensor from float32 values, in bf16
    ulps of each value."""
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    return float(((got.float() - want).abs() / ulp).max())


def _gn_equal() -> float:
    """(a) the kernels, launched directly and through the nets' entry
    ``group_norm_relu`` (its forward, and its backward by autograd), against
    the plain versions at every shape and dtype; returns the largest bf16
    distance in ulps, away from values near zero (within 1e-5 of the
    largest, where bf16's ulps are finer than the float32 sums' own
    spread)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    worst = 0.0
    for label, n in GN_BATCHES:
        for level in GN_LEVELS:
            for dtype in (torch.bfloat16, torch.float32):
                x, groups, w, b, dy = _gn_case(n, level, dtype, gen)
                wr, br = w.to(dtype).float(), b.to(dtype).float()
                y, mean, rstd = gn_ops._forward(x, groups, w, b, GN_EPS)
                dx, dw, db = gn_ops._backward(dy, x, groups, w, b, mean, rstd)
                xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))
                ey = gn_ops.group_norm_relu(xl, groups, wl, bl, GN_EPS)
                ey.backward(dy)
                py = gn_ops.group_norm_relu_plain(x.float(), groups, wr, br, GN_EPS)
                pdx, pdw, pdb = gn_ops.group_norm_relu_backward_plain(
                    dy.float(), x.float(), groups, wr, br, mean, rstd)
                torch.cuda.synchronize()
                aten = gn_ops.group_norm_relu_plain(x, groups, w, b, GN_EPS)
                errs = []
                for got, want in ((y, py), (dx, pdx), (ey.detach(), py), (xl.grad, pdx),
                                  (aten, py)):
                    near = want.abs() <= 1e-5 * float(want.abs().max())
                    diff = (got.float() - want).abs()
                    if dtype == torch.bfloat16:
                        far = ~near
                        errs.append(_bf16_ulps(got[far], want[far]))
                        worst = max(worst, errs[-1] if got is not aten else 0.0)
                        ok = bool((diff[near] <= 1e-5 * float(want.abs().max())).all())
                    else:
                        errs.append(float(diff.max() / want.abs().max()))
                        ok = errs[-1] <= 1e-5
                    check(got is aten or (ok and (dtype == torch.float32 or errs[-1] <= 1.0)),
                          f"group_norm: the kernel differs from the plain version at {n} x "
                          f"{level[0]} {dtype}: {errs}")
                sums = [float((g - r).abs().max() / r.abs().max())
                        for g, r in ((dw, pdw), (db, pdb), (wl.grad, pdw), (bl.grad, pdb))]
                check(max(sums) <= 1e-4 and wl.grad.dtype == bl.grad.dtype == torch.float32,
                      f"group_norm: dweight/dbias {sums} at {n} x {level[0]}")
                print(f"group_norm (a) {label} {n} x {level[0]} {str(dtype)[6:]}: the "
                      f"kernels' y and dx, group_norm_relu's y and x.grad, and torch's own y on "
                      f"the card in this dtype, against the plain float32 values: "
                      f"{'ulps' if dtype == torch.bfloat16 else 'relative'} {errs}; dweight and "
                      f"dbias, then group_norm_relu's weight.grad and bias.grad, relative {sums}")
                del x, dy, y, dx, xl, ey, py, pdx, aten
    return worst


def _gn_launches() -> None:
    """(b) launches of one forward and backward of the 3D net (bf16, a
    32^3 batch of 2) and of the same net with BatchNorm."""
    x = torch.randn(2, 1, 32, 32, 32, device=DEV)
    counts = {}
    for norm in ("group", "batch"):
        net = UNet(depth=4, ndim=3, top_filter=16, midchannels_factor=1, norm=norm,
                   p_dropout=0.0, dtype=torch.bfloat16).to(DEV)
        gn_ops.launches = 0
        y = net(x)
        fwd = gn_ops.launches
        y.float().mean().backward()
        torch.cuda.synchronize()
        counts[norm] = (fwd, gn_ops.launches - fwd)
    print(f"group_norm (b) launches of one forward and backward of the 3D net (depth 4, top "
          f"filter 16, bf16): GroupNorm {counts['group']}, BatchNorm {counts['batch']}")
    check(counts == {"group": (28, 28), "batch": (0, 0)},
          "group_norm: not 2 launches a GroupNorm forward and backward")


def _gn_times() -> dict:
    """(c) device ms of the kernels, the plain backward and the library
    calls at every shape and dtype (CUDA events over back-to-back calls
    behind a spin of the card), the byte bound (each input read once, each
    output written once); returns the sums over one bf16 net forward at 128
    patches and one bf16 training step at 64 (the kernels line's
    numbers)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    totals = {}
    for label, n in GN_BATCHES:
        for dtype in (torch.bfloat16, torch.float32):
            total = defaultdict(float)
            for level in GN_LEVELS:
                x, groups, w, b, dy = _gn_case(n, level, dtype, gen)
                _, mean, rstd = gn_ops._forward(x, groups, w, b, GN_EPS)
                xg, wg, bg = (t.detach().requires_grad_() for t in (x, w, b))
                lib = F.relu(F.group_norm(xg, groups, wg.to(dtype), bg.to(dtype), GN_EPS))
                row = {
                    "ms": _kernel_device_ms(lambda t: gn_ops._forward(t, groups, w, b, GN_EPS), x),
                    "backward_ms": _kernel_device_ms(
                        lambda t: gn_ops._backward(t, x, groups, w, b, mean, rstd), dy),
                    "library_ms": _kernel_device_ms(
                        lambda t: F.relu(F.group_norm(t, groups, w.to(dtype), b.to(dtype),
                                                      GN_EPS)), x),
                    "library_backward_ms": _kernel_device_ms(
                        lambda t: torch.autograd.grad(lib, (xg, wg, bg), t, retain_graph=True),
                        dy, n=5),
                    "plain_backward_ms": _kernel_device_ms(
                        lambda t: gn_ops.group_norm_relu_backward_plain(t, x, groups, w, b, mean,
                                                                        rstd), dy, n=3),
                    "bound_ms": _bytes_ms(2 * x.numel() * x.element_size()),
                    "backward_bound_ms": _bytes_ms(3 * x.numel() * x.element_size()),
                }
                row["plain_ms"] = row["library_ms"]  # the plain forward is torch's call
                print(f"group_norm (c) {label} {n} x {level[0]} {str(dtype)[6:]}: forward "
                      f"{row['ms']!r} ms ({100 * row['bound_ms'] / row['ms']:.1f}% of the "
                      f"bound {row['bound_ms']!r}), backward {row['backward_ms']!r} ms "
                      f"({100 * row['backward_bound_ms'] / row['backward_ms']:.1f}% of "
                      f"{row['backward_bound_ms']!r}); F.relu(F.group_norm) {row['library_ms']!r} "
                      f"ms, its backward {row['library_backward_ms']!r} ms; plain backward "
                      f"{row['plain_backward_ms']!r} ms (bytes at {PEAK['hbm_tbs']} TB/s)")
                calls = level[1]
                for k, v in row.items():
                    total[k] += calls * v
                del x, dy, xg, wg, bg, lib, mean, rstd
                torch.cuda.empty_cache()
            print(f"group_norm (c) the 14 calls of one net forward at {n} patches, "
                  f"{str(dtype)[6:]}: {json.dumps(total)}; {card_name_and_power()}")
            totals[(label, dtype)] = dict(total)
    return {"serve_forward": totals[("serve", torch.bfloat16)],
            "train_step": totals[("train", torch.bfloat16)]}


def phase_group_norm() -> dict:
    """17. The fused GroupNorm+ReLU kernels: (a) against the plain
    versions, (b) their launches in a net, (c) their times; returns the
    kernels line's numbers."""
    err = _gn_equal()
    _gn_launches()
    times = _gn_times()
    serve, train = times["serve_forward"], times["train_step"]
    return {"max_ulps": err,
            "ms": serve["ms"], "bound_ms": serve["bound_ms"], "library_ms": serve["library_ms"],
            "plain_ms": serve["plain_ms"], "train_step": train}


def phase_study(work: str) -> dict:
    """Phase 14: the paired label-efficiency study through its entry point
    at its width, seed 42, three arms (one a pretrainer) at two fractions;
    the table and the comparison with the JAX package's snapshots run. No
    EDT kernel runs on it; the keyed dropout kernel does (dropout 0.1)."""
    edt.launches = edt.mask_launches = dropout_ops.launches = 0
    # the study's mode, torch's defaults (cuDNN's convolutions in TF32,
    # matmuls in float32), whatever an earlier phase left set
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    out = os.path.join(work, f"seed{STUDY_SEED}")
    t0 = time.perf_counter()
    with _unimportable(NOT_ON_THE_CARD), _fold1_starts({}) as starts:
        results = study.main(out, seed=STUDY_SEED, arms=STUDY_ARMS,
                             fractions=STUDY_FRACTIONS, device=DEV, scale=STUDY_SCALE)
    wall = time.perf_counter() - t0
    launches = {**_edt_launches(), "keyed_dropout": dropout_ops.launches}
    n_folds = {**study.SCALE, **STUDY_SCALE}["n_folds"]
    vals = [v for arm in STUDY_ARMS for f in STUDY_FRACTIONS for v in results[arm][str(f)]]
    ok = (list(results) == list(STUDY_ARMS)
          and all(len(results[arm][str(f)]) == n_folds
                  for arm in STUDY_ARMS for f in STUDY_FRACTIONS)
          and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals))
    print(f"study (a) {', '.join(STUDY_ARMS)} at {STUDY_FRACTIONS} x {n_folds} folds, "
          f"{STUDY_SCALE['n_epoch']} fine-tune and {STUDY_SCALE['pretrain_epochs']} pretraining "
          f"epochs a phase, in {wall!r} s (TF32: cuDNN {torch.backends.cudnn.allow_tf32}, "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}): "
          f"{json.dumps(results)}; {n_folds} finite Dice in [0, 1] per arm x fraction: {ok}")
    check(ok, "study: results.json lacks a finite Dice in [0, 1] per arm x fraction x fold")
    _study_transfers(out, starts)
    with open(os.path.join(out, "label_efficiency_table.md")) as f:
        table = f.read()
    snap = os.path.join(work, "snapshots")
    os.makedirs(snap)
    shutil.copy(os.path.join(out, "results.json"), os.path.join(snap, f"seed{STUDY_SEED}.json"))
    shutil.copy(os.path.join(out, "provenance.json"), snap)
    apart = study.write_snapshot_docs(snap, "docs")
    with open(os.path.join(snap, "comparison.md")) as f:
        lines = f.read().splitlines()
    rows = [ln for ln in lines if ln.startswith("| main |")]
    ok = (table.count("\n") == 2 + len(STUDY_FRACTIONS)
          and len(rows) == len(STUDY_FRACTIONS) * (2 * len(STUDY_ARMS) - 1)
          and lines[0].startswith("Runs made with") and torch.__version__ in lines[0])
    print(f"study (b) the table ({table.count(chr(10))} lines) and compare_to_reference "
          f"against the JAX snapshots ({len(rows)} rows, {len(apart)} pairs of CIs apart at "
          f"this cut; {lines[0]!r}): {ok}")
    check(ok, "study: the table or the comparison is incomplete")
    print(f"study: phase 14 in {time.perf_counter() - t0!r} s; port kernel launches {launches}")
    check(launches["edt_envelope_pass"] == launches["distance_transform_edt_kernel"] == 0,
          "study: an EDT kernel ran on phase 14's path")
    check(launches["keyed_dropout"] > 0, "study: the dropout kernel did not run on phase 14")
    return launches


def main() -> None:
    kind = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    edt_rows = phase_edt(rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        main_launches = phase_main(rng, work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3d_") as work:
        gn_3d = phase_3d(rng, work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train2d_") as work:
        train2d_drops = phase_train2d(work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train3d_") as work:
        gn_train3d = sum(phase_train3d(rng, work).values())
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssl_") as work:
        data = phase_ssl(work)
        torch.cuda.empty_cache()
        phase_cls(work, data)
        torch.cuda.empty_cache()
        gan_launches = phase_gan(work, data)
        torch.cuda.empty_cache()
        phase_ad(work, data)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multigpu_") as work:
        phase_multigpu(work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prep_") as work:
        phase_prep(work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_study_") as work:
        study_launches = phase_study(work)
    torch.cuda.empty_cache()
    rng_launches = phase_rng()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dropout_") as work:
        drop = phase_dropout(work)
    torch.cuda.empty_cache()
    gnorm = phase_group_norm()
    # no single PyTorch call computes a min-plus pass or an EDT: library_ms null
    kernels = [{
        "name": name, "route": "cuda", "source": "ich_tpu_torch/csrc/edt.cu",
        "replaces": "ich_tpu/ops/pallas_edt.py:27", "launches": gan_launches[name],
        "launches_by_path": {"gan_train": gan_launches[name], "edt_leg": main_launches[name],
                             "le_study": study_launches[name], "rng": rng_launches[name]},
        **edt_rows[name], "bound_by": "bytes", "library_ms": None,
    } for name in ("edt_envelope_pass", "distance_transform_edt_kernel")]
    # dropout replaces no TPU kernel (XLA draws the JAX package's masks); its
    # times are one forward pass's five launches at batch 16 (ms a call as a
    # caller waits; device_ms the kernel alone), and the library call is
    # F.dropout, the same function over torch's own stream
    kernels.append({
        "name": "keyed_dropout", "route": "cuda", "source": "ich_tpu_torch/csrc/dropout.cu",
        "replaces": "none: XLA's rng_bit_generator under flax's nn.Dropout "
                    "(ich_tpu/models/layers.py:188)",
        "launches": train2d_drops,
        "launches_by_path": {"train2d": train2d_drops, "le_study": study_launches["keyed_dropout"],
                             "gan_train": gan_launches["keyed_dropout"],
                             "train2d_bs16_step": drop["step_launches"]},
        "max_abs_err": drop["max_abs_err"], "ms": drop["ms"], "plain_ms": drop["plain_ms"],
        "bound_ms": drop["bound_ms"], "bound_by": "bytes", "library_ms": drop["library_ms"],
        "device_ms": drop["device_ms"],
    })
    # group_norm replaces no TPU kernel (XLA fuses the JAX package's
    # FlatGroupNorm); its times are the device ms of one bf16 net forward's 14
    # calls at 128 patches, and the library call, torch's F.relu(F.group_norm),
    # is also its plain forward
    kernels.append({
        "name": "group_norm_relu", "route": "cuda", "source": "ich_tpu_torch/csrc/group_norm.cu",
        "replaces": "none: XLA's fusion of FlatGroupNorm and the ReLU "
                    "(ich_tpu/models/layers.py:66)",
        "launches": gn_3d["serve3d"],
        "launches_by_path": {"serve3d": gn_3d["serve3d"], "train3d": gn_train3d},
        "max_ulps": gnorm["max_ulps"], "ms": gnorm["ms"], "plain_ms": gnorm["plain_ms"],
        "bound_ms": gnorm["bound_ms"], "bound_by": "bytes", "library_ms": gnorm["library_ms"],
        "train_step": gnorm["train_step"],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
