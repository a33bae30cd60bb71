#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. card: name and power limit; build the kernels from csrc/ (nvcc).
  2. b1: the patch-match argmax kernel (wgmma on a TMA-fed ring) against
     its plain version on random descriptors at the unpadded CUFED5 shape
     (10332 x 10332, D = 2304) in f32 and bf16, plus ragged shapes (batch
     2, nq and nr off the 128-row query and 128- or 256-row ref tiles, a
     depth off the ring's 128-byte stages and one below a stage, where
     TMA zero-fills), the depths the wrapper refuses, exact ties across
     ref tiles and across the partitions of the ref axis on query rows of
     both consumer warpgroups, at batch 1 and 3 (the tensor maps' batch
     stride), near ties (top-2 gaps from 1e-7 to 1e-3 on
     patch-structured descriptors at D = 2304) and the ref_bias
     exclusion.
  3. b3: the deformable im2col kernel against its plain version on random
     inputs at the three unpadded DynAgg shapes of CUFED5 in f32 and bf16,
     plus odd shapes (Cg = 1, 3 and 6, which take the scalar channel loop;
     stride 2; dilation 2), a bf16 image of 1536x1536x128 whose columns
     pass 2^31 elements (64-bit index math; its first and last rows
     against the plain version) and the large-offset probe, which must
     give exact zeros.
  3b. b3f: the fused forward (deform_conv_fused: sampling and contraction in
     one launch over the batch) at the three DynAgg shapes at batch 1 and 16,
     f32 and bf16, against the columns route on the card (B3, torch.matmul,
     stack, bias; within 2e-5 of the output's largest) and the plain version,
     timed beside both (library_ms: the columns route) and its bound; at batch
     16 both against an f64 contraction of the same columns; a band's padding
     (its rows bit for bit the whole image's), odd shapes (a ragged last tile,
     C off the stage depth, Co odd and past 128, one vector a group), x and the
     offsets as views off the 16-byte boundary, the large-offset probe (the
     output equals the bias), shapes outside fused_applicable (the columns, no
     fused launch, the operator refuses them) and a bf16 image past 2^31 values
     (64-bit indices). The kernels line's entry is batch 16.
  4. b2: the window-contraction kernel of the windowed deformable conv in
     image mode (window_conv: it reads x at each window's origin) against
     its plain version and, bit for bit, against rows mode (window_contract
     on the gathered windows); and the windowed op against the exact op;
     on random DynAgg-structured inputs (G = 8; a block-constant integer
     flow in +-16 plus a residual in +-0.4) at relu1 512x384x64 (blk 4,
     win 8) and relu2 256x192x128 (blk 2, win 6), in f32 and bf16; a
     fallback probe (residual x 5) that must equal the exact op bit for
     bit with no kernel launch; the row-chunked form (8 launches); rows
     mode on odd shapes (ragged tiles, C and Co off the tiles, window
     coordinates far outside the window); image mode on odd shapes with
     origins at both clamps (window rows and columns in the zero ring),
     an output grid smaller than the image, C and Co off the tiles, huge
     coordinates and zero modulation; and shapes or types the kernel
     refuses, which must raise on the card.
  5. epilogue: the conv epilogue kernel (bias, activation and residual
     add in place after a cuDNN conv) against its plain version, bit for
     bit, at the restoration net's shapes at batch 16 on the 128 x 84
     request (relu1 336x512 at C 64 and 3, relu2 168x256 at C 128,
     relu3 84x128 at C 216 and 256) in f32 and bf16, for each activation
     with and without a residual, and on operands off 16-byte alignment;
     then one residual block's two epilogues at relu1 (16 x 336 x 512 x
     64, f32) timed beside the plain version, the unfused ops they
     replace (the bias add on the conv's NCHW view, ReLU, the residual
     add) and the bytes bound. These are the times of the kernels line.
  6. main: RefRestorationModel.feed_data / test at full width (ngf 64,
     16 blocks, 8 groups; random weights from a seeded generator) in the
     f32 config and the serving config (bf16 gathers and match operands),
     over requests of CUFED5 size, each at its own shape; the launch
     counters must rise on this path (the DynAggs: 3 fused launches a
     request, no B3 launch); a small request must agree with the
     same nets run on the CPU, where the plain versions run. One more
     HR 512x336 request per config records every kernel's inputs: B1 must
     get the request's (vh-2)(vw-2) = 10332 query and ref rows, no
     ref_bias.
  7. path: each kernel against its plain version on exactly the tensors
     the main path gave it (B1 at 10332 x 10332 x 2304: the request's
     exact descriptor grid, no ref_bias; B3 at the 128x84, 256x168 and
     512x336 DynAggs of the request, and the fused forward on the
     DynAggs' arguments), in both configs; then the
     windowed op, which no model calls, on the relu1 (blk 4) and relu2
     (blk 2) DynAggs' own tensors:
     the branch it takes, B2 in image mode against its plain version and
     rows mode there, the prep's and B2's times, and the windowed op
     against the exact op. These are the times of the kernels line.
  8. eval: the port's test runner (c2matching_tpu_torch.test.run, what
     `python -m c2matching_tpu_torch.test` calls) on the card, through
     options files written from options/test/test_synth_smoke.yml (f32)
     and test_synth_smoke_serving.yml (bf16 gathers and match operands)
     with their dataroots and pretrain paths replaced: two sets, the
     3-pair synth set at 160 from the port's generator and one
     CUFED5-shaped pair (input 332x500, reference 340x512, which takes
     the dataset's padding branch), and the nets' seeded init saved as
     the reference's .pth files the options name. Each config runs once to
     warm up, then three times more with the launch counters at 0 (both
     kernels must launch); the f32 metrics on the synth set are held
     against the same runner on the CPU. Prints PSNR, PSNR_Y, SSIM_Y and
     the median ms per image over the three passes for each config and
     set.
  9. b3bwd: the deformable conv's backward kernel (deform_conv_backward:
     one launch per DynAgg covers the whole batch, and the columns'
     gradient grad_out @ w_kc^T is formed on the tensor cores inside it)
     against its plain version on random inputs at stage-3 training's
     three DynAggs at gt 160 and batch 9 (relu3 40x40x256, relu2
     80x80x128, relu1 160x160x64; G = 8, K = 9, Co = C) in f32 and bf16,
     offsets on exact integers and past the image's edges, the offset and
     mask gradients alone (the training path's call) and with grad_x (f32
     atomics); the columns' route it replaced (grad_cols by torch.matmul
     into device memory, then deform_col2im, image by image), kept as its
     yardstick, against the same plain version; the large-offset probe
     must give exact zeros; batch-2 probes (B3B_ODD) reach every path of
     the kernel, the widest group and Co it takes. Times the kernel (CUDA
     events and torch.profiler), the columns' route (both), the plain
     version and the library route (torch.matmul + F.grid_sample's
     backward), beside the bound.
 10. contras: stages 1 and 2 of training (the contrastive correspondence
     network) through `python -m c2matching_tpu_torch.train`'s run() on the
     card with options/train/stage1_teacher_contras_network.yml and
     stage2_student_contras_network.yml as they are but for data roots and
     iteration counts, run from the outputs' root (ContrasExtractorSep,
     batch 8 at gt 160, Adam 1e-3, margin 1, safe radius 4; distill weight
     15, temperature 0.15) on a 10-pair 160-px synth set read through
     ContrasDataset: 3 iterations each, then one validation pass of
     ContrasValDataset over a CUFED5-shaped 332x500 image through a
     one-line annotation file. Stage 2's teacher is the flax .ckpt its
     options name, which the port resolves to the net_g_latest.pth stage 1
     wrote beside it. Checks the tensorboard event files
     (use_tb_logger: true), every loss finite, every sample through the
     128-correspondence gate (n_valid 8), every parameter of the trained
     net moved, the teacher bit for bit unchanged, the checkpoints and
     .state files; prints ms per iteration (first and later apart), peak
     memory of the iterations and of the validation pass, the pass's ms,
     and the loss's own CUDA-event ms on one batch's features beside the
     extractors' forward and forward + backward, a whole step's ms on that
     batch with the loader stopped, and the host ms of a ContrasDataset
     item and of its warp. Then one step of each stage at batch 2 / gt 96
     on the card against the CPU from the same seeded weights: the logs,
     the card's float32 gradients against the CPU's float64 ones, and the
     float64 gradients of both (the model's float64_grads).
 11. train: `python -m c2matching_tpu_torch.train`'s run() on the card with
     options/train/stage3_restoration_gan.yml at full width (ngf 64, 16
     blocks, 8 groups, D ndf 32, VGG19 relu5_1 perceptual, WGAN-GP) and its
     batch of 9 at gt 160, on a 10-pair 160-px synth set, from phase
     contras' outputs' root, where its pretrain_model_feature_extractor,
     stage 2's .ckpt, resolves to the net_student_latest.pth phase contras
     wrote (without it the phase raises), so that the card runs the three
     stages in a chain: 2 G-pretrain and 3 GAN iterations, the
     launch counters at 0 before the run. Checks the losses are finite,
     every LR group and D moved, B3's forward and backward launched (the
     backward once per DynAgg and iteration: 3; the fused forward never
     in an iteration); prints
     ms per pretrain and GAN iteration (host clock around a synchronised
     optimize_parameters), peak memory and launches per iteration, then a
     torch.profiler breakdown of one more GAN iteration by kernel, and the
     backward kernel as in phase b3bwd on the tensors one more GAN
     iteration hands it (each DynAgg's whole batch, whose sampled feature
     must need no gradient; these are the times of the kernels line).
 12. train_cpu: one G-pretrain step and one GAN step of a small config
     (ngf 16, 2 blocks, ndf 4, batch 2 at gt 64) on the card against the
     same steps on the CPU (plain versions) from the same weights: losses
     and G gradients.
 13. dist: data parallelism over torch.distributed, on the shipped
     stage3_restoration_gan.yml at full width (1 pretrain + 2 GAN
     iterations): (i) `python -m torch.distributed.run --nproc_per_node 1`
     running the train CLI with --launcher pytorch over NCCL (a child that
     turns TF32 off and cuDNN's deterministic algorithms on, as this
     process does for its run, and replays the batches this process's
     run() was fed) against run() in process: the nets within 1e-6 (bit
     for bit expected), the gradient all-reduce's ms a call; (ii) two
     ranks sharing the card over gloo (dist_params.backend: gloo in the
     options' copy; c2matching_tpu_torch.scripts.dist_step) at a global
     batch of 8, 4 a rank, against one process on the same batches, each
     of its steps from the two ranks' state before it: the averaged
     gradients within 1e-3 (G) and 5e-2 (D: float32 cancellation in its
     first conv, see DIST_GRAD_REL) of each net's largest, the logs within
     1e-3, D's running statistics before its Adam step within 1e-6, the
     parameters after Adam within 2 x LR x Adam's reach at that step; ms a
     step and peak memory of each rank (not a scaling number: both share
     the card); the stage-1 options in float64 (float64_grads, two
     batches of 8): the logs and gradients within 1e-12; (iii) the serve CLI at two ranks (gloo, the
     card shared) against one process at batch 2 on phase eval's sets:
     the same files within one uint8 step. Each kernel of the training
     path must launch in (i) and (ii).
 14. spatial: val_spatial_shard, batch-1 evaluation split into one
     horizontal band of each image a rank. `python -m
     c2matching_tpu_torch.test --launcher pytorch` (under
     torch.distributed.run, TF32 off, cuDNN deterministic) at two ranks
     sharing the card over gloo, on phase eval's f32 options at full
     width with val_spatial_shard: true, on phase eval's sets and three
     HR 512x336 pairs (LR 128x84: bands of 64 LR rows),
     against the same CLI in one process: every image's output within
     1e-4, the saved PNGs (rank 0 alone saves) within one uint8 step, the
     averages within 1e-3 dB (SSIM_Y 1e-5) on both ranks; every image
     split into bands (the CUFED-shaped pair's 85 LR rows into 42 and
     43); B1 once and the fused forward three times an image on each
     rank, the last image's B1, B3 and fused operands at the band's
     arguments held against
     their plain versions; per rank ms an image, peak memory, halo
     exchanges and gathers with their bytes (both ranks share the card:
     not a scaling number). Per
     rank the leaf module that rose highest above its entry
     (``ModulePeaks``). The CLI at world size 1 over NCCL with the option
     on and off, every output bit for bit: a guard that the option is a
     no-op there (no band is cut at world size 1; NCCL's band collectives
     need two cards and are not run). The B3 band probe: the lower half of
     each DynAgg image (Ho = H / 2 at padding (1 - H / 2, 1), the whole x), the
     kernel bit for bit the whole image's columns of those rows, its
     plain version likewise, and the two within B3's f32 tolerance. One
     JSON line of the phase's numbers.
 15. options: the options the port took last, on a 10-pair 160-px synth
     set whose refs share their inputs' keys, packed into lmdb databases by
     c2matching_tpu_torch.scripts.create_cufed_lmdb (through the lmdb
     package where installed, else the port's own store of the same
     format; the line says which). lmdb: RefCUFEDDataset and
     ContrasDataset items from lmdb equal to the disk set's under the same
     seeds, host ms an item for each store; the shipped
     stage3_restoration_gan.yml (1 pretrain + 1 GAN iteration, batch 9 at
     gt 160, from phase contras' student) and
     stage1_teacher_contras_network.yml (1 iteration, batch 8) through
     run(), once from lmdb and once from disk, one loader thread, cuDNN's
     deterministic algorithms: the batches and the losses equal bit for
     bit, stage 3's trained net too, stage 1's within 2 x lr_g (its loss's
     gather scatters its gradient with atomics). trace: the lmdb stage-3
     run carries logger.trace_dir over both its iterations: one trace
     file, JSON, one ProfilerStep an iteration, naming B1 and the B3
     forward and backward kernels (CUPTI sees the ctypes launches).
     remat: one warm GAN step of
     that model from one state under train.remat_policy none, dcn_rows and
     dots: ms, peak memory and B3 forward launches each; the nets after
     each within 1e-6 of none's (bit for bit expected); dcn_rows launches
     B3 as often as none, dots twice. bf16: the same step with dtype
     bfloat16 on network_d and perceptual_opt beside the f32 one (ms,
     peak), and a small model's GAN step with both, card vs CPU, each log
     within 2^-5. bytes: profile_serving --cost at batch 16 (serving
     config): each stage's *_hbm_gb and *_hbm_gb_per_s beside its
     *_gflops. One JSON line of the phase's numbers.
 16. extras: the off-path pieces. DCNSep (groups 8, a random
     conv_offset_mask) at the DynAgg widths at HR 512x384 (relu1
     512x384x64, relu2 256x192x128, relu3 128x96x256): one fused launch
     a forward and no B3 launch, B3's columns on the module's offsets
     against deform_im2col_plain, the module's
     output against the same module on the CPU; module, B3, plain and
     grid_sample times beside B3's bound. DCNSep forward and backward at
     batch 9 at the training shapes (160x160x64, 80x80x128, 40x40x256):
     9 forward launches and 1 backward launch, the x, offset and mask
     gradients through autograd against deform_conv_backward_plain within
     phase b3bwd's gates, forward, autograd backward and kernel times
     beside the bounds. The backward's pieces: DCN(128, one group) at
     batch 9, 40x40 (two 64-channel sub-groups, one launch) and
     DCNv2Module(64 -> 330) at batch 4, 80x80 (two Co chunks, two
     launches), forward and backward against the plain versions and
     against the CPU, no launch of the columns' route. SRModel
     (model_type SRModel) on a net of the ported blocks at nf 64 (conv,
     two spectral-norm residual blocks, a DCN, two BN residual blocks in
     eval, Upsample(4)): test_x8 at LR 120x80, batch 2, against the CPU,
     8 fused launches (one a transform) and no B3 launch; one
     optimize_parameters step against the CPU
     (logs and gradients). TextureLoss (use_weights), MapLoss,
     PerceptualLossMultiInputs, MaskedTVLoss and deform_psroi_pooling at
     batch 9, gt 160, against the CPU, each one's ms. One JSON line of the
     phase's numbers.
 17. serve: batch serving and the tools. export_serving of the serving
     config at batch 2, HR 512x336 (the graph's operator calls, the
     export's seconds and the .pt2's MB); the artifact is loaded and run in
     a fresh process that cannot import c2matching_tpu_torch.models and
     held against the in-process forward, while `python -m
     c2matching_tpu_torch.scripts.serve` runs in two more processes, in
     the serving config on phase eval's sets (3 synth pairs at 160, the
     CUFED5-shaped pair), at --batch 2 (a full and a padded partial flush)
     and --batch 1: the same files, every PNG within one uint8 step of its
     twin. Then, with no other process running: serve.py's loop in process
     on 32 CUFED5-sized pairs at batch 16, its second flush under
     torch.profiler (end-to-end images/s, the device's busy share); batch
     16 at HR 512x336, full width, in the serving and f32 configs:
     profile_serving's stage times, net images/s, peak memory and the
     launch counts (3 fused launches a forward, no B3); one serving
     forward at batch 16 whose B1 launch (the whole batch), whose fused
     DynAgg launches (against the columns route) and B3 on its arguments
     (48, one flush) are held against their
     plain versions (B1 image by image) and timed beside their library
     calls and bounds; a torch.profiler trace of it in the serving config
     (top kernels, busy share); the host's cost of a call through
     torch.ops. Last bench_train (stage 3 GAN, stage 1) and
     profile_train at full width: one JSON line each with the JAX
     version's keys (profile_train's byte fields included), finite, and
     the B3 backward launched in stage 3; then `python -m
     c2matching_tpu_torch.scripts.bench_train --stage 3 --decompose` in
     its own process, as the pin of utils/bench_gate.py was taken (torch's
     default TF32 settings): the step with the batch on the card and its
     gate line.
 18. one JSON line of kernels, the card's line, and last the JSON result.

Exits non-zero, printing no result, when a phase fails or no CUDA card
is present. TF32 is off for convolutions and matmuls throughout.
"""
import contextlib
import importlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

B1_VAL_TOL = 1e-4    # |kernel - plain| of the max score: f32 sums of the
                     # same exact products in two orders, scores of O(4)
B1_GAP_TOL = 1e-4    # indices must agree where the plain top-2 gap exceeds
                     # this; below it the two summation orders may pick
                     # either of two near-equal candidates
B3_F32_TOL = 1e-5    # |kernel - plain| of f32 columns (values of O(1);
                     # the kernel may fuse multiply-adds)
B3_BF16_REL = 2 ** -8  # bf16 columns: one round-to-nearest of the exact
                       # value (half an ulp, at most 2^-8 relative)
MAIN_CPU_TOL = 1e-3  # card (kernels, cuDNN) vs CPU (plain versions) output
                     # of the full f32 model on a small request
B3_LIB_TOL = 1e-3    # grid_sample (the library yardstick) vs B3's columns:
                     # it maps coordinates to [-1, 1] and back, which moves
                     # a sample by ~1e-5 px at 512 px
B2_F32_TOL = 1e-5    # |kernel - plain| of B2's output, f32 rows (outputs
                     # of O(1) at the DCN init scale; sums in other orders)
B2_BF16_TOL = 1e-4   # bf16 rows: both convert the same values to f32
WIN_F32_REL = 1e-4   # windowed op vs exact op, of max |out|: tents and
                     # bilinear corner weights round apart
WIN_BF16_REL = 0.03  # bf16 x: the exact op rounds the weight to bf16, the
                     # windowed op keeps it f32
EVAL_PSNR_TOL = 0.01  # dB, card vs CPU f32 runner on the synth set: the
                      # outputs agree to ~1e-6, so only a rare uint8
                      # rounding flips
EVAL_SSIM_TOL = 1e-4
EVAL_SERVING_PSNR_TOL = 0.5  # dB, serving vs f32 on the card: bf16 gathers
                             # and near-tie match flips; a sanity bound
B3B_REL = 1e-5       # |kernel - plain| of the offset and mask gradients, of
                     # their largest magnitude: the columns' gradient as
                     # 3xTF32 against f32 (~3e-7 of it in the CPU emulation,
                     # tests/test_torch_dcn_bwd_scheme.py) and f32 dots in
                     # another order (bf16 x is read alike)
B3B_X_REL = 1e-5     # grad_x in f32: atomics add in a run-dependent order
B3B_X_BF16_REL = 2 ** -7  # grad_x cast to bf16 once: one rounding apart
TRAIN_CPU_REL = 1e-3  # card vs CPU, small config: the losses, and the G
                      # gradients of G's largest gradient (cuDNN and the
                      # kernels sum in other orders)

F32_BLOCKS = {
    'network_g': {'type': 'RestorationNet', 'ngf': 64, 'n_blocks': 16,
                  'groups': 8},
    'network_map': {'type': 'CorrespondenceGenerationArch', 'patch_size': 3,
                    'stride': 1,
                    'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                    'vgg_type': 'vgg19'},
    'network_extractor': {'type': 'ContrasExtractorSep'},
}
SERVING_BLOCKS = {
    'network_g': dict(F32_BLOCKS['network_g'], gather_dtype='bfloat16',
                      trunk_unroll=16),
    'network_map': dict(F32_BLOCKS['network_map'], match_dtype='bfloat16'),
    'network_extractor': {'type': 'ContrasExtractorSep'},
}
# HR request sizes: the CUFED5 bench shape, another CUFED5 image, and one
# on the JAX package's 64-px bucket
REQUESTS = ((512, 336), (500, 332), (512, 384))
DCN_SHAPES = (('relu3_1', 128, 84, 256), ('relu2_1', 256, 168, 128),
              ('relu1_1', 512, 336, 64))
# what the main path hands the kernels for REQUESTS[0] (LR 128x84, run at
# its own shape): relu3_1 features of 128x84 give 126 x 82 descriptors,
# B1's query and ref rows; the DynAggs sample at 1x, 2x and 4x of 128x84
PATH_B1 = (1, 126 * 82, 9 * 256)
PATH_B3 = tuple((h, w, c) for _, h, w, c in DCN_SHAPES)
# the windowed op's (blk, win) by the DynAgg shape of an HR 512x384
# request: phase b2 runs these shapes on random DynAgg-structured
# inputs, phase path the same layers (by their channels) at PATH_B3
WINDOWED = {(512, 384, 64): ('relu1_1', 4, 8),
            (256, 192, 128): ('relu2_1', 2, 6)}
# published peaks of one H100 SXM (dense, at the 700 W limit): device
# memory, f32 outside the tensor cores, bf16 and TF32 in them
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, 'tf32': 495e12}
# B1 runs f32 operands as 3xTF32: three TF32 products per f32 product
B1_TF32_PRODUCTS = 3
# stage-3 training at gt 160 (LR 40): the DynAggs' per-image shapes
TRAIN_B3 = (('relu3_1', 40, 40, 256), ('relu2_1', 80, 80, 128),
            ('relu1_1', 160, 160, 64))
TRAIN_OPTIONS = 'options/train/stage3_restoration_gan.yml'
TRAIN_PRETRAIN, TRAIN_GAN = 2, 3    # iterations of phase train


class Checks:
    """Collects failed checks so that every phase reports before exit."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        print(('ok   ' if ok else 'FAIL ') + what, flush=True)
        if not ok:
            self.failed.append(what)
        return ok


@contextlib.contextmanager
def _in_dir(path):
    """Run the block with ``path`` as the working directory."""
    import os
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _check_events(check, root, name, tags, what):
    """``use_tb_logger: true`` wrote one event file under
    ``root``/tb_logger/``name`` naming each of ``tags``."""
    import os
    tb_dir = f'{root}/tb_logger/{name}'
    files = sorted(os.listdir(tb_dir)) if os.path.isdir(tb_dir) else []
    data = b''
    for fname in files:
        with open(f'{tb_dir}/{fname}', 'rb') as f:
            data += f.read()
    check(len(files) == 1 and all(t.encode() in data for t in tags),
          f'{what}: tensorboard event file under tb_logger/{name} '
          f'({len(data)} bytes) holds {", ".join(tags)}')


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, min_ms=25.0):
    """Mean device time of ``fn`` over enough runs to fill ``min_ms`` of
    device time (at least 3), after one timed warm-up. The events bracket
    a whole queue of calls, so the host's time to launch the first call is
    spread over all of them: with 3 runs it would add ~15 us to each,
    which a kernel of 0.1 ms would feel."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(200, math.ceil(min_ms / max(start.elapsed_time(end),
                                                  1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, rate):
    """The least time the card could take for the work, in ms, and what
    bounds it: the bytes over the memory rate against the operations over
    the peak rate of their type (a key of PEAK_FLOPS)."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_S
    t_ops = 1e3 * ops / PEAK_FLOPS[rate]
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ----------------------------------------------------------------- B1
def _b1_compare(check, q, r, bias, label):
    from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain
    idx_k, val_k = match_argmax(q, r, bias)
    idx_p, val_p = match_argmax_plain(q, r, bias)
    scores = torch.matmul(q.float(), r.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    top2 = scores.topk(2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    clear = gaps > B1_GAP_TOL
    near = (gaps >= 1e-7) & (gaps <= 1e-3)
    same = (idx_k == idx_p) | ~clear
    picked = scores.gather(-1, idx_k.long()[..., None])[..., 0]
    err = (val_k - val_p).abs().max().item()
    check(bool(same.all()), f'b1 {label}: indices equal on the '
          f'{int(clear.sum())} of {clear.numel()} rows with top-2 gap > '
          f'{B1_GAP_TOL:g} (on all rows: {int((idx_k == idx_p).sum())}; '
          f'{int(near.sum())} rows have a gap in [1e-7, 1e-3])')
    check(bool(((picked - val_p).abs() <= B1_GAP_TOL).all()),
          f'b1 {label}: every picked index scores within {B1_GAP_TOL:g} of '
          'the max')
    check(err <= B1_VAL_TOL, f'b1 {label}: max |val diff| {err:.3g} <= '
          f'{B1_VAL_TOL:g}')
    return idx_k, err


def _b1_time(q, r, bias, label):
    from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain
    ms = cuda_ms(lambda: match_argmax(q, r, bias))
    plain_ms = cuda_ms(lambda: match_argmax_plain(q, r, bias))
    print(f'b1 {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms',
          flush=True)
    return ms, plain_ms


def _b1_work(q, r, bias):
    """(bytes, operations) of B1: read q, r and the bias once, write the
    index and the value; a multiply-add per (query, kept ref row,
    channel): excluded ref rows cannot win, so their products are not
    needed."""
    b, nq, d = q.shape
    kept = r.shape[1] if bias is None else int((bias == 0).sum())
    moved = nbytes(q, r) + (0 if bias is None else nbytes(bias)) + 8 * b * nq
    return moved, 2 * b * nq * kept * d


def _b1_library_ms(q, r, bias):
    """The same function as PyTorch calls: torch.matmul, the bias, max."""
    def call():
        scores = torch.matmul(q, r.mT)
        return (scores if bias is None else scores + bias).max(dim=-1)
    return cuda_ms(call)


def _b1_call_peak(q, r, bias=None):
    """Bytes one call adds at its peak above what is allocated before it:
    its outputs, the partitions' partials and, for f32, the split
    operands."""
    from c2matching_tpu_torch.ops import match_argmax
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    match_argmax(q, r, bias)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_b1(check, dev):
    from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # the CUFED5 request: 126 x 82 descriptors of 9 x 256 channels
    nq = nr = 126 * 82
    d = 9 * 256
    q = randn(nq, d)
    r = randn(nr, d)
    r = r / r.norm(dim=-1, keepdim=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        qd, rd = q.to(dtype), r.to(dtype)
        _b1_compare(check, qd, rd, None, f'{nq}x{nr}x{d} {name}')
        _b1_time(qd, rd, None, f'{nq}x{nr}x{d} {name}')
    del q, r, qd, rd
    torch.cuda.empty_cache()

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        # ragged shapes, batched: nq and nr off the 128-row tiles, D off
        # the 32-word stages (a zero-filled tail stage), the ref axis split;
        # ref rows normalised as the main path's, so scores stay O(4)
        _b1_compare(check, randn(2, 300, 72).to(dtype),
                    randn(2, 470, 72).to(dtype), None,
                    f'ragged 2x300x470x72 {name}')
        # a depth below one 128-byte stage, one query warpgroup's rows
        # past nq, and one ref row past a tile
        _b1_compare(check, randn(3, 65, 16).to(dtype),
                    randn(3, 257, 16).to(dtype), None,
                    f'ragged 3x65x257x16 {name}')
        r = randn(2, 3001, 2312)
        _b1_compare(check, randn(2, 1000, 2312).to(dtype),
                    (r / r.norm(dim=-1, keepdim=True)).to(dtype), None,
                    f'ragged 2x1000x3001x2312 {name} '
                    f'({_b1_parts(2, 1000, 3001, dtype)} partitions)')
        for d_bad in (27, 12):
            try:
                match_argmax(randn(300, d_bad).to(dtype),
                             randn(470, d_bad).to(dtype))
                raised = False
            except ValueError:
                raised = True
            check(raised, f'b1 D = {d_bad} {name}: the wrapper refuses '
                  'D % 8 != 0')
        # exact ties: duplicated ref rows in one 128-row tile and across
        # two, and adjacent (a thread's two columns); the lowest wins
        base = randn(50, 64)
        for r_tie, want in ((torch.cat([base] * 3), torch.arange(50)),
                            (base.repeat_interleave(3, dim=0),
                             3 * torch.arange(50))):
            idx, _ = match_argmax((2 * base).to(dtype), r_tie.to(dtype))
            check(torch.equal(idx.long().cpu(), want),
                  f'b1 ties {name}: the lowest duplicate index wins')
        # exact ties across ref tiles and across partitions: few queries
        # split the ref axis into many partitions, many into few
        for nq_tie, batch in ((200, 1), (4096, 1), (200, 3)):
            _b1_tie_probe(check, gen, dev, dtype, nq_tie, batch)
        # near ties at full depth
        q, r = _b1_near_ties(gen, dev)
        _b1_compare(check, q.to(dtype), r.to(dtype), None,
                    f'near ties {q.shape[0]}x{r.shape[0]}x{q.shape[1]} {name}'
                    f' ({_b1_parts(1, q.shape[0], r.shape[0], dtype)} '
                    'partitions)')
        del q, r
        # ref_bias: exclude the unbiased winner of every other query
        q = randn(700, 64).to(dtype)
        r = randn(1000, 64).to(dtype)
        win, _ = match_argmax_plain(q, r)
        keep = torch.rand(1000, generator=gen, device=dev) > 0.5
        keep[win[::2].long()] = False
        bias = torch.where(keep, 0.0, -1e30).float()
        idx, _ = _b1_compare(check, q, r, bias, f'ref_bias {name}')
        check(bool(keep[idx.long()].all()),
              f'b1 ref_bias {name}: no excluded row wins')


def _b1_parts(batch, nq, nr, dtype):
    pmk = importlib.import_module('c2matching_tpu_torch.ops.'
                                  'patch_match_kernel')
    return pmk.partitions(batch, nq, nr, dtype)


def _b1_tie_probe(check, gen, dev, dtype, nq, batch=1, d=256, copies=3):
    """Each query's best ref row duplicated at `copies` random positions
    of its image among normalised random rows (at least 5120 ref rows, 4
    per duplicate; other positions in each image): the lowest position
    must win, on the query rows of both consumer warpgroups (64 each of a
    block's 128), across ref tiles and partitions, in every image."""
    from c2matching_tpu_torch.ops import match_argmax
    name = str(dtype).replace('torch.', '')
    nr = max(5120, 4 * copies * nq)
    base = torch.randn(batch, nq, d, generator=gen, device=dev)
    r = torch.randn(batch, nr, d, generator=gen, device=dev)
    r = r / r.norm(dim=-1, keepdim=True)
    pos = torch.stack([torch.randperm(nr, generator=gen, device=dev)
                       [:copies * nq] for _ in range(batch)])
    pos = pos.reshape(batch, nq, copies)
    for i in range(batch):
        r[i, pos[i].reshape(-1)] = base[i].repeat_interleave(copies, dim=0)
    parts = _b1_parts(batch, nq, nr, dtype)
    idx, _ = match_argmax((2 * base).to(dtype), r.to(dtype))
    check(torch.equal(idx.long(), pos.min(dim=-1).values),
          f'b1 ties {name} {batch}x{nq}x{nr}x{d}: the lowest of {copies} '
          'duplicates wins across ref tiles, both consumer warpgroups\' '
          f'rows and {parts} partitions')
    if nq * batch <= 256:
        check(parts > 1, f'b1 ties {name} {nq}x{nr}: the ref axis is split '
              f'({parts} partitions)')


def _b1_near_ties(gen, dev, n=2048, extra=2000, d=9 * 256):
    """Patch-structured descriptors: q of 9 L2-normalised pixels of 256
    channels; for each query a normalised near copy of it and a second
    row that scores higher by a gap drawn log-uniformly from 1e-7 to
    1e-3; both among normalised random rows, all shuffled. Returns
    (q, r) in f32."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q = randn(n, 9, d // 9)
    q = (q / q.norm(dim=-1, keepdim=True)).reshape(n, d)
    first = q + 0.02 * randn(n, d)
    first = first / first.norm(dim=-1, keepdim=True)
    gap = 10 ** (-7 + 4 * torch.rand(n, 1, generator=gen, device=dev))
    second = first + gap * q / (q * q).sum(-1, keepdim=True)
    rest = randn(extra, d)
    r = torch.cat([first, second, rest / rest.norm(dim=-1, keepdim=True)])
    perm = torch.randperm(r.shape[0], generator=gen, device=dev)
    return q, r[perm].contiguous()


# ----------------------------------------------------------------- B3
def _dcn_inputs(gen, dev, h, w, c, dtype, g=8, k=9):
    x = torch.randn(h, w, c, generator=gen, device=dev).to(dtype)
    # match offsets are integer shifts; the learned residual is small
    shift = torch.randint(-16, 17, (h, w, 1, k, 2), generator=gen,
                          device=dev).float()
    offset = (shift + 0.5 * torch.randn(h, w, g, k, 2, generator=gen,
                                        device=dev)).contiguous()
    mask = torch.rand(h, w, g, k, generator=gen, device=dev)
    return x, offset, mask


def _b3_compare(check, x, offset, mask, label, **conv):
    """Kernel columns against the plain version's on the same inputs
    (``conv``: the stride, padding and dilation); returns the max
    |difference|."""
    from c2matching_tpu_torch.ops import deform_im2col, deform_im2col_plain
    cols_k = deform_im2col(x, offset, mask, **conv).float()
    err = (cols_k - deform_im2col_plain(x, offset, mask, **conv).float())
    err = err.abs().max().item()
    if x.dtype == torch.float32:
        ok = err <= B3_F32_TOL
        bound = f'{B3_F32_TOL:g}'
    else:
        # against the unrounded f32 columns of the same bf16 input: one
        # rounding to bf16 plus f32 arithmetic error
        exact = deform_im2col_plain(x.float(), offset, mask, **conv)
        ok = bool(((cols_k - exact).abs()
                   <= B3_BF16_REL * exact.abs() + B3_F32_TOL).all())
        bound = f'{B3_BF16_REL:g}|v| + {B3_F32_TOL:g} of the f32 columns'
        del exact
    check(ok, f'b3 {label}: max |cols diff| {err:.3g} within {bound}')
    del cols_k
    torch.cuda.empty_cache()
    return err


def _b3_time(x, offset, mask, label):
    from c2matching_tpu_torch.ops import deform_im2col, deform_im2col_plain
    ms = cuda_ms(lambda: deform_im2col(x, offset, mask))
    plain_ms = cuda_ms(lambda: deform_im2col_plain(x, offset, mask))
    print(f'b3 {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms',
          flush=True)
    torch.cuda.empty_cache()
    return ms, plain_ms


# ops per column element: four corner weights, four multiply-adds, the mask
B3_OPS_PER_COL = 13


def _b3_work(x, offset, mask):
    """(bytes, operations) of B3 on one image: read x, the offsets and the
    mask once, write the columns once."""
    ho, wo, _, k, _ = offset.shape
    n_cols = ho * wo * k * x.shape[-1]
    moved = nbytes(x, offset, mask) + n_cols * x.element_size()
    return moved, B3_OPS_PER_COL * n_cols


def _b3_library(check, x, offset, mask, label):
    """F.grid_sample computes B3's bilinear samples with the same zero
    padding, one batch entry per group (coordinates mapped to [-1, 1] with
    align_corners); checks that against the kernel's columns and returns
    the time of the grid_sample call alone."""
    from c2matching_tpu_torch.ops import deform_im2col
    h, w, c = x.shape
    ho, wo, g, k, _ = offset.shape
    base_y = torch.arange(ho, device=x.device, dtype=torch.float32) - 1
    base_x = torch.arange(wo, device=x.device, dtype=torch.float32) - 1
    tap = torch.arange(k, device=x.device)
    sy = base_y[:, None, None, None] + (tap // 3).float() + offset[..., 0]
    sx = base_x[None, :, None, None] + (tap % 3).float() + offset[..., 1]
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    grid = grid.reshape(ho * wo, g, k, 2).permute(1, 0, 2, 3).contiguous()
    inp = x.reshape(h, w, g, c // g).permute(2, 3, 0, 1).contiguous()

    def call():
        return F.grid_sample(inp, grid, mode='bilinear', padding_mode='zeros',
                             align_corners=True)

    samples = call() * mask.reshape(ho * wo, g, k).permute(1, 0, 2)[:, None]
    cols = samples.permute(2, 3, 0, 1).reshape(ho * wo, k * c)
    err = (cols - deform_im2col(x, offset, mask)).abs().max().item()
    check(err <= B3_LIB_TOL, f'b3 {label}: grid_sample yardstick within '
          f'{err:.3g} <= {B3_LIB_TOL:g} of the kernel columns')
    del samples, cols
    return cuda_ms(call)


def _b3_wide_probe(check, gen, dev, dtype, h=1536, w=1536, c=128):
    """An image whose columns pass 2^31 elements, which the kernel serves
    with 64-bit index math: its first and last output rows against the
    plain version on those rows alone (their offsets moved by the rows
    skipped, so the sample points stay the same)."""
    from c2matching_tpu_torch.ops import deform_im2col, deform_im2col_plain
    name = str(dtype).replace('torch.', '')
    x, offset, mask = _dcn_inputs(gen, dev, h, w, c, dtype)
    cols = deform_im2col(x, offset, mask)
    n = cols.numel()
    worst = 0.0
    for r0 in (0, h - 4):
        sub = offset[r0:r0 + 4].clone()
        sub[..., 0] += r0
        want = deform_im2col_plain(x, sub, mask[r0:r0 + 4]).float()
        got = cols[r0 * w:(r0 + 4) * w].float()
        exact = deform_im2col_plain(x.float(), sub, mask[r0:r0 + 4])
        check(bool(((got - exact).abs()
                    <= B3_BF16_REL * exact.abs() + B3_F32_TOL).all()),
              f'b3 wide {h}x{w}x{c} {name} ({n / 2 ** 31:.2f} x 2^31 column '
              f'elements), rows {r0}-{r0 + 3}: within {B3_BF16_REL:g}|v| + '
              f'{B3_F32_TOL:g} of the f32 columns')
        worst = max(worst, (got - want).abs().max().item())
    print(f'b3 wide {h}x{w}x{c} {name}: max |cols diff| {worst:.3g} against '
          'the plain version', flush=True)
    del x, offset, mask, cols
    torch.cuda.empty_cache()


def phase_b3(check, dev):
    from c2matching_tpu_torch.ops import deform_im2col, modulated_deform_conv
    gen = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        for layer, h, w, c in DCN_SHAPES:
            x, offset, mask = _dcn_inputs(gen, dev, h, w, c, dtype)
            label = f'{layer} {h}x{w}x{c} {name}'
            _b3_compare(check, x, offset, mask, label)
            _b3_time(x, offset, mask, label)

        # odd shapes: Cg = 1, 3 and 6 (the scalar channel loop), stride 2,
        # dilation 2
        for h, w, c, stride, pad, dil in ((37, 29, 8, 1, 1, 1),
                                          (37, 29, 24, 1, 1, 1),
                                          (37, 29, 48, 1, 1, 1),
                                          (64, 48, 64, 2, 1, 1),
                                          (64, 48, 128, 1, 2, 2)):
            ho = (h + 2 * pad - 2 * dil - 1) // stride + 1
            wo = (w + 2 * pad - 2 * dil - 1) // stride + 1
            x = torch.randn(h, w, c, generator=gen, device=dev).to(dtype)
            _, offset, mask = _dcn_inputs(gen, dev, ho, wo, 8, dtype)
            _b3_compare(check, x, offset, mask,
                        f'odd {h}x{w}x{c} Cg {c // 8} stride {stride} '
                        f'dilation {dil} {name}', stride=(stride, stride),
                        padding=(pad, pad), dilation=(dil, dil))

        if dtype == torch.bfloat16:
            _b3_wide_probe(check, gen, dev, dtype)

        # large offsets: the whole tap is out of the image -> exact zeros
        layer, h, w, c = DCN_SHAPES[0]
        x, offset, mask = _dcn_inputs(gen, dev, h, w, c, dtype)
        big = torch.tensor([1e4, -1e4, 1e6, -3e7], device=dev)
        offset = big[torch.randint(0, 4, offset.shape, generator=gen,
                                   device=dev)]
        cols = deform_im2col(x, offset, mask)
        check(bool((cols == 0).all()),
              f'b3 large-offset probe {name}: columns exactly zero')
        weight = torch.randn(9, c, c, generator=gen, device=dev)
        bias = torch.randn(c, generator=gen, device=dev)
        out = modulated_deform_conv(x[None], offset[None], mask[None],
                                    weight, bias)
        check(torch.equal(out, bias.expand_as(out)),
              f'b3 large-offset probe {name}: output equals the bias')


# ------------------------------------------------------------- B3 fused
B3F_REL = 2e-5       # |kernel - columns path| of the output, of its largest
                     # magnitude: the same columns (bit for bit in bf16, the
                     # kernel's arithmetic is B3's), contracted in another
                     # order, as 3xTF32 in f32 (~2^-22 a product, ~1e-6 of
                     # the output over 2304-deep sums)
B3F_BATCHES = (1, 16)  # a request alone, and the serving batch


def _fused_inputs(gen, dev, batch, h, w, c, dtype, co=None):
    """x (B, H, W, C), DynAgg-structured offsets and mask, w_kc (9C, Co)
    rounded to x's dtype as modulated_deform_conv rounds it, and a bias."""
    co = c if co is None else co
    x, offset, mask = zip(*(_dcn_inputs(gen, dev, h, w, c, dtype)
                            for _ in range(batch)))
    weight = torch.empty(9 * c, co, device=dev).uniform_(
        -1, 1, generator=gen) / math.sqrt(9 * c)
    bias = torch.randn(co, generator=gen, device=dev)
    return (torch.stack(x), torch.stack(offset), torch.stack(mask),
            weight.to(dtype).float(), bias)


def _fused_route(x, offset, mask, w_kc, bias, **conv):
    """The columns route on the card (what the no-grad path ran before the
    fused kernel): B3 per image, its columns to f32, torch.matmul, the
    stack and the bias add."""
    dc = importlib.import_module('c2matching_tpu_torch.ops.deform_conv')
    conv = tuple(conv.get(k, d) for k, d in (
        ('kernel_size', (3, 3)), ('stride', (1, 1)), ('padding', (1, 1)),
        ('dilation', (1, 1))))
    return dc._mdc_forward(x, offset, mask, w_kc, bias, conv)


def _fused_compare(check, x, offset, mask, w_kc, bias, label, plain=True,
                   **conv):
    """The fused kernel against the columns route on the card (within
    B3F_REL of its largest magnitude) and, with ``plain``, against the
    plain version (f32: the same gate; bf16: B3's columns against the
    plain columns differ by a bf16 rounding where the f32 value lies
    within an ulp of a tie, so the gate adds one bf16 ulp of the largest
    column times the largest weight a flipped column can move an output
    by, 2^-8 x 2 x that). Returns the largest difference from the route,
    of its largest magnitude."""
    from c2matching_tpu_torch.ops import (deform_conv_fused,
                                          deform_conv_fused_plain)
    launches = deform_conv_fused.launches
    got = deform_conv_fused(x, offset, mask, w_kc, bias, **conv)
    torch.cuda.synchronize()
    check(deform_conv_fused.launches == launches + 1,
          f'b3f {label}: one launch for the batch')
    want = _fused_route(x, offset, mask, w_kc, bias, **conv)
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / max(scale, 1e-30)
    check(rel <= B3F_REL and bool(torch.isfinite(got).all()),
          f'b3f {label}: kernel vs the columns route {rel:.3g} <= '
          f'{B3F_REL:g} of the output\'s largest {scale:.3g}')
    del want
    if plain:
        want = deform_conv_fused_plain(x, offset, mask, w_kc, bias, **conv)
        err = (got - want).abs().max().item()
        tol = B3F_REL * want.abs().max().item()
        if x.dtype == torch.bfloat16:
            tol += 2 * 2 ** -8 * x.float().abs().max().item() * \
                w_kc.abs().max().item()
        check(err <= tol, f'b3f {label}: kernel vs plain max |diff| '
              f'{err:.3g} <= {tol:.3g}')
        del want
    del got
    torch.cuda.empty_cache()
    return rel


def _fused_bound(x, offset, mask, w_kc, bias):
    """(ms, what bounds it) of one fused call: the largest of x, the
    offsets, the mask, the weight and bias read once and the output written
    once; the contraction on the tensor cores in bf16, or as three TF32
    products for an f32 x; B3's sampling, B3_OPS_PER_COL a column value, on
    the SIMT f32 pipes."""
    b, ho, wo = offset.shape[:3]
    co = w_kc.shape[1]
    moved = (nbytes(x, offset, mask, w_kc) + co * 4 * (bias is not None)
             + b * ho * wo * co * 4)
    cols = b * ho * wo * w_kc.shape[0]
    ops = 2 * cols * co
    ms, by = (bound(moved, B1_TF32_PRODUCTS * ops, 'tf32')
              if x.dtype == torch.float32 else bound(moved, ops, x.dtype))
    simt_ms = 1e3 * B3_OPS_PER_COL * cols / PEAK_FLOPS[torch.float32]
    return (simt_ms, 'SIMT operations') if simt_ms > ms else (ms, by)


def _fused_measure(x, offset, mask, w_kc, bias, plain=True):
    """(kernel ms, plain ms or None, columns route ms) of one call."""
    from c2matching_tpu_torch.ops import (deform_conv_fused,
                                          deform_conv_fused_plain)
    ms = cuda_ms(lambda: deform_conv_fused(x, offset, mask, w_kc, bias))
    plain_ms = (cuda_ms(lambda: deform_conv_fused_plain(
        x, offset, mask, w_kc, bias), min_ms=1.0) if plain else None)
    route_ms = cuda_ms(lambda: _fused_route(x, offset, mask, w_kc, bias))
    torch.cuda.empty_cache()
    return ms, plain_ms, route_ms


def _fused_f64(check, x, offset, mask, w_kc, bias, label, card):
    """The kernel's and the columns route's error against the same columns
    (B3's, bit for bit the kernel's samples) contracted in f64, of the
    reference's largest magnitude: in f32 the route is IEEE f32
    (torch.matmul without TF32), so a kernel error at the route's level
    shows 3xTF32 as an f32 contraction. Returns (kernel, route)."""
    from c2matching_tpu_torch.ops import deform_conv_fused, deform_im2col
    got = deform_conv_fused(x, offset, mask, w_kc, bias)
    route = _fused_route(x, offset, mask, w_kc, bias)
    w64 = w_kc.double()
    k_err = r_err = scale = 0.0
    for i in range(x.shape[0]):
        ref = deform_im2col(x[i], offset[i], mask[i]).double() @ w64
        if bias is not None:
            ref += bias.double()
        ref = ref.reshape(got.shape[1:])
        scale = max(scale, ref.abs().max().item())
        k_err = max(k_err, (got[i].double() - ref).abs().max().item())
        r_err = max(r_err, (route[i].double() - ref).abs().max().item())
        del ref
    k_rel, r_rel = k_err / max(scale, 1e-30), r_err / max(scale, 1e-30)
    print(f'b3f {label}: against an f64 contraction of the same columns, '
          f'kernel {k_rel:.3g}, columns route (torch.matmul, TF32 off) '
          f'{r_rel:.3g} of its largest {scale:.3g} ({card})', flush=True)
    check(k_rel <= B3F_REL, f'b3f {label}: kernel vs f64 {k_rel:.3g} <= '
          f'{B3F_REL:g}')
    del got, route
    torch.cuda.empty_cache()
    return k_rel, r_rel


def _fused_band_probe(check, gen, dev, dtype):
    """A band's arguments (the lower half of each DynAgg image: Ho = H / 2
    at padding (1 - H / 2, 1), the whole x): the kernel's output rows bit
    for bit those of the whole image's output."""
    from c2matching_tpu_torch.ops import deform_conv_fused
    name = str(dtype).replace('torch.', '')
    for layer, h, w, c in DCN_SHAPES:
        x, offset, mask, w_kc, bias = _fused_inputs(gen, dev, 2, h, w, c,
                                                    dtype)
        row0 = h // 2
        pad = (1 - row0, 1)
        whole = deform_conv_fused(x, offset, mask, w_kc, bias)[:, row0:]
        band = deform_conv_fused(x, offset[:, row0:].contiguous(),
                                 mask[:, row0:].contiguous(), w_kc, bias,
                                 padding=pad)
        check(torch.equal(band, whole), f'b3f band probe {layer} {h}x{w}x{c} '
              f'{name}, rows {row0}-{h - 1} at padding {pad}: bit for bit '
              'the whole image\'s rows')
        _fused_compare(check, x, offset[:, row0:].contiguous(),
                       mask[:, row0:].contiguous(), w_kc, bias,
                       f'band {layer} {name} padding {pad}', padding=pad)
        del x, offset, mask, whole, band
        torch.cuda.empty_cache()


def phase_b3f(check, dev, report, card):
    """The fused forward (deform_conv_fused) at the three DynAgg shapes at
    batch 1 and 16, f32 and bf16: against the columns route and the plain
    version, timed beside them and its bound; at batch 16 it and the route
    against an f64 contraction of the same columns; a band's padding; odd
    shapes (a ragged last tile, C off the stage depth, Co off the tiles and
    odd, a group of one vector); views off the 16-byte boundary; the
    large-offset probe; an image past 2^31 values (the 64-bit
    instantiation); shapes outside fused_applicable,
    which modulated_deform_conv sends to the columns without a fused
    launch and the operator refuses on the card."""
    from c2matching_tpu_torch.ops import (deform_conv_fused, deform_im2col,
                                          fused_applicable,
                                          modulated_deform_conv)
    gen = torch.Generator(device=dev).manual_seed(25)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        entry, f64 = {}, {}
        for batch in B3F_BATCHES:
            tot = dict.fromkeys(('ms', 'plain_ms', 'library_ms', 'bound_ms'),
                                0.0)
            worst, bound_by = 0.0, set()
            for layer, h, w, c in DCN_SHAPES:
                args = _fused_inputs(gen, dev, batch, h, w, c, dtype)
                label = f'{layer} batch {batch} {h}x{w}x{c} {name}'
                worst = max(worst, _fused_compare(check, *args, label))
                ms, plain_ms, route_ms = _fused_measure(*args)
                b_ms, b_by = _fused_bound(*args)
                print(f'b3f {label}: kernel {ms:.3f} ms, plain '
                      f'{plain_ms:.3f} ms, columns route (B3 + torch.matmul)'
                      f' {route_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by} '
                      f'({card})', flush=True)
                if batch == SERVE_BATCH:
                    f64[layer] = _fused_f64(check, *args, label, card)
                tot['ms'] += ms
                tot['plain_ms'] += plain_ms
                tot['library_ms'] += route_ms
                tot['bound_ms'] += b_ms
                bound_by.add(b_by)
                del args
                torch.cuda.empty_cache()
            b_ms, b_by = tot['bound_ms'], ' and '.join(sorted(bound_by))
            print(f'b3f batch {batch} {name}: the three DynAggs {tot["ms"]:.3f}'
                  f' ms against the columns route {tot["library_ms"]:.3f} ms, '
                  f'bound {b_ms:.3f} ms by {b_by} ({100 * b_ms / tot["ms"]:.1f}'
                  f'% of it) ({card})', flush=True)
            entry[batch] = {'ms': tot['ms'], 'plain_ms': tot['plain_ms'],
                            'library_ms': tot['library_ms'],
                            'bound_ms': b_ms, 'bound_by': b_by,
                            'max_rel_err': worst}
        # the kernels line: the serving batch, every time measured there
        report[f'b3f_{name}'] = dict(entry[SERVE_BATCH], batch1=entry[1],
                                     f64_rel=f64)

        _fused_band_probe(check, gen, dev, dtype)
        vector = 16 // torch.tensor([], dtype=dtype).element_size()
        # odd shapes: a ragged last tile (3 x 37 x 29 pixels), C off the
        # stage depth, Co odd and off the 64-wide tiles, Co past 128, one
        # vector a group
        for b, h, w, c, g, co in ((3, 37, 29, 8 * vector, 8, 33),
                                  (2, 20, 24, 5 * vector, 1, 200),
                                  (1, 9, 70, 24 * vector, 8, 64)):
            x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
            offset = (4 * torch.randn(b, h, w, g, 9, 2, generator=gen,
                                      device=dev)).contiguous()
            mask = torch.rand(b, h, w, g, 9, generator=gen, device=dev)
            w_kc = (torch.randn(9 * c, co, generator=gen, device=dev)
                    / math.sqrt(9 * c)).to(dtype).float()
            bias = torch.randn(co, generator=gen, device=dev)
            _fused_compare(check, x, offset, mask, w_kc, bias,
                           f'odd B {b} {h}x{w}x{c} G {g} Co {co} {name}')
            _fused_compare(check, x, offset, mask, w_kc, None,
                           f'odd B {b} {h}x{w}x{c} G {g} Co {co} {name} no '
                           'bias', padding=(2, 0))

        # x and the offsets one element into their storage: the operator
        # copies them to aligned storage, the output bit for bit
        x, offset, mask, w_kc, bias = _fused_inputs(gen, dev, 2, 40, 36, 64,
                                                    dtype)
        xs = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:]
        xs = xs.view(x.shape).copy_(x)
        offs = torch.empty(offset.numel() + 1, device=dev)[1:]
        offs = offs.view(offset.shape).copy_(offset)
        check(bool(xs.data_ptr() % 16 and offs.data_ptr() % 8)
              and torch.equal(deform_conv_fused(xs, offs, mask, w_kc, bias),
                              deform_conv_fused(x, offset, mask, w_kc, bias)),
              f'b3f unaligned views {name}: bit for bit the aligned call')
        del x, offset, mask, xs, offs

        # large offsets: every tap out of the image -> the output is the bias
        layer, h, w, c = DCN_SHAPES[0]
        x, offset, mask, w_kc, bias = _fused_inputs(gen, dev, 2, h, w, c,
                                                    dtype)
        big = torch.tensor([1e4, -1e4, 1e6, -3e7, float('nan')], device=dev)
        offset = big[torch.randint(0, 5, offset.shape, generator=gen,
                                   device=dev)]
        out = deform_conv_fused(x, offset, mask, w_kc, bias)
        check(torch.equal(out, bias.expand_as(out)),
              f'b3f large-offset probe {name}: output equals the bias')
        del x, offset, mask, out

        # outside fused_applicable: the columns, no fused launch; the
        # operator refuses them on the card
        x = torch.randn(1, 16, 16, 8 * vector, generator=gen,
                        device=dev).to(dtype)
        for k, stride, g, what in ((5, 1, 8, '5x5 taps'),
                                   (3, 2, 8, 'stride 2'),
                                   (3, 1, 16, 'a group of half a vector')):
            ho = (16 + 2 - k) // stride + 1
            offset = torch.randn(1, ho, ho, g, k * k, 2, generator=gen,
                                 device=dev)
            mask = torch.rand(1, ho, ho, g, k * k, generator=gen, device=dev)
            weight = torch.randn(k * k, x.shape[-1], 16, generator=gen,
                                 device=dev)
            conv = {'kernel_size': (k, k), 'stride': (stride, stride)}
            before = (deform_conv_fused.launches, deform_im2col.launches)
            with torch.no_grad():
                out = modulated_deform_conv(x, offset, mask, weight, **conv)
            check(not fused_applicable(x, offset, **conv)
                  and deform_conv_fused.launches == before[0]
                  and deform_im2col.launches == before[1] + 1,
                  f'b3f {what} {name}: the columns, no fused launch')
            try:
                deform_conv_fused(x, offset, mask, weight.reshape(-1, 16)
                                  .to(dtype).float(), None, **conv)
                refused = False
            except ValueError:
                refused = True
            check(refused, f'b3f {what} {name}: the operator refuses it')
            del offset, mask, weight, out
        torch.cuda.empty_cache()

    # 64-bit indices: x past 2^31 values, a few output pixels sampling its
    # far rows; against the columns route (B3 takes 64-bit there too)
    h, w, c = 1 << 14, 1 << 14, 8
    x = torch.randn(1, h, w, c, generator=gen, device=dev).to(torch.bfloat16)
    offset = torch.rand(1, 16, 16, 1, 9, 2, generator=gen, device=dev)
    offset[..., 0] *= h - 40
    offset[..., 1] *= w - 40
    mask = torch.rand(1, 16, 16, 1, 9, generator=gen, device=dev)
    w_kc = (torch.randn(9 * c, 64, generator=gen, device=dev)
            / 8).to(torch.bfloat16).float()
    _fused_compare(check, x, offset, mask, w_kc, None,
                   f'wide {h}x{w}x{c} bfloat16 ({x.numel() / 2 ** 31:.2f} x '
                   '2^31 values)', plain=False)
    del x
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- B2
def _b2_window(x, offset, mask, blk, win):
    """The windowed op's own prep for one image: the image-mode arguments
    of B2 (x, origins, ry, rx, mm), whether every tap lies in its window,
    and the block counts."""
    dw = importlib.import_module('c2matching_tpu_torch.ops.dcn_window')
    origins, ry, rx, mm, ok = dw._window_prep(x, offset, mask, blk, win)
    h, w, _ = x.shape
    return (x, origins, ry, rx, mm), bool(ok), h // blk, w // blk


def _b2_tol(dtype):
    return B2_F32_TOL if dtype == torch.float32 else B2_BF16_TOL


def _b2_compare(check, args, label):
    """B2 in image mode (``window_conv``, args = x, origins, ry, rx, mm,
    weight, blk, win, nby, nbx) against its plain version, and against
    rows mode on the gathered windows, which must give the same bits.
    Returns the max |difference| from the plain version."""
    from c2matching_tpu_torch.ops import (window_contract, window_conv,
                                          window_conv_plain)
    dk = importlib.import_module('c2matching_tpu_torch.ops.'
                                 'dcn_window_kernel')
    x, origins = args[:2]
    out_k = window_conv(*args)
    err = (out_k - window_conv_plain(*args)).abs().max().item()
    tol = _b2_tol(x.dtype)
    check(err <= tol, f'b2 {label}: max |out diff| {err:.3g} <= {tol:g}')
    rows = dk._window_gather(x, origins, args[7])
    check(torch.equal(out_k, window_contract(rows, *args[2:])),
          f'b2 {label}: image mode and rows mode equal bit for bit')
    del out_k, rows
    torch.cuda.empty_cache()
    return err


def _b2_time(args, label):
    """Times of B2 in image mode, of its plain version (the gather and the
    dense contraction) and of rows mode on the gathered windows."""
    from c2matching_tpu_torch.ops import (window_contract, window_conv,
                                          window_conv_plain)
    dk = importlib.import_module('c2matching_tpu_torch.ops.'
                                 'dcn_window_kernel')
    ms = cuda_ms(lambda: window_conv(*args))
    plain_ms = cuda_ms(lambda: window_conv_plain(*args))
    rows = dk._window_gather(args[0], args[1], args[7])
    rows_ms = cuda_ms(lambda: window_contract(rows, *args[2:]))
    print(f'b2 {label}: image mode {ms:.3f} ms, plain {plain_ms:.3f} ms, '
          f'rows mode {rows_ms:.3f} ms (on {nbytes(rows) / 1e9:.2f} GB of '
          'gathered windows)', flush=True)
    del rows
    torch.cuda.empty_cache()
    return ms, plain_ms, rows_ms


def _b2_needed_cells(ry, rx, mm, blk, win, nbx):
    """Per (block, tap, group, window cell), whether a non-zero tent weight
    needs it (a tent is non-zero on at most 2 x 2 cells of a window; a
    cell is needed once however many pixels use it), and the number of
    (pixel, tap, group, cell) samples with a non-zero weight."""
    g, k, p = ry.shape
    dev = ry.device
    pix = torch.arange(p, device=dev)
    wo = nbx * blk
    block = (pix // wo // blk) * nbx + (pix % wo) // blk
    base = ((block[None, None] * k + torch.arange(k, device=dev)[:, None])
            * g + torch.arange(g, device=dev)[:, None, None]) * win * win
    need = torch.zeros(p // (blk * blk) * k * g * win * win,
                       dtype=torch.bool, device=dev)
    y0 = ry.floor().clamp(-2, win)
    x0 = rx.floor().clamp(-2, win)
    n_samples = 0
    for dy in (0, 1):
        cy = y0 + dy
        ty = (1 - (ry - cy).abs()).clamp_min(0) * ((cy >= 0) & (cy < win))
        for dx in (0, 1):
            cx = x0 + dx
            txm = ((1 - (rx - cx).abs()).clamp_min(0) * mm
                   * ((cx >= 0) & (cx < win)))
            used = (ty != 0) & (txm != 0)
            n_samples += int(used.sum())
            cell = (base + cy.clamp(0, win - 1).long() * win
                    + cx.clamp(0, win - 1).long())
            need[cell[used]] = True
    return need, n_samples


def _b2_work(x, origins, ry, rx, mm, weight, blk, win, nby, nbx):
    """(bytes, operations) of B2 in image mode: read x, the origins, the
    three (G, K, P) fields and the weight once, write the f32 output once;
    the contraction with the weight is dense (2 P K C Co), the tent
    sampling one multiply-add per (pixel, tap, group, cell) with a
    non-zero weight and channel of the group."""
    g, k, p = ry.shape
    c = x.shape[-1]
    co = weight.shape[-1]
    _, n_samples = _b2_needed_cells(ry, rx, mm, blk, win, nbx)
    moved = (nbytes(x, origins, ry, rx, mm) + 4 * weight.numel()
             + 4 * p * co)
    return moved, 2 * p * k * c * co + 2 * n_samples * (c // g)


def _b2_rows_work(x, ry, rx, mm, weight, blk, win, nby, nbx):
    """(bytes, operations) of B2 in rows mode: the gathered window cells
    that a non-zero tent needs, the fields, the weight and the output; the
    same operations as image mode."""
    g, k, p = ry.shape
    c = x.shape[-1]
    co = weight.shape[-1]
    need, n_samples = _b2_needed_cells(ry, rx, mm, blk, win, nbx)
    moved = (int(need.sum()) * (c // g) * x.element_size()
             + nbytes(ry, rx, mm) + 4 * weight.numel() + 4 * p * co)
    return moved, 2 * p * k * c * co + 2 * n_samples * (c // g)


def _b2_inputs(gen, dev, h, w, c, blk, g=8, k=9):
    """Random DynAgg-structured inputs of one image: x, the block-constant
    integer flow in +-16, a residual in +-0.4, the mask, a weight at the
    DCN's init scale and a bias."""
    x = torch.randn(1, h, w, c, generator=gen, device=dev)
    flow = torch.randint(-16, 17, (1, h // blk, w // blk, 1, k, 2),
                         generator=gen, device=dev).float()
    flow = flow.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
    resid = 0.4 * (2 * torch.rand(1, h, w, g, k, 2, generator=gen,
                                  device=dev) - 1)
    mask = torch.rand(1, h, w, g, k, generator=gen, device=dev)
    weight = torch.randn(k, c, c, generator=gen, device=dev) / math.sqrt(k * c)
    bias = torch.randn(c, generator=gen, device=dev)
    return x, flow, resid, mask, weight, bias


def _windowed_vs_exact(check, x, offset, mask, weight, bias, blk, win,
                       label, chunks=None):
    """The windowed op (or its row-chunked form) against the exact op:
    returns (launches of B2, windowed ms, exact ms)."""
    from c2matching_tpu_torch.ops import (
        modulated_deform_conv, modulated_deform_conv_windowed,
        modulated_deform_conv_windowed_chunked, window_contract)
    if chunks is None:
        def windowed():
            return modulated_deform_conv_windowed(x, offset, mask, weight,
                                                  bias, blk=blk, win=win)
    else:
        def windowed():
            return modulated_deform_conv_windowed_chunked(
                x, offset, mask, weight, bias, blk=blk, win=win,
                row_chunks=chunks)

    def exact():
        return modulated_deform_conv(x, offset, mask, weight, bias)

    window_contract.launches = 0
    out_w = windowed()
    torch.cuda.synchronize()
    launches = window_contract.launches
    out_e = exact()
    scale = out_e.abs().max().item()
    err = (out_w - out_e).abs().max().item()
    rel = WIN_F32_REL if x.dtype == torch.float32 else WIN_BF16_REL
    check(out_w.shape == out_e.shape and err <= rel * scale,
          f'{label}: max |windowed - exact| {err:.3g} <= {rel:g} x max|out| '
          f'{scale:.3g}')
    del out_w, out_e
    ms = cuda_ms(windowed)
    exact_ms = cuda_ms(exact)
    torch.cuda.empty_cache()
    return launches, ms, exact_ms


def _b2_coords(gen, dev, shape, win):
    """Window coordinates reaching 3 cells past the window on both sides,
    5% of them far outside it (huge ones too)."""
    r = (win + 5) * torch.rand(shape, generator=gen, device=dev) - 3
    far = torch.rand(shape, generator=gen, device=dev) < 0.05
    huge = torch.tensor([1e6, -1e6, 3e30, -3e30], device=dev)[
        torch.randint(0, 4, shape, generator=gen, device=dev)]
    return torch.where(far, huge, r)


def _b2_image_probe(check, gen, dev, h, w, c, g, co, blk, win, nby, nbx):
    """Image mode on random windows: origins drawn from the two clamps
    (-2 and H + 2 - win, and the same for x), so whole window rows and
    columns lie in the zero ring, and from in between; coordinates past
    the window, huge ones, and zero modulation; in f32 and bf16, against
    the plain version and rows mode."""
    nb, p = nby * nbx, nby * nbx * blk * blk

    def origin(n, top):
        pick = torch.randint(0, 3, (nb, 9), generator=gen, device=dev)
        mid = torch.randint(-2, top + 1, (nb, 9), generator=gen, device=dev)
        return torch.where(pick == 0, -2, torch.where(pick == 1, top, mid))

    origins = torch.stack([origin(nb, h + 2 - win), origin(nb, w + 2 - win)],
                          dim=-1).to(torch.int32)
    ry = _b2_coords(gen, dev, (g, 9, p), win)
    rx = _b2_coords(gen, dev, (g, 9, p), win)
    mm = torch.rand(g, 9, p, generator=gen, device=dev)
    mm = mm * (torch.rand(g, 9, p, generator=gen, device=dev) > 0.2)
    weight = torch.randn(9, c, co, generator=gen, device=dev) / 12
    x = torch.randn(h, w, c, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        _b2_compare(check, (x.to(dtype), origins, ry, rx, mm, weight, blk,
                            win, nby, nbx),
                    f'image probe {h}x{w}x{c} G {g} Co {co} blk {blk} '
                    f'win {win} {nby}x{nbx} blocks, origins at both clamps '
                    f'{name}')


def phase_b2(check, dev, card):
    from c2matching_tpu_torch.ops import (modulated_deform_conv,
                                          modulated_deform_conv_windowed,
                                          window_contract,
                                          window_contract_plain)
    gen = torch.Generator(device=dev).manual_seed(4)
    for (h, w, c), (layer, blk, win) in WINDOWED.items():
        x32, flow, resid, mask, weight, bias = _b2_inputs(gen, dev, h, w, c,
                                                          blk)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace('torch.', '')
            label = f'{layer} {h}x{w}x{c} blk {blk} win {win} {name}'
            x = x32.to(dtype)
            offset = flow + resid
            args, ok, nby, nbx = _b2_window(x[0], offset[0], mask[0], blk,
                                            win)
            check(ok, f'b2 {label}: every tap inside its window')
            args = (*args, weight, blk, win, nby, nbx)
            _b2_compare(check, args, label)
            ms = _b2_time(args, label)[0]
            dw = importlib.import_module('c2matching_tpu_torch.ops.'
                                         'dcn_window')
            prep_ms = cuda_ms(lambda: dw._window_prep(x[0], offset[0],
                                                      mask[0], blk, win))
            print(f'b2 windowed op {label}: prep {prep_ms:.3f} ms, B2 '
                  f'{ms:.3f} ms ({card})', flush=True)
            del args
            launches, ms, exact_ms = _windowed_vs_exact(
                check, x, offset, mask, weight, bias, blk, win,
                f'b2 windowed op {label}')
            check(launches == 1, f'b2 windowed op {label}: window_contract '
                  f'launched {launches} time(s)')
            print(f'b2 windowed op {label}: {ms:.3f} ms, exact op '
                  f'{exact_ms:.3f} ms ({card})', flush=True)
            # row chunks: 8 sequential kernel launches, no fallback
            launches, ms, exact_ms = _windowed_vs_exact(
                check, x, offset, mask, weight, bias, blk, win,
                f'b2 chunked op {label}', chunks=8)
            check(launches == 8, f'b2 chunked op {label}: window_contract '
                  f'launched {launches} times')
            print(f'b2 chunked op (8 chunks) {label}: {ms:.3f} ms, exact op '
                  f'{exact_ms:.3f} ms ({card})', flush=True)
            # fallback: residuals past the window take the exact op
            offset = flow + 5 * resid
            window_contract.launches = 0
            out = modulated_deform_conv_windowed(x, offset, mask, weight,
                                                 bias, blk=blk, win=win)
            check(window_contract.launches == 0
                  and torch.equal(out, modulated_deform_conv(
                      x, offset, mask, weight, bias)),
                  f'b2 fallback probe {label}: no launch, output equals the '
                  'exact op bit for bit')
            del out, offset
            torch.cuda.empty_cache()

    # rows mode on odd shapes against the plain version: tiles that
    # straddle blocks and end ragged, C and Co off the kernel's tiles (a
    # group of 6 channels takes the scalar path; Co 200 two column tiles),
    # coordinates far outside the window (huge ones too), zero modulation
    for blk, win, nby, nbx, c, g, co in ((3, 7, 5, 7, 24, 4, 40),
                                         (1, 5, 9, 11, 16, 2, 200)):
        nb, p = nby * nbx, nby * nbx * blk * blk
        rows = torch.randn(nb, 9, win, win * c, generator=gen, device=dev)
        ry = _b2_coords(gen, dev, (g, 9, p), win)
        rx = _b2_coords(gen, dev, (g, 9, p), win)
        mm = torch.rand(g, 9, p, generator=gen, device=dev)
        mm = mm * (torch.rand(g, 9, p, generator=gen, device=dev) > 0.2)
        weight = torch.randn(9, c, co, generator=gen, device=dev) / 12
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace('torch.', '')
            args = (rows.to(dtype), ry, rx, mm, weight, blk, win, nby, nbx)
            err = (window_contract(*args)
                   - window_contract_plain(*args)).abs().max().item()
            tol = _b2_tol(dtype)
            check(err <= tol, f'b2 rows probe blk {blk} win {win} {nby}x{nbx}'
                  f' blocks C {c} G {g} Co {co} {name}: max |out diff| '
                  f'{err:.3g} <= {tol:g}')

    # image mode on odd shapes: the output grid smaller than the image (as
    # a row chunk's), C off the 16-channel ring slots with a group of 6
    # (scalar path) or of 4, Co off the 64-channel tiles, a 2-tile Co
    for h, w, c, g, co, blk, win, nby, nbx in (
            (37, 29, 24, 4, 40, 3, 7, 5, 7),
            (40, 44, 20, 5, 72, 2, 6, 20, 22),
            (16, 20, 48, 8, 200, 4, 8, 4, 5),
            (12, 9, 16, 2, 3, 1, 5, 12, 9)):
        _b2_image_probe(check, gen, dev, h, w, c, g, co, blk, win, nby, nbx)

    # a CUDA tensor the kernel cannot take raises: no fallback hides it
    from c2matching_tpu_torch.ops import window_conv
    x = torch.randn(16, 16, 8, device=dev)
    origins = torch.zeros(16, 9, 2, dtype=torch.int32, device=dev)
    fields = torch.zeros(2, 9, 256, device=dev)
    wide = torch.zeros(16, 16, 1024, device=dev)
    out = window_conv(x, origins, fields, fields, fields,
                      torch.zeros(9, 8, 8, device=dev), 4, 6, 4, 4)
    check(tuple(out.shape) == (16, 16, 8), 'b2 image mode takes the valid '
          'counterpart of the refused calls')
    for what, bad in (
            ('a float64 image', (x.double(), origins,
                                 torch.zeros(9, 8, 8, device=dev))),
            ('int64 origins', (x, origins.long(),
                               torch.zeros(9, 8, 8, device=dev))),
            ('C = 1024, past its 512-channel limit',
             (wide, origins, torch.zeros(9, 1024, 8, device=dev)))):
        try:
            window_conv(*bad[:2], fields, fields, fields, bad[2], 4, 6, 4, 4)
            raised = False
        except (TypeError, ValueError, RuntimeError):
            raised = True
        check(raised, f'b2 image mode refuses {what} on the card')


# ------------------------------------------------------------ conv epilogue
# (pixels, C) of the restoration net's convs at batch 16 on the 128 x 84
# request: relu1's blocks and final conv, relu2's offset convs, relu3's
# offset-mask and offset convs
EPILOGUE_SHAPES = (((16, 336, 512), 64), ((16, 336, 512), 3),
                   ((16, 168, 256), 128), ((16, 84, 128), 216),
                   ((16, 84, 128), 256))


def _epilogue_operands(gen, dev, shape, dtype):
    y = torch.randn(shape, generator=gen, device=dev).to(dtype)
    bias = torch.randn(shape[-1], generator=gen, device=dev).to(dtype)
    res = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return y, bias, res


def _unaligned_copy(t):
    """A copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def phase_epilogue(check, dev, report):
    from c2matching_tpu_torch.ops import conv_epilogue, conv_epilogue_plain
    gen = torch.Generator(device=dev).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        for (pixels, c), copy in [(s, torch.clone) for s in EPILOGUE_SHAPES] \
                + [(((3, 5, 7), 64), _unaligned_copy)]:
            y, bias, res = _epilogue_operands(gen, dev, pixels + (c,), dtype)
            for act in (None, 'relu', 'lrelu'):
                for r in (None, res):
                    want = conv_epilogue_plain(y.clone(), bias, act, r)
                    got = conv_epilogue(copy(y), bias, act, r)
                    check(torch.equal(got, want),
                          f'epilogue {"x".join(map(str, pixels))}x{c} {name} '
                          f'act {act} residual {r is not None}'
                          f'{" unaligned" if copy is _unaligned_copy else ""}'
                          ': equal to the plain version')
                    del want, got
            del y, bias, res
        torch.cuda.empty_cache()

    # one residual block's epilogues at relu1: conv1's bias + ReLU, conv2's
    # bias + the block's input
    shape = EPILOGUE_SHAPES[0][0] + (EPILOGUE_SHAPES[0][1],)
    y1, bias, x = _epilogue_operands(gen, dev, shape, torch.float32)
    y2 = torch.randn(shape, generator=gen, device=dev)

    def kernel():
        conv_epilogue(y1, bias, 'relu')
        conv_epilogue(y2, bias, None, x)

    def plain():
        conv_epilogue_plain(y1, bias, 'relu')
        conv_epilogue_plain(y2, bias, None, x)

    def library():
        # what F.conv2d's cuDNN path and the block ran: the bias add on the
        # conv's NCHW view (channels-last), then F.relu and x + out
        b4 = bias.view(1, -1, 1, 1)
        y1.permute(0, 3, 1, 2).add_(b4)
        F.relu(y1)
        y2.permute(0, 3, 1, 2).add_(b4)
        return x + y2

    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    library_ms = cuda_ms(library)
    # conv1's output read and written, conv2's read and written, x read
    bound_ms, bound_by = bound(5 * nbytes(y1), 4 * y1.numel(), torch.float32)
    print(f'epilogue relu1 block {"x".join(map(str, shape))} f32: kernel '
          f'{ms:.3f} ms, plain {plain_ms:.3f} ms, library {library_ms:.3f} '
          f'ms, bound {bound_ms:.3f} ms ({bound_by}; {100 * bound_ms / ms:.1f}'
          '% of it)', flush=True)
    report['epilogue_float32'] = {'ms': ms, 'plain_ms': plain_ms,
                                  'bound_ms': bound_ms, 'bound_by': bound_by,
                                  'library_ms': library_ms}
    del y1, y2, x
    torch.cuda.empty_cache()


# --------------------------------------------------------------- main path
def _request(gen, dev, hr_h, hr_w):
    """A smooth random HR image, its x4 LR, the LR upsampled back, and a
    shifted copy as the reference (NHWC, [0, 1])."""
    coarse = torch.rand(1, 3, hr_h // 8 + 1, hr_w // 8 + 1, generator=gen,
                        device=dev)
    gt = F.interpolate(coarse, size=(hr_h, hr_w), mode='bilinear',
                       align_corners=False)
    gt = (gt + 0.05 * torch.rand(gt.shape, generator=gen, device=dev))
    gt = gt.clamp(0, 1)
    lq = F.avg_pool2d(gt, 4)
    up = F.interpolate(lq, scale_factor=4, mode='bicubic',
                       align_corners=False).clamp(0, 1)
    ref = torch.roll(gt, shifts=(24, 16), dims=(2, 3))

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    return {'img_in_lq': nhwc(lq), 'img_in_up': nhwc(up),
            'img_ref': nhwc(ref)}


def _serve(model, batch):
    model.feed_data(batch)
    model.test()
    out = model.cropped_output()
    torch.cuda.synchronize()
    return out


def _stage_ms(model, batch):
    """Device time of each net for one request, by CUDA events around the
    calls RefRestorationModel.test makes."""
    model.feed_data(batch)
    b = model.batch
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        events[0].record()
        feats = model.net_extractor(b['img_in_up'], b['img_ref'])
        events[1].record()
        pre, ref_feat = model.net_map(feats, b['img_ref'])
        events[2].record()
        model.net_g(b['img_in_lq'], pre, ref_feat)
        events[3].record()
    torch.cuda.synchronize()
    names = ('extractor', 'match+vgg19', 'restoration')
    return {n: events[i].elapsed_time(events[i + 1])
            for i, n in enumerate(names)}


@contextlib.contextmanager
def _record_kernel_inputs():
    """Record what the main path hands each kernel: (q, r, ref_bias) of
    every match and (x, offset, mask, weight, bias) of every DynAgg's DCN,
    the whole batch. Wraps the names the callers look up; the kernels and
    their launch counters stay as they are."""
    pm = importlib.import_module('c2matching_tpu_torch.ops.patch_match')
    ra = importlib.import_module(
        'c2matching_tpu_torch.models.archs.ref_restoration_arch')
    seen = {'b1': [], 'b3': []}
    match, mdc = pm.match_argmax, ra.modulated_deform_conv

    def match_rec(q, r, ref_bias=None):
        seen['b1'].append((q, r, ref_bias))
        return match(q, r, ref_bias)

    def mdc_rec(x, offset, mask, weight, bias=None, **conv):
        seen['b3'].append((x, offset, mask, weight, bias))
        return mdc(x, offset, mask, weight, bias, **conv)

    pm.match_argmax, ra.modulated_deform_conv = match_rec, mdc_rec
    try:
        yield seen
    finally:
        pm.match_argmax, ra.modulated_deform_conv = match, mdc


def phase_main(check, dev, report, card, recorded):
    from c2matching_tpu_torch.models import RefRestorationModel
    from c2matching_tpu_torch.models.archs.arch_util import Conv2d
    from c2matching_tpu_torch.ops import (conv_epilogue, deform_conv_fused,
                                          deform_im2col, match_argmax)
    gen = torch.Generator(device=dev).manual_seed(3)
    requests = [_request(gen, dev, *hw) for hw in REQUESTS]
    for cfg, blocks in (('f32', F32_BLOCKS), ('serving', SERVING_BLOCKS)):
        model = RefRestorationModel(blocks, dev,
                                    torch.Generator().manual_seed(0))
        _serve(model, requests[0])   # warm-up: cuDNN plans, allocator
        match_argmax.launches = 0
        deform_im2col.launches = deform_conv_fused.launches = 0
        conv_epilogue.launches = 0
        fused, graph = Conv2d.fused_epilogues, Conv2d.graph_epilogues
        times = []
        outs = []
        for batch in requests:
            t0 = time.perf_counter()
            outs.append(_serve(model, batch))
            times.append(time.perf_counter() - t0)
        launches = {'match_argmax': match_argmax.launches,
                    'deform_im2col': deform_im2col.launches,
                    'deform_conv_fused': deform_conv_fused.launches,
                    'conv_epilogue': conv_epilogue.launches}
        # the DynAggs of a request without a graph: one fused launch each,
        # no columns
        check(launches['deform_conv_fused'] == 3 * len(requests)
              and launches['deform_im2col'] == 0,
              f'main {cfg}: deform_conv_fused launched '
              f'{launches["deform_conv_fused"]} times (3 a request over '
              f'{len(requests)}), deform_im2col {launches["deform_im2col"]} '
              '(none)')
        check(conv_epilogue.launches == Conv2d.fused_epilogues - fused
              and Conv2d.graph_epilogues == graph,
              f'main {cfg}: the conv epilogue launched once a conv '
              f'({conv_epilogue.launches}), no conv on the graph path')
        for (hr_h, hr_w), out, dt in zip(REQUESTS, outs, times):
            check(tuple(out.shape) == (1, hr_h, hr_w, 3)
                  and bool(torch.isfinite(out).all()),
                  f'main {cfg} HR {hr_h}x{hr_w}: output {tuple(out.shape)} '
                  'finite')
            print(f'main {cfg} HR {hr_h}x{hr_w}: latency {1e3 * dt:.1f} ms '
                  f'({card})', flush=True)
        print(f'main {cfg}: {len(times) / sum(times):.3f} images/s over '
              f'{len(times)} requests at batch 1 ({card})', flush=True)
        for name in ('match_argmax', 'conv_epilogue'):
            check(launches[name] > 0,
                  f'main {cfg}: {name} launched {launches[name]} times')
        stages = _stage_ms(model, requests[0])
        print(f'main {cfg} HR {REQUESTS[0][0]}x{REQUESTS[0][1]} device ms by '
              'net: ' + ', '.join(f'{k} {v:.2f}' for k, v in stages.items())
              + f' ({card})', flush=True)
        report[f'main_{cfg}_launches'] = launches
        if cfg == 'f32':
            # the same nets on the CPU, where the plain versions run
            small = _request(gen, dev, 96, 80)
            out = _serve(model, small).cpu()
            cpu = RefRestorationModel(blocks, 'cpu',
                                      torch.Generator().manual_seed(0))
            cpu.feed_data({k: v.cpu() for k, v in small.items()})
            cpu.test()
            err = (out - cpu.cropped_output()).abs().max().item()
            check(err <= MAIN_CPU_TOL, f'main f32: card vs CPU on HR 96x80, '
                  f'max |diff| {err:.3g} <= {MAIN_CPU_TOL:g}')
        # one more request, outside the counted run, for phase path
        with _record_kernel_inputs() as seen:
            _serve(model, requests[0])
        lr_h, lr_w = REQUESTS[0][0] // 4, REQUESTS[0][1] // 4
        rows = (lr_h - 2) * (lr_w - 2)
        shapes = [(tuple(q.shape), tuple(r.shape), bias)
                  for q, r, bias in seen['b1']]
        check(shapes == [((1, rows, 9 * 256), (1, rows, 9 * 256), None)],
              f'main {cfg}: B1 gets the LR {lr_h}x{lr_w} request\'s '
              f'({lr_h} - 2) x ({lr_w} - 2) = {rows} query and ref rows, no '
              f'ref_bias: {shapes}')
        recorded[cfg] = seen
        del model
        torch.cuda.empty_cache()


def phase_path(check, report, recorded, card):
    """Each kernel against its plain version on the tensors the main path
    gave it for the HR 512x336 request, in both configs; then the windowed
    op on the relu1 and relu2 DynAggs' tensors."""
    for cfg, dtype in (('f32', torch.float32), ('serving', torch.bfloat16)):
        name = str(dtype).replace('torch.', '')
        seen = recorded.pop(cfg)
        report[f'path_b3f_{name}'] = _path_fused(check, seen['b3'], name,
                                                 card)
        # the request's one image
        seen['b3'] = [(x[0], offset[0], mask[0], weight, bias)
                      for x, offset, mask, weight, bias in seen['b3']]
        check(len(seen['b1']) == 1,
              f'path {cfg}: one match call ({len(seen["b1"])})')
        (q, r, bias), = seen['b1']
        check(tuple(q.shape) == PATH_B1 and tuple(r.shape) == PATH_B1
              and bias is None and q.dtype == dtype and r.dtype == dtype,
              f'path {cfg}: B1 gets q {tuple(q.shape)}, r {tuple(r.shape)} '
              f'{r.dtype}, ref_bias {bias}')
        label = f'main path {q.shape[1]}x{r.shape[1]}x{q.shape[2]} {name}'
        _, err = _b1_compare(check, q, r, None, label)
        ms, plain_ms = _b1_time(q, r, None, label)
        scratch = _b1_call_peak(q, r)
        moved, ops = _b1_work(q, r, None)
        if dtype == torch.float32:
            # the kernel's pipe: three TF32 products per f32 product
            simt_ms, _ = bound(moved, ops, torch.float32)
            bound_ms, bound_by = bound(moved, B1_TF32_PRODUCTS * ops, 'tf32')
            pipe = (f'3xTF32 at {PEAK_FLOPS["tf32"] / 1e12:g} TFLOP/s; '
                    f'SIMT f32 at {PEAK_FLOPS[torch.float32] / 1e12:g} '
                    f'TFLOP/s: {simt_ms:.3f} ms')
        else:
            bound_ms, bound_by = bound(moved, ops, dtype)
            pipe = f'bf16 at {PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s'
        library_ms = _b1_library_ms(q, r, None)
        print(f'b1 {label}: bound {bound_ms:.3f} ms by {bound_by} ({pipe}), '
              f'torch.matmul + max {library_ms:.3f} ms on the same rows; '
              f'the call adds {scratch / 2**30:.3f} GiB (outputs and '
              f'scratch) ({card})', flush=True)
        report[f'b1_{name}'] = {'ms': ms, 'plain_ms': plain_ms,
                                'max_abs_err': err, 'bound_ms': bound_ms,
                                'bound_by': bound_by,
                                'library_ms': library_ms}
        del q, r
        seen['b1'].clear()
        torch.cuda.empty_cache()

        shapes = sorted(tuple(d[0].shape) for d in seen['b3'])
        check(shapes == sorted(PATH_B3)
              and all(d[0].dtype == dtype for d in seen['b3']),
              f'path {cfg}: B3 gets x {shapes} {dtype}')
        total_ms = total_plain = worst = 0.0
        total_lib = 0.0 if dtype == torch.float32 else None
        moved = ops = 0
        for x, offset, mask, _, _ in seen['b3']:
            label = 'main path {}x{}x{} {}'.format(*x.shape, name)
            worst = max(worst, _b3_compare(check, x, offset, mask, label))
            ms, plain_ms = _b3_time(x, offset, mask, label)
            total_ms += ms
            total_plain += plain_ms
            work = _b3_work(x, offset, mask)
            moved, ops = moved + work[0], ops + work[1]
            if total_lib is not None:
                lib_ms = _b3_library(check, x, offset, mask, label)
                print(f'b3 {label}: grid_sample {lib_ms:.3f} ms ({card})',
                      flush=True)
                total_lib += lib_ms
        bound_ms, bound_by = bound(moved, ops, torch.float32)
        print(f'b3 main path {name}: kernel {total_ms:.3f} ms over the three '
              f'DynAggs, bound {bound_ms:.3f} ms by {bound_by} ({card})',
              flush=True)
        report[f'b3_{name}'] = {'ms': total_ms, 'plain_ms': total_plain,
                                'max_abs_err': worst, 'bound_ms': bound_ms,
                                'bound_by': bound_by,
                                'library_ms': total_lib}
        report[f'b2_{name}'] = _path_windowed(check, seen['b3'], cfg, name,
                                              card)
        del seen
        torch.cuda.empty_cache()


def _path_fused(check, dcns, name, card, where='main path', plain=True):
    """The fused kernel on the very arguments the main path's DynAggs
    handed modulated_deform_conv, as it rounds and reshapes them: against
    the columns route and (with ``plain``) the plain version, and timed."""
    total = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0}
    worst = 0.0
    for x, offset, mask, weight, bias in dcns:
        k, c, co = weight.shape
        w_kc = weight.reshape(k * c, co).to(x.dtype).float()
        args = (x, offset.float().contiguous(), mask.float().contiguous(),
                w_kc, None if bias is None else bias.float())
        label = '{} {}x{}x{}x{} {}'.format(where, *x.shape, name)
        worst = max(worst, _fused_compare(check, *args, label, plain=plain))
        ms, plain_ms, route_ms = _fused_measure(*args, plain=plain)
        print(f'b3f {label}: kernel {ms:.3f} ms, plain '
              + (f'{plain_ms:.3f} ms' if plain else 'not timed')
              + f', columns route {route_ms:.3f} ms ({card})', flush=True)
        total['ms'] += ms
        total['plain_ms'] += plain_ms or 0.0
        total['library_ms'] += route_ms
    return dict(total, plain_ms=total['plain_ms'] if plain else None,
                max_rel_err=worst)


def _path_windowed(check, dcns, cfg, name, card):
    """The windowed op on the DynAggs it serves (relu1 blk 4, relu2 blk
    2), with B2 in image mode against its plain version and rows mode on
    the same inputs whichever branch the op takes. Returns the kernels-line
    entry of this config: B2's launches in the windowed op's run, counted
    from 0 before each call, and the sums over the two DynAggs."""
    dw = importlib.import_module('c2matching_tpu_torch.ops.dcn_window')
    total = {'launches': 0, 'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
    moved = ops = rows_moved = 0
    rows_ms = 0.0
    served = 0
    by_channels = {c: v for (_, _, c), v in WINDOWED.items()}
    for x, offset, mask, weight, bias in dcns:
        if x.shape[-1] not in by_channels:
            continue
        served += 1
        layer, blk, win = by_channels[x.shape[-1]]
        label = 'main path {} {}x{}x{} blk {} win {} {}'.format(
            layer, *x.shape, blk, win, name)
        args, ok, nby, nbx = _b2_window(x, offset, mask, blk, win)
        args = (*args, weight, blk, win, nby, nbx)
        total['max_abs_err'] = max(total['max_abs_err'],
                                   _b2_compare(check, args, label))
        ms, plain_ms, r_ms = _b2_time(args, label)
        prep_ms = cuda_ms(lambda: dw._window_prep(x, offset, mask, blk, win))
        print(f'path windowed op {label}: prep {prep_ms:.3f} ms, B2 '
              f'{ms:.3f} ms ({card})', flush=True)
        work = _b2_work(*args)
        moved, ops = moved + work[0], ops + work[1]
        rows_moved += _b2_rows_work(x, *args[2:])[0]
        total['ms'] += ms
        total['plain_ms'] += plain_ms
        rows_ms += r_ms
        del args
        launches, ms, exact_ms = _windowed_vs_exact(
            check, x[None], offset[None], mask[None], weight, bias, blk, win,
            f'path windowed op {label}')
        check(launches == int(ok), f'path windowed op {label}: branch '
              f'{"windowed" if ok else "exact"}, window_contract launched '
              f'{launches} time(s)')
        print(f'path windowed op {label}: branch '
              f'{"windowed" if ok else "exact (fallback)"}, {ms:.3f} ms, '
              f'exact op {exact_ms:.3f} ms ({card})', flush=True)
        total['launches'] += launches
    check(served == len(WINDOWED), f'path {cfg}: {served} DynAggs of the '
          f'windowed op\'s shapes')
    check(total['launches'] > 0, f'path {cfg}: window_contract launched '
          f'{total["launches"]} times by the windowed op')
    # the kernel's pipe: three TF32 products per f32 product
    total['bound_ms'], total['bound_by'] = bound(
        moved, B1_TF32_PRODUCTS * ops, 'tf32')
    simt_ms, _ = bound(moved, ops, torch.float32)
    rows_bound, rows_by = bound(rows_moved, B1_TF32_PRODUCTS * ops, 'tf32')
    total['library_ms'] = None
    print(f'b2 main path {name}: image mode {total["ms"]:.3f} ms over the two '
          f'DynAggs, bound {total["bound_ms"]:.3f} ms by {total["bound_by"]} '
          f'({moved / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP; 3xTF32 at '
          f'{PEAK_FLOPS["tf32"] / 1e12:g} TFLOP/s; SIMT f32 at '
          f'{PEAK_FLOPS[torch.float32] / 1e12:g} TFLOP/s: {simt_ms:.3f} ms); '
          f'rows mode {rows_ms:.3f} ms, bound {rows_bound:.3f} ms by '
          f'{rows_by} ({rows_moved / 1e9:.3f} GB) ({card})', flush=True)
    return total


# ------------------------------------------------------------------ eval
EVAL_OPTIONS = (('f32', 'options/test/test_synth_smoke.yml'),
                ('serving', 'options/test/test_synth_smoke_serving.yml'))
EVAL_METRICS = ('psnr', 'psnr_y', 'ssim_y')
EVAL_PASSES = 3   # timed runs of each config; the host clock varies by tens
                  # of % from one run to the next, so the median is printed


def _eval_data(root):
    """The synth set (3 pairs at 160) and one CUFED5-shaped pair, input
    332x500 and a larger 340x512 reference, under ``root``."""
    import numpy as np
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    from c2matching_tpu_torch.utils.util import imwrite
    synth.write_dataset(f'{root}/synth', n=3, size=(160,))
    rng = np.random.RandomState(1)
    imwrite(synth.to_bgr_u8(synth.synth_image(rng, 332, 500)),
            f'{root}/cufed/input/000_0.png')
    imwrite(synth.to_bgr_u8(synth.synth_image(rng, 340, 512)),
            f'{root}/cufed/ref/000_1.png')
    with open(f'{root}/cufed/pairs.txt', 'w') as f:
        f.write('000_0.png 000_1.png\n')


def _eval_weights(root):
    """The nets' seeded init (manual_seed 0, full width) as the reference's
    .pth files: net_g and net_extractor state dicts and a torchvision VGG19
    (``features.{i}.*``). Returns {options key: path}."""
    from c2matching_tpu_torch.models import define_network
    from c2matching_tpu_torch.models.archs.vgg_arch import NAMES
    gen = torch.Generator().manual_seed(0)
    nets = {k: define_network(F32_BLOCKS[k], gen)
            for k in ('network_g', 'network_map', 'network_extractor')}
    vgg = {}
    for key, value in nets['network_map'].state_dict().items():
        if key.startswith('vgg.vgg_net.'):
            name, leaf = key[len('vgg.vgg_net.'):].split('.')
            vgg[f'features.{NAMES["vgg19"].index(name)}.{leaf}'] = value
    files = {'pretrain_model_g': nets['network_g'].state_dict(),
             'pretrain_model_feature_extractor':
                 nets['network_extractor'].state_dict(),
             'pretrain_model_vgg': vgg}
    paths = {}
    for key, state in files.items():
        paths[key] = f'{root}/{key}.pth'
        torch.save(state, paths[key])
    return paths


def _eval_options(template, root, weights, sets):
    """Options text: ``template`` (a repo options file) with its synth
    dataroots under ``root``, the pretrain paths ``weights``, and the
    CUFED5-shaped pair as dataset test_2 when ``sets`` names it."""
    import os.path as osp
    here = osp.dirname(osp.abspath(__file__))
    with open(osp.join(here, template)) as f:
        text = f.read().replace('./datasets/synth', f'{root}/synth')
    for key, path in weights.items():
        if f'  {key}: ~' in text:
            text = text.replace(f'  {key}: ~', f'  {key}: {path}')
        else:
            text = text.replace('  strict_load: true',
                                f'  {key}: {path}\n  strict_load: true')
    if 'cufed' in sets:
        text = text.replace('\nval_func:', f"""
  test_2:
    name: cufed
    type: RefCUFEDDataset
    dataroot_in: {root}/cufed/input
    dataroot_ref: {root}/cufed/ref
    io_backend:
      type: disk
    ann_file: {root}/cufed/pairs.txt

val_func:""", 1)
    return text


@contextlib.contextmanager
def _timed_validation():
    """Host time of each image's model part (feed_data, test, crop, and the
    copy to uint8 images, which waits for the card) and of each dataset's
    whole validation loop (decode, bicubic chain, model, metrics, PNG
    save): {dataset name: [(loop seconds, [image seconds]) per pass]}."""
    from c2matching_tpu_torch.models.ref_restoration_model import \
        RefRestorationModel
    from c2matching_tpu_torch.models.sr_model import SRModel
    times = {'images': [], 'sets': {}}
    images, loop = (RefRestorationModel._validation_images,
                    SRModel._validation_loop)

    def images_timed(self, val_data):
        t0 = time.perf_counter()
        out = images(self, val_data)
        times['images'].append(time.perf_counter() - t0)
        return out

    def loop_timed(self, dataloader, *args, **kwargs):
        first = len(times['images'])
        t0 = time.perf_counter()
        avgs = loop(self, dataloader, *args, **kwargs)
        times['sets'].setdefault(dataloader.dataset.opt['name'], []).append(
            (time.perf_counter() - t0, times['images'][first:]))
        return avgs

    RefRestorationModel._validation_images = images_timed
    SRModel._validation_loop = loop_timed
    try:
        yield times
    finally:
        RefRestorationModel._validation_images = images
        SRModel._validation_loop = loop


def _eval_tf32(run, path, out_root):
    """``run(path)`` with cuDNN convolutions and matmuls in TF32 (torch's
    default for convolutions), after a warm-up; the settings are restored
    after."""
    import os
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        os.environ['C2MATCHING_ROOT'] = f'{out_root}_warm'
        run(path)
        os.environ['C2MATCHING_ROOT'] = out_root
        return run(path)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def phase_eval(check, card):
    import os
    import tempfile
    from c2matching_tpu_torch.ops import deform_conv_fused, match_argmax
    from c2matching_tpu_torch.test import run
    with tempfile.TemporaryDirectory(prefix='chip_smoke_eval_') as root:
        _eval_data(root)
        weights = _eval_weights(root)
        results = {}
        for cfg, template in EVAL_OPTIONS:
            path = f'{root}/{cfg}.yml'
            with open(path, 'w') as f:
                f.write(_eval_options(template, root, weights,
                                      ('synth', 'cufed')))
            os.environ['C2MATCHING_ROOT'] = f'{root}/out_{cfg}_warm'
            run(path)                      # warm-up: cuDNN plans, allocator
            match_argmax.launches = 0
            deform_conv_fused.launches = 0
            with _timed_validation() as times:
                for i in range(EVAL_PASSES):
                    # a results tree of its own per pass: the runner archives
                    # an existing one under a name stamped to the second
                    os.environ['C2MATCHING_ROOT'] = f'{root}/out_{cfg}_{i}'
                    results[cfg] = run(path)
            launches = {'match_argmax': match_argmax.launches,
                        'deform_conv_fused': deform_conv_fused.launches}
            for name, count in launches.items():
                check(count > 0, f'eval {cfg}: {name} launched {count} times '
                      'by the test runner')
            for name, avgs in results[cfg].items():
                passes = times['sets'][name]
                n_img = len(passes[0][1])
                model = sorted(1e3 * sum(p[1]) / n_img for p in passes)
                runner = sorted(1e3 * p[0] / n_img for p in passes)
                check(all(math.isfinite(avgs[k]) for k in EVAL_METRICS),
                      f'eval {cfg} {name}: finite metrics')
                print(f'eval {cfg} {name}: PSNR {avgs["psnr"]:.4f} dB, '
                      f'PSNR_Y {avgs["psnr_y"]:.4f} dB, SSIM_Y '
                      f'{avgs["ssim_y"]:.5f}; {n_img} images, median of '
                      f'{len(passes)} passes (min-max): model '
                      f'{statistics.median(model):.1f} ({model[0]:.1f}-'
                      f'{model[-1]:.1f}) ms/image (feed_data + test + crop + '
                      f'uint8), runner {statistics.median(runner):.1f} '
                      f'({runner[0]:.1f}-{runner[-1]:.1f}) ms/image (decode, '
                      'bicubic chain, model, metrics, PNG save) '
                      f'({card})', flush=True)
        # the f32 config under torch's default TF32 settings (cuDNN convs
        # in TF32), which the runners keep: its metrics within the gates
        # that hold the card against the CPU
        results['f32_tf32'] = _eval_tf32(run, f'{root}/f32.yml',
                                         f'{root}/out_f32_tf32')
        for name, avgs in results['f32_tf32'].items():
            off = results['f32'][name]
            print(f'eval f32 {name}, TF32 on against off: ' + ', '.join(
                f'{k} {avgs[k]:.6f} vs {off[k]:.6f} ({avgs[k] - off[k]:+.3g})'
                for k in EVAL_METRICS) + f' ({card})', flush=True)
            for k in EVAL_METRICS:
                tol = EVAL_SSIM_TOL if k == 'ssim_y' else EVAL_PSNR_TOL
                check(abs(avgs[k] - off[k]) <= tol,
                      f'eval f32 {name}: {k} with TF32 on within {tol:g} of '
                      'TF32 off')
        # the same runner on the CPU, where the plain versions run
        cpu_path = f'{root}/f32_cpu.yml'
        with open(cpu_path, 'w') as f:
            f.write(_eval_options(EVAL_OPTIONS[0][1], root, weights,
                                  ('synth',)))
        os.environ['C2MATCHING_ROOT'] = f'{root}/out_cpu'
        cpu = run(cpu_path, 'cpu')['synth']
        card_f32 = results['f32']['synth']
        for k in EVAL_METRICS:
            tol = EVAL_SSIM_TOL if k == 'ssim_y' else EVAL_PSNR_TOL
            diff = abs(card_f32[k] - cpu[k])
            check(diff <= tol, f'eval f32 synth: {k} card {card_f32[k]:.6f} '
                  f'vs CPU {cpu[k]:.6f}, |diff| {diff:.3g} <= {tol:g}')
        for name, avgs in results['serving'].items():
            diff = abs(avgs['psnr'] - results['f32'][name]['psnr'])
            check(diff <= EVAL_SERVING_PSNR_TOL,
                  f'eval serving {name}: PSNR within {diff:.4f} dB of f32 '
                  f'(<= {EVAL_SERVING_PSNR_TOL:g})')
        del os.environ['C2MATCHING_ROOT']


# ------------------------------------------------------------- B3 backward
B3B_BATCH = 9        # stage-3 training's batch: one launch covers it


def _b3b_inputs(gen, dev, h, w, c, dtype, batch=B3B_BATCH):
    """One DynAgg's backward inputs for a batch: x, offsets (integer
    shifts; a third of the residuals exactly 0, so taps sit on integer
    coordinates; shifts of +-16 carry taps past the edges), mask, grad_out
    (B, h, w, C) and w_kc (9C, C) at the DCN's init scale, rounded to bf16
    for a bf16 x as modulated_deform_conv rounds it."""
    parts = [_dcn_inputs(gen, dev, h, w, c, dtype) for _ in range(batch)]
    x, offset, mask = (torch.stack(t) for t in zip(*parts))
    exact = torch.rand(offset.shape, generator=gen, device=dev) < 1 / 3
    offset = torch.where(exact, offset.round(), offset)
    grad_out = torch.randn(batch, h, w, c, generator=gen, device=dev)
    w_kc = torch.randn(9 * c, c, generator=gen, device=dev) / math.sqrt(9 * c)
    return x, offset, mask, grad_out, w_kc.to(dtype).float()


def _b3b_compare(check, inputs, label, needs, keep_plain=False, **conv):
    """The backward kernel's gradients against its plain version's
    (``conv``: the stride, padding and dilation); returns the kernel's
    gradients, the max |difference| of the offset and mask gradients and,
    with ``keep_plain``, the plain version's gradients."""
    from c2matching_tpu_torch.ops import (deform_conv_backward,
                                          deform_conv_backward_plain)
    got = deform_conv_backward(*inputs, needs=needs, **conv)
    want = deform_conv_backward_plain(*inputs, needs=needs, **conv)
    x = inputs[0]
    worst = 0.0
    for name, g, w in zip(('x', 'offset', 'mask'), got, want):
        if w is None:
            check(g is None, f'b3bwd {label}: no grad_{name} asked, none '
                  'given')
            continue
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        if name == 'x':
            rel = B3B_X_REL if x.dtype == torch.float32 else B3B_X_BF16_REL
        else:
            rel = B3B_REL
            worst = max(worst, err)
        check(err <= rel * scale, f'b3bwd {label}: grad_{name} max |diff| '
              f'{err:.3g} <= {rel:g} x {scale:.3g}')
    if not keep_plain:
        del want
        torch.cuda.empty_cache()
        return got, worst
    return got, worst, want


# (h, w, C, Co, stride) of batch-2 probes, G = 8, each with and without
# grad_x, and the kernel's paths each reaches beside the training shapes':
# Cg 3, 2 and 6 (the scalar channel loop, chunks cut to whole samples; Cg
# 2 and 4 are the small training config's) with Co 20, 8 and 36 (depth
# past Co zero-filled by TMA) and stride 2; Cg 8 with pixel counts off the
# 64-pixel tiles; Cg 4 (one vector a lane) at stride 2 and 9 pixels an
# image (fewer rows than a TMA box); Cg 16 (1, 2 or 4 lanes a task by
# dtype and grad_x); Cg 32 with 300 tiles (tiles cut into chunk segments);
# Cg 64 (the widest group: one sample a chunk) and Co 320 (the widest
# grad_out rows: one A buffer) at Cg 8
B3B_ODD = ((7, 9, 24, 20, 1), (13, 5, 16, 8, 1), (11, 10, 48, 36, 2),
           (9, 70, 64, 40, 1), (6, 6, 32, 12, 2), (9, 11, 128, 128, 1),
           (120, 80, 256, 256, 1), (7, 6, 512, 64, 1),
           (10, 12, 64, 320, 1))


def _b3b_odd_probe(check, gen, dev, dtype, g=8, k=9, batch=2):
    for h, w, c, co, st in B3B_ODD:
        ho, wo = (h - 1) // st + 1, (w - 1) // st + 1
        x = torch.randn(batch, h, w, c, generator=gen, device=dev).to(dtype)
        shift = torch.randint(-3, 4, (batch, ho, wo, 1, k, 2), generator=gen,
                              device=dev).float()
        offset = shift + 0.5 * torch.randn(batch, ho, wo, g, k, 2,
                                           generator=gen, device=dev)
        mask = torch.rand(batch, ho, wo, g, k, generator=gen, device=dev)
        grad_out = torch.randn(batch, ho, wo, co, generator=gen, device=dev)
        w_kc = torch.randn(k * c, co, generator=gen, device=dev)
        w_kc = (w_kc / math.sqrt(k * c)).to(dtype).float()
        args = (x, offset, mask, grad_out, w_kc)
        label = f'odd {batch}x{h}x{w}x{c} Co {co} stride {st} {dtype}'
        for needs in ((False, True, True), (True, True, True)):
            _b3b_compare(check, args, label, needs, stride=(st, st))


def _columns_route(x, offset, mask, grad_out, w_kc, needs=(False, True,
                                                          True)):
    """The earlier route of the same gradients, image by image: grad_cols
    = grad_out_i @ w_kc^T by torch.matmul into device memory, then the
    columns' backward kernel (deform_col2im)."""
    from c2matching_tpu_torch.ops import deform_col2im
    b, ho, wo, co = grad_out.shape
    outs = []
    for i in range(b):
        grad_cols = torch.matmul(grad_out[i].reshape(ho * wo, co), w_kc.t())
        outs.append(deform_col2im(x[i], offset[i], mask[i], grad_cols,
                                  needs=needs))
    return outs


def _profiled_ms(fn, name=None, reps=10):
    """Device time per call of ``fn`` from torch.profiler: the summed time
    of the kernels whose name holds ``name`` (every kernel when None) over
    ``reps`` calls, after a warm-up. Unlike cuda_ms it does not count the
    host's gaps between launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (name is None or name in e.key))
    return us / 1e3 / reps


# f32 operations per element of the columns' gradient: the four corner
# products and adds
B3B_OPS_PER_COL = 8


def _b3b_work(x, offset, mask, grad_out, w_kc):
    """(bytes, TF32 operations, f32 operations) of the offset and mask
    gradients of a batch: x, the offsets, the mask, grad_out and w_kc read
    once, the two gradients written once; the columns' gradient
    grad_out @ w_kc^T as three TF32 products (3xTF32), then the corner
    dots."""
    b, ho, wo, co = grad_out.shape
    n_cols = b * ho * wo * w_kc.shape[0]
    moved = nbytes(x, offset, mask, grad_out, w_kc) + nbytes(offset, mask)
    return moved, 3 * 2 * n_cols * co, B3B_OPS_PER_COL * n_cols


def _b3b_bound(moved, tf32_ops, f32_ops):
    """The least time for the work of _b3b_work, in ms, and what bounds it:
    the bytes over the memory rate against the operations, the larger of
    the TF32 products at the tensor cores' rate and the corner dots at the
    f32 rate (the kernel runs the two on separate pipes at once)."""
    t_bytes = 1e3 * moved / PEAK_BYTES_S
    t_ops = 1e3 * max(tf32_ops / PEAK_FLOPS['tf32'],
                      f32_ops / PEAK_FLOPS[torch.float32])
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _b3b_library_ms(x, offset, mask, grad_out, w_kc):
    """The library's route to the same gradients: the columns' gradient by
    torch.matmul, then F.grid_sample's backward to its grid (the input
    needs no gradient, as on the training path) for B3's samples, one batch
    entry per (image, group)."""
    b, h, w, c = x.shape
    _, ho, wo, g, k, _ = offset.shape
    co = grad_out.shape[-1]
    base_y = torch.arange(ho, device=x.device, dtype=torch.float32) - 1
    base_x = torch.arange(wo, device=x.device, dtype=torch.float32) - 1
    tap = torch.arange(k, device=x.device)
    sy = base_y[:, None, None, None] + (tap // 3).float() + offset[..., 0]
    sx = base_x[None, :, None, None] + (tap % 3).float() + offset[..., 1]
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    grid = grid.reshape(b, ho * wo, g, k, 2).permute(0, 2, 1, 3, 4)
    grid = grid.reshape(b * g, ho * wo, k, 2).contiguous().requires_grad_()
    inp = x.float().reshape(b, h, w, g, c // g).permute(0, 3, 4, 1, 2)
    out = F.grid_sample(inp.reshape(b * g, c // g, h, w), grid,
                        mode='bilinear', padding_mode='zeros',
                        align_corners=True)

    def call():
        grad_cols = torch.matmul(grad_out.reshape(-1, co), w_kc.t())
        gout = grad_cols.reshape(b, ho * wo, k, g, c // g)
        gout = gout.permute(0, 3, 4, 1, 2).reshape(b * g, c // g, ho * wo, k)
        return torch.autograd.grad(out, grid, gout, retain_graph=True)

    ms = cuda_ms(call)
    del out, grid, inp
    return ms


def _b3b_measure(check, inputs, label, card, with_x=True):
    """Checks and times of the backward kernel on each DynAgg's (x,
    offset, mask, grad_out, w_kc) of ``inputs``, a whole batch each: its
    offset and mask gradients (the training path's call) against the plain
    version and against the columns' route, and with ``with_x`` also with
    grad_x; the kernel's time by CUDA events (cuda_ms) and by
    torch.profiler, the columns' route's (9 x grad_cols matmul +
    deform_col2im) by both, the plain version's, the library route's and
    the bound. The columns' route is the kernel it replaced on the
    training path, kept as its yardstick: deform_col2im is held against its
    plain version (deform_im2col_backward_plain on the same grad_cols)
    within B3B_REL. Returns the sums over ``inputs`` (a kernels-line
    entry)."""
    from c2matching_tpu_torch.ops import (deform_conv_backward,
                                          deform_conv_backward_plain)
    only = (False, True, True)
    keys = ('ms', 'prof_ms', 'prof_all_ms', 'route_ms', 'route_prof_ms',
            'plain_ms', 'library_ms')
    total = dict.fromkeys(keys, 0.0)
    total['max_abs_err'] = 0.0
    work = [0, 0, 0]
    for args in inputs:
        shape = '{} {}x{}x{}x{}'.format(label, *args[0].shape)
        got, err, plain = _b3b_compare(check, args, shape, only,
                                       keep_plain=True)
        total['max_abs_err'] = max(total['max_abs_err'], err)
        route = _columns_route(*args)
        for name, i in (('offset', 1), ('mask', 2)):
            have = torch.stack([r[i] for r in route])
            diff = (have - plain[i]).abs().max().item()
            scale = plain[i].abs().max().item()
            check(diff <= B3B_REL * scale, f'b3bwd {shape}: deform_col2im\'s '
                  f'grad_{name} against its plain version {diff:.3g} <= '
                  f'{B3B_REL:g} x {scale:.3g}')
        del got, route, plain, have
        if with_x:
            _b3b_compare(check, args, f'{shape} with grad_x',
                         (True, True, True))
        t = {
            'ms': cuda_ms(lambda: deform_conv_backward(*args, needs=only)),
            'prof_ms': _profiled_ms(
                lambda: deform_conv_backward(*args, needs=only),
                'mdc_backward_kernel'),
            'prof_all_ms': _profiled_ms(
                lambda: deform_conv_backward(*args, needs=only)),
            'route_ms': cuda_ms(lambda: _columns_route(*args)),
            'route_prof_ms': _profiled_ms(lambda: _columns_route(*args)),
            'plain_ms': cuda_ms(lambda: deform_conv_backward_plain(
                *args, needs=only), min_ms=1.0),
            'library_ms': _b3b_library_ms(*args)}
        # CUDA events again, after the profiler: on an H100 the first
        # reading on the training tensors read up to 26% above it
        again_ms = cuda_ms(lambda: deform_conv_backward(*args, needs=only))
        x_ms = cuda_ms(lambda: deform_conv_backward(*args))
        one = _b3b_work(*args)
        work = [a + b for a, b in zip(work, one)]
        b_ms, b_by = _b3b_bound(*one)
        print(f'b3bwd {shape}: kernel {t["ms"]:.4f} ms (profiler '
              f'{t["prof_ms"]:.4f}, every kernel of the call '
              f'{t["prof_all_ms"]:.4f}; events again {again_ms:.4f}; with '
              f'grad_x {x_ms:.4f}), columns\' '
              f'route {t["route_ms"]:.4f} ms (profiler '
              f'{t["route_prof_ms"]:.4f}), '
              f'plain {t["plain_ms"]:.2f} ms, library (matmul + grid_sample '
              f'backward) {t["library_ms"]:.4f} ms, bound {b_ms:.4f} ms by '
              f'{b_by} ({card})', flush=True)
        for key in keys:
            total[key] += t[key]
        torch.cuda.empty_cache()
    total['bound_ms'], total['bound_by'] = _b3b_bound(*work)
    print(f'b3bwd {label}, sum over the three DynAggs (one iteration): '
          f'kernel {total["ms"]:.4f} ms (profiler {total["prof_ms"]:.4f}, '
          f'ratio {total["prof_ms"] / total["ms"]:.3f}; every kernel of the '
          f'call {total["prof_all_ms"]:.4f}), columns\' route '
          f'{total["route_ms"]:.4f} ms (profiler '
          f'{total["route_prof_ms"]:.4f}), library '
          f'{total["library_ms"]:.4f} ms, bound {total["bound_ms"]:.4f} ms '
          f'by {total["bound_by"]} ({work[0] / 1e9:.4f} GB, '
          f'{work[1] / 1e9:.2f} TF32 GFLOP, {work[2] / 1e9:.3f} f32 GFLOP); '
          f'kernel / bound {total["ms"] / total["bound_ms"]:.2f} ({card})',
          flush=True)
    return {k: total[k] for k in ('ms', 'plain_ms', 'max_abs_err',
                                  'library_ms', 'bound_ms', 'bound_by')}


def phase_b3_backward(check, dev, card):
    from c2matching_tpu_torch.ops import deform_conv_backward
    gen = torch.Generator(device=dev).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        _b3b_measure(check, [_b3b_inputs(gen, dev, h, w, c, dtype)
                             for _, h, w, c in TRAIN_B3],
                     f'random {name}', card)

        # large offsets: every tap outside the image -> exact zeros
        layer, h, w, c = TRAIN_B3[0]
        x, offset, mask, grad_out, w_kc = _b3b_inputs(gen, dev, h, w, c,
                                                      dtype)
        big = torch.tensor([1e4, -1e4, 1e6, -3e30], device=dev)
        offset = big[torch.randint(0, 4, offset.shape, generator=gen,
                                   device=dev)]
        gx, goff, gm = deform_conv_backward(x, offset, mask, grad_out, w_kc)
        check(bool((gx == 0).all() and (goff == 0).all()
                   and (gm == 0).all()),
              f'b3bwd large-offset probe {name}: gradients exactly zero')
        _b3b_odd_probe(check, gen, dev, dtype)


# --------------------------------------------------------------- contras
CONTRAS_OPTIONS = {1: 'options/train/stage1_teacher_contras_network.yml',
                   2: 'options/train/stage2_student_contras_network.yml'}
CONTRAS_ITERS = 3        # iterations of each stage in phase contras
CONTRAS_BATCH = 8        # the shipped configs' batch (at gt 160)
CONTRAS_VAL_HW = (332, 500)  # the val image: a CUFED5 input
CONTRAS_CPU_GT, CONTRAS_CPU_BATCH = 96, 2  # the card-vs-CPU steps
CONTRAS_LOSS_REL = 1e-5  # card vs CPU: each log of one step, relative
CONTRAS_GRAD_REL = 1e-9  # card vs CPU: the step's gradients in float64
                         # (convs included), of the largest: the same graph
                         # in double on both sides (measured 2e-15)
CONTRAS_GRAD32_REL = 1e-3  # the card's float32 gradients against the CPU's
                           # float64 ones, of the largest: a hardest
                           # negative whose two best candidates lie within
                           # float32's ~1e-6 disagreement with float64 flips
                           # and moves its gradient term (measured 2.7e-4 on
                           # the card, 7.6e-4 for the CPU's float32 step)


def _contras_options(stage, root, backend=None):
    """The shipped stage-1 or stage-2 options with the dataroots under
    ``root`` (the 160-px synth set to train on, the CUFED5-shaped image and
    its one-line annotation file to validate on) and CONTRAS_ITERS
    iterations: a log line each, validation and checkpoints at the last.
    Everything else is the file's own: widths, batch (8), gt size (160),
    losses, LRs, ``use_tb_logger: true`` and stage 2's teacher, the flax
    ``.ckpt`` path the JAX package writes, which the port resolves to the
    ``.pth`` stage 1 wrote beside it (run from the outputs' root).
    ``backend``: the ``dist_params.backend`` of phase dist's copy."""
    import os.path as osp
    name = CONTRAS_OPTIONS[stage]
    with open(osp.join(osp.dirname(osp.abspath(__file__)), name)) as f:
        text = f.read()
    n = CONTRAS_ITERS
    swaps = [
        ('./datasets/CUFED/input', f'{root}/synth/input'),
        ('./datasets/CUFED/ref', f'{root}/synth/ref'),
        ('dataroot_in: ./datasets/CUFED5',
         f'dataroot_in: {root}/cufed5/input'),
        ('dataroot_ref: ./datasets/CUFED5',
         f'dataroot_ref: {root}/cufed5/ref'),
        ('./datasets/contras_val.txt', f'{root}/cufed5/pairs.txt'),
        (TRAIN_ANN, TRAIN_ANN.replace(
            '\n\n', f'\n    ann_file: {root}/synth/pairs.txt\n\n')),
        ('print_freq: 100', 'print_freq: 1'),
        ('save_checkpoint_freq: !!float 5e3', f'save_checkpoint_freq: {n}')]
    if stage == 1:
        swaps += [('niter: 5000', f'niter: {n}'),
                  ('val_freq: !!float 5e3', f'val_freq: {n}')]
    else:
        swaps += [('niter: 75000', f'niter: {n}'),
                  ('val_freq: !!float 1e3', f'val_freq: {n}')]
    if backend:
        swaps.append(('backend: ici', f'backend: {backend}'))
    for old, new in swaps:
        if old not in text:
            raise ValueError(f'{name} has no {old!r}')
        text = text.replace(old, new)
    return text


@contextlib.contextmanager
def _timed_contras():
    """Per iteration of a contrastive model's optimize_parameters: host
    seconds between two synchronises and the logs; at the first call, the
    model and its trained net's parameters; the last training batch. Per
    validation: host seconds,
    the peak memory of the iterations before it and of the pass itself,
    and the means."""
    from c2matching_tpu_torch.models.teacher_contras_model import \
        ContrasModel
    rec = {'iters': [], 'val': [], 'first': None, 'model': None}
    real_step, real_val = ContrasModel.optimize_parameters, \
        ContrasModel.validation

    def step(self, current_iter):
        if rec['first'] is None:
            rec['first'] = [p.detach().clone()
                            for p in self.trained.parameters()]
            rec['model'] = self
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_step(self, current_iter)
        torch.cuda.synchronize()
        rec['iters'].append({
            'step': current_iter, 's': time.perf_counter() - t0,
            'logs': {k: float(v) for k, v in self.log_dict.items()}})
        rec['batch'] = self.batch

    def validation(self, *args, **kwargs):
        torch.cuda.synchronize()
        train_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        means = real_val(self, *args, **kwargs)
        torch.cuda.synchronize()
        rec['val'].append({'s': time.perf_counter() - t0,
                           'train_peak': train_peak,
                           'peak': torch.cuda.max_memory_allocated(),
                           'means': means})
        return means

    ContrasModel.optimize_parameters = step
    ContrasModel.validation = validation
    try:
        yield rec
    finally:
        ContrasModel.optimize_parameters = real_step
        ContrasModel.validation = real_val


def _contras_loss_ms(model, b, stage, card):
    """CUDA-event times on the training batch ``b``: the loss alone on its
    features (forward, and forward + backward), beside the extractors'
    forward and the trained extractor's forward + backward; then the host
    time of a whole step on it with the loader stopped."""
    from c2matching_tpu_torch.models.contras_losses import (
        distillation_loss_batch, triplet_loss_batch)
    opts = model._loss_opts()
    if stage == 1:
        def extract():
            out = model.net_g(b['img_in'], b['img_ref'])
            return [out['dense_features1'], out['dense_features2']]

        def loss(feats):
            return triplet_loss_batch(*feats, b['transformed_coordinate'],
                                      **opts)[0]
    else:
        def extract():
            s = model.net_student(b['img_in_up'], b['img_ref'])
            with torch.no_grad():
                t = model.net_teacher(b['img_in'], b['img_ref'])
            return [s['dense_features1'], s['dense_features2'],
                    t['dense_features1'], t['dense_features2']]

        def loss(feats):
            return distillation_loss_batch(
                *feats, b['transformed_coordinate'],
                temperature=model.temperature,
                distill_weight=model.distill_weight, **opts)[0]

    with torch.no_grad():
        feats = [f.detach() for f in extract()]
        fwd = cuda_ms(extract)
        loss_fwd = cuda_ms(lambda: loss(feats))
    leaves = [f.clone().requires_grad_(i < 2) for i, f in enumerate(feats)]
    loss_fb = cuda_ms(lambda: loss(leaves).backward())
    cts = [torch.randn_like(f) for f in feats[:2]]

    def extractor_fb():
        out = extract()
        sum((o * c).sum() for o, c in zip(out, cts)).backward()

    ext_fb = cuda_ms(extractor_fb)
    model.optimizer_g.zero_grad(set_to_none=True)
    # whole steps on that batch with the loader stopped (they move the
    # weights on; the run's checkpoints are written)
    model.batch = b
    model.optimize_parameters(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        model.optimize_parameters(0)
    torch.cuda.synchronize()
    step = 1e3 * (time.perf_counter() - t0) / 3
    n = feats[0].shape[1] * feats[0].shape[2]
    print(f'contras stage {stage}: on one batch of {feats[0].shape[0]} at '
          f'{tuple(b["img_in"].shape[1:3])} ({n} feature positions): loss '
          f'{loss_fwd:.3f} ms forward, {loss_fb:.3f} ms forward + backward; '
          f'extractors {fwd:.3f} ms forward, {ext_fb:.3f} ms forward + '
          f'backward of the trained net (CUDA events); a whole step with the '
          f'loader stopped {step:.1f} ms (host clock, mean of 3) ({card})',
          flush=True)
    return {'loss_ms': loss_fwd, 'loss_fb_ms': loss_fb, 'extract_ms': fwd,
            'extract_fb_ms': ext_fb, 'step_ms': step}


def _contras_stage(check, stage, root, card):
    """Stage ``stage`` through train.run on the card: the checks, the
    printed times and peaks. Returns the model, its run's outputs
    directory and its last training batch."""
    import os
    from c2matching_tpu_torch.train import run
    path = f'{root}/stage{stage}.yml'
    with open(path, 'w') as f:
        f.write(_contras_options(stage, root))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _timed_contras() as rec:
        run(path)
    wall = time.perf_counter() - t0
    model = rec['model']
    label = model.net_label
    exp = f'{root}/out/experiments/{model.opt["name"]}'
    n = CONTRAS_ITERS
    iters = rec['iters']
    check(len(iters) == n, f'contras stage {stage}: {len(iters)} iterations')
    keys = ('loss', 'pos_dist', 'neg_dist', 'n_valid') + (
        ('distill_loss',) if stage == 2 else ())
    for it in iters:
        logs = it['logs']
        check(set(logs) == set(keys)
              and all(math.isfinite(v) for v in logs.values()),
              f'contras stage {stage} iteration {it["step"]}: finite losses '
              + ', '.join(f'{k} {logs.get(k, float("nan")):.5g}'
                          for k in keys))
        check(logs.get('n_valid') == CONTRAS_BATCH,
              f'contras stage {stage} iteration {it["step"]}: every sample '
              f'passed the gate (n_valid {logs.get("n_valid")})')
    unmoved = [name for (name, p), a in zip(model.trained.named_parameters(),
                                            rec['first'])
               if torch.equal(a, p.detach())]
    check(not unmoved, f'contras stage {stage}: every parameter of '
          f'{label} moved (unmoved: {unmoved})')
    saved = sorted(os.listdir(f'{exp}/models'))
    states = sorted(os.listdir(f'{exp}/training_state'))
    check(saved == [f'{label}_{n}.pth', f'{label}_latest.pth']
          and states == [f'{n}.state'],
          f'contras stage {stage}: checkpoints {saved}, states {states}')
    check(len(rec['val']) == 1, f'contras stage {stage}: '
          f'{len(rec["val"])} validation pass(es)')
    _check_events(check, f'{root}/out', model.opt['name'],
                  ('loss', 'loss_val'), f'contras stage {stage}')
    times = [1e3 * it['s'] for it in iters]
    print(f'contras stage {stage} ({CONTRAS_OPTIONS[stage]}), batch '
          f'{CONTRAS_BATCH} at gt 160, full width: first iteration '
          f'{times[0]:.1f} ms, later {", ".join(f"{v:.1f}" for v in times[1:])}'
          f' ms (host clock, synchronised); the run (options to the last '
          f'checkpoint) {wall:.1f} s ({card})', flush=True)
    for val in rec['val']:
        means = val['means']
        check(all(math.isfinite(v) for v in means.values())
              and means['loss'] > 0, f'contras stage {stage}: validation '
              'means ' + ', '.join(f'{k} {v:.5g}' for k, v in means.items()))
        print(f'contras stage {stage}: peak device memory '
              f'{val["train_peak"] / 2 ** 30:.2f} GiB over the iterations; '
              f'validation on one {CONTRAS_VAL_HW[0]}x{CONTRAS_VAL_HW[1]} '
              f'image ({(CONTRAS_VAL_HW[0] // 4) * (CONTRAS_VAL_HW[1] // 4)} '
              f'feature positions): {1e3 * val["s"]:.1f} ms, peak '
              f'{val["peak"] / 2 ** 30:.2f} GiB ({card})', flush=True)
    return model, exp, rec['batch']


def _contras_cpu(check, dev, root):
    """One step of each stage at batch 2 / gt 96, on the card and on the
    CPU from the same seeded weights (the teacher's too) on the same
    batch: the logs, the card's
    float32 gradients against the CPU's float64 ones, and the float64
    gradients of both."""
    import random
    import numpy as np
    from c2matching_tpu_torch.data import ContrasDataset, default_collate
    from c2matching_tpu_torch.models import MODELS
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    from c2matching_tpu_torch.utils import dict_to_nonedict, options
    import os.path as osp
    here = osp.dirname(osp.abspath(__file__))
    gt = CONTRAS_CPU_GT
    synth.write_dataset(f'{root}/small', n=CONTRAS_CPU_BATCH, size=(gt,))
    random.seed(0)
    np.random.seed(0)
    data = ContrasDataset({
        'name': 'small', 'phase': 'train', 'scale': 4,
        'dataroot_in': f'{root}/small/input',
        'dataroot_ref': f'{root}/small/ref', 'io_backend': {'type': 'disk'},
        'ann_file': f'{root}/small/pairs.txt', 'gt_size': gt,
        'use_flip': True, 'use_rot': True})
    batch = default_collate([data[i] for i in range(CONTRAS_CPU_BATCH)])
    for stage in (1, 2):
        loaded = options.load(osp.join(here, CONTRAS_OPTIONS[stage]))
        opt = {k: loaded[k] for k in loaded
               if k in ('model_type', 'network_g', 'network_student',
                        'network_teacher', 'train')}
        opt.update(name=f'contras_cpu_{stage}', is_train=True, scale=4,
                   manual_seed=0, path={'strict_load': True})
        opt = dict_to_nonedict(opt)
        models, grads64 = [], []
        for where in (dev, 'cpu'):
            model = MODELS[opt['model_type']](opt, where)
            grads64.append({k: g.cpu() for k, g in
                            model.float64_grads(batch)[1].items()})
            model.feed_data(batch)
            model.optimize_parameters(1)
            models.append(model)
        card, cpu = models
        for k, v in cpu.log_dict.items():
            want, got = float(v), float(card.log_dict[k])
            check(abs(got - want) <= CONTRAS_LOSS_REL * abs(want),
                  f'contras_cpu stage {stage}: {k} card {got:.7g} vs CPU '
                  f'{want:.7g} (rel {CONTRAS_LOSS_REL:g})')
        check(float(card.log_dict['n_valid']) == CONTRAS_CPU_BATCH,
              f'contras_cpu stage {stage}: n_valid '
              f'{float(card.log_dict["n_valid"])}')
        exact = grads64[1]
        top = max(float(g.abs().max()) for g in exact.values())

        def off(net):
            return max(float((p.grad.double().cpu() - exact[n]).abs().max())
                       for n, p in net.named_parameters()) / top

        cpu32 = off(cpu.trained)
        card32 = off(card.trained)
        check(card32 <= CONTRAS_GRAD32_REL, f'contras_cpu stage {stage}: '
              f'the card\'s float32 gradients within {card32:.2e} of the '
              f'largest ({top:.3g}) of the CPU\'s float64 ones (<= '
              f'{CONTRAS_GRAD32_REL:g}; the CPU\'s float32 within '
              f'{cpu32:.2e})')
        err64 = max(float((grads64[0][n] - g).abs().max())
                    for n, g in exact.items()) / top
        check(err64 <= CONTRAS_GRAD_REL, f'contras_cpu stage {stage}: '
              f'float64 gradients card vs CPU within {err64:.2e} of the '
              f'largest (<= {CONTRAS_GRAD_REL:g})')
        del models, card, cpu
    torch.cuda.empty_cache()


def _contras_data_ms(root, card):
    """Host ms of one ContrasDataset item at gt 160 (decode, the warp, the
    PIL chains, the coordinate grid) and of its warp alone, one thread."""
    import numpy as np
    from c2matching_tpu_torch.data import ContrasDataset
    from c2matching_tpu_torch.data.warp import warp_perspective
    ds = ContrasDataset({
        'name': 'synth', 'phase': 'train', 'scale': 4,
        'dataroot_in': f'{root}/synth/input',
        'dataroot_ref': f'{root}/synth/ref', 'io_backend': {'type': 'disk'},
        'ann_file': f'{root}/synth/pairs.txt', 'gt_size': 160,
        'use_flip': True, 'use_rot': True})
    ds[0]
    t0 = time.perf_counter()
    for i in range(8):
        ds[i]
    item = 1e3 * (time.perf_counter() - t0) / 8
    img = ds._load_bgr(ds.paths[0]['in_path'])
    h_inv = np.array([[1.01, 0.02, -3.0], [-0.01, 0.99, 2.0],
                      [1e-5, -2e-5, 1.0]])
    t0 = time.perf_counter()
    for _ in range(8):
        warp_perspective(img, h_inv, (160, 160))
    warp = 1e3 * (time.perf_counter() - t0) / 8
    print(f'contras data (host, one thread): {item:.1f} ms a ContrasDataset '
          f'item at gt 160, of which warp_perspective {warp:.1f} ms; a batch '
          f'of {CONTRAS_BATCH} is {CONTRAS_BATCH * item:.0f} ms of host work '
          f'({card})', flush=True)
    return {'item_ms': item, 'warp_ms': warp}


def phase_contras(check, dev, report, card, root):
    """Stages 1 and 2 through train.run on the card, the teacher's weights
    from stage 1 in stage 2, then one step of each against the CPU. Leaves
    stage 2's net_student_latest.pth in ``report['student_pth']``."""
    import os
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    synth.write_dataset(f'{root}/synth', n=10, size=(160,))
    synth.write_dataset(f'{root}/cufed5', n=1, size=CONTRAS_VAL_HW)
    os.environ['C2MATCHING_ROOT'] = f'{root}/out'
    os.makedirs(f'{root}/out', exist_ok=True)
    # the shipped stage-2 options name stage 1's output by a path relative
    # to the working directory
    try:
        with _in_dir(f'{root}/out'):
            model, exp, batch = _contras_stage(check, 1, root, card)
            report['contras_stage1'] = _contras_loss_ms(model, batch, 1, card)
            teacher = f'{exp}/models/net_g_latest.pth'
            del model, batch
            model, exp, batch = _contras_stage(check, 2, root, card)
            saved = torch.load(teacher, map_location='cpu', weights_only=True)
            now = model.net_teacher.state_dict()
            check(all(torch.equal(saved[k], now[k].cpu()) for k in saved)
                  and not any(p.requires_grad
                              for p in model.net_teacher.parameters()),
                  'contras stage 2: the teacher is bit for bit stage 1\'s '
                  'net_g_latest.pth after the run, and frozen')
            report['contras_stage2'] = _contras_loss_ms(model, batch, 2, card)
            report['student_pth'] = f'{exp}/models/net_student_latest.pth'
            del model, batch
    finally:
        del os.environ['C2MATCHING_ROOT']
    torch.cuda.empty_cache()
    report['contras_data'] = _contras_data_ms(root, card)
    _contras_cpu(check, dev, root)


# ----------------------------------------------------------------- train
TRAIN_ANN = """    io_backend:
      type: disk

    gt_size: 160"""


def _train_options(root, pretrain=TRAIN_PRETRAIN, gan=TRAIN_GAN,
                   backend=None):
    """stage3_restoration_gan.yml for the synth set under ``root``:
    ``pretrain`` + ``gan`` iterations, a log line each and a checkpoint at
    the end. Everything else is the file's own: networks, losses, batch (9),
    gt size (160), ``use_tb_logger: true`` and the extractor, the flax
    ``.ckpt`` path of stage 2's student, which the port resolves to the
    ``.pth`` phase contras wrote beside it (run from its outputs' root).
    ``backend``: the ``dist_params.backend`` of phase dist's copy."""
    import os.path as osp
    here = osp.dirname(osp.abspath(__file__))
    with open(osp.join(here, TRAIN_OPTIONS)) as f:
        text = f.read()
    swaps = [
        ('./datasets/CUFED/input', f'{root}/input'),
        ('./datasets/CUFED/ref', f'{root}/ref'),
        ('./datasets/CUFED5_pairs.txt', f'{root}/pairs.txt'),
        ('dataroot_in: ./datasets/CUFED5', f'dataroot_in: {root}/input'),
        ('dataroot_ref: ./datasets/CUFED5', f'dataroot_ref: {root}/ref'),
        ('niter: 255000', f'niter: {pretrain + gan}'),
        ('net_g_pretrain_steps: 10000', f'net_g_pretrain_steps: {pretrain}'),
        ('print_freq: 100', 'print_freq: 1'),
        ('save_checkpoint_freq: !!float 5e3',
         f'save_checkpoint_freq: {pretrain + gan}'),
        # the train block reads its pairs from the annotation file too
        (TRAIN_ANN, TRAIN_ANN.replace(
            '\n\n', f'\n    ann_file: {root}/pairs.txt\n\n'))]
    if backend:
        swaps.append(('backend: ici', f'backend: {backend}'))
    for old, new in swaps:
        if old not in text:
            raise ValueError(f'{TRAIN_OPTIONS} has no {old!r}')
        text = text.replace(old, new)
    return text


@contextlib.contextmanager
def _timed_iterations():
    """Per iteration of RefRestorationModel.optimize_parameters: host
    seconds around the call between two synchronises, the kernels' launch
    counts and the losses; at the first call, the model and its
    parameters."""
    from c2matching_tpu_torch.models.ref_restoration_model import \
        RefRestorationModel
    from c2matching_tpu_torch.ops import (deform_conv_backward,
                                          deform_conv_fused, deform_im2col,
                                          match_argmax)
    counters = (deform_im2col, deform_conv_backward, match_argmax,
                deform_conv_fused)
    rec = {'iters': [], 'first': None}
    real = RefRestorationModel.optimize_parameters

    def timed(self, step):
        if rec['first'] is None:
            rec['first'] = {
                'g': {grp['name']: [p.detach().clone() for p in grp['params']]
                      for grp in self.optimizer_g.param_groups},
                'd': [p.detach().clone() for p in self.net_d.parameters()]}
            rec['model'] = self
        torch.cuda.synchronize()
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        real(self, step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec['iters'].append({
            'step': step, 's': dt,
            'launches': [c.launches - b for c, b in zip(counters, before)],
            'logs': {k: float(v) for k, v in self.log_dict.items()}})

    RefRestorationModel.optimize_parameters = timed
    try:
        yield rec
    finally:
        RefRestorationModel.optimize_parameters = real


def phase_train(check, dev, report, card, chain_root):
    import os
    import tempfile
    from c2matching_tpu_torch.ops import (deform_conv_backward,
                                          deform_im2col, match_argmax)
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    from c2matching_tpu_torch.train import run
    with tempfile.TemporaryDirectory(prefix='chip_smoke_train_') as root:
        synth.write_dataset(f'{root}/synth', n=10, size=(160,))
        # stage 2's student, trained by phase contras: the shipped path is
        # relative to phase contras' outputs' root
        extractor = report['student_pth']
        print(f'train: pretrain_model_feature_extractor resolves to '
              f'{extractor}', flush=True)
        path = f'{root}/train.yml'
        with open(path, 'w') as f:
            f.write(_train_options(f'{root}/synth'))
        os.environ['C2MATCHING_ROOT'] = f'{root}/out'
        for counter in (deform_im2col, deform_conv_backward, match_argmax):
            counter.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _timed_iterations() as rec, _in_dir(f'{chain_root}/out'):
            run(path)
        wall = time.perf_counter() - t0
        launches = {'match_argmax': match_argmax.launches,
                    'deform_im2col': deform_im2col.launches,
                    'deform_conv_backward': deform_conv_backward.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del os.environ['C2MATCHING_ROOT']
        saved = sorted(os.listdir(f'{root}/out/experiments/'
                                  'stage3_restoration_gan/models'))
        _check_events(check, f'{root}/out', 'stage3_restoration_gan',
                      ('l_pix', 'l_g_gan'), 'train')

    iters = rec['iters']
    n_iters = TRAIN_PRETRAIN + TRAIN_GAN
    check(len(iters) == n_iters, f'train: {len(iters)} iterations run')
    for it in iters:
        kind = 'pretrain' if it['step'] <= TRAIN_PRETRAIN else 'GAN'
        keys = ('l_pix',) if kind == 'pretrain' else (
            'l_g_pix', 'l_g_percep', 'l_g_gan', 'l_d_real', 'l_d_fake',
            'l_grad_penalty')
        logs = it['logs']
        check(all(k in logs for k in keys)
              and all(math.isfinite(v) for v in logs.values()),
              f'train iteration {it["step"]} ({kind}): finite losses '
              + ', '.join(f'{k} {logs[k]:.5g}' for k in keys if k in logs))
        n_im2col, n_bwd, n_match, n_fused = it['launches']
        print(f'train iteration {it["step"]} ({kind}): {1e3 * it["s"]:.1f} ms'
              f' (host clock, synchronised), launches: deform_im2col '
              f'{n_im2col}, deform_conv_backward {n_bwd}, match_argmax '
              f'{n_match}, deform_conv_fused {n_fused} ({card})', flush=True)
        # a training step's DynAggs record a graph: the columns, never the
        # fused forward
        check(n_fused == 0, f'train iteration {it["step"]}: '
              f'deform_conv_fused launched {n_fused} times (none)')
        # one backward launch per DynAgg covers the batch of 9
        check(n_bwd == len(TRAIN_B3), f'train iteration {it["step"]}: '
              f'deform_conv_backward launched {n_bwd} times (one per '
              f'DynAgg: {len(TRAIN_B3)})')
    first, model = rec['first'], rec['model']
    for grp in model.optimizer_g.param_groups:
        moved = any(not torch.equal(a, p.detach())
                    for a, p in zip(first['g'][grp['name']], grp['params']))
        check(moved, f'train: G LR group {grp["name"]} moved')
    check(any(not torch.equal(a, p.detach()) for a, p in
              zip(first['d'], model.net_d.parameters())), 'train: D moved')
    for name, n in launches.items():
        check(n > 0, f'train: {name} launched {n} times')
    check('net_g_latest.pth' in saved and f'net_d_{n_iters}.pth' in saved,
          f'train: checkpoints {saved}')
    pre = [1e3 * it['s'] for it in iters if it['step'] <= TRAIN_PRETRAIN]
    gan = [1e3 * it['s'] for it in iters if it['step'] > TRAIN_PRETRAIN]
    print(f'train stage3_restoration_gan, batch 9 at gt 160, full width: '
          f'pretrain iterations {", ".join(f"{v:.1f}" for v in pre)} ms, '
          f'GAN iterations {", ".join(f"{v:.1f}" for v in gan)} ms; peak '
          f'device memory {peak:.2f} GiB; the run (options to the last '
          f'checkpoint) {wall:.1f} s; launches over the run {launches} '
          f'({card})', flush=True)
    report['train_launches'] = launches
    _train_profile(model, card)
    # the backward kernel on the tensors one GAN iteration hands it
    with _record_backward() as seen:
        model.optimize_parameters(n_iters + 1)
    shapes = [tuple(d[0].shape) for d, _ in seen]
    check(sorted(shapes) == sorted((9, h, w, c) for _, h, w, c in TRAIN_B3),
          f'train: deform_conv_backward gets x {shapes}')
    check(not any(needs_x for _, needs_x in seen), 'train: the DynAggs\' '
          'sampled feature (the frozen VGG19\'s ref_feat) needs no gradient')
    check(all(t.is_contiguous() for d, _ in seen for t in d[:3]),
          'train: the DynAggs hand the deformable conv contiguous x, offset '
          'and mask (its wrappers copy none of them)')
    report['b3bwd_float32'] = _b3b_measure(check, [d for d, _ in seen],
                                           'train path', card, with_x=False)
    del model, rec, first, seen
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _record_backward():
    """The (x, offset, mask, grad_out, w_kc) of the first backward of the
    deformable conv at each DynAgg shape (the whole batch), with whether
    autograd asked for grad_x, taken in the autograd Function's backward;
    the kernel and its counter stay as they are."""
    dc = importlib.import_module('c2matching_tpu_torch.ops.deform_conv')
    seen, shapes = [], set()
    real = dc._ModulatedDeformConv.backward

    def rec(ctx, grad_out):
        x, offset, mask, w_kc = ctx.saved_tensors[:4]
        if tuple(x.shape) not in shapes:
            shapes.add(tuple(x.shape))
            seen.append(((x, offset, mask, grad_out.float().contiguous(),
                          w_kc), ctx.needs_input_grad[0]))
        return real(ctx, grad_out)

    dc._ModulatedDeformConv.backward = staticmethod(rec)
    try:
        yield seen
    finally:
        dc._ModulatedDeformConv.backward = staticmethod(real)


def _train_profile(model, card, top=12):
    """One more GAN iteration on the run's last batch under torch.profiler:
    the device time by kernel (the largest ``top``) and the device's busy
    share of the iteration (the kernels' summed time over the host clock,
    an upper bound where kernels overlap)."""
    from torch.profiler import ProfilerActivity, profile
    step = TRAIN_PRETRAIN + TRAIN_GAN + 1
    model.optimize_parameters(step)          # the same iteration, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: a user annotation (Optimizer.step) carries the device
    # time of the kernels inside it
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    device_us = sum(e.self_device_time_total for e in events)
    print(f'train profile, one GAN iteration: {1e3 * wall:.1f} ms host '
          f'clock, {device_us / 1e3:.1f} ms of kernels '
          f'({100 * device_us / 1e6 / wall:.1f}% busy), {len(events)} '
          f'kernel names ({card})', flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f'  {e.self_device_time_total / 1e3:8.2f} ms  {e.count:5d} x  '
              f'{e.key[:90]}', flush=True)


def _small_train_opt(out):
    """debug_stage3_synth.yml's train block (its losses and LRs) on a small
    model."""
    import os.path as osp
    from c2matching_tpu_torch.utils import dict_to_nonedict, options
    here = osp.dirname(osp.abspath(__file__))
    train = dict(options.load(osp.join(
        here, 'options/train/debug_stage3_synth.yml'))['train'])
    return dict_to_nonedict({
        'name': 'chip_train_cpu', 'is_train': True,
        'model_type': 'RefRestorationModel', 'scale': 4, 'manual_seed': 0,
        'network_g': {'type': 'RestorationNet', 'ngf': 16, 'n_blocks': 2,
                      'groups': 8},
        'network_d': {'type': 'ImageDiscriminator', 'in_nc': 3, 'ndf': 4},
        'network_map': F32_BLOCKS['network_map'],
        'network_extractor': F32_BLOCKS['network_extractor'],
        'path': {'models': f'{out}/models',
                 'training_state': f'{out}/training_state'},
        'train': train})


def phase_train_cpu(check, dev):
    """One pretrain and one GAN step of a small config, card vs CPU, each
    from fresh models with the same seeded weights, on the same batch."""
    import tempfile
    from c2matching_tpu_torch.data import DataLoader, create_dataset
    from c2matching_tpu_torch.models import RefRestorationModel
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    with tempfile.TemporaryDirectory(prefix='chip_smoke_train_cpu_') as root:
        synth.write_dataset(f'{root}/synth', n=2, size=(64,))
        data = create_dataset({
            'name': 'synth', 'type': 'RefCUFEDDataset', 'phase': 'train',
            'scale': 4, 'dataroot_in': f'{root}/synth/input',
            'dataroot_ref': f'{root}/synth/ref',
            'io_backend': {'type': 'disk'},
            'ann_file': f'{root}/synth/pairs.txt', 'gt_size': 64,
            'use_flip': False, 'use_rot': False})
        batch = next(iter(DataLoader(data, batch_size=2)))
        opt = _small_train_opt(f'{root}/out')
        pretrain = opt['train']['net_g_pretrain_steps']
        for step, kind in ((1, 'pretrain'), (pretrain + 1, 'GAN')):
            models = []
            for where in (dev, 'cpu'):
                model = RefRestorationModel(opt, where)
                model.feed_data(batch)
                model.optimize_parameters(step)
                models.append(model)
            card, cpu = models
            for k, v in cpu.log_dict.items():
                want, got = float(v), float(card.log_dict[k])
                ok = abs(got - want) <= TRAIN_CPU_REL * max(abs(want), 1e-12)
                check(ok, f'train_cpu {kind} step: {k} card {got:.6g} vs CPU '
                      f'{want:.6g} (rel {TRAIN_CPU_REL:g})')
            grads = dict(cpu.net_g.named_parameters())
            top = max(p.grad.abs().max().item() for p in grads.values())
            err = max((p.grad.cpu() - grads[n].grad).abs().max().item()
                      for n, p in card.net_g.named_parameters())
            check(err <= TRAIN_CPU_REL * top, f'train_cpu {kind} step: G '
                  f'gradients max |card - CPU| {err:.3g} <= '
                  f'{TRAIN_CPU_REL:g} x {top:.3g}')
            del models, card, cpu
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ dist
DIST_PRETRAIN, DIST_GAN = 1, 2   # stage-3 iterations of phase dist's runs
DIST_BATCH = 8           # the two-rank runs' global batch, 4 a rank
DIST_CONTRAS_ITERS = 2   # stage-1 batches of the two-rank run (float64)
DIST_PARAM_TOL = 1e-6    # NCCL at world size 1 vs in process: the nets
                         # after the same iterations on the same batches
DIST_GRAD_REL = {'net_g': 1e-3, 'net_d': 5e-2}
                         # two ranks vs one process, stage 3 in float32:
                         # every averaged gradient, of its net's largest.
                         # The CPU test holds 1e-5 at gt 64. At gt 160 and
                         # batch 8, D's first conv weight's float32 gradient
                         # (BatchNorm's backward cancels its terms over 2e5
                         # pixels) is off its float64 value by 9.4e-4 of D's
                         # largest (CPU, D's init), and the two runs' parted
                         # by up to 6.3e-3 of it on the card, G's by 8.8e-5
                         # (measured). Each rank's own BatchNorm statistics
                         # in place of the global ones move D's by 0.64-1.86
                         # of it (a mutated copy, CPU test)
DIST_LOG_REL = 1e-3      # each logged value, relative: G's GAN term reads
                         # D after its Adam step, whose parameters part by
                         # up to 2 x LR where a gradient is rounding noise
DIST_REL64 = 1e-12       # stage 1 in float64 (float64_grads), two ranks vs
                         # one process: the logs and every gradient leaf
                         # (test (d) of tests/test_torch_parallel_contras.py)
DIST_STATS_TOL = 1e-6    # D's running statistics before D's Adam step
# the train CLI under torch.distributed.run, TF32 off and cuDNN's
# deterministic algorithms (as the in-process run), fed the batches the
# in-process run was fed, timing each gradient all-reduce
DIST_TRAIN_CHILD = """
import json, os, runpy, sys, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
from c2matching_tpu_torch.models.base_model import BaseModel
from c2matching_tpu_torch.models.ref_restoration_model import \
    RefRestorationModel
replay = iter(torch.load(os.environ['CHIP_SMOKE_REPLAY'], weights_only=False))
feed = RefRestorationModel.feed_data
RefRestorationModel.feed_data = lambda self, batch: feed(self, next(replay))
sync = BaseModel.sync_gradients
spent, backend = [], []

def timed(params):
    backend.append(torch.distributed.get_backend())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync(params)
    torch.cuda.synchronize()
    spent.append(1e3 * (time.perf_counter() - t0))

BaseModel.sync_gradients = staticmethod(timed)
sys.argv = ['c2matching_tpu_torch.train'] + sys.argv[1:]
runpy.run_module('c2matching_tpu_torch.train', run_name='__main__')
from c2matching_tpu_torch import ops
print(json.dumps({'allreduce_ms': spent, 'backends': sorted(set(backend)),
                  'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
                  'launches': {k: getattr(ops, k).launches for k in (
                      'match_argmax', 'deform_im2col',
                      'deform_conv_backward')}}), flush=True)
"""


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


_DIST_PROCS = []   # phase dist's processes, each in a session of its own


def _stop(proc):
    """End ``proc`` and every process it started (torchrun's workers)."""
    import os
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _spawn(cmd, cwd, env=None):
    """Start ``cmd`` with the checkout on the path, its output in a file
    (a pipe that fills would stall a rank inside a collective). Returns a
    function that waits for it: (return code, output, seconds)."""
    import os
    import os.path as osp
    here = osp.dirname(osp.abspath(__file__))
    log = tempfile.TemporaryFile('w+')
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=log,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=here,
                                     **(env or {})))
    _DIST_PROCS.append(proc)

    def wait(timeout=400):
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            _stop(proc)
        log.seek(0)
        text = log.read()
        log.close()
        return proc.returncode, text, time.perf_counter() - t0

    return wait


def _torchrun(n, *args):
    return [sys.executable, '-m', 'torch.distributed.run',
            '--nproc_per_node', str(n), '--master_port', str(_free_port()),
            *args]


def _rank_lines(text):
    """Each rank's JSON record in ``text``. The ranks write to one output
    file, and a record may follow another on the same line."""
    decoder, records = json.JSONDecoder(), []
    pos = text.find('{"rank"')
    while pos >= 0:
        record, pos = decoder.raw_decode(text, pos)
        records.append(record)
        pos = text.find('{"rank"', pos)
    return sorted(records, key=lambda r: r['rank'])


def _dist_done(check, what, result):
    rc, text, wall = result
    if not check(rc == 0, f'{what}: exit {rc} ({wall:.1f} s)'):
        print(text[-3000:], flush=True)
    return rc == 0, text


def _dist_counters():
    from c2matching_tpu_torch.ops import (deform_conv_backward,
                                          deform_im2col, match_argmax)
    return match_argmax, deform_im2col, deform_conv_backward


def _dist_nccl(check, card, root, chain_out):
    """(i) The train CLI under torch.distributed.run at world size 1 over
    NCCL against run() in process, on the same batches: the nets after the
    same iterations. Returns the batches."""
    import os
    from c2matching_tpu_torch.models.ref_restoration_model import \
        RefRestorationModel
    from c2matching_tpu_torch.train import run
    path = f'{root}/stage3.yml'
    with open(path, 'w') as f:
        f.write(_train_options(f'{root}/synth', DIST_PRETRAIN, DIST_GAN))
    seen = []
    feed = RefRestorationModel.feed_data

    def record(self, batch):
        seen.append(dict(batch))
        return feed(self, batch)

    RefRestorationModel.feed_data = record
    os.environ['C2MATCHING_ROOT'] = f'{root}/one'
    torch.backends.cudnn.deterministic = True
    for counter in _dist_counters():
        counter.launches = 0
    try:
        with _in_dir(chain_out):
            model = run(path)
        _dist_launches(check, 'dist (i) in process',
                       {c.__name__: c.launches for c in _dist_counters()})
    finally:
        RefRestorationModel.feed_data = feed
        torch.backends.cudnn.deterministic = False
        del os.environ['C2MATCHING_ROOT']
    want = {'net_g': model.net_g.state_dict(),
            'net_d': model.net_d.state_dict()}
    del model
    torch.save(seen, f'{root}/batches.pt')
    with open(f'{root}/launch_train.py', 'w') as f:
        f.write(DIST_TRAIN_CHILD)
    ok, text = _dist_done(check, 'dist (i) torch.distributed.run, 1 process, '
                          'NCCL', _spawn(
                              _torchrun(1, f'{root}/launch_train.py', '-opt',
                                        path, '--launcher', 'pytorch'),
                              chain_out,
                              {'C2MATCHING_ROOT': f'{root}/nccl',
                               'CHIP_SMOKE_REPLAY': f'{root}/batches.pt'})())
    if not ok:
        return seen
    rec = _json_line(text)
    check(rec.get('backends') == ['nccl'], f'dist (i): the gradients '
          f'all-reduced over {rec.get("backends")}')
    models = f'{root}/nccl/experiments/stage3_restoration_gan/models'
    worst, exact = 0., True
    for label, state in want.items():
        got = torch.load(f'{models}/{label}_latest.pth', weights_only=True)
        for k, v in state.items():
            if not v.is_floating_point():
                continue
            diff = float((got[k].float() - v.cpu().float()).abs().max())
            worst = max(worst, diff)
            exact = exact and torch.equal(got[k], v.cpu())
    check(worst <= DIST_PARAM_TOL, f'dist (i): G and D after {DIST_PRETRAIN} '
          f'pretrain + {DIST_GAN} GAN iterations at world size 1 over NCCL '
          f'within {worst:.3g} <= {DIST_PARAM_TOL:g} of the in-process run '
          f'({"bit for bit" if exact else "not bit for bit"})')
    _dist_launches(check, 'dist (i) NCCL process', rec.get('launches', {}))
    ms = rec.get('allreduce_ms', [])
    check(len(ms) == DIST_PRETRAIN + 2 * DIST_GAN, f'dist (i): {len(ms)} '
          'gradient all-reduces (G a pretrain iteration, D and G a GAN one)')
    print(f'dist (i) NCCL, world size 1, stage3_restoration_gan.yml at full '
          f'width, batch 9 at gt 160: gradient all-reduce (G 8.9 M and D '
          f'parameters, flattened) {", ".join(f"{v:.3f}" for v in ms)} ms a '
          f'call, synchronised; peak {rec.get("peak_gib", float("nan")):.2f} '
          f'GiB ({card})', flush=True)
    return seen


def _dist_records(root, name):
    return [torch.load(f'{root}/{name}/rank{r}.pt', weights_only=False)
            for r in range(2)]


def _adam_reach(t, betas=(0.9, 0.999)):
    """The largest |m_hat| / sqrt(v_hat) of Adam at its step ``t`` over all
    gradient histories (Cauchy-Schwarz on the bias-corrected moments): 1 at
    the first step, 1.0014 at the second, 1.0036 at the third."""
    b1, b2 = betas
    return math.sqrt(sum(
        ((1 - b1) * b1 ** (t - i) / (1 - b1 ** t)) ** 2
        / ((1 - b2) * b2 ** (t - i) / (1 - b2 ** t)) for i in range(1, t + 1)))


def _dist_compare(check, what, one, ranks, lr_of, grad_rel=DIST_GRAD_REL,
                  log_rel=DIST_LOG_REL):
    """Two ranks' records against one process's, each step from the same
    state (``run_steps``' ``follow``): every averaged gradient within
    ``grad_rel[net]`` of its net's largest, the logs within ``log_rel``, D's
    running statistics before its Adam step within DIST_STATS_TOL, the
    parameters after Adam equal on the two ranks and within what two Adam
    steps of opposite sign can part them, 2 x LR x ``_adam_reach(step)``
    (a gradient of rounding noise may take either sign; Adam's moments,
    not carried over by ``follow``, hold the earlier steps' signs), plus
    the parameter's float32 rounding."""
    for step, (want, got, got1) in enumerate(zip(one, *ranks), start=1):
        tag = f'{what} step {step}'
        for label, grads in want['grads'].items():
            top = max(float(g.abs().max()) for g in grads.values())
            err, name = max((float((got['grads'][label][k] - g).abs().max()),
                             k) for k, g in grads.items())
            check(top > 0 and err <= grad_rel[label] * top,
                  f'{tag}: {label} gradients, averaged over the ranks, '
                  f'within {err:.3g} <= {grad_rel[label]:g} x {top:.3g} '
                  f'({name})')
        rel, name = max((abs(got['logs'].get(k, math.inf) - v)
                         / max(abs(v), 1e-30), k)
                        for k, v in want['logs'].items())
        check(set(got['logs']) == set(want['logs']) and rel <= log_rel,
              f'{tag}: the global batch\'s logs within {rel:.3g} <= '
              f'{log_rel:g} relative ({name})')
        if want['d_stats'] is not None:
            stats = [k for k in want['d_stats'] if k.startswith('conv')
                     and k.endswith(('running_mean', 'running_var'))]
            err = max(float((got['d_stats'][k] - want['d_stats'][k])
                            .abs().max()) for k in stats)
            check(len(stats) == 20 and err <= DIST_STATS_TOL,
                  f'{tag}: D\'s running statistics before its Adam step '
                  f'(the global batch\'s) within {err:.3g} <= '
                  f'{DIST_STATS_TOL:g}')
        worst, same = 0., True
        reach = 2 * _adam_reach(step)
        for label, params in want['params'].items():
            for k, p in params.items():
                diff = (got['params'][label][k] - p).abs()
                ulp = 2. ** -23 * float(p.abs().max())
                worst = max(worst, float(diff.max() - ulp) / lr_of(label, k))
                same = same and torch.equal(got['params'][label][k],
                                            got1['params'][label][k])
        check(worst <= reach and same, f'{tag}: parameters after Adam within '
              f'{worst:.6g} x LR <= {reach:.6g} x LR of one process (less '
              f'float32 rounding); the two ranks equal: {same}')


def _dist_launches(check, what, launches):
    """Each kernel of the training path launched in the run (counts from 0
    before it)."""
    names = ('match_argmax', 'deform_im2col', 'deform_conv_backward')
    check(all(launches.get(k, 0) > 0 for k in names),
          f'{what}: kernel launches over the run {launches}')


def _dist_timing(check, what, text, card, kernels=True):
    lines = _rank_lines(text)
    check(len(lines) == 2 and all(r['world'] == 2 for r in lines),
          f'{what}: two ranks reported')
    for r in lines:
        if kernels:
            _dist_launches(check, f'{what}, rank {r["rank"]}',
                           r['launches'])
        ms = ', '.join(f'{s["ms"]:.1f}' for s in r['steps'])
        reduce_ms = ', '.join(f'{s["allreduce_ms"]:.1f}' for s in r['steps'])
        print(f'{what}, rank {r["rank"]}: ms a step {ms}, of which gradient '
              f'all-reduce {reduce_ms} (host clock, synchronised; both ranks '
              f'share the card: not a scaling number); peak '
              f'{r["peak_gib"]:.2f} GiB ({card})', flush=True)


def _dist_serve(root):
    """(iii) The serve CLI at two ranks (over gloo, sharing the card) and
    one process, at batch 2, on phase eval's sets. Returns the outputs'
    directories and the waits."""
    _eval_data(root)
    path = f'{root}/serve.yml'
    with open(path, 'w') as f:
        f.write(_eval_options(EVAL_OPTIONS[1][1], root, _eval_weights(root),
                              ('synth', 'cufed'))
                + '\ndist_params:\n  backend: gloo\n')
    args = ['-opt', path, '--batch', '2', '--out']
    outs = {2: f'{root}/served_2ranks', 1: f'{root}/served_1'}
    waits = {2: _spawn(_torchrun(2, '-m', 'c2matching_tpu_torch.scripts.serve',
                                 *args, outs[2], '--launcher', 'pytorch'),
                       root),
             1: _spawn([sys.executable, '-m',
                        'c2matching_tpu_torch.scripts.serve', *args,
                        outs[1]], root)}
    return outs, waits


def _dist_serve_check(check, card, outs, waits):
    import os
    import re
    import numpy as np
    from c2matching_tpu_torch.utils import png
    for n, wait in waits.items():
        if not _dist_done(check, f'dist (iii) serve, {n} rank(s)', wait())[0]:
            return
        with open(f'{outs[n]}/serve.log') as f:
            for line in re.findall(r'\d+ images in .*', f.read()):
                print(f'dist (iii) serve at batch 2, {n} rank(s): {line} '
                      f'({card})', flush=True)
    worst, count = 0, 0
    for name in ('synth', 'cufed'):
        files = {n: sorted(os.listdir(f'{outs[n]}/{name}')) for n in outs}
        check(files[2] == files[1] and files[1], f'dist (iii) serve {name}: '
              f'two ranks write {files[2]}, one process {files[1]}')
        for fname in files[1]:
            imgs = []
            for n in (2, 1):
                with open(f'{outs[n]}/{name}/{fname}', 'rb') as f:
                    imgs.append(png.decode(f.read()).astype(np.int16))
            worst = max(worst, int(np.abs(imgs[0] - imgs[1]).max()))
            count += 1
    check(worst <= SERVE_CLI_STEPS, f'dist (iii) serve: {count} PNGs of two '
          f'ranks within {worst} <= {SERVE_CLI_STEPS} uint8 step of one '
          'process\'s')


def phase_dist(check, dev, report, card, chain_root):
    """(i) NCCL at world size 1 against the in-process run; (ii) two ranks
    sharing the card over gloo against one process (stage 3, then stage 1
    beside (iii)); (iii) serve at two ranks against one process."""
    import os
    import random
    import numpy as np
    from c2matching_tpu_torch.data import create_dataset, default_collate
    from c2matching_tpu_torch.models.ref_restoration_model import (group_lrs,
                                                                   lr_group)
    from c2matching_tpu_torch.scripts import dist_step
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    from c2matching_tpu_torch.utils import dict_to_nonedict
    from c2matching_tpu_torch.utils.options import parse
    chain_out = f'{chain_root}/out'
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dist_') as root, \
            contextlib.ExitStack() as stack:
        stack.callback(lambda: [_stop(p) for p in _DIST_PROCS])
        synth.write_dataset(f'{root}/synth', n=10, size=(160,))
        synth.write_dataset(f'{root}/cufed5', n=1, size=CONTRAS_VAL_HW)
        batches = _dist_nccl(check, card, root, chain_out)
        t1 = time.perf_counter()

        # (ii) stage 3: the first DIST_BATCH items of each recorded batch
        batches = [{k: v[:DIST_BATCH] if isinstance(v, np.ndarray) else v
                    for k, v in b.items()} for b in batches]
        torch.save(batches, f'{root}/batches3.pt')
        s3 = f'{root}/stage3_gloo.yml'
        with open(s3, 'w') as f:
            f.write(_train_options(f'{root}/synth', DIST_PRETRAIN, DIST_GAN,
                                   backend='gloo'))
        ok, text = _dist_done(check, 'dist (ii) stage 3, 2 ranks on the card '
                              'over gloo', _spawn(_torchrun(
                                  2, '-m', 'c2matching_tpu_torch.scripts.'
                                  'dist_step', '-opt', s3, '--batches',
                                  f'{root}/batches3.pt', '--out',
                                  f'{root}/gloo3', '--launcher', 'pytorch'),
                                  chain_out)())
        if ok:
            _dist_timing(check, f'dist (ii) stage3_restoration_gan.yml, full '
                         f'width, {DIST_BATCH // 2} a rank at gt 160',
                         text, card)
        t2 = time.perf_counter()

        # (ii) stage 1 and (iii) serve at once; the references meanwhile
        s1 = f'{root}/stage1_gloo.yml'
        with open(s1, 'w') as f:
            f.write(_contras_options(1, root, backend='gloo'))
        opt1 = dict_to_nonedict(parse(s1, is_train=True))
        data = create_dataset(opt1['datasets']['train'])
        contras = []
        for k in range(DIST_CONTRAS_ITERS):
            random.seed(k)
            contras.append(default_collate([data[i]
                                            for i in range(DIST_BATCH)]))
        torch.save(contras, f'{root}/batches1.pt')
        wait1 = _spawn(_torchrun(2, '-m', 'c2matching_tpu_torch.scripts.'
                                 'dist_step', '-opt', s1, '--batches',
                                 f'{root}/batches1.pt', '--out',
                                 f'{root}/gloo1', '--launcher', 'pytorch',
                                 '--float64'), root)
        outs, waits = _dist_serve(f'{root}/serve')
        if ok:
            # one process, each step from the two ranks' state before it
            opt3 = dict_to_nonedict(parse(s3, is_train=True))
            gloo3 = _dist_records(root, 'gloo3')
            with _in_dir(chain_out):
                one3, _ = dist_step.run_steps(opt3, batches, dev,
                                              follow=gloo3[0])
            lrs = group_lrs(opt3['train'])
            _dist_compare(
                check, 'dist (ii) stage 3', one3, gloo3,
                lambda label, k: (opt3['train']['lr_d'] if label == 'net_d'
                                  else lrs[lr_group(k)]))
            del one3, gloo3
        one1, _ = dist_step.run_steps(opt1, contras, dev, float64=True)
        ok1, text1 = _dist_done(check, 'dist (ii) stage 1 in float64, 2 '
                                'ranks on the card over gloo', wait1())
        if ok1:
            _dist_timing(check, f'dist (ii) stage1_teacher_contras_network.yml'
                         f' float64_grads, {DIST_BATCH // 2} a rank at gt 160 '
                         '(beside (iii))', text1, card, kernels=False)
            _dist_compare(check, 'dist (ii) stage 1 (float64)', one1,
                          _dist_records(root, 'gloo1'),
                          lambda label, k: opt1['train']['lr_g'],
                          grad_rel={'net_g': DIST_REL64},
                          log_rel=DIST_REL64)
            check(all(r['logs']['n_valid'] == DIST_BATCH
                      for r in _dist_records(root, 'gloo1')[0]),
                  f'dist (ii) stage 1: n_valid {DIST_BATCH}, the global '
                  'batch\'s count')
        _dist_serve_check(check, card, outs, waits)
        del one1
    torch.cuda.empty_cache()
    print(f'dist phase seconds: (i) {t1 - t0:.1f}, (ii) stage 3 '
          f'{t2 - t1:.1f}, (ii) stage 1 with (iii) and the references '
          f'{time.perf_counter() - t2:.1f}', flush=True)


# --------------------------------------------------------------- spatial
SPATIAL_OUT_TOL = 1e-4   # banded vs one process: each image's output (f32
                         # sums of a conv over a band's halo in another
                         # order; values of O(1))
SPATIAL_PNG_STEPS = 1    # uint8 steps between a saved PNG and its twin
SPATIAL_PSNR_TOL = 1e-3  # dB, the averages of PSNR and PSNR_Y
SPATIAL_SSIM_TOL = 1e-5  # the average SSIM_Y
SPATIAL_REQ = (512, 336)  # the request of phase main, 3 pairs, set 'req'
# cuDNN's v7 API for the runs that read peak memory: with TF32 off, the
# v8 heuristics of torch 2.11 give the medium DynAgg's conv_offset_mask
# (128 to 216 channels at 128x192, a band's shape at HR 512x384) a plan
# that takes ~13.7 GiB of workspace (scripts/profile_memory.py)
SPATIAL_V7_ENV = {'TORCH_CUDNN_V8_API_DISABLED': '1'}
SPATIAL_PEAK_RATIO = 1.0  # a rank's peak under the v7 API over one
                          # process's: a band holds half the image's
                          # activations and the whole reference's features
# the test CLI, TF32 off and cuDNN's deterministic algorithms, recording
# each image's cropped output and host ms (synchronised), the last image's
# B1 and B3 operands held against their plain versions (checks of this
# file, whose lines go to the output), the launch counts, the band
# exchanges' counts and bytes, the peak memory and the leaf modules that
# rose highest above their entry (utils/prof.py::ModulePeaks, hooks read
# on the host): one {"rank": ...} line
SPATIAL_CHILD = """
import importlib, json, os, sys, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
import chip_smoke as cs
from c2matching_tpu_torch import ops, parallel, test
from c2matching_tpu_torch.models.ref_restoration_model import \\
    RefRestorationModel
from c2matching_tpu_torch.parallel import spatial
from c2matching_tpu_torch.utils.prof import ModulePeaks
pm = importlib.import_module('c2matching_tpu_torch.ops.patch_match')
ra = importlib.import_module(
    'c2matching_tpu_torch.models.archs.ref_restoration_arch')
images, crop = RefRestorationModel._validation_images, \\
    RefRestorationModel.cropped_output
match, mdc = pm.match_argmax, ra.modulated_deform_conv
outputs, ms, last, bands, info = {}, {}, {}, {}, {}

def cropped(self):
    out = crop(self)
    self.chip_smoke_out = out
    return out

def timed(self, val_data):
    if 'peaks' not in info:
        info['peaks'] = ModulePeaks(self.net_extractor, self.net_map,
                                    self.net_g)
    path = val_data['lq_path'][0]
    key = path.split('/')[-3] + '/' + os.path.basename(path)
    last.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = images(self, val_data)
    torch.cuda.synchronize()
    ms.setdefault(key.split('/')[0], []).append(
        1e3 * (time.perf_counter() - t0))
    outputs[key] = self.chip_smoke_out.cpu()
    bands[key] = None if self._band is None else self._band.rows
    info['backend'] = (torch.distributed.get_backend()
                       if torch.distributed.is_initialized() else None)
    return result

def match_rec(q, r, ref_bias=None):
    last['b1'] = (q, r, ref_bias)
    return match(q, r, ref_bias)

def mdc_rec(x, offset, mask, weight, bias=None, **conv):
    last.setdefault('b3', []).append((x, offset, mask, weight, bias, conv))
    return mdc(x, offset, mask, weight, bias, **conv)

RefRestorationModel._validation_images = timed
RefRestorationModel.cropped_output = cropped
pm.match_argmax, ra.modulated_deform_conv = match_rec, mdc_rec
spatial.reset_stats()
results = test.main(sys.argv[1:])
launches = {k: getattr(ops, k).launches
            for k in ('match_argmax', 'deform_conv_fused')}
stats = dict(spatial.stats)
rank = int(os.environ.get('RANK', 0))
check = cs.Checks()
with torch.inference_mode():
    if 'b1' in last:
        q, r, bias = last['b1']
        cs._b1_compare(check, q, r, bias, f'spatial rank {rank} band '
                       f'{tuple(q.shape)} x {tuple(r.shape)}')
    for x, offset, mask, weight, bias, conv in last.get('b3', []):
        label = (f'spatial rank {rank} band {tuple(offset.shape[1:3])} of '
                 f'{tuple(x.shape[1:])} padding {conv["padding"]}')
        cs._b3_compare(check, x[0], offset[0], mask[0], label, **conv)
        k, c, co = weight.shape
        cs._fused_compare(check, x, offset, mask,
                          weight.reshape(k * c, co).to(x.dtype).float(),
                          bias, label, **conv)
torch.save(outputs, os.environ['CHIP_SMOKE_OUT'] + f'/outputs.rank{rank}.pt')
print(json.dumps({
    'rank': rank, 'world': int(os.environ.get('WORLD_SIZE', 1)),
    'backend': info.get('backend'),
    'results': results, 'ms': ms, 'bands': bands, 'launches': launches,
    'stats': stats, 'b1_b3_failed': check.failed,
    'b1_b3_checked': ('b1' in last) + len(last.get('b3', [])),
    'peak_gib': info['peaks'].total(),
    'peak_modules': info['peaks'].top(3)}), flush=True)
"""


def _spatial_options(root, weights, spatial, backend):
    """Phase eval's f32 options on phase eval's sets and the 'req' set,
    with ``val_spatial_shard`` and ``dist_params.backend``."""
    text = _eval_options(EVAL_OPTIONS[0][1], root, weights,
                         ('synth', 'cufed'))
    text = text.replace('\nval_func:', f"""
  test_3:
    name: req
    type: RefCUFEDDataset
    dataroot_in: {root}/req/input
    dataroot_ref: {root}/req/ref
    io_backend:
      type: disk
    ann_file: {root}/req/pairs.txt

val_func:""", 1)
    return (text + f'\nval_spatial_shard: {str(spatial).lower()}\n'
            f'dist_params:\n  backend: {backend}\n')


def _spatial_run(root, name, opts, n, env=None):
    """Start the test CLI of options ``opts`` in SPATIAL_CHILD: at ``n``
    ranks under torch.distributed.run, or (``n`` 0) alone without a
    launcher. Its results tree and outputs under ``root``/``name``."""
    import os
    out = f'{root}/{name}'
    os.makedirs(out)
    child = f'{root}/spatial_child.py'
    args = ['-opt', opts]
    cmd = ([sys.executable, child] + args if n == 0 else
           _torchrun(n, child, *args, '--launcher', 'pytorch'))
    return _spawn(cmd, root, dict(env or {}, C2MATCHING_ROOT=out,
                                  CHIP_SMOKE_OUT=out))


def _spatial_records(check, what, result, n):
    ok, text = _dist_done(check, what, result)
    if not ok:
        return None
    lines = _rank_lines(text)
    for line in text.splitlines():
        if line.startswith(('ok   b', 'FAIL b')):
            print(f'  {what}: {line}', flush=True)
    if not check(len(lines) == max(n, 1), f'{what}: {len(lines)} rank '
                 'record(s)'):
        return None
    for r in lines:
        check(not r['b1_b3_failed'] and r['b1_b3_checked'] == 4,
              f'{what}, rank {r["rank"]}: the last image\'s B1 and 3 B3 '
              f'launches at the band\'s arguments against their plain '
              f'versions ({r["b1_b3_checked"]} held; failed: '
              f'{r["b1_b3_failed"]})')
    return lines


def _spatial_outputs(root, name, rank=0):
    return torch.load(f'{root}/{name}/outputs.rank{rank}.pt',
                      weights_only=True)


def _spatial_pngs(root, name):
    import os
    import numpy as np
    from c2matching_tpu_torch.utils import png
    vis = f'{root}/{name}/results/synth_smoke/visualization'
    imgs = {}
    for sub in sorted(os.listdir(vis)):
        for fname in sorted(os.listdir(f'{vis}/{sub}')):
            with open(f'{vis}/{sub}/{fname}', 'rb') as f:
                imgs[f'{sub}/{fname}'] = png.decode(f.read()).astype(
                    np.int16)
    return imgs


def _spatial_b3_probe(check, dev):
    """B3 at a band's arguments: the lower half of each DynAgg image of an
    HR 512x336 request (Ho = H / 2, padding (1 - H / 2, 1), the
    whole x), the kernel against the same rows of its whole-image columns
    and against its plain version, which must give those rows of its own
    whole-image columns bit for bit."""
    from c2matching_tpu_torch.ops import deform_im2col, deform_im2col_plain
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for layer, h, w, c in DCN_SHAPES:
        x, offset, mask = _dcn_inputs(gen, dev, h, w, c, torch.float32)
        row0 = h // 2
        pad = (1 - row0, 1)
        band = (x, offset[row0:].contiguous(), mask[row0:].contiguous())
        whole_k = deform_im2col(x, offset, mask)[row0 * w:]
        band_k = deform_im2col(*band, padding=pad)
        same_k = torch.equal(band_k, whole_k)
        del whole_k
        band_p = deform_im2col_plain(*band, padding=pad)
        same_p = torch.equal(band_p,
                             deform_im2col_plain(x, offset, mask)[row0 * w:])
        err = (band_k - band_p).abs().max().item()
        label = (f'spatial B3 band probe {layer} {h}x{w}x{c}, rows '
                 f'{row0}-{h - 1} at padding {pad}')
        check(same_k, f'{label}: kernel bit for bit the whole image\'s '
              'columns of those rows')
        check(same_p, f'{label}: plain version bit for bit its whole '
              'image\'s columns of those rows')
        check(err <= B3_F32_TOL, f'{label}: kernel vs plain max |diff| '
              f'{err:.3g} <= {B3_F32_TOL:g} ('
              f'{"bit for bit" if err == 0 else "not bit for bit"})')
        out[layer] = err
        del band, band_k, band_p
        torch.cuda.empty_cache()
    return out


def _spatial_line(what, r, card):
    n_img = sum(len(v) for v in r['ms'].values())
    st = r['stats']
    times = ', '.join(f'{k} {statistics.median(v):.1f}'
                      for k, v in sorted(r['ms'].items()))
    print(f'{what}, rank {r["rank"]}: ms an image (median of the set; host '
          f'clock, synchronised) {times}; peak {r["peak_gib"]:.2f} GiB; '
          f'launches B1 {r["launches"]["match_argmax"]}, B3F '
          f'{r["launches"]["deform_conv_fused"]} over {n_img} images; highest '
          'above its entry: ' + ', '.join(
              f'{name} {shape} {gib:.2f} GiB (output {out:.3f})'
              for name, shape, gib, out in r['peak_modules'][:1])
          + f'; a band '
          f'image: {st["halo_exchanges"] / n_img:.0f} halo exchanges, '
          f'{st["halo_bytes"] / n_img / 2 ** 10:.1f} KiB received, '
          f'{st["gathers"] / n_img:.0f} gathers, '
          f'{st["gather_bytes"] / n_img / 2 ** 20:.2f} MiB received '
          f'({card})', flush=True)


def phase_spatial(check, dev, card):
    """val_spatial_shard on the card: the test CLI at two ranks sharing the
    card over gloo against one process; at world size 1 over NCCL the
    option on against off, bit for bit; the B3 band probe."""
    import numpy as np
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    with tempfile.TemporaryDirectory(prefix='chip_smoke_spatial_') as root, \
            contextlib.ExitStack() as stack:
        stack.callback(lambda: [_stop(p) for p in _DIST_PROCS])
        _eval_data(root)
        synth.write_dataset(f'{root}/req', n=3, size=SPATIAL_REQ)
        weights = _eval_weights(root)
        opts = {}
        for key, spatial, backend in (('gloo', True, 'gloo'),
                                      ('nccl_on', True, 'ici'),
                                      ('nccl_off', False, 'ici')):
            opts[key] = f'{root}/{key}.yml'
            with open(opts[key], 'w') as f:
                f.write(_spatial_options(root, weights, spatial, backend))
        with open(f'{root}/spatial_child.py', 'w') as f:
            f.write(SPATIAL_CHILD)
        n_img = 3 + 1 + 3

        # two ranks sharing the card, alone on it; then one process and the
        # two world-size-1 NCCL runs at once; then the two peak runs under
        # cuDNN's v7 API at once
        two = _spatial_records(check, 'spatial, 2 ranks on the card over '
                               'gloo', _spatial_run(
                                   root, 'two', opts['gloo'], 2)(600), 2)
        rec = {}
        for group in ({'one': (opts['gloo'], 0, None),
                       'nccl_on': (opts['nccl_on'], 1, None),
                       'nccl_off': (opts['nccl_off'], 1, None)},
                      {'one_v7': (opts['gloo'], 0, SPATIAL_V7_ENV),
                       'two_v7': (opts['gloo'], 2, SPATIAL_V7_ENV)}):
            waits = {k: _spatial_run(root, k, *v) for k, v in group.items()}
            rec.update({k: _spatial_records(check, f'spatial {k}', w(600),
                                            group[k][1])
                        for k, w in waits.items()})
        probe = _spatial_b3_probe(check, dev)
        if two is None or None in rec.values():
            return
        one = rec['one'][0]
        for r in two:
            check(r['backend'] == 'gloo' and r['world'] == 2
                  and all(r['bands'].values()), f'spatial two ranks over '
                  f'{r["backend"]}, rank {r["rank"]}: every image split into '
                  f'bands (LR rows a band: {r["bands"]})')
            check(r['launches']['match_argmax'] == n_img
                  and r['launches']['deform_conv_fused'] == 3 * n_img,
                  f'spatial rank {r["rank"]}: B1 launched '
                  f'{r["launches"]["match_argmax"]} times, B3F '
                  f'{r["launches"]["deform_conv_fused"]} over {n_img} images '
                  f'(1 and 3 an image)')
            _spatial_line('spatial, 2 ranks sharing one card over gloo (not '
                          'a scaling number: both ranks share the card)', r,
                          card)
        _spatial_line('spatial, one process (the option has no effect)',
                      one, card)
        check(one['launches']['match_argmax'] == n_img
              and one['launches']['deform_conv_fused'] == 3 * n_img
              and one['stats']['halo_exchanges'] == 0,
              f'spatial one process: launches {one["launches"]}, no '
              'exchange')
        worst = {}
        for two_k, one_k in (('two', 'one'), ('two_v7', 'one_v7')):
            want = _spatial_outputs(root, one_k)
            worst[two_k] = 0.
            for rank in range(2):
                got = _spatial_outputs(root, two_k, rank)
                check(sorted(got) == sorted(want) and len(want) == n_img,
                      f'spatial {two_k} rank {rank}: {len(got)} outputs')
                for k, v in want.items():
                    worst[two_k] = max(worst[two_k],
                                       float((got[k] - v).abs().max()))
            check(worst[two_k] <= SPATIAL_OUT_TOL, f'spatial {two_k}: every '
                  f'image\'s output on both ranks within {worst[two_k]:.3g} '
                  f'<= {SPATIAL_OUT_TOL:g} of {one_k}\'s')
        peaks = {'v8 default': ([r['peak_gib'] for r in two],
                                one['peak_gib']),
                 'v7 API': ([r['peak_gib'] for r in rec['two_v7']],
                            rec['one_v7'][0]['peak_gib'])}
        for what, (ranks, whole) in peaks.items():
            print(f'spatial peak under cuDNN\'s {what}: ranks ' + ', '.join(
                f'{p:.2f}' for p in ranks) + f' GiB, one process '
                f'{whole:.2f} GiB ({card})', flush=True)
        ranks, whole = peaks['v7 API']
        check(max(ranks) <= SPATIAL_PEAK_RATIO * whole, f'spatial: a rank\'s '
              f'peak under cuDNN\'s v7 API {max(ranks):.2f} GiB <= '
              f'{SPATIAL_PEAK_RATIO:g} x one process\'s {whole:.2f} GiB')
        pngs = {k: _spatial_pngs(root, k) for k in ('two', 'one')}
        steps = max((int(np.abs(pngs['two'][k] - v).max())
                     for k, v in pngs['one'].items()
                     if k in pngs['two']), default=99)
        check(sorted(pngs['two']) == sorted(pngs['one'])
              and len(pngs['one']) == n_img and steps <= SPATIAL_PNG_STEPS,
              f'spatial: {len(pngs["two"])} PNGs saved once by two ranks, '
              f'within {steps} <= {SPATIAL_PNG_STEPS} uint8 step of one '
              'process\'s')
        metric_diff = {}
        for r in two:
            for name, avgs in one['results'].items():
                for k, v in avgs.items():
                    d = abs(r['results'][name][k] - v)
                    metric_diff[k] = max(metric_diff.get(k, 0.), d)
        for k, d in sorted(metric_diff.items()):
            tol = SPATIAL_SSIM_TOL if k == 'ssim_y' else SPATIAL_PSNR_TOL
            check(d <= tol, f'spatial: {k} averages of both ranks within '
                  f'{d:.3g} <= {tol:g} of one process\'s on every set')
        nccl = {k: _spatial_outputs(root, k) for k in ('nccl_on', 'nccl_off')}
        check(rec['nccl_on'][0]['backend'] == 'nccl'
              and sorted(nccl['nccl_on']) == sorted(nccl['nccl_off'])
              and all(torch.equal(v, nccl['nccl_off'][k])
                      for k, v in nccl['nccl_on'].items()),
              'spatial: the CLI at world size 1 over NCCL, the option on '
              'vs off, every output bit for bit (a no-op guard: no band is '
              'cut at world size 1)')
        print(json.dumps({'phase': 'spatial', 'card': card,
                          'two_ranks': [{k: r[k] for k in (
                              'rank', 'ms', 'peak_gib', 'peak_modules',
                              'launches', 'stats', 'bands')} for r in two],
                          'one': {k: one[k] for k in (
                              'ms', 'peak_gib', 'peak_modules',
                              'launches')},
                          'max_abs_err': worst['two'],
                          'max_abs_err_v7': worst['two_v7'],
                          'peak_gib_by_cudnn_api': peaks,
                          'png_steps': steps,
                          'metric_diff': metric_diff,
                          'b3_band_probe_err': probe}),
              flush=True)


# ---------------------------------------------------------------- options
OPTIONS_PRETRAIN, OPTIONS_GAN = 1, 1   # stage-3 iterations of the lmdb and
                                       # disk runs
OPTIONS_PAIRS = 10                     # synth pairs at 160, shared keys
REMAT_POLICIES = ('none', 'dcn_rows', 'dots')
REMAT_TOL = 1e-6     # each policy's GAN step vs 'none' from one state: the
                     # parameters, of the largest (DIST_PARAM_TOL's bound;
                     # the same arithmetic recomputed, bit for bit expected)
BF16_TRAIN_REL = 2 ** -5  # bf16 D and perceptual VGG, card vs CPU, each log
                          # of a GAN step: the CPU test's bound against JAX
                          # (tests/test_torch_train_bf16.py)
TRACE_KERNELS = ('match_argmax_kernel', 'mdc_im2col_kernel',
                 'mdc_backward_kernel')   # B1, B3 forward, B3 backward


def _options_data(root):
    """The synth set under ``root``/disk with each ref renamed to its
    input's key (lmdb pairs by key) and an annotation file of the pairs,
    and its lmdb databases under ``root``/lmdb from the port's packer.
    Returns the packer's seconds."""
    import os
    from c2matching_tpu_torch.scripts import create_cufed_lmdb
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    disk = f'{root}/disk'
    synth.write_dataset(disk, n=OPTIONS_PAIRS, size=(160,))
    for f in os.listdir(f'{disk}/ref'):
        os.rename(f'{disk}/ref/{f}', f'{disk}/ref/{f.replace("_1.", "_0.")}')
    keys = sorted(os.listdir(f'{disk}/input'))
    with open(f'{disk}/pairs.txt', 'w') as f:
        f.write(''.join(f'{k} {k}\n' for k in keys))
    t0 = time.perf_counter()
    for name in ('input', 'ref'):
        create_cufed_lmdb.pack(f'{disk}/{name}', f'{root}/lmdb', name, 160, 4)
    return time.perf_counter() - t0


def _options_stage_text(name, root, store, swaps=()):
    """The shipped options file ``name`` training from ``root``'s lmdb
    databases or its disk set (``store``), one loader thread (the items'
    augmentation draws in the loader's order), validating on the disk set
    by its annotation file; ``swaps`` more replacements."""
    import os.path as osp
    with open(osp.join(osp.dirname(osp.abspath(__file__)), name)) as f:
        text = f.read()
    if store == 'lmdb':
        data = [('./datasets/CUFED/input', f'{root}/lmdb/input.lmdb'),
                ('./datasets/CUFED/ref', f'{root}/lmdb/ref.lmdb'),
                (TRAIN_ANN, TRAIN_ANN.replace('type: disk', 'type: lmdb'))]
    else:
        data = [('./datasets/CUFED/input', f'{root}/disk/input'),
                ('./datasets/CUFED/ref', f'{root}/disk/ref'),
                (TRAIN_ANN, TRAIN_ANN.replace(
                    '\n\n', f'\n    ann_file: {root}/disk/pairs.txt\n\n'))]
    for old, new in data + [
            ('n_workers: 6', 'n_workers: 1'),
            ('dataroot_in: ./datasets/CUFED5',
             f'dataroot_in: {root}/disk/input'),
            ('dataroot_ref: ./datasets/CUFED5',
             f'dataroot_ref: {root}/disk/ref'),
            ('print_freq: 100', 'print_freq: 1')] + list(swaps):
        if old not in text:
            raise ValueError(f'{name} has no {old!r}')
        text = text.replace(old, new)
    return text


@contextlib.contextmanager
def _recorded(cls):
    """The numpy arrays of every batch ``cls.feed_data`` takes and the logs
    of every ``optimize_parameters`` (after a synchronise), with each
    step's host seconds."""
    import numpy as np
    rec = {'batches': [], 'logs': [], 's': []}
    feed, step = cls.feed_data, cls.optimize_parameters

    def record_feed(self, batch):
        rec['batches'].append({k: np.array(v) for k, v in batch.items()
                               if isinstance(v, np.ndarray)})
        return feed(self, batch)

    def record_step(self, it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(self, it)
        torch.cuda.synchronize()
        rec['s'].append(time.perf_counter() - t0)
        rec['logs'].append({k: float(v) for k, v in self.log_dict.items()})

    cls.feed_data, cls.optimize_parameters = record_feed, record_step
    try:
        yield rec
    finally:
        cls.feed_data, cls.optimize_parameters = feed, step


def _same_runs(check, what, runs, net_tol):
    """The lmdb run's batches and logs against the disk run's, bit for
    bit, and its trained net within ``net_tol`` (0: bit for bit)."""
    import numpy as np
    (a, net_a), (b, net_b) = runs['lmdb'], runs['disk']
    same_batches = (len(a['batches']) == len(b['batches']) > 0 and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a['batches'], b['batches'])))
    check(same_batches, f'{what}: {len(a["batches"])} batches from lmdb '
          'equal to the disk run\'s, bit for bit')
    check(len(a['logs']) == len(b['logs']) > 0 and a['logs'] == b['logs'],
          f'{what}: the losses from lmdb equal to the disk run\'s, bit for '
          f'bit: {a["logs"][-1] if a["logs"] else None}')
    diff = max(float((net_a[k].float() - net_b[k].float()).abs().max())
               for k in net_a if net_a[k].is_floating_point())
    exact = all(torch.equal(net_a[k], net_b[k]) for k in net_a)
    check(net_a.keys() == net_b.keys() and diff <= net_tol,
          f'{what}: the trained net within {diff:.3g} <= {net_tol:g} of the '
          f'disk run\'s ({"bit for bit" if exact else "not bit for bit"})')


def _options_lmdb(check, root, chain_out, card, out):
    """Stage 3 (OPTIONS_PRETRAIN + OPTIONS_GAN iterations of the shipped
    config) and stage 1 (one iteration) from lmdb and from disk on the same
    seed; the lmdb stage-3 run carries a trace_dir window over both of its
    iterations. Returns the stage-3 disk run's recorded batches."""
    import os
    from c2matching_tpu_torch.models.ref_restoration_model import \
        RefRestorationModel
    from c2matching_tpu_torch.models.teacher_contras_model import \
        ContrasModel
    from c2matching_tpu_torch.train import run
    n = OPTIONS_PRETRAIN + OPTIONS_GAN
    # stage 3's backward is deterministic with cuDNN's deterministic
    # algorithms (B3's backward adds no atomics without grad_x): its net
    # bit for bit. Stage 1's loss gathers features (torch.gather), whose
    # backward scatters with atomics: from the same gradients but for
    # their last bits, its one Adam step (lr_g 1e-3) moves each parameter
    # by at most lr_g, so the two nets lie within 2 x lr_g
    stages = (
        ('stage 3', TRAIN_OPTIONS, RefRestorationModel, 'net_g', 0.0, [
            ('./datasets/CUFED5_pairs.txt', f'{root}/disk/pairs.txt'),
            ('niter: 255000', f'niter: {n}'),
            ('net_g_pretrain_steps: 10000',
             f'net_g_pretrain_steps: {OPTIONS_PRETRAIN}')]),
        ('stage 1', CONTRAS_OPTIONS[1], ContrasModel, 'net_g',
         2 * 1e-3 * _adam_reach(1), [
             ('./datasets/contras_val.txt', f'{root}/disk/pairs.txt'),
             ('niter: 5000', 'niter: 1')]))
    recs = {}
    for what, name, cls, net, net_tol, swaps in stages:
        runs = {}
        for store in ('lmdb', 'disk'):
            extra = list(swaps)
            if what == 'stage 3' and store == 'lmdb':
                extra.append(('logger:\n', f'logger:\n  trace_dir: '
                              f'{root}/trace\n  trace_start_iter: 1\n'
                              f'  trace_n_iters: {n}\n'))
            path = f'{root}/{what[-1]}_{store}.yml'
            with open(path, 'w') as f:
                f.write(_options_stage_text(name, root, store, extra))
            os.environ['C2MATCHING_ROOT'] = f'{root}/out_{what[-1]}_{store}'
            t0 = time.perf_counter()
            try:
                with _recorded(cls) as rec, _in_dir(chain_out):
                    model = run(path)
            finally:
                del os.environ['C2MATCHING_ROOT']
            wall = time.perf_counter() - t0
            runs[store] = (rec, {k: v.detach().clone() for k, v in
                                 getattr(model, net).state_dict().items()})
            del model
            torch.cuda.empty_cache()
            print(f'options lmdb: {what} ({name}) from {store}: '
                  f'iterations '
                  + ', '.join(f'{1e3 * s:.1f}' for s in rec['s'])
                  + f' ms (host clock, synchronised); the run {wall:.1f} s '
                  f'({card})', flush=True)
        _same_runs(check, f'options lmdb {what}', runs, net_tol)
        out[f'{what.replace(" ", "")}_iter_ms'] = {
            store: [round(1e3 * s, 3) for s in runs[store][0]['s']]
            for store in runs}
        recs[what] = runs['disk'][0]
    return recs['stage 3']['batches']


def _options_host_ms(check, root, card):
    """Host ms per item of RefCUFEDDataset (train, gt 160) and
    ContrasDataset read from lmdb and from disk, each item under the same
    seeds from both stores and equal bit for bit. Median over the items."""
    import random
    import numpy as np
    from c2matching_tpu_torch.data import ContrasDataset, RefCUFEDDataset
    out = {}
    for kind, cls in (('RefCUFEDDataset', RefCUFEDDataset),
                      ('ContrasDataset', ContrasDataset)):
        items, ms = {}, {}
        for store in ('lmdb', 'disk'):
            opt = {'name': 'synth', 'phase': 'train', 'scale': 4,
                   'gt_size': 160, 'use_flip': True, 'use_rot': True}
            if store == 'lmdb':
                opt.update(io_backend={'type': 'lmdb'},
                           dataroot_in=f'{root}/lmdb/input.lmdb',
                           dataroot_ref=f'{root}/lmdb/ref.lmdb')
            else:
                opt.update(io_backend={'type': 'disk'},
                           dataroot_in=f'{root}/disk/input',
                           dataroot_ref=f'{root}/disk/ref',
                           ann_file=f'{root}/disk/pairs.txt')
            data = cls(opt)
            items[store], times = [], []
            for i in range(len(data)):
                random.seed(i)
                np.random.seed(i)
                t0 = time.perf_counter()
                items[store].append(data[i])
                times.append(1e3 * (time.perf_counter() - t0))
            ms[store] = statistics.median(times)
        same = len(items['lmdb']) == len(items['disk']) == OPTIONS_PAIRS \
            and all(np.array_equal(a[k], b[k]) for a, b in zip(
                items['lmdb'], items['disk']) for k in a
                if isinstance(a[k], np.ndarray))
        check(same, f'options lmdb: {kind} items from lmdb equal to disk, '
              'bit for bit')
        print(f'options lmdb: {kind} host ms an item (median of '
              f'{OPTIONS_PAIRS}), lmdb {ms["lmdb"]:.2f}, disk '
              f'{ms["disk"]:.2f} (host of {card})', flush=True)
        out[kind] = {k: round(v, 3) for k, v in ms.items()}
    return out


def _check_trace(check, root):
    """The trace_dir window's file: one, JSON, naming B1 and the B3
    forward and backward kernels, with one ProfilerStep an iteration."""
    import glob
    files = glob.glob(f'{root}/trace/*.pt.trace.json')
    names, steps = set(), set()
    if len(files) == 1:
        with open(files[0]) as f:
            events = json.load(f).get('traceEvents', [])
        names = {e.get('name', '') for e in events
                 if e.get('cat') == 'kernel'}
        steps = {e.get('name') for e in events
                 if str(e.get('name', '')).startswith('ProfilerStep#')}
    found = {k: sum(k in name for name in names) for k in TRACE_KERNELS}
    check(len(files) == 1 and all(found.values()), f'options trace: '
          f'{len(files)} trace file(s) under trace_dir, {len(names)} kernel '
          f'names, of them {found}')
    n = OPTIONS_PRETRAIN + OPTIONS_GAN
    check(len(steps) == n, f'options trace: {sorted(steps)} ({n} '
          'iterations in the window)')
    return {'files': len(files), 'kernel_names': len(names),
            'steps': len(steps), **found}


def _state(model):
    """A copy of everything a GAN step changes."""
    import copy
    return {'g': copy.deepcopy(model.net_g.state_dict()),
            'd': copy.deepcopy(model.net_d.state_dict()),
            'opt_g': copy.deepcopy(model.optimizer_g.state_dict()),
            'opt_d': copy.deepcopy(model.optimizer_d.state_dict()),
            'counts': copy.deepcopy(model.schedules.state_dict())}


def _restore(model, state):
    import copy
    model.net_g.load_state_dict(state['g'])
    model.net_d.load_state_dict(state['d'])
    model.optimizer_g.load_state_dict(copy.deepcopy(state['opt_g']))
    model.optimizer_d.load_state_dict(copy.deepcopy(state['opt_d']))
    model.schedules.load_state_dict(copy.deepcopy(state['counts']))


def _gan_step(model, batch, state, step):
    """One GAN step from ``state``, warm (the same step run before it):
    (host ms around the synchronised step, peak GiB, B3 forward launches,
    the nets' parameters after it, the logs, and GiB allocated at the
    step's start and at its peak up to the end of the D update)."""
    from c2matching_tpu_torch.ops import deform_im2col
    import numpy as np
    alpha = np.full((batch['img_in'].shape[0], 1, 1, 1), 0.3, np.float32)
    marks = {}
    d_update = model._d_update

    def marked_d_update(*args):
        out = d_update(*args)
        marks['d'] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    model._d_update = marked_d_update
    try:
        for _ in range(2):
            _restore(model, state)
            model.feed_data(batch)
            model.gp_alpha = alpha
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks['start'] = torch.cuda.memory_allocated() / 2 ** 30
            deform_im2col.launches = 0
            t0 = time.perf_counter()
            model.optimize_parameters(step)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del model._d_update
    return (ms, torch.cuda.max_memory_allocated() / 2 ** 30,
            deform_im2col.launches,
            [p.detach().clone() for net in (model.net_g, model.net_d)
             for p in net.parameters()],
            {k: float(v) for k, v in model.log_dict.items()}, marks)


def _stage3_model(root, chain_out, dev, blocks=None, perceptual=None):
    """The shipped stage-3 model (disk options of phase options), its
    network_d and perceptual_opt updated by ``blocks`` / ``perceptual``."""
    from c2matching_tpu_torch.models import create_model
    from c2matching_tpu_torch.utils import dict_to_nonedict
    from c2matching_tpu_torch.utils.options import parse
    opt = parse(f'{root}/3_disk.yml', is_train=True)
    opt['network_d'].update(blocks or {})
    opt['train']['perceptual_opt'].update(perceptual or {})
    with _in_dir(chain_out):
        return create_model(dict_to_nonedict(opt), dev)


def _options_remat(check, root, chain_out, dev, batch, card, out):
    """One GAN step of the shipped stage-3 model from one state under each
    remat policy, then with bf16 D and perceptual VGG from the same state.
    Returns the 'none' step (ms, peak)."""
    model = _stage3_model(root, chain_out, dev)
    step = OPTIONS_PRETRAIN + 1
    model.feed_data(batch)
    model.optimize_parameters(step)           # Adam's state, cuDNN's plans
    state = _state(model)
    res = {}
    for policy in REMAT_POLICIES:
        model.remat_policy = policy
        res[policy] = _gan_step(model, batch, state, step)
    none = res['none']
    top = max(float(p.abs().max()) for p in none[3])
    for policy in REMAT_POLICIES:
        ms, peak, im2col, params, _, marks = res[policy]
        diff = max(float((a - b).abs().max())
                   for a, b in zip(params, none[3]))
        exact = all(torch.equal(a, b) for a, b in zip(params, none[3]))
        same = 'bit for bit' if exact else 'not bit for bit'
        check(diff <= REMAT_TOL * top, f'options remat {policy}: G and D '
              f'after the step within {diff:.3g} <= {REMAT_TOL:g} x {top:.3g} '
              f'of the none step ({same})')
        print(f'options remat {policy}: GAN step {ms:.1f} ms (host clock, '
              f'synchronised, warm), peak {peak:.2f} GiB (allocated at the '
              f'start {marks["start"]:.2f}, peak to the end of the D update '
              f'{marks["d"]:.2f}), deform_im2col launched {im2col} times '
              f'({card})', flush=True)
        out[policy] = {'ms': round(ms, 3), 'peak_gib': round(peak, 3),
                       'start_gib': round(marks['start'], 3),
                       'd_update_peak_gib': round(marks['d'], 3),
                       'im2col_launches': im2col, 'bit_for_bit': exact}
    check(res['dcn_rows'][2] == none[2], f'options remat dcn_rows: '
          f'deform_im2col launched {res["dcn_rows"][2]} times, as none '
          f'({none[2]}): the recompute takes the kept columns')
    check(res['dots'][2] == 2 * none[2], f'options remat dots: '
          f'deform_im2col launched {res["dots"][2]} times (twice none\'s)')
    model.remat_policy = 'none'
    del res, model
    torch.cuda.empty_cache()
    return none[0], none[1], state


def _options_bf16(check, root, chain_out, dev, batch, card, state, f32):
    """The shipped stage-3 GAN step with ``dtype: bfloat16`` on network_d
    and perceptual_opt, from the f32 remat state, beside the f32 step;
    then a small model's GAN step with both, card against the CPU."""
    import tempfile
    from c2matching_tpu_torch.data import DataLoader, create_dataset
    from c2matching_tpu_torch.models import RefRestorationModel
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    bf16 = {'dtype': 'bfloat16'}
    model = _stage3_model(root, chain_out, dev, bf16, bf16)
    ms, peak, _, _, logs, _ = _gan_step(model, batch, state,
                                        OPTIONS_PRETRAIN + 1)
    check(_finite(logs.values()), 'options bf16 D and VGG: finite losses')
    print(f'options bf16 D and perceptual VGG: GAN step {ms:.1f} ms, peak '
          f'{peak:.2f} GiB; f32 {f32[0]:.1f} ms, {f32[1]:.2f} GiB ({card})',
          flush=True)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_bf16_') as tmp:
        synth.write_dataset(f'{tmp}/synth', n=2, size=(64,))
        data = create_dataset({
            'name': 'synth', 'type': 'RefCUFEDDataset', 'phase': 'train',
            'scale': 4, 'dataroot_in': f'{tmp}/synth/input',
            'dataroot_ref': f'{tmp}/synth/ref',
            'io_backend': {'type': 'disk'},
            'ann_file': f'{tmp}/synth/pairs.txt', 'gt_size': 64,
            'use_flip': False, 'use_rot': False})
        small = next(iter(DataLoader(data, batch_size=2)))
        opt = _small_train_opt(tmp)
        opt['network_d']['dtype'] = 'bfloat16'
        opt['train']['perceptual_opt']['dtype'] = 'bfloat16'
        step = opt['train']['net_g_pretrain_steps'] + 1
        logs = []
        for where in (dev, 'cpu'):
            small_model = RefRestorationModel(opt, where)
            small_model.feed_data(small)
            small_model.optimize_parameters(step)
            logs.append({k: float(v) for k, v in
                         small_model.log_dict.items()})
            del small_model
    worst = max(abs(logs[0][k] - v) / max(abs(v), 1e-12)
                for k, v in logs[1].items())
    check(logs[0].keys() == logs[1].keys() and worst <= BF16_TRAIN_REL,
          f'options bf16 D and VGG, small model: each log of a GAN step, '
          f'card vs CPU, within {worst:.3g} <= {BF16_TRAIN_REL:g} of its '
          'value')
    return {'ms': round(ms, 3), 'peak_gib': round(peak, 3),
            'f32_ms': round(f32[0], 3), 'f32_peak_gib': round(f32[1], 3),
            'card_vs_cpu_rel': worst}


def _options_bytes(check, dev, card):
    """profile_serving --cost at batch 16, HR 512x336, serving config: the
    byte fields beside the FLOP fields."""
    from c2matching_tpu_torch.scripts.profile_serving import profile
    res = profile(SERVING_BLOCKS, batch=SERVE_BATCH, iters=1, cost=True,
                  device=dev, hr=SERVE_HR)
    keys = [f'{s}_{k}' for s in ('extractor', 'matcher', 'generator')
            for k in ('gflops', 'tflops_per_s', 'hbm_gb', 'hbm_gb_per_s')]
    check(all(k in res for k in keys) and _finite(res.values())
          and all(res[k] > 0 for k in keys), 'options bytes: profile_serving '
          '--cost gives every stage\'s *_gflops and *_hbm_gb, finite')
    print(f'options bytes: profile_serving --cost, serving config, batch '
          f'{SERVE_BATCH}: ' + ', '.join(f'{k} {res.get(k)}' for k in keys)
          + f' ({card})', flush=True)
    torch.cuda.empty_cache()
    return {k: res.get(k) for k in keys}


@contextlib.contextmanager
def _deterministic_cudnn():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def phase_options(check, dev, card, chain_root):
    """The options the port took last: the lmdb data path and its packer,
    train.remat_policy, logger.trace_dir, bf16 D and perceptual VGG, the
    profilers' byte fields. Prints one JSON line."""
    import importlib.util
    chain_out = f'{chain_root}/out'
    store = ('the lmdb package' if importlib.util.find_spec('lmdb')
             else 'the port\'s store c2matching_tpu_torch/utils/lmdb_shim.py '
             '(no lmdb package)')
    out = {'phase': 'options', 'lmdb': {'store': store}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_options_') as root, \
            _deterministic_cudnn():
        out['lmdb']['pack_s'] = round(_options_data(root), 3)
        print(f'options lmdb: packed {OPTIONS_PAIRS} pairs (3 variants each '
              f'of input and ref) in {out["lmdb"]["pack_s"]:.2f} s with '
              f'{store}', flush=True)
        out['lmdb']['host_ms_per_item'] = _options_host_ms(check, root, card)
        batches = _options_lmdb(check, root, chain_out, card, out['lmdb'])
        out['trace'] = _check_trace(check, root)
        out['remat'] = {}
        *f32, state = _options_remat(check, root, chain_out, dev,
                                     batches[-1], card, out['remat'])
        out['bf16_d_vgg'] = _options_bf16(check, root, chain_out, dev,
                                          batches[-1], card, state, f32)
        del state
    out['bytes'] = _options_bytes(check, dev, card)
    out['seconds'] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out), flush=True)


# ----------------------------------------------------------------- extras
# DCNSep at the DynAgg widths at HR 512x384 (no bucket padding), groups 8
EXTRAS_FWD = (('relu3_1', 128, 96, 256), ('relu2_1', 256, 192, 128),
              ('relu1_1', 512, 384, 64))
EXTRAS_BATCH = 9     # stage-3 training's batch at gt 160
# the repair's shapes: (label, module, C, Co, groups, batch, h, w)
EXTRAS_REPAIR = (('DCN group 128', 'DCN', 128, 128, 1, 9, 40, 40),
                 ('DCNv2Module Co 330', 'DCNv2Module', 64, 330, 8, 4, 80, 80))
EXTRAS_CPU_REL = 1e-4  # card vs CPU, of each tensor's largest magnitude: a
                       # DCN module's output and gradients, the x8 output
                       # (cuDNN's convs and the kernels against CPU convs
                       # and the plain versions: sums in other orders)
EXTRAS_LOSS_REL = 1e-4  # card vs CPU of each loss's value: VGG features by
                        # cuDNN and by CPU convs, reduced in other orders
EXTRAS_SR_LR = (120, 80)  # the x8 ensemble's non-square LR input
EXTRAS_SR_BATCH = 2


def _extras_sr_arch():
    """A net built from the ported blocks at nf 64 (conv, 2 spectral-norm
    residual blocks, a DCN of one 64-channel group, 2 BN residual blocks,
    x4 Upsample, conv to RGB), registered as ``ExtrasSR`` so that
    SRModel's define_network builds it."""
    from torch import nn
    from c2matching_tpu_torch.models.archs import ARCHS
    from c2matching_tpu_torch.models.archs import arch_util as au
    from c2matching_tpu_torch.models.archs.dcn_arch import DCN

    class ExtrasSR(nn.Module):
        def __init__(self, nf=64, generator=None):
            super().__init__()
            self.conv_first = au.conv(3, nf, generator)
            self.sn_blocks = nn.ModuleList(
                au.ResidualBlockNoBN(nf, generator, sn=True)
                for _ in range(2))
            with torch.no_grad():
                # sn_bias divides a bias by its norm, which takes no
                # gradient: at a zero bias its gradient is 1e12 times
                # the output's, so the blocks start from a drawn one
                for block in self.sn_blocks:
                    for layer in (block.conv1, block.conv2):
                        layer.bias.normal_(0.0, 0.02, generator=generator)
            self.dcn = DCN(nf, nf, 1, generator)
            with torch.no_grad():   # learned offsets of a few pixels
                self.dcn.conv_offset_mask.weight.normal_(
                    0.0, 0.05, generator=generator)
            self.bn_blocks = nn.ModuleList(
                au.ResidualBlockWithBN(nf, generator) for _ in range(2))
            self.upsample = au.Upsample(4, nf, generator)
            self.conv_last = au.conv(nf, 3, generator)

        def forward(self, x):
            feat = au.lrelu(self.conv_first(x))
            for block in self.sn_blocks:
                feat = block(feat)
            feat = feat + self.dcn(feat)
            for block in self.bn_blocks:
                feat = block(feat)
            return self.conv_last(self.upsample(feat))

    ARCHS['ExtrasSR'] = ExtrasSR


def _rel_err(got, want):
    """max |got - want| over max |want|, ``want`` on the CPU."""
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _dcn_module(kind, c, co, g, gen, offset_std=0.05):
    """A DCN module of the port on the CPU with a seeded init and, where it
    has one, a non-zero conv_offset_mask (learned offsets of a few
    pixels)."""
    from c2matching_tpu_torch.models.archs import dcn_arch
    module = getattr(dcn_arch, kind)(c, co, g, gen)
    if hasattr(module, 'conv_offset_mask'):
        with torch.no_grad():
            module.conv_offset_mask.weight.normal_(0.0, offset_std,
                                                   generator=gen)
            module.conv_offset_mask.bias.normal_(0.0, 0.5, generator=gen)
    return module


def _extras_forward(check, dev, card):
    """DCNSep forward at the DynAgg widths at HR 512x384 (one image, groups
    8): B3's columns against deform_im2col_plain, the module's output
    against the same module on the CPU, one B3 launch a forward; module,
    B3, plain and grid_sample times beside B3's bound."""
    from c2matching_tpu_torch.ops import (deform_conv_fused, deform_im2col,
                                          deform_im2col_plain)
    gen = torch.Generator().manual_seed(21)
    out = {}
    for layer, h, w, c in EXTRAS_FWD:
        label = f'extras DCNSep forward {layer} {h}x{w}x{c}'
        module = _dcn_module('DCNSep', c, c, 8, gen)
        x = torch.randn(1, h, w, c, generator=gen)
        extra = torch.randn(1, h, w, c, generator=gen)
        with torch.no_grad():
            want = module(x, extra)
            module.to(dev)
            xd, ed = x.to(dev), extra.to(dev)
            deform_im2col.launches = deform_conv_fused.launches = 0
            got = module(xd, ed)
            launches = deform_conv_fused.launches
            columns = deform_im2col.launches
            offset, mask = module.offset_mask(ed)
            offset, mask = offset[0].contiguous(), mask[0].contiguous()
        check(launches == 1 and columns == 0, f'{label}: the fused kernel '
              f'launched {launches} time(s), B3 {columns}; 1 and 0 expected')
        err = _b3_compare(check, xd[0], offset, mask, label)
        rel = _rel_err(got, want)
        check(rel <= EXTRAS_CPU_REL, f'{label}: card vs CPU output '
              f'{rel:.3g} <= {EXTRAS_CPU_REL:g} of its largest')
        with torch.no_grad():
            module_ms = cuda_ms(lambda: module(xd, ed))
        b3_ms = cuda_ms(lambda: deform_im2col(xd[0], offset, mask))
        plain_ms = cuda_ms(lambda: deform_im2col_plain(xd[0], offset, mask),
                           min_ms=1.0)
        grid_ms = _b3_library(check, xd[0], offset, mask, label)
        b_ms, b_by = bound(*_b3_work(xd[0], offset, mask), torch.float32)
        out[layer] = {'shape': [h, w, c], 'launches': launches,
                      'module_ms': module_ms, 'b3_ms': b3_ms,
                      'plain_ms': plain_ms, 'grid_sample_ms': grid_ms,
                      'bound_ms': b_ms, 'bound_by': b_by,
                      'max_abs_err': err, 'cpu_rel': rel}
        print(f'{label}: module {module_ms:.4f} ms, B3 {b3_ms:.4f} ms, '
              f'plain {plain_ms:.3f} ms, grid_sample {grid_ms:.4f} ms, '
              f'bound {b_ms:.4f} ms by {b_by}; card vs CPU {rel:.3g} '
              f'({card})', flush=True)
        del module, xd, ed, offset, mask, got, want
        torch.cuda.empty_cache()
    return out


def _extras_backward(check, dev, card):
    """DCNSep forward and backward at batch 9 at the training shapes: the
    x, offset and mask gradients through autograd (one backward launch a
    backward) against deform_conv_backward_plain within phase b3bwd's
    gates; forward and backward ms beside their bounds."""
    from c2matching_tpu_torch.models.archs.dcn_arch import DCNv2Module
    from c2matching_tpu_torch.ops import (deform_conv_backward,
                                          deform_conv_backward_plain,
                                          deform_im2col)
    gen = torch.Generator().manual_seed(22)
    out = {}
    for layer, h, w, c in TRAIN_B3:
        label = f'extras DCNSep batch {EXTRAS_BATCH} {layer} {h}x{w}x{c}'
        module = _dcn_module('DCNSep', c, c, 8, gen).to(dev)
        x = torch.randn(EXTRAS_BATCH, h, w, c, generator=gen).to(dev)
        extra = torch.randn(EXTRAS_BATCH, h, w, c, generator=gen).to(dev)
        grad_out = torch.randn(EXTRAS_BATCH, h, w, c, generator=gen).to(dev)
        with torch.no_grad():
            offset, mask = module.offset_mask(extra)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, offset, mask)]
        deform_im2col.launches = deform_conv_backward.launches = 0
        # the module's deformable conv at those offsets and mask
        y = DCNv2Module.forward(module, *leaves)
        got = torch.autograd.grad(y, leaves, grad_out, retain_graph=True)
        launches = {'forward': deform_im2col.launches,
                    'backward': deform_conv_backward.launches}
        check(launches == {'forward': EXTRAS_BATCH, 'backward': 1},
              f'{label}: launches {launches}, {EXTRAS_BATCH} forward and 1 '
              'backward expected')
        w_kc = module.weight.detach().permute(2, 3, 1, 0).reshape(9 * c, c)
        want = deform_conv_backward_plain(x, offset, mask, grad_out, w_kc)
        errs = {}
        for name, g, wnt, rel in zip(('x', 'offset', 'mask'), got, want,
                                     (B3B_X_REL, B3B_REL, B3B_REL)):
            err = (g - wnt).abs().max().item()
            scale = wnt.abs().max().item()
            errs[name] = err
            check(err <= rel * scale, f'{label}: grad_{name} max |diff| '
                  f'{err:.3g} <= {rel:g} x {scale:.3g}')
        del want
        fwd_ms = cuda_ms(lambda: module(x, extra))
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            y, leaves, grad_out, retain_graph=True))
        kernel_ms = cuda_ms(lambda: deform_conv_backward(
            x, offset, mask, grad_out, w_kc))
        work = [0, 0]
        for i in range(EXTRAS_BATCH):
            one = _b3_work(x[i], offset[i], mask[i])
            work = [a + b for a, b in zip(work, one)]
        fwd_bound, fwd_by = bound(*work, torch.float32)
        bwd_bound, bwd_by = _b3b_bound(*_b3b_work(x, offset, mask, grad_out,
                                                  w_kc))
        out[layer] = {'shape': [EXTRAS_BATCH, h, w, c], 'launches': launches,
                      'forward_ms': fwd_ms, 'backward_ms': bwd_ms,
                      'backward_kernel_ms': kernel_ms,
                      'forward_b3_bound_ms': fwd_bound,
                      'forward_bound_by': fwd_by,
                      'backward_bound_ms': bwd_bound,
                      'backward_bound_by': bwd_by,
                      'max_abs_err': errs}
        print(f'{label}: module forward {fwd_ms:.4f} ms (B3 bound '
              f'{fwd_bound:.4f} by {fwd_by}), autograd backward '
              f'{bwd_ms:.4f} ms, backward kernel with grad_x {kernel_ms:.4f} '
              f'ms (offset and mask bound {bwd_bound:.4f} by {bwd_by}) '
              f'({card})', flush=True)
        del module, x, extra, grad_out, offset, mask, leaves, y, got
        torch.cuda.empty_cache()
    return out


def _extras_repair(check, dev, card):
    """The shapes the backward kernel took in pieces since the repair: a
    group of 128 channels (two sub-groups, one launch) and Co 330 (two
    chunks, two launches). Forward and backward against the plain
    versions on the card and against the same module on the CPU; every
    gradient from the kernel (its launch count, none of the columns'
    route)."""
    from c2matching_tpu_torch.ops import (deform_col2im, deform_conv_backward,
                                          deform_conv_backward_plain,
                                          deform_im2col)
    gen = torch.Generator().manual_seed(23)
    out = {}
    for label, kind, c, co, g, b, h, w in EXTRAS_REPAIR:
        label = f'extras repair {label} ({kind} {c} -> {co}, {g} group(s), ' \
                f'batch {b} at {h}x{w})'
        module = _dcn_module(kind, c, co, g, gen)
        x = torch.randn(b, h, w, c, generator=gen)
        grad_out = torch.randn(b, h, w, co, generator=gen)
        if kind == 'DCNv2Module':
            shift = torch.randint(-3, 4, (b, h, w, 1, 9, 2), generator=gen)
            inputs = [x, shift + 0.5 * torch.randn(b, h, w, g, 9, 2,
                                                   generator=gen),
                      torch.rand(b, h, w, g, 9, generator=gen)]
        else:
            inputs = [x]
        grads = []
        for where in ('cpu', dev):
            mod = module.to(where)
            mod.zero_grad(set_to_none=True)
            leaves = [t.detach().to(where).requires_grad_(True)
                      for t in inputs]
            deform_im2col.launches = deform_conv_backward.launches = 0
            deform_col2im.launches = 0
            y = mod(*leaves)
            y.backward(grad_out.to(where))
            grads.append((y.detach(), [t.grad for t in leaves],
                          {n: p.grad for n, p in mod.named_parameters()}))
        pieces = -(-co // 320)
        launches = {'forward': deform_im2col.launches,
                    'backward': deform_conv_backward.launches,
                    'columns_route': deform_col2im.launches}
        check(launches == {'forward': b, 'backward': pieces,
                           'columns_route': 0},
              f'{label}: launches {launches}, {b} forward, {pieces} backward '
              'and no columns\' route expected')
        (y_cpu, in_cpu, p_cpu), (y_dev, in_dev, p_dev) = grads
        worst = _rel_err(y_dev, y_cpu)
        for name, got, want in (
                [('output', y_dev, y_cpu)]
                + [(f'grad input {i}', a, b_)
                   for i, (a, b_) in enumerate(zip(in_dev, in_cpu))]
                + [(f'grad {n}', p_dev[n], p_cpu[n]) for n in p_cpu]):
            rel = _rel_err(got, want)
            worst = max(worst, rel)
            check(rel <= EXTRAS_CPU_REL, f'{label}: card vs CPU {name} '
                  f'{rel:.3g} <= {EXTRAS_CPU_REL:g} of its largest')
        # the kernel's pieces against the plain backward on the card
        with torch.no_grad():
            xd = x.to(dev)
            if kind == 'DCNv2Module':
                offset, mask = (t.to(dev) for t in inputs[1:])
            else:
                offset, mask = module.offset_mask(xd)
            w_kc = module.weight.detach().permute(2, 3, 1, 0).reshape(
                9 * c, co)
            god = grad_out.to(dev)
            got = deform_conv_backward(xd, offset, mask, god, w_kc)
            want = deform_conv_backward_plain(xd, offset, mask, god, w_kc)
        _b3_compare(check, xd[0], offset[0], mask[0], label)
        errs = {}
        for name, gk, wnt, rel in zip(('x', 'offset', 'mask'), got, want,
                                      (B3B_X_REL, B3B_REL, B3B_REL)):
            err = (gk - wnt).abs().max().item()
            scale = wnt.abs().max().item()
            errs[name] = err
            check(err <= rel * scale, f'{label}: grad_{name} against the '
                  f'plain backward {err:.3g} <= {rel:g} x {scale:.3g}')
        needs = (False, True, True)
        bwd_ms = cuda_ms(lambda: deform_conv_backward(xd, offset, mask, god,
                                                      w_kc, needs=needs))
        plain_ms = cuda_ms(lambda: deform_conv_backward_plain(
            xd, offset, mask, god, w_kc, needs=needs), min_ms=1.0)
        b_ms, b_by = _b3b_bound(*_b3b_work(xd, offset, mask, god, w_kc))
        key = f'{kind}_c{c}_co{co}_g{g}'
        out[key] = {'shape': [b, h, w, c, co, g], 'launches': launches,
                    'backward_ms': bwd_ms, 'plain_ms': plain_ms,
                    'bound_ms': b_ms, 'bound_by': b_by, 'max_abs_err': errs,
                    'cpu_rel': worst}
        print(f'{label}: backward (offset and mask) {bwd_ms:.4f} ms in '
              f'{pieces} launch(es), plain {plain_ms:.3f} ms, bound '
              f'{b_ms:.4f} ms by {b_by}; card vs CPU worst {worst:.3g} '
              f'({card})', flush=True)
        del module, grads, got, want, xd, offset, mask, god
        torch.cuda.empty_cache()
    return out


def _extras_sr(check, dev, card):
    """SRModel on ExtrasSR: test_x8 on a non-square LR 120x80 on the card
    against the CPU (8 x batch B3 launches), and one optimize_parameters
    step card vs CPU (the logs and every gradient)."""
    from c2matching_tpu_torch.models import create_model
    from c2matching_tpu_torch.ops import (deform_conv_backward,
                                          deform_conv_fused, deform_im2col)
    _extras_sr_arch()
    gen = torch.Generator().manual_seed(24)
    h, w = EXTRAS_SR_LR
    lq = torch.rand(EXTRAS_SR_BATCH, h, w, 3, generator=gen)
    opt = {'model_type': 'SRModel', 'is_train': False, 'manual_seed': 3,
           'network_g': {'type': 'ExtrasSR', 'nf': 64}, 'path': {},
           'crop_border': 4, 'val': {'use_x8': True}}
    outs = []
    for where in ('cpu', dev):
        model = create_model(opt, device=where)
        model.feed_data({'img_in_lq': lq})
        deform_im2col.launches = deform_conv_fused.launches = 0
        model.test_x8()
        launches = (deform_conv_fused.launches, deform_im2col.launches)
        outs.append(model.output.cpu())
    check(launches == (8, 0), f'extras SRModel.test_x8: the fused kernel '
          f'and B3 launched {launches} times, (8, 0) expected (a launch a '
          'transform covers the batch)')
    x8_rel = _rel_err(outs[1], outs[0])
    check(outs[1].shape == (EXTRAS_SR_BATCH, 4 * h, 4 * w, 3)
          and bool(torch.isfinite(outs[1]).all()),
          f'extras SRModel.test_x8: output {tuple(outs[1].shape)}, finite')
    check(x8_rel <= EXTRAS_CPU_REL, f'extras SRModel.test_x8 LR {h}x{w} '
          f'batch {EXTRAS_SR_BATCH}: card vs CPU {x8_rel:.3g} <= '
          f'{EXTRAS_CPU_REL:g} of its largest')
    x8_ms = cuda_ms(model.test_x8)
    test_ms = cuda_ms(model.test)
    # one training step, card vs CPU, at LR 40 (gt 160)
    train_opt = dict(opt, is_train=True, train={
        'lr_g': 1e-4, 'pixel_criterion': 'L1Loss', 'pixel_weight': 1.0,
        'lr_scheme': 'MultiStepLR', 'lr_steps': [100]})
    batch = {'img_in_lq': torch.rand(EXTRAS_SR_BATCH, 40, 40, 3,
                                     generator=gen),
             'img_in': torch.rand(EXTRAS_SR_BATCH, 160, 160, 3,
                                  generator=gen)}
    models = []
    for where in ('cpu', dev):
        model = create_model(train_opt, device=where)
        model.feed_data(batch)
        deform_im2col.launches = deform_conv_backward.launches = 0
        model.optimize_parameters(1)
        models.append(model)
    step_launches = {'forward': deform_im2col.launches,
                     'backward': deform_conv_backward.launches}
    check(step_launches == {'forward': EXTRAS_SR_BATCH, 'backward': 1},
          f'extras SRModel step: launches {step_launches}')
    cpu, dev_model = models
    for k, v in cpu.log_dict.items():
        want, got = float(v), float(dev_model.log_dict[k])
        check(abs(got - want) <= TRAIN_CPU_REL * abs(want),
              f'extras SRModel step: {k} card {got:.6g} vs CPU {want:.6g} '
              f'(rel {TRAIN_CPU_REL:g})')
    grads = dict(cpu.net_g.named_parameters())
    top = max(p.grad.abs().max().item() for p in grads.values())
    err = max((p.grad.cpu() - grads[n].grad).abs().max().item()
              for n, p in dev_model.net_g.named_parameters())
    check(err <= TRAIN_CPU_REL * top, f'extras SRModel step: gradients max '
          f'|card - CPU| {err:.3g} <= {TRAIN_CPU_REL:g} x {top:.3g}')

    def step():
        dev_model.optimize_parameters(2)

    step_ms = cuda_ms(step)
    print(f'extras SRModel (ExtrasSR nf 64): test_x8 {x8_ms:.3f} ms, test '
          f'{test_ms:.3f} ms at LR {h}x{w} batch {EXTRAS_SR_BATCH}; a '
          f'training step {step_ms:.3f} ms at LR 40 batch '
          f'{EXTRAS_SR_BATCH} ({card})', flush=True)
    del models, cpu, dev_model
    torch.cuda.empty_cache()
    return {'x8_launches': launches, 'x8_cpu_rel': x8_rel, 'x8_ms': x8_ms,
            'test_ms': test_ms, 'step_launches': step_launches,
            'step_ms': step_ms, 'step_grad_err': err}


def _extras_losses(check, dev, card):
    """The losses no config calls and deform_psroi_pooling, card vs CPU,
    at batch 9, gt 160; each call's ms on the card, its inputs there
    already."""
    import copy
    from c2matching_tpu_torch.models import losses
    from c2matching_tpu_torch.ops import deform_psroi_pooling
    gen = torch.Generator().manual_seed(25)
    b, s = EXTRAS_BATCH, 160
    od, gs, ps = 8, 7, 7
    inp = {k: torch.rand(b, s // f, s // f, c, generator=gen)
           for k, f, c in (('relu1_1', 1, 64), ('relu2_1', 2, 128),
                           ('relu3_1', 4, 256))}
    inp.update({f'w_{k}': torch.rand(b, v.shape[1] - 2, v.shape[2] - 2, 1,
                                     generator=gen)
                for k, v in list(inp.items())})
    corner = torch.rand(128, 2, generator=gen) * (s - 40)
    size = 8 + torch.rand(128, 2, generator=gen) * 30
    inp.update(
        x=torch.rand(b, s, s, 3, generator=gen),
        gt=torch.rand(b, s, s, 3, generator=gen),
        stack=torch.rand(b, 2, s, s, 3, generator=gen),
        stack_gt=torch.rand(b, 2, s, s, 3, generator=gen),
        mask=(torch.rand(b, s, s, 1, generator=gen) > 0.3).float(),
        score=torch.randn(s // 4, s // 4, od * gs * gs, generator=gen),
        rois=torch.cat([torch.zeros(128, 1), corner, corner + size], 1),
        offsets=torch.randn(128, 2, 2, ps, ps, generator=gen))
    layers = ('relu1_1', 'relu2_1', 'relu3_1')
    gen_vgg = torch.Generator().manual_seed(26)
    calls = {
        'TextureLoss': (
            losses.TextureLoss(use_weights=True, generator=gen_vgg),
            lambda m, t: m(t['x'], {k: t[k] for k in layers},
                           {k: t[f'w_{k}'] for k in layers})),
        'MapLoss': (losses.MapLoss(criterion='l1', generator=gen_vgg),
                    lambda m, t: m({k: t[k] for k in layers}, t['gt'])),
        'PerceptualLossMultiInputs': (
            losses.PerceptualLossMultiInputs(
                {'relu1_1': 1.0, 'relu2_1': 1.0}, criterion='fro',
                style_weight=1.0, use_input_norm=False, generator=gen_vgg),
            lambda m, t: sum(m(t['stack'], t['stack_gt']))),
        'MaskedTVLoss': (losses.MaskedTVLoss(0.5),
                         lambda m, t: m(t['x'], t['mask'])),
        'deform_psroi_pooling': (
            None, lambda m, t: deform_psroi_pooling(
                t['score'], t['rois'], t['offsets'], od, gs, ps,
                spatial_scale=0.25, trans_std=0.1, sample_per_part=4)),
    }
    on_dev = {k: v.to(dev) for k, v in inp.items()}
    out = {}
    for name, (module, fn) in calls.items():
        mod = (copy.deepcopy(module).to(dev)
               if isinstance(module, torch.nn.Module) else module)
        with torch.no_grad():
            want = fn(module, inp)
            got = fn(mod, on_dev)
            ms = cuda_ms(lambda: fn(mod, on_dev))
        rel = _rel_err(got, want)
        check(rel <= EXTRAS_LOSS_REL and bool(torch.isfinite(got).all()),
              f'extras {name} batch {b} gt {s}: card vs CPU {rel:.3g} <= '
              f'{EXTRAS_LOSS_REL:g}')
        out[name] = {'ms': ms, 'cpu_rel': rel}
        print(f'extras {name}: {ms:.3f} ms, card vs CPU {rel:.3g} ({card})',
              flush=True)
        del mod, got
    del on_dev
    torch.cuda.empty_cache()
    return out


def phase_extras(check, dev, card):
    """The off-path pieces on the card: the DCN modules on B3 and its
    backward at any group width and Co, SRModel's x8 ensemble and step,
    the remaining losses and deform_psroi_pooling. Prints one JSON
    line."""
    t0 = time.perf_counter()
    out = {'phase': 'extras', 'card': card,
           'dcnsep_forward': _extras_forward(check, dev, card),
           'dcnsep_train': _extras_backward(check, dev, card),
           'repair': _extras_repair(check, dev, card),
           'sr_model': _extras_sr(check, dev, card),
           'losses': _extras_losses(check, dev, card)}
    out['seconds'] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out), flush=True)


# ------------------------------------------------------------------ serve
SERVE_BATCH = 16     # profile_serving's default batch, at HR 512x336
SERVE_HR = (512, 336)
SERVE_ITERS = 3      # timed calls of each stage per config
SERVE_E2E_PAIRS = 2 * SERVE_BATCH   # a warm flush, then the measured one
SERVE_E2E_HW = (332, 500)           # a CUFED5 input's size
SERVE_CLI_STEPS = 1  # uint8 steps between a PNG served at batch 2 and its
                     # batch-1 twin (the bound of tests/test_serve_cli.py)
EXPORT_BATCH = 2
EXPORT_TOL = 1e-5    # the loaded artifact vs the in-process forward: the
                     # same kernels on the same inputs in another process
# the JAX scripts' JSON keys (scripts/bench_train.py, profile_train.py);
# the byte fields count the port's own way (utils/prof.py::ByteCounter)
BENCH_KEYS = {'metric', 'value', 'unit', 'samples_per_sec'}
GATE_ITERS = 10      # bench_train --decompose's iterations in its own
                     # process, as the pin's runs took them
PROFILE_TRAIN_KEYS = (
    {'batch', 'gt_size', 'fetch_overhead_ms', 'phase_sum_net_ms',
     'phase_sum_samples_per_s'}
    | {f'{p}_{k}' for p in ('match', 'g_forward', 'loss_head', 'g_step',
                            'd_step')
       for k in ('ms', 'ms_net', 'gflops', 'tflops_per_s', 'hbm_gb',
                 'hbm_gb_per_s')})
# loads the exported artifact in a fresh interpreter that cannot import the
# port's model code, runs it on the saved inputs on the card and saves the
# output; prints the kernels' launch counts
EXPORT_LOADER = '''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.startswith('c2matching_tpu_torch.models'):
            raise ImportError(f'{name} is blocked for this run')
        return None
sys.meta_path.insert(0, Block())
import torch
import c2matching_tpu_torch.ops as ops
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
artifact, inputs, out = sys.argv[1:]
program = torch.export.load(artifact)
args = [t.cuda() for t in torch.load(inputs)]
with torch.no_grad():
    result = program.module()(*args)
torch.save(result.cpu(), out)
assert not any(m.startswith('c2matching_tpu_torch.models')
               for m in sys.modules)
print('launches', ops.match_argmax.launches, ops.deform_conv_fused.launches)
'''


def _run_in(pool, cmd):
    """Run ``cmd`` from the checkout's root with the checkout on the path,
    in a thread of ``pool``: a future of (CompletedProcess, seconds)."""
    import os
    import os.path as osp
    here = osp.dirname(osp.abspath(__file__))

    def run():
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=here),
                              timeout=600)
        return proc, time.perf_counter() - t0

    return pool.submit(run)


def _json_line(text):
    """The last line of ``text`` that holds a JSON object, parsed."""
    lines = [line for line in text.splitlines() if line.startswith('{')]
    return json.loads(lines[-1]) if lines else {}


def _finite(values):
    return all(math.isfinite(v) for v in values
               if isinstance(v, (int, float)))


def _serve_cli(check, card, root, pool):
    """`python -m c2matching_tpu_torch.scripts.serve` in the serving config
    on the eval sets (3 synth pairs at 160, the CUFED5-shaped pair) at
    batch 2 (a full flush and a padded partial one on the synth set) and at
    batch 1, the two processes at once: the same files, every PNG within
    one uint8 step of its twin."""
    import os
    import re
    import numpy as np
    from c2matching_tpu_torch.utils import png
    _eval_data(root)
    path = f'{root}/serve.yml'
    with open(path, 'w') as f:
        f.write(_eval_options(EVAL_OPTIONS[1][1], root, _eval_weights(root),
                              ('synth', 'cufed')))
    outs = {b: f'{root}/served_b{b}' for b in (2, 1)}
    runs = {b: _run_in(pool, [sys.executable, '-m',
                              'c2matching_tpu_torch.scripts.serve', '-opt',
                              path, '--batch', str(b), '--out', outs[b]])
            for b in outs}
    for batch, run in runs.items():
        proc, wall = run.result()
        if not check(proc.returncode == 0, f'serve --batch {batch}: exit '
                     f'{proc.returncode}'):
            print((proc.stdout + proc.stderr)[-3000:], flush=True)
            return
        with open(f'{outs[batch]}/serve.log') as f:
            log = f.read()
        for n, s, rate in re.findall(r'(\d+) images in ([\d.]+)s '
                                     r'end-to-end \(([\d.]+) img/s', log):
            print(f'serve --batch {batch}: {n} images in {s} s end to end, '
                  f'{rate} images/s (decode, bicubic chain, card, PNG '
                  'encode; serving config; beside the other serve and the '
                  f'export\'s loading process) ({card})', flush=True)
        print(f'serve --batch {batch}: the command {wall:.1f} s (process '
              'start, model build, both sets)', flush=True)
    for name in ('synth', 'cufed'):
        files = {b: sorted(os.listdir(f'{outs[b]}/{name}')) for b in outs}
        check(files[2] == files[1] and len(files[2]) == (3 if name == 'synth'
                                                         else 1),
              f'serve {name}: batch 2 and batch 1 write {files[2]} and '
              f'{files[1]}')
        worst = 0
        for fname in files[2]:
            imgs = []
            for b in (2, 1):
                with open(f'{outs[b]}/{name}/{fname}', 'rb') as f:
                    imgs.append(png.decode(f.read()).astype(np.int16))
            worst = max(worst, int(np.abs(imgs[0] - imgs[1]).max()))
        check(worst <= SERVE_CLI_STEPS, f'serve {name}: every PNG at batch 2 '
              f'within {worst} <= {SERVE_CLI_STEPS} uint8 step of batch 1')


def _serve_e2e(check, dev, card, root):
    """serve.py's loop in process, in the serving config, on 32 generated
    CUFED5-sized pairs at batch 16: one flush to warm up, then one flush
    (taking its items from the prefetching stream, the host's decode and
    bicubic chain, the forward, the PNG encode) under torch.profiler: its
    end-to-end images/s and the device's busy share of it."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from torch.profiler import ProfilerActivity, profile
    from c2matching_tpu_torch.data import create_dataset
    from c2matching_tpu_torch.models import create_model
    from c2matching_tpu_torch.scripts import make_synth_dataset as synth
    from c2matching_tpu_torch.scripts import serve
    from c2matching_tpu_torch.utils import dict_to_nonedict, get_root_logger
    from c2matching_tpu_torch.utils.options import parse
    synth.write_dataset(f'{root}/e2e/synth', n=SERVE_E2E_PAIRS,
                        size=SERVE_E2E_HW)
    path = f'{root}/e2e.yml'
    with open(path, 'w') as f:
        f.write(_eval_options(EVAL_OPTIONS[1][1], f'{root}/e2e', {}, ()))
    opt = dict_to_nonedict(parse(path, is_train=False))
    model = create_model(opt, dev)
    dataset = create_dataset(opt['datasets']['test_1'])
    out = f'{root}/e2e/out'
    os.makedirs(out)
    logger = get_root_logger()
    with ThreadPoolExecutor(max_workers=2) as pool:
        stream = serve._prefetched(dataset, len(dataset), pool,
                                   window=2 * SERVE_BATCH)
        flushes = serve.bucket_batches(stream, SERVE_BATCH)
        t0 = time.perf_counter()
        serve._flush(model, *next(flushes), out, SERVE_BATCH, logger)
        warm = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n = serve._flush(model, *next(flushes), out, SERVE_BATCH, logger)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, 'is_user_annotation', False))
    check(n == SERVE_BATCH and len(os.listdir(out)) == SERVE_E2E_PAIRS,
          f'serve e2e: {len(os.listdir(out))} PNGs written')
    print(f'serve e2e, serving config, batch {SERVE_BATCH} of '
          f'{SERVE_E2E_HW[0]}x{SERVE_E2E_HW[1]} pairs: the first flush '
          f'{warm:.2f} s (cuDNN plans); the second {1e3 * wall:.1f} ms, '
          f'{n / wall:.2f} images/s end to end, {device_us / 1e3:.1f} ms of '
          f'kernels ({100 * device_us / 1e6 / wall:.1f}% busy, '
          f'{100 - 100 * device_us / 1e6 / wall:.1f}% idle) ({card})',
          flush=True)


def _b1_batch_compare(check, q, r, bias, label):
    """One launch of the kernel over the whole batch against the plain
    version image by image (an image's f32 scores are Nq x Nr); returns
    the max |value difference|."""
    from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain
    idx_k, val_k = match_argmax(q, r, bias)
    err = 0.0
    n_clear = n_same = n_rows = n_far = n_excluded = 0
    for i in range(q.shape[0]):
        scores = torch.matmul(q[i].float(), r[i].float().mT)
        if bias is not None:
            scores = scores + bias
        idx_p, val_p = match_argmax_plain(q[i:i + 1], r[i:i + 1], bias)
        top2 = scores.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > B1_GAP_TOL
        same = idx_k[i] == idx_p[0]
        picked = scores.gather(-1, idx_k[i].long()[:, None])[:, 0]
        n_clear += int(clear.sum())
        n_same += int((same | ~clear).sum())
        n_rows += clear.numel()
        n_far += int(((picked - val_p[0]).abs() > B1_GAP_TOL).sum())
        if bias is not None:
            n_excluded += int((bias[idx_k[i].long()] != 0).sum())
        err = max(err, (val_k[i] - val_p[0]).abs().max().item())
        del scores, top2
    check(n_same == n_rows, f'b1 {label}: indices equal on the {n_clear} of '
          f'{n_rows} rows with top-2 gap > {B1_GAP_TOL:g} (one launch for '
          f'the batch, the plain version image by image)')
    check(n_far == 0 and n_excluded == 0, f'b1 {label}: every picked index '
          f'scores within {B1_GAP_TOL:g} of the max ({n_far} not), no '
          f'excluded row wins ({n_excluded})')
    check(err <= B1_VAL_TOL, f'b1 {label}: max |val diff| {err:.3g} <= '
          f'{B1_VAL_TOL:g}')
    torch.cuda.empty_cache()
    return err


def _serve_flush_kernels(check, seen, cfg, dtype, card):
    """B1's batch launch and one flush's B3 launches (each DynAgg, every
    image) against their plain versions; their times, library times and
    bounds at the batch's shapes."""
    from c2matching_tpu_torch.ops import (deform_im2col, deform_im2col_plain,
                                          match_argmax, match_argmax_plain)
    name = str(dtype).replace('torch.', '')
    q, r, bias = seen['b1'][0]
    check(tuple(q.shape) == tuple(r.shape) == (SERVE_BATCH,) + PATH_B1[1:]
          and q.dtype == dtype and bias is None,
          f'serve {cfg}: B1 gets q {tuple(q.shape)} {q.dtype}, the ref rows '
          f'{tuple(r.shape)}, ref_bias {bias}')
    label = f'batch {q.shape[0]} {q.shape[1]}x{r.shape[1]}x{q.shape[2]} {name}'
    b1 = {'max_abs_err': _b1_batch_compare(check, q, r, bias, label)}
    b1['ms'] = cuda_ms(lambda: match_argmax(q, r, bias))
    b1['plain_ms'] = cuda_ms(lambda: match_argmax_plain(q, r, bias))
    b1['library_ms'] = _b1_library_ms(q, r, bias)
    scratch = _b1_call_peak(q, r, bias)
    moved, ops = _b1_work(q, r, bias)
    b1['bound_ms'], b1['bound_by'] = (
        bound(moved, B1_TF32_PRODUCTS * ops, 'tf32')
        if dtype == torch.float32 else bound(moved, ops, dtype))
    print(f'b1 {label}: kernel {b1["ms"]:.3f} ms, plain {b1["plain_ms"]:.3f}'
          f' ms, torch.matmul + max {b1["library_ms"]:.3f} ms, bound '
          f'{b1["bound_ms"]:.3f} ms by {b1["bound_by"]}; the call adds '
          f'{scratch / 2**30:.3f} GiB (outputs and scratch) ({card})',
          flush=True)
    del q, r, bias
    seen['b1'].clear()
    torch.cuda.empty_cache()

    shapes = sorted(tuple(d[0].shape) for d in seen['b3'])
    check(shapes == sorted((SERVE_BATCH,) + s for s in PATH_B3)
          and all(d[0].dtype == dtype for d in seen['b3']),
          f'serve {cfg}: one flush hands B3 x {shapes} {dtype}')
    # the fused kernel that serves the flush, on its very arguments
    b3f = _path_fused(check, seen['b3'], name, card,
                      where=f'serve batch {SERVE_BATCH}', plain=False)
    print(f'b3f serve {cfg}: the flush\'s three launches {b3f["ms"]:.3f} ms '
          f'against the columns route {b3f["library_ms"]:.3f} ms ({card})',
          flush=True)
    worst, bad, moved, ops, lib_ms = 0.0, 0, 0, 0, 0.0
    for x, offset, mask, _, _ in seen['b3']:
        for i in range(x.shape[0]):
            cols = deform_im2col(x[i], offset[i], mask[i]).float()
            if dtype == torch.float32:
                err = (cols - deform_im2col_plain(x[i], offset[i], mask[i]))
                bad += int((err.abs() > B3_F32_TOL).sum())
            else:
                # against the unrounded f32 columns of the same bf16 input,
                # as phase path holds them
                exact = deform_im2col_plain(x[i].float(), offset[i],
                                            mask[i])
                err = cols - exact
                bad += int((err.abs() > B3_BF16_REL * exact.abs()
                            + B3_F32_TOL).sum())
                del exact
            worst = max(worst, err.abs().max().item())
            work = _b3_work(x[i], offset[i], mask[i])
            moved, ops = moved + work[0], ops + work[1]
            del cols, err
        if dtype == torch.float32:
            # grid_sample's time on image 0, for each image of the batch
            lib_ms += x.shape[0] * _b3_library(
                check, x[0], offset[0], mask[0],
                'serve batch {} {}x{}x{} image 0'.format(*x.shape, name))
        torch.cuda.empty_cache()
    tol = (f'{B3_F32_TOL:g}' if dtype == torch.float32 else
           f'{B3_BF16_REL:g}|v| + {B3_F32_TOL:g} of the f32 columns')
    check(bad == 0, f'b3 serve {cfg}: the flush\'s '
          f'{len(seen["b3"]) * SERVE_BATCH} launches within {tol} of the '
          f'plain version ({bad} columns not; max |diff| {worst:.3g})')

    def flush(fn):
        return lambda: [fn(x[i], o[i], m[i]) for x, o, m, _, _ in seen['b3']
                        for i in range(x.shape[0])]

    b3 = {'ms': cuda_ms(flush(deform_im2col)),
          'plain_ms': cuda_ms(flush(deform_im2col_plain), min_ms=1.0),
          'max_abs_err': worst,
          'library_ms': lib_ms if dtype == torch.float32 else None}
    b3['bound_ms'], b3['bound_by'] = bound(moved, ops, torch.float32)
    # the events bracket 48 calls in a row, the host's dispatch between
    # them included; the profiler sums the kernels alone
    device_ms = _profiled_ms(flush(deform_im2col), 'mdc_im2col', reps=3)
    print(f'b3 serve {cfg}: one batch-{SERVE_BATCH} flush '
          f'({len(seen["b3"]) * SERVE_BATCH} launches): kernel '
          f'{b3["ms"]:.3f} ms by events, {device_ms:.3f} ms of kernels by '
          f'the profiler, plain {b3["plain_ms"]:.3f} ms, grid_sample '
          + (f'{lib_ms:.3f} ms' if dtype == torch.float32 else 'not timed')
          + f', bound {b3["bound_ms"]:.3f} ms by '
          f'{b3["bound_by"]} ({card})', flush=True)
    seen['b3'].clear()
    torch.cuda.empty_cache()
    return b1, b3, b3f


def _serve_profile(model, card, top=10):
    """A batch-16 serving forward (feed_data done) under torch.profiler:
    the largest kernels by device time and the device's busy share of the
    forward's host clock."""
    from torch.profiler import ProfilerActivity, profile
    model.test()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.test()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    device_us = sum(e.self_device_time_total for e in events)
    print(f'serve profile, one batch-{SERVE_BATCH} serving forward: '
          f'{1e3 * wall:.1f} ms host clock, {device_us / 1e3:.1f} ms of '
          f'kernels ({100 * device_us / 1e6 / wall:.1f}% busy) ({card})',
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f'  {e.self_device_time_total / 1e3:8.2f} ms  {e.count:5d} x  '
              f'{e.key[:90]}', flush=True)


def _serve_batch(check, dev, report, card):
    """Batch-16 serving at HR 512x336, full width, in both configs:
    profile_serving's stage times, peak memory and launches; then one
    serving forward at that batch whose B1 and B3 launches are held
    against their plain versions (and, in the serving config, traced)."""
    from c2matching_tpu_torch.models import RefRestorationModel
    from c2matching_tpu_torch.ops import (deform_conv_fused, deform_im2col,
                                          match_argmax)
    from c2matching_tpu_torch.scripts.profile_serving import profile
    gen = torch.Generator(device=dev).manual_seed(5)
    for cfg, blocks, dtype in (('serving', SERVING_BLOCKS, torch.bfloat16),
                               ('f32', F32_BLOCKS, torch.float32)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        match_argmax.launches = deform_im2col.launches = 0
        deform_conv_fused.launches = 0
        out = profile(blocks, batch=SERVE_BATCH, iters=SERVE_ITERS,
                      device=dev, hr=SERVE_HR)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = (match_argmax.launches, deform_conv_fused.launches,
                    deform_im2col.launches)
        calls = SERVE_ITERS + 1
        check(launches == (calls + 1, len(PATH_B3) * calls, 0),
              f'serve {cfg} batch {SERVE_BATCH}: match_argmax launched '
              f'{launches[0]} times (a batch each), deform_conv_fused '
              f'{launches[1]} (a DynAgg each), deform_im2col {launches[2]}')
        check(_finite(out.values()), f'serve {cfg}: profile_serving finite')
        print(f'serve {cfg} batch {SERVE_BATCH} HR {SERVE_HR[0]}x'
              f'{SERVE_HR[1]}, profile_serving: '
              + ', '.join(f'{k} {out[k]}' for k in (
                  'extractor_ms', 'matcher_ms', 'generator_ms',
                  'total_net_ms', 'net_img_per_s', 'fetch_overhead_ms'))
              + f'; peak {peak:.2f} GiB ({card})', flush=True)
        report[f'serve_{cfg}'] = dict(out, peak_gib=peak)

        model = RefRestorationModel(blocks, dev,
                                    torch.Generator().manual_seed(0))
        reqs = [_request(gen, dev, *SERVE_HR) for _ in range(SERVE_BATCH)]
        model.feed_data({k: torch.cat([q[k] for q in reqs])
                         for k in reqs[0]})
        del reqs
        model.test()                        # warm at the batch's shapes
        with _record_kernel_inputs() as seen:
            model.test()
        res = model.cropped_output()
        check(tuple(res.shape) == (SERVE_BATCH,) + SERVE_HR + (3,)
              and bool(torch.isfinite(res).all()),
              f'serve {cfg}: batch-{SERVE_BATCH} output {tuple(res.shape)} '
              'finite')
        del res
        if cfg == 'serving':
            _serve_profile(model, card)
        model.batch = model.output = None
        b1, b3, b3f = _serve_flush_kernels(check, seen, cfg, dtype, card)
        report[f'serve_b1_{cfg}'], report[f'serve_b3_{cfg}'] = b1, b3
        report[f'serve_b3f_{cfg}'] = b3f
        del model, seen
        torch.cuda.empty_cache()


def _dispatch_us(dev, card, calls=500):
    """Host time per call of each operator's wrapper (through
    ``torch.ops``, the registered operator) against the operator's own
    Python body called directly, on small inputs whose kernels are short:
    the dispatcher's cost per call. Interleaved op, body, body, op."""
    pm = importlib.import_module('c2matching_tpu_torch.ops.patch_match_kernel')
    dc = importlib.import_module('c2matching_tpu_torch.ops.deform_conv')
    gen = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(1, 256, 64, generator=gen, device=dev)
    r = torch.randn(1, 256, 64, generator=gen, device=dev)
    x, offset, mask = _dcn_inputs(gen, dev, 16, 16, 64, torch.float32)
    conv = ([3, 3], [1, 1], [1, 1], [1, 1])
    pairs = {
        'match_argmax': (lambda: pm.match_argmax(q, r),
                         lambda: pm._match_argmax_op._init_fn(q, r, None)),
        'deform_im2col': (
            lambda: dc.deform_im2col(x, offset, mask),
            lambda: dc._deform_im2col_op._init_fn(x, offset, mask, *conv))}
    for name, (op, body) in pairs.items():
        times = {'op': [], 'body': []}
        for kind in ('op', 'body', 'body', 'op'):
            fn = op if kind == 'op' else body
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[kind].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        print(f'dispatch {name}: {min(times["op"]):.1f} us a call through '
              f'torch.ops, {min(times["body"]):.1f} us for the operator\'s '
              f'body alone (host clock, best of two runs of {calls}) '
              f'({card})', flush=True)


def _serve_export(check, dev, card, root, pool):
    """export_serving of the serving config at batch 2, HR 512x336; the
    .pt2 loaded in a fresh process that cannot import the model code, run
    there on the same inputs (in a thread of ``pool``). Returns the
    function that waits for that process and holds its output against the
    in-process forward."""
    import os
    from c2matching_tpu_torch.models import RefRestorationModel
    from c2matching_tpu_torch.scripts.export_serving import (
        build_serving_fn, export_serving)
    model = RefRestorationModel(SERVING_BLOCKS, dev,
                                torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    program = export_serving(model, EXPORT_BATCH, *SERVE_HR)
    export_s = time.perf_counter() - t0
    artifact = f'{root}/serving_b{EXPORT_BATCH}.pt2'
    torch.export.save(program, artifact)
    mb = os.path.getsize(artifact) / 1e6
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == 'call_function']
    n_ops = (targets.count('c2matching.match_argmax.default'),
             targets.count('c2matching.deform_conv_fused.default'),
             targets.count('c2matching.deform_im2col.default'))
    check(n_ops == (1, len(PATH_B3), 0), f'export: the graph calls '
          f'c2matching::match_argmax {n_ops[0]}, '
          f'c2matching::deform_conv_fused {n_ops[1]} (one a DynAgg for the '
          f'batch) and c2matching::deform_im2col {n_ops[2]} times')
    del program
    gen = torch.Generator(device=dev).manual_seed(9)
    reqs = [_request(gen, dev, *SERVE_HR) for _ in range(EXPORT_BATCH)]
    inputs = [torch.cat([q[k] for q in reqs])
              for k in ('img_in_up', 'img_ref', 'img_in_lq')]
    with torch.no_grad():
        direct = build_serving_fn(model)(*inputs)
    torch.save([t.cpu() for t in inputs], f'{root}/inputs.pt')
    direct = direct.cpu()
    del model
    torch.cuda.empty_cache()
    run = _run_in(pool, [sys.executable, '-c', EXPORT_LOADER, artifact,
                         f'{root}/inputs.pt', f'{root}/loaded.pt'])
    print(f'export serving config, batch {EXPORT_BATCH}, HR {SERVE_HR[0]}x'
          f'{SERVE_HR[1]}: torch.export {export_s:.1f} s, artifact '
          f'{mb:.1f} MB ({card})', flush=True)

    def finish():
        proc, load_s = run.result()
        if not check(proc.returncode == 0, f'export: load and run in a '
                     f'fresh process without the model code (exit '
                     f'{proc.returncode})'):
            print((proc.stdout + proc.stderr)[-3000:], flush=True)
            return
        counts = [line.split()[1:] for line in proc.stdout.splitlines()
                  if line.startswith('launches')]
        check(bool(counts) and all(int(n) > 0 for n in counts[-1]),
              f'export: the loaded program launched B1 and B3F {counts}')
        loaded = torch.load(f'{root}/loaded.pt')
        err = (loaded - direct).abs().max().item()
        check(tuple(loaded.shape) == (EXPORT_BATCH,) + SERVE_HR + (3,)
              and err <= EXPORT_TOL, f'export: loaded artifact vs '
              f'in-process forward, max |diff| {err:.3g} <= {EXPORT_TOL:g}')
        print(f'export: the loading process {load_s:.1f} s (start, load, '
              'one run; beside the two serve processes)', flush=True)

    return finish


def _bench_gate(check, card):
    """`python -m c2matching_tpu_torch.scripts.bench_train --stage 3
    --decompose` as a user runs it (its own process, torch's default TF32
    settings, as utils/bench_gate.py's pin was taken): the decomposed
    step and its gate line against the pin."""
    import os
    import os.path as osp
    here = osp.dirname(osp.abspath(__file__))
    cmd = [sys.executable, '-m', 'c2matching_tpu_torch.scripts.bench_train',
           '--stage', '3', '--decompose', '--iters', str(GATE_ITERS)]
    proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=here))
    lines = [line for line in proc.stderr.splitlines()
             if line.startswith(('decompose', 'WARNING'))]
    check(proc.returncode == 0 and any(
        line.startswith('decompose gate: ') for line in lines),
        f'bench_train --stage 3 --decompose (own process): exit '
        f'{proc.returncode}, a decompose gate line')
    for line in lines + [json.dumps(_json_line(proc.stdout))]:
        print(f'bench_train --stage 3 --decompose --iters {GATE_ITERS} (own '
              f'process): {line} ({card})', flush=True)


def _serve_train_tools(check, card):
    """bench_train (stage 3 GAN, stage 1) and profile_train at full width
    through their CLIs' main(), in process: one JSON line each with the
    JAX version's keys and finite values; then bench_train's gate."""
    import io
    from c2matching_tpu_torch.ops import deform_conv_backward
    from c2matching_tpu_torch.scripts import bench_train, profile_train
    runs = ((bench_train.main, ['--stage', '3', '--iters', '3'], BENCH_KEYS),
            (bench_train.main, ['--stage', '1', '--iters', '3'], BENCH_KEYS),
            (profile_train.main, ['--iters', '2'], PROFILE_TRAIN_KEYS))
    for main_fn, argv, keys in runs:
        tool = main_fn.__module__.rsplit('.', 1)[-1]
        deform_conv_backward.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main_fn(argv)
        out = _json_line(buf.getvalue())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(set(out) == keys and _finite(out.values()),
              f'{tool} {" ".join(argv)}: one JSON line with the JAX '
              f'version\'s keys, finite')
        if argv[:2] == ['--stage', '3']:
            check(deform_conv_backward.launches > 0, f'{tool} stage 3: '
                  f'deform_conv_backward launched '
                  f'{deform_conv_backward.launches} times')
        print(f'{tool} {" ".join(argv)}: {json.dumps(out)}; peak '
              f'{peak:.2f} GiB ({card})', flush=True)
    torch.cuda.empty_cache()
    _bench_gate(check, card)


def phase_serve(check, dev, report, card):
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    with tempfile.TemporaryDirectory(prefix='chip_smoke_serve_') as root, \
            ThreadPoolExecutor(max_workers=3) as pool:
        # the export's loading process and the two serve processes run at
        # once; nothing is timed in this process meanwhile
        t0 = time.perf_counter()
        finish_export = _serve_export(check, dev, card, root, pool)
        _serve_cli(check, card, root, pool)
        finish_export()
        t1 = time.perf_counter()
        _serve_e2e(check, dev, card, root)
        _serve_batch(check, dev, report, card)
        _dispatch_us(dev, card)
        t2 = time.perf_counter()
    _serve_train_tools(check, card)
    print(f'serve phase seconds: export and CLI processes {t1 - t0:.1f}, '
          f'e2e, batch {SERVE_BATCH} and dispatch {t2 - t1:.1f}, training '
          f'tools {time.perf_counter() - t2:.1f}', flush=True)

def main():
    if len(sys.argv) > 1:
        sys.exit(f'chip_smoke.py takes no arguments, got {sys.argv[1:]}')
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py: torch.cuda.is_available() is False; this '
                 'script needs a CUDA card')
    from c2matching_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('TF32 off: torch.backends.cudnn.allow_tf32 = False, '
          'torch.backends.cuda.matmul.allow_tf32 = False')
    dev = torch.device('cuda', 0)
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}', flush=True)

    check = Checks()
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f'kernels built in {time.perf_counter() - t0:.1f} s '
          f'({", ".join(logs) or "cached"})', flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    report = {}
    recorded = {}
    # phase contras trains stages 1 and 2 here; phase train reads stage 2's
    # student from it
    chain = tempfile.TemporaryDirectory(prefix='chip_smoke_chain_')
    with chain as chain_root:
        for name, fn in (
                ('b1', lambda: phase_b1(check, dev)),
                ('b3', lambda: phase_b3(check, dev)),
                ('b3f', lambda: phase_b3f(check, dev, report, card)),
                ('b2', lambda: phase_b2(check, dev, card)),
                ('epilogue', lambda: phase_epilogue(check, dev, report)),
                ('main', lambda: phase_main(check, dev, report, card,
                                            recorded)),
                ('path', lambda: phase_path(check, report, recorded, card)),
                ('eval', lambda: phase_eval(check, card)),
                ('b3bwd', lambda: phase_b3_backward(check, dev, card)),
                ('contras', lambda: phase_contras(check, dev, report, card,
                                                  chain_root)),
                ('train', lambda: phase_train(check, dev, report, card,
                                              chain_root)),
                ('train_cpu', lambda: phase_train_cpu(check, dev)),
                ('dist', lambda: phase_dist(check, dev, report, card,
                                            chain_root)),
                ('spatial', lambda: phase_spatial(check, dev, card)),
                ('options', lambda: phase_options(check, dev, card,
                                                  chain_root)),
                ('extras', lambda: phase_extras(check, dev, card)),
                ('serve', lambda: phase_serve(check, dev, report, card))):
            try:
                fn()
            except Exception as exc:  # a phase fails; the others still run
                check(False, f'{name} raised {type(exc).__name__}: {exc}')

    if check.failed:
        print(f'{len(check.failed)} check(s) failed:', *check.failed,
              sep='\n  ')
        sys.exit(1)

    # f32 numbers; B1 and B3 launch on the main path, B2 in the windowed
    # op's run on the main path's DynAgg tensors (phase path), B3's backward
    # in the training run, timed on one iteration's tensors (phase train)
    launches = dict(report['main_f32_launches'],
                    window_contract=report['b2_float32'].pop('launches'),
                    deform_conv_backward=report['train_launches'][
                        'deform_conv_backward'])
    kernels = []
    for name, key, source, replaces in (
            ('match_argmax', 'b1', 'c2matching_tpu_torch/csrc/patch_match.cu',
             'c2matching_tpu/ops/pallas/patch_match_kernel.py:81'),
            ('deform_im2col', 'b3', 'c2matching_tpu_torch/csrc/deform_conv.cu',
             'c2matching_tpu/ops/deform_conv.py:214'),
            ('deform_conv_fused', 'b3f',
             'c2matching_tpu_torch/csrc/deform_conv_fused.cu',
             'c2matching_tpu/ops/deform_conv.py:214 with its contraction'),
            ('window_contract', 'b2',
             'c2matching_tpu_torch/csrc/dcn_window.cu',
             'c2matching_tpu/ops/pallas/dcn_window_kernel.py:125'),
            ('deform_conv_backward', 'b3bwd',
             'c2matching_tpu_torch/csrc/deform_conv_backward.cu',
             'c2matching_tpu/ops/deform_conv.py:214'),
            ('conv_epilogue', 'epilogue',
             'c2matching_tpu_torch/csrc/conv_epilogue.cu',
             'none: an XLA fusion of the conv output on the TPU')):
        kernels.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': launches[name],
                        **report[f'{key}_float32']})
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
