"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels of ``pccf_torch`` from
``pccf_torch/csrc`` and holds each against its plain PyTorch version on the
card at every shape the main path gives it, and times both beside the least
time the card could take for the same work (``pccf_torch.kernels.roofline``)
and, where one PyTorch call computes the same function, that call.  Then it
drives the three parts of the main path with the flagship model (random
weights from ``--seed``, the composed configuration unmodified, graph
filtering on):

- serving: counterfactual requests of 1, 5, 16, 20 and 64 clouds through
  ``pccf_torch.serve.CounterfactualServer`` with its default buckets (1 to
  64), checked for shapes, finiteness, batch invariance (the first request
  again inside the batches of 16, 20 and 64), one batch a request in
  ``stats``, the exact launches of every kernel and agreement with the same
  model on the CPU; then ``submit`` x 5 and ``flush`` against
  ``counterfactual`` on the same batch, a ``flush`` on a second thread while
  submits land, four ``counterfactual_async`` requests of 16 in flight
  (bit-equal to the synchronous ones, their host buffers pinned; the host
  clock of the four pipelined against four sequential) and ``warmup`` over
  every bucket (``stats`` as they were);
- generation: ``CounterfactualServer.generate`` at 1, 16 and 70 clouds
  (chunks of 64 and 6), without and with ``probs``, and the entry point
  ``pccf_torch.generate.generate_random_samples`` at its batch of 16 with a
  bias on z1, each chunk launching the W-decoder stack, PCGen and graph
  filtering once and nothing else; determinism per seed and chunk, the three
  kernels against their plain versions at generation's batches 1, 16 and 64
  (the W-decoder with a z1 of one row broadcast over the code tokens and of
  a row per code), the card against the CPU on the same host draws, warm
  latency at batch 1 and 16 and one profiled batch-16 call;
- stage-1 training: VQ-VAE steps through ``pccf_torch.train.Trainer``
  (batch 8, 2048 points, AdamW at lr 0.004) on a fixed batch of synthetic
  clouds under each reconstruction objective (ChamferEMD, the flagship's,
  then Chamfer and ChamferSinkhorn, each + embedding loss), checked for
  finite and falling losses and for the launches of that objective's loss
  kernel alone, and one step at batch 2 and 512 points against the same step
  on the CPU under each; then the entry point
  ``pccf_torch.train.autoencoder.train_autoencoder`` under Chamfer and
  ChamferSinkhorn for 2 epochs of 16 clouds (validation, the codebook hook
  after every epoch, the final test);
- stage-2 training: ``pccf_torch.train.w_autoencoder.train_w_autoencoder``
  for one epoch on codes derived from 64 clouds (derived dataset, two steps
  of batch 32, validation, final test, merge back), then W-autoencoder steps
  on one derived batch (finite losses, falling MSE) and a validation pass
  over two batches, whose W-nets run their transformer stacks through the
  ``wformer`` kernels; one step at a small width against the CPU; and the
  counterfactual route with the fused CVAE gate failing, against the CPU;
- classifier training: DGCNN classifier steps through ``Trainer`` (batch 16
  of spheres and boxes, 2048 points, SGD at lr 0.01, dropout on), each
  launching the streaming-BN EdgeConv kernels of its blocks at k = 20 and
  nothing else (step time, samples/s, peak memory, a profile), one step at
  batch 2 and 512 points against the CPU (dropout 0), and the entry point
  ``pccf_torch.train.classifier.train_classifier`` for 2 epochs of 32 clouds
  (validation, the final test's logits, confusion matrix, misclassified);
- the five evaluation suites: ``pccf_torch.evaluate_counterfactuals.
  evaluate_counterfactuals`` over 186 clouds (86 spheres, 100 boxes: the
  flagship's ModelNet desk / table test split) with the entry point's
  classifier and the flagship VQ-VAE, each suite's metrics and seconds, the
  launches of every kernel equal to what the suites' structure implies
  (``suite_launch_counts``), one profiled counterfactual chunk of 64; then
  the suites on 8 clouds of 512 points on the card against the CPU (the
  original classification equal but at argmax near-ties, a derived suite's
  accuracy apart only by clouds whose codes differ or whose prediction sits
  at a near-tie);
- the model variants of the experiment tree (``variant_configs``), each the
  flagship with one override: A the LDGCNN encoder (requests of 1 and 16,
  ChamferEMD steps at 8 x 2048, one step at 2 x 512 against the CPU), B the
  convolutional W-encoder and the linear W-decoder (stage-2 steps at 32,
  requests), C the VampPrior with 16 pseudo-inputs (stage-2 steps,
  generation at 16), D an encoder activation of GELU (steps through the
  neighbour gather and its backward, the row scatter), E a corner of the
  tuning spaces (requests: heads of 8, 32 and 128, FF widths 137, 1000 and
  700, PCGen 500-300-77 with a map of 200 on the general PCGen kernel,
  LDGCNN pools at 17 and 130 channels); each request's and step's launches
  exact and each path's card output against the CPU; before them the
  widened kernels at those shapes against their plain versions: E's stacks,
  the general PCGen kernel, the pools at 17, 130 and 511 channels, the
  gather and the row scatter at D's (8, 2048, 25, F), and the kernels
  widened past JAX's last limits: ``pcgen_general`` at 5 and 6 component
  layers and the attention at heads of 256 and 512 (d = 512);
- the experiment's own entry points (``cli_phase``): the five ``main``s of
  ``pccf_torch`` run in this process on the card from the experiment tree,
  the flagship model at 2048 points on ``data/dataset=synthetic`` (64 train
  and 32 test clouds of 4096 points), epochs cut to 4 (the classifier,
  early stopping at patience 1), 2 (stage 1) and 2 (stage 2); each stage's
  seconds, epoch times and launches, every checkpoint reloaded to the same
  eval output, a stage-1 resume bit-equal to the same epoch run on in
  memory (in default mode), and the compiled batch assembler against its
  numpy version;
- tuning and the dataset readers (``tuning_and_readers_phase``), at the CLI
  phase's sizes: ``tune_autoencoder`` (3 trials of the learning space, one
  of the decoder's) and ``tune_w_autoencoder`` (2 trials over the CLI
  phase's models), each trial's launches those of its stage's entry point,
  the sqlite studies read back; the ModelNet reader's kNN precompute at the
  desk / table split's 778 clouds of 2048 points against the plain kNN
  (and the reader on h5 files it writes where ``h5py`` imports, else its
  refusal); a PC15k tree it writes, the stage-1 and classifier entry points
  on it with 0 and 2 loader worker processes (stage 1 bit-equal), and the
  first epoch's batches through the workers bit-equal to the in-process
  ones.

Each path must have launched every kernel it runs (launch counts set to 0
just before the path and read just after); every stage-1 step also the
exact counts of the kernels graph filtering's fused pass took over
(``STEP_LAUNCHES``), serving (``REQUEST_LAUNCHES`` a request), generation
(``GENERATION_KERNELS`` once a chunk), every classifier step and the suites
the exact counts of all kernels.  A profiled stage-1 step whose trace
holds fewer launches of a kernel than its wrapper counted (``torch.profiler``
loses records) is traced again, up to three traces in all.

Graph filtering's fused pass (``graph_filter``, forward, and
``graph_filter_backward``, its backward with the row scatter) at every shape
the paths give it: serving's batch 1, 5 and 16, stage 1's 8 and the card-vs-
CPU step's (2, 512), and a cloud with duplicated points; its indices equal
``knn_cuda(x, 4)``'s, its output, mean and gradient held to the plain
versions and the same on a second call, its plan (``graph_filter.filter_plan``)
equal to the library's, each timed beside the chain it replaced (kNN, the
gather and the eager tail; autograd through the gather and the tail
backward).

kNN is checked and timed at serving's batch 1, 5 and 16, at stage 1's 8, at
stage 2's 32 and at the suites' chunks of 64 and 58; at batch 1 the kernel
splits each cloud's candidates across blocks (its lists held equal to the
unsplit ones); the fused PCGen at batch 1, 16, 64 and 58, the CVAE chain and
the W-nets' stacks at 64, 58 and 1, graph filtering at 64 and 58; the
classifier step's pools and scatters at batch 16, k = 20.  The graph
max-pool at serving's batch 1, 5 and 16, stage 2's 32, the suites' 64 and 58,
the sum-pool at stage 1's widths: each beside its plan's channel slice and
centre ranges (``gather.pool_plan``, held equal to the kernel library's) and
the times in the other slice widths, every width bit-equal to the plan's; the
sum-pool also bit-equal to the sum in slot order on the CPU, on every call.
The training max-pool with its winning slot at stage 1's widths, bit-exact to
the strict > rule (``ops.graph_max_pool_slots_strict``) on rows with NaNs,
ties and a hub row; its slot scatter bit-equal to its plain version on the
CPU and the same on a second call, its plan (``gather.slot_scatter_plan``,
held equal to the library's) timed beside the other slice widths and row
splits, each bit-equal to the plan's.

Before the kernel table it prints a line for every shape at which the
stacks' device kernels run (``pccf_gemm`` and ``pccf_attention``, recorded
from the W-encoder, W-decoder and the batch-16 and batch-1 CVAE chains):
the check against the float64 product or attention, the time per launch,
the plain version's, the one-call PyTorch yardstick's and the bound; then the
weight split that feeds the GEMM (``pccf_tf32_split``) on the real weights of
the W-encoder, the W-decoder and the CVAE pack, bit-exact against its plain
version.

    python3 chip_smoke.py [--seed 0]

The row scatter, the EMD, the nearest-neighbour kernel and the Sinkhorn
kernel are also held bit-equal across two calls, the row scatter bit-equal to
its plain version run on the CPU (both add in ascending edge order), and one
EMD call's and one Sinkhorn call's device launches are read from a trace: 19
and 25 pair sweeps.  The nearest-neighbour kernel runs its plan's column
splits (``chamfer.nn_plan``); the Sinkhorn kernel's sweeps' grids
(``sinkhorn.sweep_plan``) are held equal to the library's, and its time is
printed beside the special-function floor of its schedule; an empty
kernel's time is printed as the launch floor.

It also prints the compiler's registers and spills of the row scatter's,
the EMD's, the graph pools', the slot scatter's, the nearest-neighbour and the
Sinkhorn kernels on one line, a
``torch.profiler`` table of one batch-16 request, of one training step of
each stage (stage 1 under each objective, with its device busy time, both
the sum of its activities' durations and the union of their intervals, and
the device time of the row scatter's, the loss kernel's, the sum-pool's, the
training max-pool's and the slot scatter's launches, their count checked
against the wrapper calls) and of one validation batch, the
warm request latency at batch 1 and 16, the step time, samples/s and peak
memory of both stages and of the classifier, the warm request latency at
bucket 32 and 64, the host time of a bucket-64 chunk's draws, the warm
generation latency at batch 1 and 16 and its device busy time, the seconds of each
entry-point run, the validation time per batch, the suites' seconds and the
total seconds of the run, the numbers PERF.md quotes.

Kernel times are medians over samples of many back-to-back calls between
one pair of CUDA events, queued behind a spin kernel so that the host's
dispatch stays out of them (``time_ms``).

Prints the card's name and power limit, one JSON line with the kernels, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing
no result, when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# Kineto tears CUPTI down at the end of each profiler session and sets it up
# again at the next, and a session after such a turnover can see none or
# only some of its device launches (tools/torch_profiler_sessions.py: 9 of
# 192 sessions short with the teardown, 0 of 192 without, on an H100); the
# launch counts read from traces need every launch, so CUPTI stays up.  Read
# when a session ends.
os.environ['TEARDOWN_CUPTI'] = '0'

REPS = 10  # timed samples per kernel and version; the median is reported
SAMPLE_MS = 2.0  # the least device time of the back-to-back calls of one sample
MAX_CALLS = 500  # back-to-back calls of one sample at most
SPIN_CYCLES_PER_MS = 2e6  # the spin kernel's clock cycles per ms (SM clock at most ~2 GHz)

# tolerances, each with its reason
# distances in 3xTF32 (C > 16) or fp32 FMA, summed in another order than the
# plain version's: near-ties at the k-th slot may swap
KNN_SET_AGREEMENT = 0.999
# the kernel rounds the component weights and their products' inputs to fp16
# (the join, h before each later layer; the layer-0 residual reads the fp16
# join) where the TPU kernel rounds to bf16, sums in fp32.  It reads ~3e-4;
# 1e-2 is the bound every PCGen kernel of the port has met, bf16 included
# (~4e-3).  RECON_REL_L2 is the check that bf16 failed, and the card tests
# hold the kernel to fp16's precision (2e-3)
PCGEN_REL_L2 = 1e-2
CVAE_REL_L2 = 1e-3  # 3xTF32 products: about fp32 rounding, through 8 transformer layers
CODE_AGREEMENT = 0.99  # VQ argmin on card vs CPU
# the stacks' GEMM against the float64 product and epilogue: 3xTF32 drops the
# small-small term (~2^-22 of each product), the tensor cores sum each 32-wide
# k tile and the tiles add in fp32; one TF32 product alone misses by ~3e-4
GEMM_REL_L2 = 5e-6
ATTENTION_REL_L2 = 1e-5  # the same products, and the online softmax rescales its fp32 sums
RECON_REL_L2 = 1e-2  # the decode runs the fp16 PCGen kernel on the card
BATCH_INVARIANCE = 1e-4  # rel. max difference of a request alone vs inside a batch
# |diff| / max |plain|: the plain row scatter's reduction on the card may take
# its own order; the kernel adds in ascending edge order, the order of the
# plain version on the CPU, which it equals bit for bit (and the slot scatter,
# in ascending centre order, its own plain version on the CPU)
SCATTER_REL_MAX = 1e-5
SUM_POOL_REL_MAX = 1e-5  # the kernel adds the k rows in slot order, the plain reduction in its own
EMD_COST_RTOL = 1e-4  # exp2 of the folded level and the row and column sums in another order than the plain version's
EMD_GRAD_REL_L2 = 1e-3  # the same, through nine levels of remaining mass
# Sinkhorn: K recomputed in every sweep as the TPU kernel's folded exp2
# (ex2.approx, 2 ulp) with the scalings added in its exponent, the middle
# sweeps' exponent from the expanded distances |x|^2 - 2 x.y + |y|^2 (the JAX
# golden's rounding), and the sums over the pairs taken in another order,
# through twelve updates of each scaling; its Chamfer minima and argmins, like
# nn_distance's, bit-exact (the same float32 squared distances, the lowest
# index on ties)
SINKHORN_COST_RTOL = 1e-4
SINKHORN_GRAD_REL_L2 = 1e-3
# graph filtering's fused pass against the plain version on its own indices
# (which equal knn_cuda's): expf's ulp and the per-cloud mean summed in
# another order (|diff| / max |plain|); the gradient through the same rows,
# then the row scatter in ascending edge order (rel-L2)
FILTER_REL_MAX = 1e-5
FILTER_GRAD_REL_L2 = 1e-5
# one training step on the card against the same step on the CPU: EMD
# recomputes its exps, cuBLAS and the CPU add
# GEMM terms in other orders, and a kNN neighbour or VQ code at a near-tie may
# differ between the two
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_REL_L2 = 1e-2  # per parameter
STEP_UPDATE_REL_L2 = 1e-2  # the AdamW update of all trained parameters together
# one stage-2 step at a small width, card against CPU: no discrete choice
# feeds the loss, so the losses and gradients differ by GEMM summation order
# only; the quantisation accuracy counts argmin choices, which a near-tie may
# flip; AdamW's first step moves each element by about lr * sign(g)
W_STEP_LOSS_RTOL = 1e-4
W_STEP_ACCURACY_ATOL = 0.01  # 1% of the code slots
W_STEP_GRAD_REL_L2 = 1e-3  # per parameter

# as the attention key biases (rounding_gradient), the classifier's
# final_conv BatchNorm shift: it moves every point's feature, so the max and
# the mean, by the same amount, which the head's BatchNorm takes out again
CLASSIFIER_ZERO_GRADIENT = 'final_conv.bn.bias'


def rounding_gradient(name: str, n_conv: int = 0) -> bool:
    """Attention key biases shift every score of a row by the same amount,
    and the BatchNorm shifts of the convolutional W-encoder (``n_conv``
    layers) before its last layer are taken off again by the next Dense +
    BatchNorm, with no activation between: their gradient is zero but for
    rounding and its sign is noise, so they are left out of the
    per-parameter gradient, update and clipper comparisons."""
    conv = re.fullmatch(r'wae\.encoder\.conv\.(\d+)\.bn\.bias', name)
    return name.endswith('key.bias') or (conv is not None and int(conv.group(1)) < n_conv - 1)


KERNEL_INFO = {
    'knn': ('pccf_torch/csrc/knn.cu', 'pccf/kernels/pallas_knn.py:183'),
    'graph_max_pool': ('pccf_torch/csrc/graph_max_pool.cu', 'pccf/kernels/pallas_gather.py:218'),
    'pcgen_mix': ('pccf_torch/csrc/pcgen_mix.cu', 'pccf/kernels/pallas_pcgen.py:133'),
    'pcgen_general': ('pccf_torch/csrc/pcgen_general.cu', 'pccf/kernels/pallas_pcgen.py:133'),
    'cvae_cf': ('pccf_torch/csrc/wformer.cu', 'pccf/kernels/pallas_cvae.py:203'),
    'gather_neighbors': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:309'),
    'scatter_add_rows': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:182'),
    'graph_max_pool_src': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:121'),
    'scatter_add_slots': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:200'),
    'graph_sum_pool': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:256'),
    'chamfer_match_cost': ('pccf_torch/csrc/emd.cu', 'pccf/kernels/pallas_emd.py:218'),
    'wformer_encoder': ('pccf_torch/csrc/wformer.cu', 'pccf/kernels/pallas_wformer.py:335'),
    'wformer_decoder': ('pccf_torch/csrc/wformer.cu', 'pccf/kernels/pallas_wformer.py:365'),
    'nn_distance': ('pccf_torch/csrc/nn_distance.cu', 'pccf/kernels/pallas_chamfer.py:78'),
    'sinkhorn_cost': ('pccf_torch/csrc/sinkhorn.cu', 'pccf/kernels/pallas_sinkhorn.py:163'),
    'graph_filter': ('pccf_torch/csrc/graph_filter.cu', 'pccf/kernels/pallas_gather.py:309'),
    'graph_filter_backward': ('pccf_torch/csrc/graph_filter.cu', 'pccf/kernels/pallas_gather.py:341'),
}
SERVING_KERNELS = ('knn', 'graph_max_pool', 'pcgen_mix', 'cvae_cf', 'graph_filter')
# every stage-1 step launches these, and the kernel of its reconstruction loss
TRAINING_KERNELS = ('knn', 'graph_filter', 'graph_filter_backward', 'scatter_add_rows', 'graph_max_pool_src',
                    'scatter_add_slots', 'graph_sum_pool')
# the exact launches of one request (one bucket): 4 kNN graphs and 4
# max-pools each in the encoder and the classifier, the CVAE chain, PCGen and
# graph filtering once, nothing else; a stage-1 step builds the encoder's 4
# graphs, filters once and scatters 7 times (4 sum-pool backwards, the
# filter's backward, the Chamfer term's backward in each direction)
REQUEST_LAUNCHES = {'knn': 8, 'graph_max_pool': 8, 'cvae_cf': 1, 'pcgen_mix': 1, 'graph_filter': 1}
STEP_LAUNCHES = {'knn': 4, 'gather_neighbors': 0, 'graph_filter': 1, 'graph_filter_backward': 1,
                 'scatter_add_rows': 7}
LOSS_KERNELS = {'ChamferEMD': 'chamfer_match_cost', 'Chamfer': 'nn_distance', 'ChamferSinkhorn': 'sinkhorn_cost'}
ENTRY_TRAIN, ENTRY_TEST, ENTRY_EPOCHS = 16, 8, 2  # the stage-1 entry point's clouds and epochs
# the evaluation suites: 186 test clouds (ModelNet desk / table's test split,
# 86 + 100) in chunks of 64 give the derived datasets chunks of 64 and 58
SUITE_CLASS_COUNTS = (86, 100)
SUITE_CHUNKS = (64, 58)
# the suites on the card against the CPU: the card decodes through the fp16
# PCGen kernel (rel-L2 ~3e-4 of the CPU's) and classifies in another
# summation order, so a prediction may flip where its two logits are this close
SUITE_TIE_MARGIN = 0.05
# a classifier step: each EdgeConv block (four in the flagship) builds its kNN
# graph (k = 20), sum-pools [u, u^2] for its batch statistics and max-pools
# with the winning slot; backward, the slot scatter and the sum-pool's row
# scatter; a block launches each of these once and nothing else launches
CLASSIFIER_STEP_KERNELS = ('knn', 'graph_sum_pool', 'graph_max_pool_src', 'scatter_add_slots', 'scatter_add_rows')
CLASSIFIER_TRAIN, CLASSIFIER_TEST = 32, 16  # the classifier entry point's clouds (2 epochs, cut from 45)
STAGE2_KERNELS = ('knn', 'graph_max_pool', 'wformer_encoder', 'wformer_decoder')
# generation: each chunk runs the W-decoder stack on the prior's draws, then
# PCGen and graph filtering, once each, and nothing else; server.generate at
# these sizes (70: chunks of 64 and of 6 at bucket 8), without and with probs,
# then the entry point with this bias on z1
GENERATION_KERNELS = ('wformer_decoder', 'pcgen_mix', 'graph_filter')
GENERATION_SIZES = (1, 16, 70)
GENERATION_BIAS = 0.5
# the model variants of the experiment tree, each the flagship with one
# override (variant_configs): A the LDGCNN encoder, B the convolutional
# W-encoder and the linear W-decoder, C the VampPrior with this many
# pseudo-inputs (no configuration ships a value; the JAX tests take 3), D an
# encoder activation of GELU, E a corner of the tuning spaces
VAMP_PSEUDO_INPUTS = 16
# a request of one bucket on a variant: the classifier's 4 kNN graphs and 4
# max-pools besides the model's; A's LDGCNN builds one graph and pools 4
# times, E's 3 times; B's and E's W-nets fail the chain's gate and run their
# transformer stacks alone
VARIANT_REQUEST_LAUNCHES = {
    'A': {'knn': 5, 'graph_max_pool': 8, 'cvae_cf': 1, 'pcgen_mix': 1, 'graph_filter': 1},
    'B': {'knn': 8, 'graph_max_pool': 8, 'wformer_encoder': 1, 'pcgen_mix': 1, 'graph_filter': 1},
    'E': {'knn': 5, 'graph_max_pool': 7, 'wformer_encoder': 2, 'wformer_decoder': 1, 'pcgen_general': 1,
          'graph_filter': 1},
}
# a ChamferEMD stage-1 step: A's one graph, its EdgeConv's sum-pool and 4
# training max-pools; D's three GELU EdgeConvs on the gather (whose backward
# is the row scatter) after a streaming first block; both scatter the
# Chamfer term's gradient twice
VARIANT_STEP_LAUNCHES = {
    'A': {'knn': 1, 'graph_sum_pool': 1, 'graph_max_pool_src': 4, 'scatter_add_slots': 4, 'scatter_add_rows': 4,
          'graph_filter': 1, 'graph_filter_backward': 1, 'chamfer_match_cost': 1},
    'D': {'knn': 4, 'graph_sum_pool': 1, 'graph_max_pool_src': 1, 'scatter_add_slots': 1, 'gather_neighbors': 3,
          'scatter_add_rows': 7, 'graph_filter': 1, 'graph_filter_backward': 1, 'chamfer_match_cost': 1},
}
# a chunk of generation under the VampPrior: the W-encoder on the
# pseudo-inputs, then what every chunk runs
VAMP_GENERATION_LAUNCHES = {'wformer_encoder': 1, 'wformer_decoder': 1, 'pcgen_mix': 1, 'graph_filter': 1}
DEEP_PCGEN_DIMS = ((1024, 512, 256, 128, 64, 16), (1024, 512, 256, 128, 64, 32, 16))  # 5 and 6 layers
WIDE_HEADS = (2, 1)  # heads over d = 512: 256 and 512 wide
CLI_OVERRIDES = ('data/dataset=synthetic', 'autoencoder.train.n_epochs=2', 'w_autoencoder.train.n_epochs=2',
                 'classifier.train.n_epochs=4', 'classifier.train.early_stopping.patience=1')
RESUME_RUNS = 3  # the resume check's in-memory runs
# the tuning phase: trials of each entry point's learning space, at the CLI
# phase's sizes
TUNE_TRIALS, TUNE_W_TRIALS = 3, 2
# the ModelNet reader's kNN precompute at the desk / table train split's size
# (modelnet40_hdf5_2048: 778 clouds of 2048 points), k = data.n_neighbors
MODELNET_SPLIT, MODELNET_CHUNK = (778, 2048, 25), 64
# the PC15k tree chip_smoke writes: (train, val, test) clouds of 15000 points
# of the two synsets of data/dataset=shapenet
SHAPENET_CLOUDS, SHAPENET_POINTS = {'bench': (12, 4, 4), 'sofa': (12, 4, 4)}, 15000
LOADER_WORKERS = 2
CLI_STAGE_KERNELS = {  # the kernels each entry point must launch
    'classifier': ('knn', 'graph_max_pool', 'graph_sum_pool', 'graph_max_pool_src', 'scatter_add_slots',
                   'scatter_add_rows'),
    'autoencoder': ('knn', 'graph_max_pool', 'pcgen_mix', 'graph_filter', 'graph_filter_backward',
                    'scatter_add_rows', 'chamfer_match_cost'),
    'w_autoencoder': ('knn', 'graph_max_pool', 'wformer_encoder', 'wformer_decoder'),
    'evaluate_counterfactuals': ('knn', 'graph_max_pool', 'pcgen_mix', 'cvae_cf', 'graph_filter', 'wformer_encoder',
                                 'wformer_decoder'),
    'generate': ('wformer_decoder', 'pcgen_mix', 'graph_filter'),
}
# the tuning corner's graph pools and the widths off four channels checked beside them
ODD_POOL_WIDTHS = (17, 130, 511)
TRAIN_BATCH, WARM_STEPS, TIMED_STEPS = 8, 2, 10
STEPS_PER_EPOCH = 100  # the timed steps stay in epoch 0: lr 0.004 (stage 1), 0.0014 / 6 (stage 2, warmup)
VALIDATION_REPS = 3


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm((got - want).double()) / (torch.linalg.norm(want.double()) + 1e-30))


def time_ms(fn, reps: int) -> float:
    """Median device time of one call over ``reps`` samples.  A sample is as
    many back-to-back calls as span ``SAMPLE_MS`` (at most ``MAX_CALLS``)
    between one pair of CUDA events, divided by their count; a spin kernel
    queued before the first event lasts as long as the host takes to enqueue
    them, so the events see device time and not the host's dispatch."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    calls = int(min(MAX_CALLS, max(1, math.ceil(SAMPLE_MS / max(start.elapsed_time(end), 1e-3)))))
    times = []
    for _ in range(reps):
        torch.cuda._sleep(int(2 * calls * host_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def device_events(prof) -> list[tuple[str, float, float]]:
    """``(name, start us, end us)`` of every device activity of a
    ``torch.profiler`` trace, in the order they started."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.start, e.time_range.end) for e in events]


def summed_ms(events: list[tuple[str, float, float]]) -> float:
    """The activities' durations summed."""
    return sum(end - start for _, start, end in events) / 1e3


def busy_ms(events: list[tuple[str, float, float]]) -> float:
    """The time at least one of the activities runs: overlapping intervals
    counted once (a kernel launched programmatically shows from its launch,
    its wait for the kernel before included, so its duration overlaps the
    one before)."""
    busy, reach = 0.0, float('-inf')
    for _, start, end in events:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy / 1e3


def short_kernel_name(name: str) -> str:
    """A device kernel's name without its namespace, return type and arguments."""
    m = re.search(r'(\w+(?:<[^()]*>)?)\(', name)
    return m.group(1) if m else name


EMD_PAIR_SWEEPS = 19  # rows P1 of -4^7, then per level columns P2 and rows P3 (+ P1 of the next level)
SINKHORN_PAIR_SWEEPS = 25  # the build, 12 v passes and 11 u passes in turn, the final rows sweep
SINKHORN_MUFU_PER_PAIR = 27  # an ex2 a pair in each sweep, an rsqrt in the two final ones
MUFU_PER_CLOCK = 16  # special-function results a clock an SM (Hopper)
# torch.profiler loses device records in about 1 stage-1 step session in 40
# with CUPTI kept up (PERF.md §7): a step trace short of a kernel's launches
# is taken again, up to this many traces in all
TRACE_ATTEMPTS = 3
# the port kernels whose device time the stage-1 steps sum: the pattern of
# their device kernels' names, and how many of those one wrapper call launches
# (the scatter: partition, lists, gather; the EMD: 2 fills, the sweeps, the
# per-sample sum, which sinkhorn.cu launches too; the nearest neighbours: the
# fold and the combine; the sum-pool: one)
DEVICE_NAMES = {'scatter_add_rows': (r'scatter_(partition|lists|gather)_kernel', 3),
                'chamfer_match_cost': (r'emd_(fill|rows|cols)_kernel|sample_sum_kernel', EMD_PAIR_SWEEPS + 3),
                'nn_distance': (r'nn_(fold|combine)_kernel', 2),
                'sinkhorn_cost': (r'sinkhorn_(build|sweep)_kernel|sample_sum_kernel', SINKHORN_PAIR_SWEEPS + 1),
                'graph_sum_pool': (r'slice_pool_kernel<[^>]*PoolSum>', 1),
                'graph_max_pool_src': (r'slice_pool_kernel<[^>]*PoolMaxSlot>', 1),
                'scatter_add_slots': (r'slot_scatter_kernel', 1),
                'graph_filter': (r'filter_(search|finish)_kernel', 2),
                'graph_filter_backward': (r'filter_grad_(partial|rows)_kernel', 2)}


class LaunchLog:
    """Stands in for the kernel library while a path runs: forwards every
    entry point and records its name and arguments (host pointer arrays read
    out as lists)."""

    def __init__(self, lib) -> None:
        self.lib, self.calls = lib, []

    def __getattr__(self, name: str):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append((name, [list(a) if isinstance(a, ctypes.Array) else a for a in args]))
            return fn(*args)

        return call


def launch_shapes(build, run) -> list[tuple]:
    """The distinct shapes at which ``run`` launches ``pccf_gemm`` (``('gemm',
    M, N, K, groups, bias, gelu, res_rows or 0, out aliases res)``) and
    ``pccf_attention`` (``('attention', B, T, T_kv, heads, head_dim)``), in
    order of first launch."""
    real = build.lib
    log = LaunchLog(real())
    build.lib = lambda: log
    try:
        run()
        torch.cuda.synchronize()
    finally:
        build.lib = real
    shapes = []
    for name, args in log.calls:
        if name == 'pccf_gemm':
            _, groups, ops, res, m, n, k, res_rows, gelu, _ = args
            key = ('gemm', m, n, k, groups, all(ops[2 * groups: 3 * groups]), bool(gelu), res_rows if res else 0,
                   res == ops[3 * groups])
        elif name == 'pccf_attention':
            key = ('attention', *args[7:12])
        else:
            continue
        if key not in shapes:
            shapes.append(key)
    return shapes


def knn_check(x: torch.Tensor, k: int, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(neighbour-set agreement, max |sorted kernel distances − sorted plain
    distances|), the distances recomputed in float64 from the indices."""
    agree = (got.long().unsqueeze(-1) == want.long().unsqueeze(-2)).any(-1).float().mean().item()
    xd = x.double()

    def dists(idx):
        nb = torch.gather(xd, 1, idx.long().reshape(x.shape[0], -1, 1).expand(-1, -1, x.shape[2]))
        d = ((nb.reshape(*idx.shape, -1) - xd[:, :, None, :]) ** 2).sum(-1)
        return torch.sort(d, dim=-1).values

    return agree, float((dists(got) - dists(want)).abs().max())


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


@torch.no_grad()
def library_stack(pack: list[dict], n_heads: int, decoder: bool) -> torch.nn.Module:
    """The same stack as PyTorch's own ``nn.TransformerEncoder`` /
    ``nn.TransformerDecoder`` (pre-norm, exact GELU, eps 1e-6, no dropout),
    every layer's FF zero-padded to the widest: the yardstick timed as
    ``library_ms``, which the port never calls."""
    from torch import nn

    d = pack[0]['wo'].shape[0]
    f_max = max(p['w1'].shape[0] for p in pack)
    dev = pack[0]['wo'].device
    layer_cls = nn.TransformerDecoderLayer if decoder else nn.TransformerEncoderLayer
    layer = layer_cls(d, n_heads, f_max, dropout=0.0, activation='gelu', layer_norm_eps=1e-6, batch_first=True,
                      norm_first=True)
    stack = nn.TransformerDecoder(layer, len(pack)) if decoder else nn.TransformerEncoder(
        layer, len(pack), enable_nested_tensor=False)

    def load_attn(attn, p, prefix):
        attn.in_proj_weight.copy_(torch.cat([p[f'w{prefix}{n}'] for n in 'qkv']))
        attn.in_proj_bias.copy_(torch.cat([p[f'b{prefix}{n}'] for n in 'qkv']))
        attn.out_proj.weight.copy_(p[f'w{prefix}o'])
        attn.out_proj.bias.copy_(p[f'b{prefix}o'])

    def load_norm(norm, p, name):
        norm.weight.copy_(p[f'{name}_w'])
        norm.bias.copy_(p[f'{name}_b'])

    stack = stack.to(dev)
    for mod, p in zip(stack.layers, pack):
        load_attn(mod.self_attn, p, '')
        load_norm(mod.norm1, p, 'ln1')
        if decoder:
            load_attn(mod.multihead_attn, p, 'x')
            load_norm(mod.norm2, p, 'lnx')
            load_norm(mod.norm3, p, 'ln2')
        else:
            load_norm(mod.norm2, p, 'ln2')
        f = p['w1'].shape[0]
        for lin in (mod.linear1, mod.linear2):
            lin.weight.zero_()
        mod.linear1.bias.zero_()
        mod.linear1.weight[:f].copy_(p['w1'])
        mod.linear1.bias[:f].copy_(p['b1'])
        mod.linear2.weight[:, :f].copy_(p['w2'])
        mod.linear2.bias.copy_(p['b2'])
    return stack.eval()


def variant_configs(cfg):
    """Paths A-E: the flagship configuration with one override each."""
    ae, wae = cfg.autoencoder, cfg.w_autoencoder
    rep = dataclasses.replace

    def with_ae(**kw):
        return rep(cfg, autoencoder=rep(ae, **kw))

    def with_wae(**kw):
        return rep(cfg, w_autoencoder=rep(wae, **kw))

    from pccf_torch import config as pc

    corner = rep(cfg, autoencoder=rep(ae, encoder=rep(ae.encoder, class_name='LDGCNN', conv_dims=(17, 130, 511)),
                                      decoder=rep(ae.decoder, conv_dims=(500, 300, 77), map_dims=(200,),
                                                  sample_dim=32)),
                 w_autoencoder=rep(wae, w_decoder=rep(wae.w_decoder, proj_dim=128, n_heads=16, mlp_dims=(137,)),
                                   w_encoder=rep(wae.w_encoder, proj_dim=256, n_heads=8, mlp_dims=(1000,)),
                                   conditional_w_encoder=rep(wae.conditional_w_encoder, proj_dim=512, n_heads=4,
                                                             mlp_dims=(700,))))
    return {
        'A': with_ae(encoder=rep(ae.encoder, class_name='LDGCNN')),
        'B': with_wae(w_encoder=pc.CONVOLUTIONAL_W_ENCODER, w_decoder=pc.LINEAR_W_DECODER),
        'C': with_wae(n_pseudo_inputs=VAMP_PSEUDO_INPUTS),
        'D': with_ae(encoder=rep(ae.encoder, act_name='GELU')),
        'E': corner,
    }


def labelled_clouds(seed: int, counts: tuple[int, ...], n: int) -> tuple[np.ndarray, np.ndarray]:
    """``counts[c]`` clouds of ``n`` points of each class ``c`` (0 spheres, 1
    boxes: ``pccf_torch.data.synthetic``'s shapes, normalised) in an order
    shuffled from ``seed``, float32, and their int64 labels."""
    from pccf_torch.data import synthetic

    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(len(counts)), counts)
    rng.shuffle(labels)
    clouds = np.stack([synthetic.normalise(synthetic.shape_cloud(rng, int(c), n)) for c in labels])
    return clouds.astype(np.float32), labels.astype(np.int64)


class StampedLines(io.TextIOBase):
    """Standard output's lines with the host clock at which each ended."""

    def __init__(self) -> None:
        self.stamped: list[tuple[float, str]] = []
        self._part = ''

    def write(self, text: str) -> int:
        now = time.perf_counter()
        self._part += text
        while '\n' in self._part:
            line, self._part = self._part.split('\n', 1)
            self.stamped.append((now, line))
        return len(text)

    def lines(self, start: float):
        """``(line, seconds since the line before, or since start)``."""
        for now, line in self.stamped:
            yield line, now - start
            start = now


def suite_launch_counts(cfg, predictions: np.ndarray, labels: np.ndarray) -> dict[str, int]:
    """The launches the five suites make over the clouds: every pass of the
    classifier over a batch builds a kNN graph and max-pools in each EdgeConv
    block; every derived chunk of up to ``MAX_BATCH`` clouds runs the
    classifier on them, the VQ-VAE's encoder (a graph and a max-pool a
    block), the inner CVAE's sampled forward (the W-encoder's and the
    posterior's encoder stacks, the W-decoder's decoder stack) or its fused
    counterfactual chain, the PCGen decode and graph filtering; the derived
    clouds are then classified in batches."""
    from pccf_torch.data.processed import MAX_BATCH

    batch, n_classes = cfg.classifier.train.batch_size, cfg.data.n_classes
    c_blocks, e_blocks = len(cfg.classifier.conv_dims), len(cfg.autoencoder.encoder.h_dim)
    counts = dict.fromkeys(('knn', 'graph_max_pool', 'wformer_encoder', 'wformer_decoder', 'cvae_cf', 'pcgen_mix',
                            'graph_filter'), 0)

    def classified(m: int) -> None:
        for name in ('knn', 'graph_max_pool'):
            counts[name] += c_blocks * -(-m // batch)

    def derived(m: int, sampled: bool) -> None:
        chunks = -(-m // MAX_BATCH)
        for name in ('knn', 'graph_max_pool'):
            counts[name] += (c_blocks + e_blocks) * chunks
        if sampled:
            counts['wformer_encoder'] += 2 * chunks
            counts['wformer_decoder'] += chunks
        else:
            counts['cvae_cf'] += chunks
        counts['pcgen_mix'] += chunks
        counts['graph_filter'] += chunks
        classified(m)

    classified(len(labels))  # the original clouds
    derived(len(labels), True)  # their double reconstructions
    for _ in range(n_classes):  # counterfactuals to each class
        derived(len(labels), False)
    if (mis := int((predictions != labels).sum())) > 0:
        derived(mis, True)
    for i in range(n_classes):
        for j in range(n_classes):
            if i != j and (m := int(((predictions == i) & (labels == j)).sum())) > 0:
                derived(m, False)
    return counts


@torch.no_grad()
def suite_outcomes(vq, judge, clouds: np.ndarray, labels: np.ndarray, seed: int, cfg, device) -> dict:
    """What each suite decides about each cloud: ``name -> (codes, predictions,
    margins)`` of the clouds it derives (each rebuilt from the noise the
    suite's derived dataset draws, the whole set in one chunk), and the
    original clouds' predictions; a margin is the gap between the two
    largest logits."""
    from pccf_torch.data.clouds import LabelledClouds
    from pccf_torch.data.processed import CounterfactualDatasetEncoder, DoubleReconstructedDatasetWithLogits
    from pccf_torch.data.structures import Inputs
    from pccf_torch.evaluate_counterfactuals import Subset

    dataset = LabelledClouds(torch.from_numpy(clouds).to(device), torch.from_numpy(labels), seed)

    def judged(cloud: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        logits = judge(Inputs(cloud)).cpu()
        top = torch.topk(logits, 2, dim=1).values
        return logits.argmax(1).numpy(), (top[:, 0] - top[:, 1]).numpy()

    out = {'original': (np.zeros((len(labels), 0)), *judged(dataset.clouds))}
    predictions = out['original'][1]

    def recon(name: str, idx: np.ndarray) -> None:
        sub = Subset(dataset, idx)
        noise = DoubleReconstructedDatasetWithLogits(sub, vq, judge).draw(len(idx))
        cloud = dataset.clouds[torch.as_tensor(idx, device=device)]
        data = vq.double_reconstruct_with_logits(Inputs(cloud, initial_sampling=noise[0]), judge(Inputs(cloud)),
                                                 noise[1])
        out[name] = (data.idx.cpu().numpy(), *judged(data.recon))

    def counterfactual(name: str, idx: np.ndarray, j: int) -> None:
        sub = Subset(dataset, idx)
        sampling = CounterfactualDatasetEncoder(sub, vq, judge, j).draw(len(idx))[0]
        cloud = dataset.clouds[torch.as_tensor(idx, device=device)]
        data = vq.generate_counterfactual(Inputs(cloud, initial_sampling=sampling), judge(Inputs(cloud)), j,
                                          cfg.user.counterfactual_value)
        out[name] = (data.idx.cpu().numpy(), *judged(data.recon))

    everyone = np.arange(len(labels))
    recon('ClassificationReconstructed', everyone)
    for j in range(cfg.data.n_classes):
        counterfactual(f'Counterfeit_to_{j}', everyone, j)
    if (mis := np.nonzero(predictions != labels)[0]).size:
        recon('MisclassifiedReconstructed', mis)
    for i in range(cfg.data.n_classes):
        for j in range(cfg.data.n_classes):
            if i != j and (idx := np.nonzero((predictions == i) & (labels == j))[0]).size:
                counterfactual(f'{i}_to_{j}', idx, j)
    return out


def cli_phase(seed: int, check, dev: torch.device, root: str) -> dict[str, int]:
    """The five entry points in this process on the card, as a user runs
    them from the experiment tree: the flagship model unmodified at 2048
    points on ``data/dataset=synthetic`` at the dataset file's own sizes (64
    train and 32 test clouds of 4096 points, 2 classes), epochs cut to 4
    (the classifier, early stopping on at patience 1), 2 (stage 1) and 2
    (stage 2).  Each stage's seconds, epoch times and launches (the counts
    zeroed just before it and read just after), every checkpoint reloaded to
    the same eval output, a stage-1 resume against the same epoch run on in
    memory from the same state (bit-equal, in default mode), and the
    compiled batch assembler against its plain version.  The experiments go
    under ``root``.  Returns the launches of all five stages."""
    from pccf_torch import cli, evaluate_counterfactuals, generate
    from pccf_torch.data import sampler
    from pccf_torch.data.dataset import get_datasets
    from pccf_torch.data.protocols import Singleton
    from pccf_torch.data.structures import Inputs
    from pccf_torch.experiment import Experiment
    from pccf_torch.kernels import api
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn import ClassifierTrainModule, build_classifier
    from pccf_torch.train import autoencoder, classifier, w_autoencoder
    from pccf_torch.train.checkpoint import Checkpoint
    from pccf_torch.train.runners import Loader

    args = [*CLI_OVERRIDES, f'user.seed={seed}']
    saved_env = {k: os.environ.get(k) for k in ('ROOT_EXP_DIR', 'DATASET_DIR')}
    total = dict.fromkeys(KERNEL_INFO, 0)

    def use_root(name: str) -> None:
        os.environ['ROOT_EXP_DIR'] = os.path.join(root, name)
        os.environ['DATASET_DIR'] = os.path.join(root, 'data')

    def run_stage(module, argv: list[str], name: str):
        api.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = module.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = api.launch_counts()
        trainer = out.get('trainer') if isinstance(out, dict) else None
        epochs = ', '.join(f'{s:.3f}' for s in trainer.epoch_seconds) if trainer is not None else 'none'
        print(f'CLI {name}: {seconds:.2f} s, epoch seconds [{epochs}], launches '
              f'{json.dumps({k: v for k, v in counts.items() if v})}', flush=True)
        return out, counts, seconds

    def record(name: str, counts: dict[str, int]) -> None:
        for k, v in counts.items():
            total[k] += v
        missing = [k for k in CLI_STAGE_KERNELS[name] if not counts[k]]
        check(not missing, f'CLI {name} launched every kernel of its path (none missing: {missing})')

    @torch.no_grad()
    def reloaded(cfg, build, name: str, model: torch.nn.Module, run) -> None:
        """The checkpoint ``name`` wrote, loaded into a fresh model, gives the
        eval output of the model that wrote it."""
        fresh = build().to(dev)
        with Experiment(cfg).create_run(record=False):
            epoch = Checkpoint(name).load(fresh, -1)
        a, b_ = run(model.eval()), run(fresh.eval())
        check(torch.equal(a, b_), f'CLI checkpoint {name} epoch_{epoch} reloads to the same eval output '
                                  f'{tuple(a.shape)} (max diff {float((a - b_).abs().max()):.3e})')

    try:
        Singleton.reset_all()
        use_root('main')
        cfg = cli.parse_args(args)[0]
        t0 = time.perf_counter()
        train_set, val_set = get_datasets(cfg, dev)
        print(f'CLI dataset: {len(train_set)} train / {len(val_set)} val clouds of {train_set.pcd.shape[1]} points, '
              f'{time.perf_counter() - t0:.2f} s (the val split\'s neighbour indices on the card)', flush=True)
        pcd, ids = train_set.pcd, np.arange(TRAIN_BATCH, dtype=np.int64)
        for kw in ({'jitter_sigma': cfg.data.jitter_sigma, 'jitter_clip': cfg.data.jitter_clip},
                   {'jitter_sigma': 0.01, 'jitter_clip': 0.02, 'resample': True, 'rotate': True, 'translate': True}):
            t0 = time.perf_counter()
            got = sampler.compiled(pcd, ids, cfg.data.n_input_points, seed + 1, **kw)
            t_c = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = sampler.plain(pcd, ids, cfg.data.n_input_points, seed + 1, **kw)
            t_p = time.perf_counter() - t0
            same = all(np.array_equal(x, y) for x, y in zip(got, want))
            check(same, f'CLI batch assembler compiled vs plain ({TRAIN_BATCH} x {cfg.data.n_input_points} from '
                        f'{pcd.shape[1]}, {sorted(k for k, v in kw.items() if v)}): bit-equal {same}; '
                        f'{t_c * 1e3:.2f} ms (plain {t_p * 1e3:.1f} ms, host clock)')
        val_set.set_inference(True)
        batch_in = val_set.__getitems__(list(range(TRAIN_BATCH)))[0]

        out, counts, _ = run_stage(classifier, args, 'classifier')
        record('classifier', counts)
        tr = out['trainer']
        check(tr.epoch <= 4 and len(tr.validation_log) == tr.epoch and bool(np.isfinite(out['logits']).all()),
              f'CLI classifier: {tr.epoch} epochs of 4 (early stopping at patience 1), validation '
              f'{json.dumps(tr.validation_log[-1])}, test {json.dumps(out["test"])}')
        reloaded(cfg, lambda: ClassifierTrainModule(build_classifier(cfg)), cfg.classifier.name, tr.model,
                 lambda m: m(batch_in))

        out, counts, _ = run_stage(autoencoder, args, 'autoencoder')
        record('autoencoder', counts)
        a_tr = out['trainer']
        check(a_tr.epoch == 2 and bool(np.isfinite(out['loss'])),
              f'CLI autoencoder: 2 epochs, validation {json.dumps(a_tr.validation_log[-1])}, final test '
              f'{json.dumps(out["test"])}')
        samp = torch.randn((TRAIN_BATCH, cfg.data.n_target_points, cfg.autoencoder.decoder.sample_dim),
                           generator=torch.Generator().manual_seed(seed + 60)).to(dev)
        fixed = Inputs(cloud=batch_in.cloud, indices=batch_in.indices, initial_sampling=samp)
        reloaded(cfg, lambda: build_vqvae(cfg), cfg.autoencoder.name, a_tr.model,
                 lambda m: m(fixed, None, torch.Generator(device=dev).manual_seed(seed)).recon)

        # the resume: one epoch and its checkpoint, then a run resumed from it
        # (user.load_checkpoint=-1) for the second, against the second epoch
        # run on in memory from the same state, three times.  A stage-1 step
        # on the card adds in a fixed order (PERF.md §7), so in default mode
        # the three in-memory runs agree bit for bit and the resumed run
        # equals them
        def flat(model) -> torch.Tensor:
            return torch.cat([v.detach().flatten().double() for v in model.state_dict().values()
                              if v.is_floating_point()])

        use_root('resume')
        try:
            base = autoencoder.main([*args, 'autoencoder.train.n_epochs=1'])['trainer']
            base.post_epoch_hooks.clear()  # the codebook hook runs every 10 epochs: not at epoch 2
            snap = ({k: v.clone() for k, v in base.model.state_dict().items()},
                    copy.deepcopy(base.optimizer.state_dict()), base.generator.get_state(), base.step)
            resumed = flat(autoencoder.main([*args, 'user.load_checkpoint=-1'])['trainer'].model)
            loader = Loader(get_datasets(cfg, dev)[0], cfg.autoencoder.train.batch_size, cfg.user.seed or 0)
            runs = []
            for _ in range(RESUME_RUNS):
                base.model.load_state_dict(snap[0])
                base.optimizer.load_state_dict(copy.deepcopy(snap[1]))
                base.generator.set_state(snap[2])
                base.step, base.epoch = snap[3], 1
                base.train_until(loader, 2)
                runs.append(flat(base.model))
        finally:
            use_root('main')
        same_runs = all(torch.equal(runs[0], r) for r in runs[1:])
        equal = all(torch.equal(resumed, r) for r in runs)
        check(not torch.are_deterministic_algorithms_enabled() and same_runs and equal,
              f'CLI stage-1 resume (1 epoch, checkpoint, load_checkpoint=-1, 1 more) against the second epoch run '
              f'on in memory {RESUME_RUNS} times from the same state, in default mode: the in-memory runs bit-equal '
              f'{same_runs} (rel L2 of all weights and statistics, largest '
              f'{max(rel_l2(runs[0], r) for r in runs):.3e}), the resumed run bit-equal to them {equal} (rel L2 '
              f'{rel_l2(resumed, runs[0]):.3e})')

        out, counts, _ = run_stage(w_autoencoder, args, 'w_autoencoder')
        record('w_autoencoder', counts)
        w_tr = out['trainer']
        check(w_tr.epoch == 2 and bool(np.isfinite(out['loss'])),
              f'CLI w_autoencoder: 2 epochs, validation {json.dumps(w_tr.validation_log[-1])}, test encoding '
              f'{json.dumps(out["test"])}')
        logits = out['classifier'](Inputs(cloud=batch_in.cloud))
        target = torch.arange(TRAIN_BATCH, device=dev) % cfg.data.n_classes
        reloaded(cfg, lambda: build_vqvae(cfg), cfg.autoencoder.name, out['vqvae'],
                 lambda m: m.generate_counterfactual(fixed, logits, target).recon)

        suites, counts, _ = run_stage(evaluate_counterfactuals, args, 'evaluate_counterfactuals')
        record('evaluate_counterfactuals', counts)
        check('ClassificationOriginal' in suites and all(np.isfinite(list(v.values())).all() for v in suites.values()),
              f'CLI evaluate_counterfactuals: {len(suites)} suites, finite, original '
              f'{json.dumps(suites["ClassificationOriginal"])}')
        clouds, counts, _ = run_stage(generate, args, 'generate')
        record('generate', counts)
        check(clouds.shape == (cfg.user.generate.batch_size, cfg.data.n_target_points, 3)
              and bool(np.isfinite(clouds).all()), f'CLI generate: finite {clouds.shape}')
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        Singleton.reset_all()
    return total


def tuning_and_readers_phase(seed: int, check, dev: torch.device, root: str) -> tuple[dict[str, int], dict[str, int]]:
    """The entry points of tuning and the dataset readers on the card, at
    the CLI phase's sizes (the flagship model on ``data/dataset=synthetic``,
    2 epochs a stage), after it and in its ``root``:

    - ``tune_autoencoder tune=learn`` for ``TUNE_TRIALS`` trials, its
      launches exactly ``TUNE_TRIALS`` times those of the stage-1 entry point
      run once with the same overrides, and one trial of an architecture
      space (``tune=decoder``); ``tune_w_autoencoder tune=learn`` for
      ``TUNE_W_TRIALS`` trials over the CLI phase's checkpoints, its
      launches exactly ``TUNE_W_TRIALS`` times those of the stage-2 entry
      point; each study's sqlite rows (every trial COMPLETE with a finite
      value and a report a epoch);
    - the ModelNet reader's kNN precompute (``index_k_neighbours``) at the
      desk / table train split's size, ``ceil(778 / 64)`` kNN launches and
      nothing else, against the plain kNN, and the reader on h5 files this
      script writes where ``h5py`` imports (else its refusal, which names
      it);
    - a PC15k tree this script writes (``SHAPENET_CLOUDS``), the stage-1
      and classifier entry points on ``data/dataset=shapenet`` with
      ``user.n_workers`` 0 and ``LOADER_WORKERS`` (the same launches; stage
      1's weights bit-equal), and the first epoch's batches of the training
      split through ``LOADER_WORKERS`` worker processes bit-equal to the
      in-process ones at both stages' batch sizes.

    Returns the launches of the tuning path and of the readers' path."""
    import sqlite3

    from pccf_torch import cli, tune_autoencoder, tune_w_autoencoder
    from pccf_torch.config import paths
    from pccf_torch.data import synthetic
    from pccf_torch.data.dataset import get_dataset, get_datasets
    from pccf_torch.data.modelnet import ModelNet40Dataset, index_k_neighbours
    from pccf_torch.data.protocols import Partitions, Singleton
    from pccf_torch.kernels import api, knn
    from pccf_torch.train import autoencoder, classifier, w_autoencoder
    from pccf_torch.train.runners import Loader

    saved_env = {k: os.environ.get(k) for k in ('ROOT_EXP_DIR', 'DATASET_DIR')}
    tuning, readers = dict.fromkeys(KERNEL_INFO, 0), dict.fromkeys(KERNEL_INFO, 0)
    args = [*CLI_OVERRIDES, f'user.seed={seed}']
    db = os.path.join(root, 'db')

    def use_root(name: str) -> None:
        os.environ['ROOT_EXP_DIR'] = os.path.join(root, name)
        os.environ['DATASET_DIR'] = os.path.join(root, 'data')

    def counted(total: dict[str, int], fn):
        api.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = api.launch_counts()
        for k, v in counts.items():
            total[k] += v
        return out, counts, seconds

    def nonzero(counts: dict[str, int]) -> str:
        return json.dumps({k: v for k, v in counts.items() if v})

    def quoted(overrides: list[str]) -> str:
        return 'overrides=[' + ','.join(f'"{o}"' for o in overrides) + ']'

    def stored(study: str, n: int, label: str, db_name: str, epochs: int = 2) -> None:
        with contextlib.closing(sqlite3.connect(os.path.join(db, f'{db_name}.db'))) as conn:
            rows = conn.execute('SELECT number, state, value, intermediate FROM trials WHERE study = ? ORDER BY '
                                'number', (study,)).fetchall()
        ok = len(rows) == n and all(r[1] == 'COMPLETE' and r[2] is not None and math.isfinite(r[2])
                                    and len(json.loads(r[3])) == epochs for r in rows)
        check(ok, f'{label}: study {study} holds {len(rows)} trials of {n}, each COMPLETE with a finite value and '
                  f'{epochs} reports: {[(r[0], r[1], r[2]) for r in rows]}')

    try:
        # ---- tuning: stage 1 -------------------------------------------------
        Singleton.reset_all()
        use_root('tune_reference')
        cfg = cli.get_config(args)[0]
        get_datasets(cfg, dev)  # the splits and their indices, once a process, before any count
        out, stage1, ref_s = counted(dict.fromkeys(KERNEL_INFO, 0), lambda: autoencoder.main(args))
        use_root('main')
        study, counts, tune_s = counted(tuning, lambda: tune_autoencoder.main(
            ['tune=learn', f'tune.n_trials={TUNE_TRIALS}', f'db_location={db}', quoted(args)]))
        want = {k: TUNE_TRIALS * v for k, v in stage1.items()}
        check(counts == want, f'tune_autoencoder tune=learn, {TUNE_TRIALS} trials of 2 epochs: {tune_s:.2f} s '
                              f'(the stage alone {ref_s:.2f} s); launches {nonzero(counts)} == {TUNE_TRIALS} x the '
                              f'stage-1 entry point\'s {nonzero(stage1)}')
        stored(study.study_name, TUNE_TRIALS, 'tune_autoencoder', 'autoencoder_optimization')
        print(f'tune_autoencoder trials: {json.dumps([(t.params, t.value) for t in study.get_trials()])}',
              flush=True)
        study, counts, arch_s = counted(tuning, lambda: tune_autoencoder.main(
            ['tune=decoder', 'tune.n_trials=1', f'db_location={db}', quoted(args)]))
        missing = [k for k in TRAINING_KERNELS + ('chamfer_match_cost',) if not counts[k]]
        check(not missing, f'tune_autoencoder tune=decoder, 1 trial: {arch_s:.2f} s, params '
                           f'{json.dumps(study.get_trials()[0].params)}; launches {nonzero(counts)} (none of the '
                           f'stage-1 kernels missing: {missing})')
        stored(study.study_name, 1, 'tune_autoencoder tune=decoder', 'autoencoder_optimization')

        # ---- tuning: stage 2, over the CLI phase's checkpoints ---------------
        w_args = [*args, f'variation={cli.parse_args(args)[0].name}']
        study, counts, tune_w_s = counted(tuning, lambda: tune_w_autoencoder.main(
            ['tune=learn', f'tune.n_trials={TUNE_W_TRIALS}', f'db_location={db}', quoted(w_args)]))
        _, stage2, ref2_s = counted(dict.fromkeys(KERNEL_INFO, 0), lambda: w_autoencoder.main(args))
        want = {k: TUNE_W_TRIALS * v for k, v in stage2.items()}
        check(counts == want, f'tune_w_autoencoder tune=learn, {TUNE_W_TRIALS} trials of 2 epochs over the CLI '
                              f'phase\'s models: {tune_w_s:.2f} s (the stage alone {ref2_s:.2f} s); launches '
                              f'{nonzero(counts)} == {TUNE_W_TRIALS} x the stage-2 entry point\'s {nonzero(stage2)}')
        stored(study.study_name, TUNE_W_TRIALS, 'tune_w_autoencoder', 'w_autoencoder_optimization')

        # ---- the ModelNet reader ---------------------------------------------
        n_clouds, n_points, k = MODELNET_SPLIT
        pcs = synthetic.batch(seed + 70, n_clouds, n_points)
        idx, counts, index_s = counted(readers, lambda: index_k_neighbours(pcs, k, dev, MODELNET_CHUNK))
        chunks = -(-n_clouds // MODELNET_CHUNK)
        agree, err, self_first = [], 0.0, bool((idx[..., 0] == np.arange(n_points)).all())
        for i in range(0, n_clouds, MODELNET_CHUNK):
            x = torch.from_numpy(pcs[i: i + MODELNET_CHUNK]).to(dev)
            a, e = knn_check(x, k, torch.from_numpy(idx[i: i + MODELNET_CHUNK]).to(dev), knn.plain(x, k))
            agree.append(a)
            err = max(err, e)
        check(nonzero(counts) == json.dumps({'knn': chunks}) and min(agree) >= KNN_SET_AGREEMENT and self_first
              and idx.shape == (n_clouds, n_points, k) and idx.dtype == np.int32,
              f'ModelNet index_k_neighbours at ({n_clouds}, {n_points}, 3), k={k}: {index_s * 1e3:.1f} ms for '
              f'{chunks} chunks of {MODELNET_CHUNK} (host clock, synchronised, the copies to the host included); '
              f'launches {nonzero(counts)}; against the plain kNN set agreement {min(agree):.5f} >= '
              f'{KNN_SET_AGREEMENT}, sorted distance gap {err:.2e}, self first {self_first}')
        model_args = [o for o in args if not o.startswith(('data/dataset=', 'data.dataset.'))]
        m_args = ['data/dataset=modelnet_desk_table', *model_args]
        m_cfg = cli.get_config(m_args)[0]
        folder = os.path.join(root, 'data', 'modelnet40_hdf5_2048')
        os.makedirs(folder, exist_ok=True)  # present, so the reader never fetches the archive
        try:
            import h5py
        except ImportError:
            h5py = None
        if h5py is None:
            try:
                ModelNet40Dataset(m_cfg, dev)
                refused = 'no error'
            except ImportError as e:
                refused = str(e)
            check('h5py' in refused, f'ModelNet reader without h5py refuses, naming it: {refused!r}')
        else:
            rng = np.random.default_rng(seed + 71)
            classes = (paths().metadata_dir / 'modelnet_classes.txt').read_text().splitlines()
            picks = [classes.index(c) for c in ('desk', 'table', 'chair')]
            for name, n in (('ply_data_train0.h5', 20), ('ply_data_test0.h5', 8)):
                with h5py.File(os.path.join(folder, name), 'w') as f:
                    f.create_dataset('data', data=synthetic.batch(seed + 72 + n, n, n_points))
                    f.create_dataset('label', data=rng.choice(picks, (n, 1)).astype(np.uint8))
            Singleton.reset_all()
            (train_m, val_m), counts, read_s = counted(readers, lambda: get_datasets(m_cfg, dev))
            with h5py.File(os.path.join(folder, 'ply_data_train0.h5'), 'r') as f:
                cached = f'index_{m_cfg.data.n_neighbors}_{m_cfg.data.n_input_points}' in f
            check(len(train_m) + len(val_m) > 0 and cached and counts['knn'] == 2,
                  f'ModelNet reader on h5 files: {len(train_m)} train / {len(val_m)} val clouds, {read_s:.2f} s, '
                  f'launches {nonzero(counts)}, index cached {cached}')

        # ---- ShapeNet, the loader's worker processes ---------------------------
        rng = np.random.default_rng(seed + 73)
        metadata = json.loads((paths().metadata_dir / 'shapenet_PointFlow_classes.json').read_text())
        synsets = {name: synset for synset, name in metadata.items()}
        for kind, (cls, counts_) in enumerate(SHAPENET_CLOUDS.items()):
            for split, n in zip(('train', 'val', 'test'), counts_):
                d = os.path.join(root, 'data', 'ShapeNetCore.v2.PC15k', synsets[cls], split)
                os.makedirs(d, exist_ok=True)
                for i in range(n):
                    np.save(os.path.join(d, f'{i:04d}.npy'), synthetic.shape_cloud(rng, kind, SHAPENET_POINTS, 0.3))
        s_args = ['data/dataset=shapenet', *model_args]
        s_cfg = cli.get_config(s_args)[0]
        Singleton.reset_all()
        split = get_dataset(s_cfg, Partitions.train, dev)
        for batch_size in (s_cfg.autoencoder.train.batch_size, s_cfg.classifier.train.batch_size):
            in_process = list(Loader(split, batch_size, seed).epoch_iterator(1))
            loader = Loader(split, batch_size, seed, LOADER_WORKERS)
            t0 = time.perf_counter()
            try:
                from_workers = list(loader.epoch_iterator(1))
            finally:
                loader.close()
            same = len(from_workers) == len(in_process) > 0 and all(
                torch.equal(a[0].cloud, b[0].cloud) and torch.equal(a[1].ref_cloud, b[1].ref_cloud)
                and torch.equal(a[1].label, b[1].label) for a, b in zip(from_workers, in_process))
            check(same, f'ShapeNet train split ({len(split)} clouds of {SHAPENET_POINTS} points): epoch 1\'s '
                        f'{len(in_process)} batches of {batch_size} through {LOADER_WORKERS} worker processes '
                        f'bit-equal to the in-process ones {same} ({time.perf_counter() - t0:.2f} s with the pool\'s '
                        f'start)')
        for module, name in ((autoencoder, 'autoencoder'), (classifier, 'classifier')):
            runs = []
            for workers in (0, LOADER_WORKERS):
                use_root(f'shapenet_{name}_{workers}')
                out, counts, seconds = counted(readers, lambda: module.main([*s_args, f'user.n_workers={workers}']))
                runs.append((out, counts))
                print(f'ShapeNet {name} entry point, user.n_workers={workers}: {seconds:.2f} s, launches '
                      f'{nonzero(counts)}', flush=True)
            (a, ca), (b, cb) = runs
            weights = all(torch.equal(x, y) for x, y in zip(a['trainer'].model.state_dict().values(),
                                                             b['trainer'].model.state_dict().values()))
            missing = [k_ for k_ in CLI_STAGE_KERNELS[name] if not cb[k_]]
            finite = bool(np.isfinite(a['loss'] if name == 'autoencoder' else a['logits']).all())
            check(ca == cb and not missing and finite and (weights or name == 'classifier'),
                  f'ShapeNet {name} entry point with {LOADER_WORKERS} loader workers against none: the same '
                  f'launches {ca == cb} (none of its kernels missing: {missing}), finite, trained weights '
                  f'bit-equal {weights}')
    finally:
        for key, v in saved_env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        Singleton.reset_all()
    return tuning, readers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    started = time.perf_counter()
    from pccf_torch import config as pc
    from pccf_torch.config import SliceConfig
    from pccf_torch.data import synthetic
    from pccf_torch.data.clouds import LabelledClouds
    from pccf_torch.data.processed import MAX_BATCH, CounterfactualDatasetEncoder, WDatasetWithLogits
    from pccf_torch.data.structures import Inputs, Outputs, Targets, WInputs, WTargets
    from pccf_torch.kernels import (_build, api, chamfer, cvae, emd, gather, graph_filter, knn, ops, pcgen, roofline,
                                    sinkhorn, wformer)
    from pccf_torch.models import WAETrainModule, build_vqvae, build_w_autoencoder
    from pccf_torch.evaluate_counterfactuals import evaluate_counterfactuals
    from pccf_torch.nn import ClassifierTrainModule, build_classifier
    from pccf_torch.nn.layers import gumbel_uniform, init_from_seed
    from pccf_torch.generate import generate_random_samples
    from pccf_torch.serve import CounterfactualServer, next_bucket
    from pccf_torch.train import (Loader, Test, Trainer, get_autoencoder_loss, get_classification_loss,
                                  get_w_autoencoder_loss)
    from pccf_torch.train.autoencoder import train_autoencoder
    from pccf_torch.train.classifier import train_classifier
    from pccf_torch.train.hooks import DEAD_ENTRY
    from pccf_torch.train.w_autoencoder import build_w_train_model, train_w_autoencoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    failures: list[str] = []

    def check(ok: bool, what: str) -> None:
        print(('ok   ' if ok else 'FAIL ') + what, flush=True)
        if not ok:
            failures.append(what)

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    clock = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,nounits'],
                           capture_output=True, text=True, timeout=60)
    max_sm_mhz = float(clock.stdout.split()[0]) if clock.returncode == 0 and clock.stdout.strip() else float('nan')
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ''
    check(bool(card), 'nvidia-smi reads the card')
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    print(f'kernel build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds or 0.0:.1f} s)', flush=True)
    resources = []
    for source, pattern in (('gather_scatter.cu', DEVICE_NAMES['scatter_add_rows'][0]),
                            ('emd.cu', DEVICE_NAMES['chamfer_match_cost'][0]),
                            ('graph_max_pool.cu', 'slice_pool_kernel'), ('gather_scatter.cu', 'slice_pool_kernel'),
                            ('gather_scatter.cu', 'slot_scatter_kernel'),
                            ('nn_distance.cu', DEVICE_NAMES['nn_distance'][0]),
                            ('sinkhorn.cu', r'sinkhorn_(build|sweep)_kernel'),
                            ('graph_filter.cu', r'filter_\w+_kernel'), ('pcgen_mix.cu', 'pcgen_mix_kernel')):
        for mangled, regs, stores, loads in _build.kernel_resources(_build.ptxas_logs.get(source, '')):
            if re.search(pattern, mangled):
                filt = subprocess.run(['c++filt'], input=mangled, capture_output=True, text=True) \
                    if shutil.which('c++filt') else None
                kernel = short_kernel_name(filt.stdout.strip() + '(') if filt and filt.returncode == 0 else mangled
                resources.append(f'{source} {kernel}: {regs} registers, spill stores / loads {stores} / {loads} bytes')
    print('registers and spills (nvcc -Xptxas -v), the row scatter, EMD, graph pool, slot scatter, nearest-neighbour, '
          'Sinkhorn, graph filter and PCGen mix kernels: '
          + ('; '.join(resources) if resources else 'none read: the library was built before this run'), flush=True)
    empty = _build.lib().pccf_empty
    print(f'launch floor: an empty kernel (one warp) {time_ms(lambda: empty(_build.stream()), REPS):.4f} ms '
          f'back to back', flush=True)

    cfg = SliceConfig()
    rng = np.random.default_rng(args.seed)
    vqvae = build_vqvae(cfg)
    classifier = build_classifier(cfg)
    init_from_seed(vqvae, args.seed)
    init_from_seed(classifier, args.seed + 1)
    vqvae = vqvae.to(dev).eval()
    classifier = classifier.to(dev).eval()
    b, n = 16, cfg.data.n_input_points
    kernels: dict[str, dict] = {}

    def bound(work: roofline.Work) -> dict:
        ms, by = roofline.bound_ms(work)
        return {'bound_ms': ms, 'bound_by': by}

    def slice_widths(run, x: torch.Tensor) -> tuple[str, bool]:
        """The pools' plan for ``x`` (held equal to the kernel library's) beside
        the time at every other slice width that fits; ``run(width)`` pools,
        ``None`` at the plan's width.  True when every width's output equals
        the plan's bit for bit."""
        _, rows, c = x.shape
        plan = gather.pool_plan(*x.shape, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        same_plan = plan == gather.kernel_pool_plan(*x.shape)
        ref, times, equal = run(None), [], True
        for w in gather.SLICE_WIDTHS:
            if w != plan.slice_width and c % w == 0 and gather.pool_smem(rows, w) <= gather.MAX_SMEM:
                equal = equal and torch.equal(run(w), ref)
                times.append(f'{time_ms(lambda: run(w), REPS):.4f} ms in slices of {w}')
        return (f'the plan: slices of {plan.slice_width}, {plan.ranges} centre range(s), the kernel\'s plan too '
                f'{same_plan}; ' + ', '.join(times) + f', bit-equal to the plan\'s {equal}'), same_plan and equal

    # ---- each kernel against its plain version at the flagship shapes ----
    with torch.inference_mode():
        # every (C, k) the main path gives kNN: the encoder's k=25 and the
        # classifier's k=20 at C = 3, 64, 128 (C=64 twice per model), and
        # graph filtering's k=4 on the decoded cloud; at serving's batch 1, 5
        # and 16 (the candidate split acts at 1; the classifier step's 16),
        # at stage 1's 8, at stage 2's 32, the derived dataset's chunk, and at
        # the suites' chunks of 64 and 58 (and of 1, a subset's); a split
        # batch must get the neighbours it gets with the candidates unsplit.
        # no single PyTorch call computes kNN indices (cdist, then topk) or a
        # max over gathered rows (indexing, then amax): library_ms is null
        batches = (b, cfg.w_autoencoder.train.batch_size)
        knn_errs, knn_ms = [], {}
        for bb in (1, 5, TRAIN_BATCH, *batches, *SUITE_CHUNKS):
            for c in (3, 64, 128):
                for k in (25, 20, 4) if c == 3 else (25, 20):
                    x = torch.from_numpy(rng.standard_normal((bb, n, c)).astype(np.float32)).to(dev)
                    got, want = knn.knn_cuda(x, k), knn.plain(x, k)
                    torch.cuda.synchronize()
                    agree, err = knn_check(x, k, got, want)
                    knn_errs.append(err)
                    self_first = bool((got[..., 0] == torch.arange(n, device=dev)).float().mean() > 0.999)
                    splits = knn.splits(bb, n, torch.cuda.get_device_properties(dev).multi_processor_count)
                    unsplit = splits == 1 or torch.equal(got, knn.knn_cuda(x, k, n_splits=1))
                    row = knn_ms[bb, c, k] = (time_ms(lambda: knn.knn_cuda(x, k), REPS),
                                              time_ms(lambda: knn.plain(x, k), REPS), bound(roofline.knn_work(x, k)))
                    # knn.splits' choice beside half and twice as many splits
                    others = {s: time_ms(lambda: knn.knn_cuda(x, k, n_splits=s), REPS)
                              for s in (splits // 2, 2 * splits) if 1 <= s <= min(knn.MAX_SPLITS, -(-n // knn.TILE))}
                    check(agree >= KNN_SET_AGREEMENT and self_first and unsplit,
                          f'knn B={bb} C={c} k={k}, {splits} split(s): neighbour-set agreement {agree:.6f}, self '
                          f'first, max |kth-distance diff| {err:.2e}, equal to the unsplit lists {unsplit}; '
                          f'{row[0]:.4f} ms (plain {row[1]:.3f} ms, bound {row[2]["bound_ms"]:.4f} ms, '
                          f'{row[2]["bound_by"]}); '
                          + ', '.join(f'{v:.4f} ms in {s} splits' for s, v in others.items()))
        head = knn_ms[b, 128, 25]
        kernels['knn'] = {'max_abs_err': max(knn_errs), 'ms': head[0], 'plain_ms': head[1], **head[2],
                          'library_ms': None, 'shape': '(16, 2048, 128) k=25'}
        print('knn ms by (B, C, k): ' + json.dumps({f'{bb},{c},{k}': round(v[0], 4) for (bb, c, k), v in
                                                    knn_ms.items()}), flush=True)

        # every (B, F, k) the main path gives max-pool: F = 64, 128, 256 at
        # the encoder's k=25 and the classifier's k=20, at serving's batch 1,
        # 5 and 16, at stage 2's 32 and at the suites' chunks of 64 and 58;
        # every slice width bit-exact too
        pool_errs, pool_ms = [], {}
        for bb in (1, 5, *batches, *SUITE_CHUNKS):
            for f in (64, 128, 256):
                for k in (25, 20):
                    x = torch.from_numpy(rng.standard_normal((bb, n, f)).astype(np.float32)).to(dev)
                    idx = knn.knn_cuda(torch.from_numpy(rng.standard_normal((bb, n, 8)).astype(np.float32)).to(dev), k)
                    err = float((gather.graph_max_pool_cuda(x, idx) - gather.plain(x, idx)).abs().max())
                    pool_errs.append(err)
                    row = pool_ms[bb, f, k] = (time_ms(lambda: gather.graph_max_pool_cuda(x, idx), REPS),
                                               time_ms(lambda: gather.plain(x, idx), REPS),
                                               bound(roofline.pool_work(x, idx)))
                    widths, widths_ok = slice_widths(lambda w: gather.graph_max_pool_cuda(x, idx, slice_width=w), x)
                    check(err == 0.0 and widths_ok, f'graph_max_pool B={bb} F={f} k={k}: bit-exact (max |diff| '
                          f'{err}); {row[0]:.4f} ms (plain {row[1]:.3f} ms, bound {row[2]["bound_ms"]:.4f} ms); '
                          f'{widths}')
        head = pool_ms[b, 256, 25]
        kernels['graph_max_pool'] = {'max_abs_err': max(pool_errs), 'ms': head[0], 'plain_ms': head[1], **head[2],
                                     'library_ms': None, 'shape': '(16, 2048, 256) k=25'}
        print('graph_max_pool ms by (B, F, k): ' + json.dumps({f'{bb},{f},{k}': round(v[0], 4) for (bb, f, k), v
                                                               in pool_ms.items()}), flush=True)

        # the fused PCGen at serving's batch 1 and 16 (the headline) and the
        # suites' chunks of 64 and 58
        dec = vqvae.decoder
        pack = dec.pack()
        pcgen_errs, pcgen_rows = [], {}
        for bb in (1, b, *SUITE_CHUNKS):
            m = torch.relu(torch.from_numpy(rng.standard_normal((bb, n, 64)).astype(np.float32))).to(dev)
            w = torch.from_numpy(rng.standard_normal((bb, cfg.autoencoder.w_dim)).astype(np.float32)).to(dev)
            run_k = functools.partial(pcgen.pcgen_mix_cuda, m, w, pack, tau=dec.tau, act_slope=0.0)
            run_p = functools.partial(pcgen.plain, m, w, pack, tau=dec.tau, act_slope=0.0)
            got, want = run_k(), run_p()
            r = rel_l2(got, want)
            pcgen_errs.append(float((got - want).abs().max()))
            work = roofline.pcgen_work(m, w, pack)
            row = pcgen_rows[bb] = {'rel_l2': r, 'ms': time_ms(run_k, REPS), 'plain_ms': time_ms(run_p, REPS),
                                    **bound(work)}
            check(r <= PCGEN_REL_L2 and bool(torch.isfinite(got).all()),
                  f'pcgen_mix B={bb}: rel L2 {r:.3e} <= {PCGEN_REL_L2}; {row["ms"]:.4f} ms (plain '
                  f'{row["plain_ms"]:.3f} ms, bound {row["bound_ms"]:.4f} ms, {row["bound_by"]})')
        # the chain and the fused PCGen have no single PyTorch call either
        kernels['pcgen_mix'] = {'max_abs_err': max(pcgen_errs), **pcgen_rows[b], 'library_ms': None,
                                'shape': '(16, 2048, 64) -> (16, 2048, 3), G=8, 1024-1024-256-16'}

        wae = vqvae.w_autoencoder
        cpack = cvae.pack_cvae_cf(wae)
        tokens = torch.from_numpy(rng.standard_normal((b, wae.n_codes, wae.embedding_dim)).astype(np.float32)).to(dev)
        probs = torch.softmax(torch.from_numpy(rng.standard_normal((b, cfg.data.n_classes)).astype(np.float32)), -1)
        probs = probs.to(dev)
        run_k = lambda: cvae.cvae_cf_cuda(tokens, probs, cpack)  # noqa: E731
        run_p = lambda: cvae.plain(tokens, probs, cpack)  # noqa: E731
        got, want = run_k(), run_p()
        r = rel_l2(got, want)
        check(r <= CVAE_REL_L2 and bool(torch.isfinite(got).all()), f'cvae_cf: rel L2 {r:.3e} <= {CVAE_REL_L2}')
        kernels['cvae_cf'] = {'max_abs_err': float((got - want).abs().max()), 'rel_l2': r,
                              'ms': time_ms(run_k, REPS), 'plain_ms': time_ms(run_p, REPS),
                              **bound(roofline.cvae_work(tokens, probs, cpack)), 'library_ms': None,
                              'shape': '(16, 256, 4), d=512, 8 heads, 2+2+4 layers'}
        # the chain at the suites' chunks of 64 and 58 and a subset's 1
        for bb in (*SUITE_CHUNKS, 1):
            x = torch.from_numpy(rng.standard_normal((bb, wae.n_codes, wae.embedding_dim)).astype(np.float32)).to(dev)
            pr = torch.softmax(torch.from_numpy(rng.standard_normal((bb, cfg.data.n_classes)).astype(np.float32)),
                               -1).to(dev)
            got, want = cvae.cvae_cf_cuda(x, pr, cpack), cvae.plain(x, pr, cpack)
            r = rel_l2(got, want)
            kernels['cvae_cf']['max_abs_err'] = max(kernels['cvae_cf']['max_abs_err'], float((got - want).abs().max()))
            ms = time_ms(lambda: cvae.cvae_cf_cuda(x, pr, cpack), REPS) if bb > 1 else float('nan')
            check(r <= CVAE_REL_L2 and bool(torch.isfinite(got).all()),
                  f'cvae_cf B={bb}: rel L2 {r:.3e} <= {CVAE_REL_L2}' + (f'; {ms:.4f} ms' if bb > 1 else ''))

        # ---- the training path's kernels at its shapes, batch 8 ----------
        bt = TRAIN_BATCH

        def graph(k: int, c: int = 8) -> torch.Tensor:
            return knn.knn_cuda(torch.from_numpy(rng.standard_normal((bt, n, c)).astype(np.float32)).to(dev), k)

        def randn(*shape: int) -> torch.Tensor:
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

        def timed(name: str, shape: str, run_k, run_p, err: float, ok: bool, what: str, work: roofline.Work,
                  run_lib=None, run_chain=None) -> None:
            """Time the kernel, its plain version and, where one exists, the
            single PyTorch call that computes the same function, or the chain
            of launches the kernel replaced on the path."""
            row = {'ms': time_ms(run_k, REPS), 'plain_ms': time_ms(run_p, REPS), **bound(work),
                   'library_ms': time_ms(run_lib, REPS) if run_lib is not None else None}
            lib = f', library {row["library_ms"]:.4f}' if run_lib is not None else ''
            if run_chain is not None:
                row['chain_ms'] = time_ms(run_chain, REPS)
                lib += f', the chain it replaced {row["chain_ms"]:.4f}'
            check(ok, f'{name} {shape}: {what}; {row["ms"]:.4f} ms (plain {row["plain_ms"]:.4f}{lib}, bound '
                      f'{row["bound_ms"]:.4f} ms, {row["bound_by"]})')
            entry = kernels.setdefault(name, {'max_abs_err': 0.0, 'shapes': {}})
            entry['max_abs_err'] = max(entry['max_abs_err'], err)
            entry['shapes'][shape] = row
            entry.update(row, shape=shape)  # the last (largest) shape is the headline

        def index_add_rows(g: torch.Tensor, idx: torch.Tensor):
            """``index_add_`` over the flattened rows, the yardstick of the row
            scatter (its index and expanded source made beforehand)."""
            bb, m, c = g.shape
            rows = (idx.long() + n * torch.arange(bb, device=dev)[:, None, None]).reshape(-1)
            src = g[:, :, None, :].expand(bb, m, idx.shape[-1], c).reshape(-1, c)
            return lambda: torch.zeros((bb * n, c), device=dev).index_add_(0, rows, src)

        # the classifier step's EdgeConv kernels at batch 16, k=20, widths 64,
        # 64, 128, 256: the pool with its slot and its slot scatter, the
        # sum-pool of [u, u^2] and its row scatter (timed before stage 1's
        # shapes, whose last is each kernel's headline)
        bc = cfg.classifier.train.batch_size
        idx20 = knn.knn_cuda(torch.from_numpy(rng.standard_normal((bc, n, 8)).astype(np.float32)).to(dev), 20)
        for f in (64, 128, 256):
            x = randn(bc, n, f)
            out, slots = gather.graph_max_pool_src_cuda(x, idx20)
            want, want_slots = ops.graph_max_pool_slots(x, idx20)
            exact = torch.equal(out, want) and torch.equal(slots, want_slots)
            timed('graph_max_pool_src', f'({bc}, {n}, {f}) k=20', lambda: gather.graph_max_pool_src_cuda(x, idx20),
                  lambda: ops.graph_max_pool_slots(x, idx20), float((out - want).abs().max()), exact,
                  f'max and slots bit-exact to the plain version {exact}', roofline.pool_work(x, idx20, slots=True))
            g = randn(bc, n, f)
            got = gather.scatter_add_slots_cuda(g, idx20, slots, n)
            exact = torch.equal(got.cpu(), ops.scatter_add_slots(g.cpu(), idx20.cpu(), slots.cpu(), n))
            timed('scatter_add_slots', f'({bc}, {n}, {f}) k=20',
                  lambda: gather.scatter_add_slots_cuda(g, idx20, slots, n),
                  lambda: ops.scatter_add_slots(g, idx20, slots, n),
                  float((got - ops.scatter_add_slots(g, idx20, slots, n)).abs().max()), exact,
                  f'bit-equal to the plain version on the CPU {exact}', roofline.scatter_slots_work(g, idx20, slots, n))
            x2 = randn(bc, n, 2 * f)
            got, want = gather.graph_sum_pool_cuda(x2, idx20), ops.graph_sum_pool(x2, idx20)
            r = rel_max(got, want)
            timed('graph_sum_pool', f'({bc}, {n}, {2 * f}) k=20', lambda: gather.graph_sum_pool_cuda(x2, idx20),
                  lambda: ops.graph_sum_pool(x2, idx20), float((got - want).abs().max()), r <= SUM_POOL_REL_MAX,
                  f'rel max diff {r:.2e} <= {SUM_POOL_REL_MAX}', roofline.pool_work(x2, idx20))
            got = gather.scatter_add_rows_cuda(x2, idx20, n)
            exact = torch.equal(got.cpu(), ops.scatter_add_rows(x2.cpu(), idx20.cpu(), n))
            timed('scatter_add_rows', f'({bc}, {n}, {2 * f}) k=20', lambda: gather.scatter_add_rows_cuda(x2, idx20, n),
                  lambda: ops.scatter_add_rows(x2, idx20, n),
                  float((got - ops.scatter_add_rows(x2, idx20, n)).abs().max()), exact,
                  f'bit-equal to the plain version on the CPU {exact}', roofline.scatter_rows_work(x2, idx20, n),
                  index_add_rows(x2, idx20))

        # pool with slot and its slot scatter at every encoder width, k=25:
        # the pool bit-exact to the strict > rule on rows with NaNs, ties and a
        # hub row, and without NaNs to the plain version and the eval pool;
        # the scatter bit-equal to its plain version on the CPU, on every call,
        # its plan (held equal to the library's) beside the other slice widths
        # and row splits
        idx25 = graph(25)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for f in (64, 128, 256):
            x = randn(bt, n, f)
            x_nan, idx_nan = x.clone(), idx25.clone()
            x_nan[:, 40] = x_nan[:, 7]
            x_nan[:, 11, ::3] = float('nan')
            x_nan[:, 12, 1::5] = float('nan')
            idx_nan[..., 1], idx_nan[..., 24] = 7, 40
            idx_nan[:, : 3 * n // 4, 12] = 11
            idx_nan[:, ::7, 0] = 12
            got_nan, got_nan_slots = gather.graph_max_pool_src_cuda(x_nan, idx_nan)
            want_nan, want_nan_slots = ops.graph_max_pool_slots_strict(x_nan, idx_nan)
            nan = torch.isnan(want_nan)
            strict = (bool(nan.any()) and torch.equal(nan, torch.isnan(got_nan))
                      and torch.equal(got_nan[~nan].view(torch.int32), want_nan[~nan].view(torch.int32))
                      and torch.equal(got_nan_slots, want_nan_slots))
            out, slots = gather.graph_max_pool_src_cuda(x, idx25)
            want, want_slots = ops.graph_max_pool_slots(x, idx25)
            exact = torch.equal(out, want) and torch.equal(slots, want_slots)
            eval_equal = torch.equal(out, gather.graph_max_pool_cuda(x, idx25))
            timed('graph_max_pool_src', f'({bt}, {n}, {f}) k=25', lambda: gather.graph_max_pool_src_cuda(x, idx25),
                  lambda: ops.graph_max_pool_slots(x, idx25), float((out - want).abs().max()),
                  strict and exact and eval_equal,
                  f'max and slots bit-exact to the strict > rule with NaNs, ties and a hub row {strict}, to the '
                  f'plain version without NaNs {exact}, bit-equal to graph_max_pool {eval_equal}',
                  roofline.pool_work(x, idx25, slots=True))
            g = randn(bt, n, f)
            got, want = gather.scatter_add_slots_cuda(g, idx25, slots, n), ops.scatter_add_slots(g, idx25, slots, n)
            # ascending centre order: bit-equal to scatter_add_ on the CPU, on every call
            exact = torch.equal(got.cpu(), ops.scatter_add_slots(g.cpu(), idx25.cpu(), slots.cpu(), n))
            same = torch.equal(got, gather.scatter_add_slots_cuda(g, idx25, slots, n))
            plan = gather.slot_scatter_plan(bt, n, f, sms=sms)
            same_plan = plan == gather.kernel_slot_scatter_plan(bt, n, f)
            others, others_equal = [], True
            for w, r in ((w, r) for w in gather.SLICE_WIDTHS for r in (1, 2, 4) if (w, r) != plan[:2] and f % w == 0):
                others_equal = others_equal and torch.equal(
                    gather.scatter_add_slots_cuda(g, idx25, slots, n, slice_width=w, ranges=r), got)
                ms = time_ms(lambda: gather.scatter_add_slots_cuda(g, idx25, slots, n, slice_width=w, ranges=r), REPS)
                others.append(f'{ms:.4f} ms in slices of {w}, {r} range(s)')
            timed('scatter_add_slots', f'({bt}, {n}, {f}) k=25', lambda: gather.scatter_add_slots_cuda(g, idx25, slots, n),
                  lambda: ops.scatter_add_slots(g, idx25, slots, n), float((got - want).abs().max()),
                  exact and same and same_plan and others_equal,
                  f'bit-equal to the plain version on the CPU {exact}, the same on a second call {same}; the plan: '
                  f'slices of {plan.slice_width}, {plan.ranges} row range(s), the kernel\'s plan too {same_plan}; '
                  + ', '.join(others) + f', bit-equal to the plan\'s {others_equal}',
                  roofline.scatter_slots_work(g, idx25, slots, n))

        def row_scatter_exact(got: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> tuple[bool, bool]:
            """(the kernel's rows equal the plain version's on a CPU copy, which
            adds in the kernel's ascending edge order; a second call equals the
            first)."""
            cpu = ops.scatter_add_rows(g.cpu(), idx.cpu(), n)
            return torch.equal(got.cpu(), cpu), torch.equal(got, gather.scatter_add_rows_cuda(g, idx, n))

        # sum-pool of [u, u^2] and its row scatter at every encoder width, k=25
        for f2 in (128, 256, 512):
            x = randn(bt, n, f2)
            got, want = gather.graph_sum_pool_cuda(x, idx25), ops.graph_sum_pool(x, idx25)
            r = rel_max(got, want)
            # the kernel adds in slot order: bit-equal to that sum on the CPU, on every call
            exact = torch.equal(got.cpu(), ops.graph_sum_pool_slot_order(x.cpu(), idx25.cpu()))
            same = torch.equal(got, gather.graph_sum_pool_cuda(x, idx25))
            widths, widths_ok = slice_widths(lambda w: gather.graph_sum_pool_cuda(x, idx25, slice_width=w), x)
            timed('graph_sum_pool', f'({bt}, {n}, {f2}) k=25', lambda: gather.graph_sum_pool_cuda(x, idx25),
                  lambda: ops.graph_sum_pool(x, idx25), float((got - want).abs().max()),
                  r <= SUM_POOL_REL_MAX and exact and same and widths_ok,
                  f'rel max diff {r:.2e} <= {SUM_POOL_REL_MAX}, bit-equal to the slot-order sum on the CPU {exact}, '
                  f'the same on a second call {same}; {widths}', roofline.pool_work(x, idx25))
            got, want = gather.scatter_add_rows_cuda(x, idx25, n), ops.scatter_add_rows(x, idx25, n)
            r, exact, same = rel_max(got, want), *row_scatter_exact(got, x, idx25)
            timed('scatter_add_rows', f'({bt}, {n}, {f2}) k=25', lambda: gather.scatter_add_rows_cuda(x, idx25, n),
                  lambda: ops.scatter_add_rows(x, idx25, n), float((got - want).abs().max()),
                  r <= SCATTER_REL_MAX and exact and same, f'rel max diff {r:.2e} <= {SCATTER_REL_MAX}, bit-equal '
                  f'to the plain version on the CPU {exact}, the same on a second call {same}',
                  roofline.scatter_rows_work(x, idx25, n), index_add_rows(x, idx25))
        # graph filtering's gather on the decoded cloud, k=4: serving (batch
        # 16) and training (batch 8, with its scatter: N*4 rows of one
        # neighbour); the yardstick is one advanced-indexing call
        for bb in (b, bt):
            cloud = torch.from_numpy(rng.standard_normal((bb, n, 3)).astype(np.float32)).to(dev)
            idx4 = knn.knn_cuda(cloud, 4)
            exact = torch.equal(gather.gather_neighbors_cuda(cloud, idx4), ops.gather_neighbors(cloud, idx4))
            rows4, batch_rows = idx4.long(), torch.arange(bb, device=dev)[:, None, None]
            timed('gather_neighbors', f'({bb}, {n}, 3) k=4', lambda: gather.gather_neighbors_cuda(cloud, idx4),
                  lambda: ops.gather_neighbors(cloud, idx4), 0.0 if exact else float('inf'), exact,
                  f'bit-exact {exact}', roofline.gather_work(cloud, idx4), lambda: cloud[batch_rows, rows4])
        g = randn(bt, n * 4, 3)
        flat = idx4.reshape(bt, n * 4, 1)
        got, want = gather.scatter_add_rows_cuda(g, flat, n), ops.scatter_add_rows(g, flat, n)
        r, exact, same = rel_max(got, want), *row_scatter_exact(got, g, flat)
        timed('scatter_add_rows', f'({bt}, {n}*4, 3) k=1', lambda: gather.scatter_add_rows_cuda(g, flat, n),
              lambda: ops.scatter_add_rows(g, flat, n), float((got - want).abs().max()),
              r <= SCATTER_REL_MAX and exact and same, f'rel max diff {r:.2e} <= {SCATTER_REL_MAX}, bit-equal to '
              f'the plain version on the CPU {exact}, the same on a second call {same}',
              roofline.scatter_rows_work(g, flat, n), index_add_rows(g, flat))
        headline = f'({bt}, {n}, 512) k=25'
        kernels['scatter_add_rows'].update(kernels['scatter_add_rows']['shapes'][headline], shape=headline)

        # graph filtering's fused pass at every shape the paths give it: the
        # card-vs-CPU step's (2, 512), a cloud with duplicated points, then
        # serving's batch 1 and 5, stage 1's 8, the suites' chunks of 64 and
        # 58, and serving's 16 (the headline, last).  Its indices equal knn_cuda's, its output and mean
        # are the plain version's on them.  No single PyTorch call computes
        # it: library_ms is null, and the chain it replaced (kNN, the gather,
        # the eager tail) is timed beside it.  Its clouds come from a
        # generator of their own, so every later phase draws what it drew
        # before this phase was added
        filter_rng = np.random.default_rng([args.seed, 11])

        def filter_randn(*shape: int) -> torch.Tensor:
            return torch.from_numpy(filter_rng.standard_normal(shape).astype(np.float32)).to(dev)

        def filter_chain(x: torch.Tensor) -> torch.Tensor:
            return ops.graph_filtering_with_idx(x, knn.knn_cuda(x, 4), gather_fn=gather.gather_neighbors_cuda)

        for bb, pts, dup in ((2, 512, False), (bt, n, True), (1, n, False), (5, n, False), (bt, n, False),
                             *((bb, n, False) for bb in SUITE_CHUNKS), (b, n, False)):
            cloud = (0.5 * filter_randn(bb, pts, 3)).contiguous()
            if dup:  # every point twice, and in cloud 0 point 8 three times: slot 0 the lowest copy
                cloud[:, 1::2] = cloud[:, 0::2]
                cloud[0, 100] = cloud[0, 8]
            out, idx, mean = graph_filter.graph_filter_cuda(cloud)
            same_idx = torch.equal(idx, knn.knn_cuda(cloud, 4))
            agree, _ = knn_check(cloud, 4, idx, knn.plain(cloud, 4))
            want = ops.graph_filtering_with_idx(cloud, idx)
            neigh = ops.gather_neighbors(cloud, idx)[:, :, 1:, :]
            want_mean = torch.sqrt(torch.abs(((cloud[:, :, None] - neigh) ** 2).sum(-1)) + 1e-12)[:, :, 0].mean(1)
            r, rm = rel_max(out, want), rel_max(mean, want_mean)
            again = all(torch.equal(a, c) for a, c in zip((out, idx, mean), graph_filter.graph_filter_cuda(cloud)))
            plan = graph_filter.filter_plan(bb, pts, sms)
            same_plan = plan == graph_filter.kernel_filter_plan(bb, pts, sms)
            timed('graph_filter', f'({bb}, {pts}, 3){" duplicated" if dup else ""}',
                  lambda: graph_filter.graph_filter_cuda(cloud), lambda: graph_filter.plain(cloud),
                  float((out - want).abs().max()),
                  same_idx and agree >= KNN_SET_AGREEMENT and max(r, rm) <= FILTER_REL_MAX and again and same_plan,
                  f'indices equal knn_cuda(x, 4)\'s {same_idx}, neighbour-set agreement with the plain kNN '
                  f'{agree:.6f}, output and mean rel max diff {r:.2e} / {rm:.2e} <= {FILTER_REL_MAX}, the same on a '
                  f'second call {again}; plan {tuple(plan)} (splits, centres a block, blocks a cloud), the '
                  f'library\'s too {same_plan}', roofline.filter_work(cloud), run_chain=lambda: filter_chain(cloud))
        # its backward at stage 1's batch and the card-vs-CPU step's, held to
        # the closed-form plain backward on the card and on the CPU; the
        # chain it replaced: autograd through the gather and the eager tail
        for bb, pts in ((2, 512), (bt, n)):
            cloud = (0.5 * filter_randn(bb, pts, 3)).contiguous()
            g = filter_randn(bb, pts, 3)
            _, idx, mean = graph_filter.graph_filter_cuda(cloud)
            dx = graph_filter.graph_filter_backward_cuda(cloud, idx, mean, g)
            want = graph_filter.plain_backward(cloud, idx, mean, g)
            r = rel_l2(dx, want)
            r_cpu = rel_l2(dx.cpu(), graph_filter.plain_backward(cloud.cpu(), idx.cpu(), mean.cpu(), g.cpu()))
            same = torch.equal(dx, graph_filter.graph_filter_backward_cuda(cloud, idx, mean, g))
            with torch.inference_mode(False):
                xc, ic, gc = cloud.clone().requires_grad_(True), idx.clone(), g.clone()
                oc = ops.graph_filtering_with_idx(xc, ic, gather_fn=api.gather_neighbors)
                timed('graph_filter_backward', f'({bb}, {pts}, 3)',
                      lambda: graph_filter.graph_filter_backward_cuda(cloud, idx, mean, g),
                      lambda: graph_filter.plain_backward(cloud, idx, mean, g), float((dx - want).abs().max()),
                      max(r, r_cpu) <= FILTER_GRAD_REL_L2 and same,
                      f'rel L2 {r:.2e} against the plain backward on the card, {r_cpu:.2e} on the CPU, <= '
                      f'{FILTER_GRAD_REL_L2}, the same on a second call {same} (its row scatter included)',
                      roofline.filter_work(cloud, backward=True),
                      run_chain=lambda: torch.autograd.grad(oc, xc, gc, retain_graph=True))
        # the ChamferEMD loss on a decoded cloud against its reference
        x1 = torch.from_numpy(synthetic.batch(args.seed, bt, n)).to(dev)
        x2 = (x1 + 0.05 * randn(bt, n, 3)).contiguous()
        got, want = emd.chamfer_match_cost_cuda(x1, x2), emd.plain(x1, x2)
        cost_err = float(((got[0] - want[0]).abs() / want[0].abs()).max())
        g1, g2 = rel_l2(got[1], want[1]), rel_l2(got[2], want[2])
        nn_exact = all(torch.equal(a, w) for a, w in zip(got[3:], want[3:]))
        same = all(torch.equal(a, w) for a, w in zip(got, emd.chamfer_match_cost_cuda(x1, x2)))
        timed('chamfer_match_cost', f'({bt}, {n}, 3) x ({bt}, {n}, 3)', lambda: emd.chamfer_match_cost_cuda(x1, x2),
              lambda: emd.plain(x1, x2), float((got[0] - want[0]).abs().max()),
              cost_err <= EMD_COST_RTOL and max(g1, g2) <= EMD_GRAD_REL_L2 and nn_exact and same,
              f'cost rel err {cost_err:.2e} <= {EMD_COST_RTOL}, grad rel L2 {g1:.2e} / {g2:.2e} <= '
              f'{EMD_GRAD_REL_L2}, Chamfer min/argmin exact {nn_exact}, the same on a second call {same}',
              roofline.emd_work(x1, x2))
        # the Chamfer and ChamferSinkhorn losses at the shapes their paths
        # give them, the headline (8, 2048, 3)^2 last: a decoded cloud
        # against its reference, a smaller batch, and a rectangular pair for
        # the marginal multipliers; no single PyTorch call computes either
        for bb, n1, n2, seed in ((2, 512, 512, 20), (bt, n, n // 2, 21), (bt, n, n, 22)):
            y1 = torch.from_numpy(synthetic.batch(args.seed + seed, bb, n1)).to(dev)
            y2 = (torch.from_numpy(synthetic.batch(args.seed + seed + 1, bb, n2)).to(dev)
                  + 0.05 * randn(bb, n2, 3)).contiguous()
            shape = f'({bb}, {n1}, 3) x ({bb}, {n2}, 3)'
            got, want = chamfer.nn_distance_cuda(y1, y2), chamfer.plain(y1, y2)
            exact = all(torch.equal(a, w) for a, w in zip(got, want))
            same = all(torch.equal(a, w) for a, w in zip(got, chamfer.nn_distance_cuda(y1, y2)))
            timed('nn_distance', shape, lambda: chamfer.nn_distance_cuda(y1, y2), lambda: chamfer.plain(y1, y2),
                  0.0 if exact else float('inf'), exact and same,
                  f'minima and argmins bit-exact {exact}, the same on a second call {same}; '
                  f'{chamfer.nn_plan(bb, n1, sms)} column split(s)', roofline.nn_distance_work(y1, y2))
            got, want = sinkhorn.sinkhorn_cost_cuda(y1, y2), sinkhorn.plain(y1, y2)
            cost_err = float(((got[0] - want[0]).abs() / want[0].abs()).max())
            g1, g2 = rel_l2(got[1], want[1]), rel_l2(got[2], want[2])
            exact = all(torch.equal(a, w) for a, w in zip(got[3:], want[3:]))
            same = all(torch.equal(a, w) for a, w in zip(got, sinkhorn.sinkhorn_cost_cuda(y1, y2)))
            splan = sinkhorn.sweep_plan(bb, n1, n2, sms)
            same_plan = splan == sinkhorn.kernel_sweep_plan(bb, n1, n2, sms)
            floor = SINKHORN_MUFU_PER_PAIR * bb * n1 * n2 / (MUFU_PER_CLOCK * sms * max_sm_mhz * 1e3)
            timed('sinkhorn_cost', shape, lambda: sinkhorn.sinkhorn_cost_cuda(y1, y2), lambda: sinkhorn.plain(y1, y2),
                  float((got[0] - want[0]).abs().max()),
                  cost_err <= SINKHORN_COST_RTOL and max(g1, g2) <= SINKHORN_GRAD_REL_L2 and exact and same
                  and same_plan,
                  f'cost rel err {cost_err:.2e} <= {SINKHORN_COST_RTOL}, grad rel L2 {g1:.2e} / {g2:.2e} <= '
                  f'{SINKHORN_GRAD_REL_L2}, Chamfer min/argmin exact {exact}, the same on a second call {same}; '
                  f'sweeps {splan}, the library\'s too {same_plan}; special-function floor of the schedule '
                  f'{floor:.4f} ms ({SINKHORN_MUFU_PER_PAIR} a pair, {MUFU_PER_CLOCK} a clock on each of {sms} SMs '
                  f'at {max_sm_mhz:.0f} MHz)',
                  roofline.sinkhorn_work(y1, y2))
        # what one EMD call and one Sinkhorn call at the headline run on the
        # device, from one trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            emd.chamfer_match_cost_cuda(x1, x2)
            torch.cuda.synchronize()
            sinkhorn.sinkhorn_cost_cuda(y1, y2)
            torch.cuda.synchronize()
        sequence = [short_kernel_name(name) for name, _, _ in device_events(prof)]
        sweeps = sum(1 for name in sequence if re.match(r'emd_(rows|cols)_kernel', name))
        check(sweeps == EMD_PAIR_SWEEPS, f'chamfer_match_cost: {sweeps} pair sweeps a call == {EMD_PAIR_SWEEPS}')
        sweeps = sum(1 for name in sequence if re.match(r'sinkhorn_(build|sweep)_kernel', name))
        check(sweeps == SINKHORN_PAIR_SWEEPS == len(sinkhorn.schedule()),
              f'sinkhorn_cost: {sweeps} pair sweeps a call == {SINKHORN_PAIR_SWEEPS}; device launches of both in '
              f'order: {", ".join(sequence)}')

        # ---- the stage-2 stacks at the flagship shapes, batch 32 ----------
        # the W-encoder and the posterior (2 layers, FF 1024) and the
        # W-decoder (4 layers, FF 1024, 1024, 1024, 512), packed from a
        # W-autoencoder's live weights as the eval forward packs them
        wae = build_w_autoencoder(cfg)
        init_from_seed(wae, args.seed + 6)
        wae = wae.to(dev)
        bw, t, d = cfg.w_autoencoder.train.batch_size, wae.n_codes, wae.decoder.proj_dim
        # the W-nets' stacks in eval at the suites' chunks of 64, 58 and 1
        # (the double reconstruction), before the headline batch of 32
        for bb in (*SUITE_CHUNKS, 1):
            for name, net_name, net in (('wformer_encoder', 'W-encoder', wae.encoder),
                                        ('wformer_decoder', 'W-decoder', wae.decoder)):
                x = randn(bb, t, d)
                if name == 'wformer_decoder':
                    memory = randn(bb, t, d)
                    spack = wformer.pack_decoder(net.layers)
                    run_k = functools.partial(wformer.wformer_decoder_cuda, x, memory, spack, net.n_heads)
                    run_p = functools.partial(wformer.plain_decoder, x, memory, spack, net.n_heads)
                    work = roofline.decoder_stack_work(x, memory, spack)
                else:
                    spack = wformer.pack_encoder(net.layers)
                    run_k = functools.partial(wformer.wformer_encoder_cuda, x, spack, net.n_heads)
                    run_p = functools.partial(wformer.plain_encoder, x, spack, net.n_heads)
                    work = roofline.encoder_stack_work(x, spack)
                got, want = run_k(), run_p()
                r = rel_l2(got, want)
                timed(name, f'{net_name} ({bb}, {t}, {d})', run_k, run_p, float((got - want).abs().max()),
                      r <= CVAE_REL_L2 and bool(torch.isfinite(got).all()), f'rel L2 {r:.3e} <= {CVAE_REL_L2}', work)
        stacks = [('wformer_encoder', 'W-encoder', wae.encoder), ('wformer_encoder', 'posterior', wae.z2_posterior),
                  ('wformer_decoder', 'W-decoder', wae.decoder)]
        stack_runs = {}
        for name, net_name, net in reversed(stacks):  # the W-encoder last: the headline
            decoder = name == 'wformer_decoder'
            heads = net.n_heads
            x = randn(bw, t, d)
            ff = ', '.join(str(layer.dense_0.out_features) for layer in net.layers)
            shape = f'{net_name} ({bw}, {t}, {d}), {heads} heads, FF {ff}'
            if decoder:
                memory = randn(bw, t, d)
                spack = wformer.pack_decoder(net.layers)
                run_k = functools.partial(wformer.wformer_decoder_cuda, x, memory, spack, heads)
                run_p = lambda: wformer.plain_decoder(x, memory, spack, heads)  # noqa: E731
                lib_stack = library_stack(spack, heads, True)
                run_l = lambda: lib_stack(x, memory)  # noqa: E731
                work = roofline.decoder_stack_work(x, memory, spack)
            else:
                spack = wformer.pack_encoder(net.layers)
                run_k = functools.partial(wformer.wformer_encoder_cuda, x, spack, heads)
                run_p = lambda: wformer.plain_encoder(x, spack, heads)  # noqa: E731
                lib_stack = library_stack(spack, heads, False)
                run_l = lambda: lib_stack(x)  # noqa: E731
                work = roofline.encoder_stack_work(x, spack)
            got, want, lib_out = run_k(), run_p(), run_l()
            r, r_lib = rel_l2(got, want), rel_l2(lib_out, want)
            timed(name, shape, run_k, run_p, float((got - want).abs().max()),
                  r <= CVAE_REL_L2 and r_lib <= CVAE_REL_L2 and bool(torch.isfinite(got).all()),
                  f'rel L2 {r:.3e} <= {CVAE_REL_L2} (the library stack against the plain version {r_lib:.3e}); '
                  f'{work.ops / 1e9:.1f} GFLOP', work, run_l)
            stack_runs[net_name] = run_k

        # ---- the stacks' device kernels, one line per shape they launch ---
        # recorded from the headline W-encoder and W-decoder (batch 32) and
        # the CVAE chain at serving's batch 16 and 1
        stack_runs['CVAE b16'] = functools.partial(cvae.cvae_cf_cuda, tokens, probs, cpack)
        stack_runs['CVAE b1'] = functools.partial(cvae.cvae_cf_cuda, tokens[:1].contiguous(), probs[:1].contiguous(),
                                                  cpack)
        shapes: dict[tuple, list[str]] = {}
        for who in ('W-encoder', 'W-decoder', 'CVAE b16', 'CVAE b1'):
            for key in launch_shapes(_build, stack_runs[who]):
                shapes.setdefault(key, []).append(who)
        launch_ms: dict[tuple, float] = {}
        for key, who in shapes.items():
            if key[0] == 'gemm':
                _, m, nn, k, groups, has_bias, gelu, res_rows, alias = key
                a = randn(m, k)
                wts = [randn(nn, k) * k ** -0.5 for _ in range(groups)]
                biases = [randn(nn) if has_bias else None for _ in range(groups)]
                res = randn(res_rows, nn) if res_rows else None
                st = wformer.Stacks(1, m, k, dev)
                want = [a.double() @ w.double().T + (bb.double() if has_bias else 0.0) for w, bb in zip(wts, biases)]
                if gelu:
                    want = [ops.gelu_exact(x) for x in want]
                if res is not None:
                    want = [x + res.double().repeat(m // res_rows, 1) for x in want]
                outs = [res.clone()] if alias else [torch.empty(m, nn, device=dev) for _ in wts]
                st.gemm(a, wts, biases, outs, outs[0] if alias else res, res_rows, gelu)
                r = max(rel_l2(o, x) for o, x in zip(outs, want))
                if alias:
                    outs = [res]

                def plain(a=a, wts=wts, biases=biases, res=res, gelu=gelu, m=m):
                    ys = [torch.nn.functional.linear(a, w, bb) for w, bb in zip(wts, biases)]
                    ys = [ops.gelu_exact(y) for y in ys] if gelu else ys
                    return [y + res.repeat(m // res.shape[0], 1) for y in ys] if res is not None else ys

                w_cat, b_cat = torch.cat(wts), torch.cat(biases) if has_bias else None
                row = (time_ms(functools.partial(st.gemm, a, wts, biases, outs, res, res_rows, gelu), REPS),
                       time_ms(plain, REPS),
                       time_ms(functools.partial(torch.nn.functional.linear, a, w_cat, b_cat), REPS),
                       bound(roofline.gemm_work(m, nn, k, groups, has_bias, res_rows)))
                epilogue = ' + '.join(e for e, on in (('bias', has_bias), ('GELU', gelu), (
                    f'res[row % {res_rows}]' if res_rows and res_rows != m else 'res', res_rows),
                    ('in place', alias)) if on) or 'none'
                what = f'pccf_gemm (M, N, K) = ({m}, {nn}, {k}){f" x {groups} groups" if groups > 1 else ""}, ' \
                       f'{epilogue} [{", ".join(who)}]: rel L2 vs float64 {r:.2e} <= {GEMM_REL_L2}'
                ok = r <= GEMM_REL_L2
            else:
                _, bb, tq, tk, heads, hd = key
                dd = heads * hd
                q, k_, v_ = randn(bb * tq, dd), randn(bb * tk, dd), randn(bb * tk, dd)
                out = torch.empty(bb * tq, dd, device=dev)
                st = wformer.Stacks(bb, tq, dd, dev)
                st.attend(q, k_, v_, out, heads)
                want = ops.attention(q.double().view(bb, tq, dd), k_.double().view(bb, tk, dd),
                                     v_.double().view(bb, tk, dd), heads)
                r = rel_l2(out.view(bb, tq, dd), want)
                q4, k4, v4 = (x.view(bb, -1, heads, hd).transpose(1, 2) for x in (q, k_, v_))
                row = (time_ms(functools.partial(st.attend, q, k_, v_, out, heads), REPS),
                       time_ms(functools.partial(ops.attention, q.view(bb, tq, dd), k_.view(bb, tk, dd),
                                                 v_.view(bb, tk, dd), heads), REPS),
                       time_ms(functools.partial(torch.nn.functional.scaled_dot_product_attention, q4, k4, v4), REPS),
                       bound(roofline.attention_work(bb, tq, tk, heads, hd)))
                what = f'pccf_attention (B, T, T_kv) = ({bb}, {tq}, {tk}), {heads} heads of {hd} ' \
                       f'[{", ".join(who)}]: rel L2 vs float64 {r:.2e} <= {ATTENTION_REL_L2}'
                ok = r <= ATTENTION_REL_L2
            launch_ms[key] = row[0]
            check(ok, f'{what}; {row[0]:.4f} ms a launch (plain {row[1]:.4f}, library {row[2]:.4f}, bound '
                      f'{row[3]["bound_ms"]:.4f} ms ({row[3]["bound_by"]}), share {row[3]["bound_ms"] / row[0]:.1%})')

        # the weight split that feeds the GEMM, on the real weights of the
        # W-encoder, the W-decoder and the CVAE pack; no PyTorch call splits
        for who, ws in (('W-encoder', wformer.stack_weights(wformer.pack_encoder(wae.encoder.layers))),
                        ('W-decoder', wformer.stack_weights(wformer.pack_decoder(wae.decoder.layers))),
                        ('CVAE pack', cpack.cuda_operands()['weights'])):
            small = wformer.split_small(ws)
            exact = all(torch.equal(small[w.data_ptr()], wformer.tf32_split(w)[1]) for w in ws)
            work = roofline.split_work(ws)
            row = (time_ms(functools.partial(wformer.split_small, ws), REPS),
                   time_ms(lambda ws=ws: [wformer.tf32_split(w)[1] for w in ws], REPS), bound(work))
            check(exact, f'pccf_tf32_split, the {len(ws)} matrices of the {who} ({work.bytes / 8e6:.2f} M '
                         f'elements): small parts bit-exact {exact}; {row[0]:.4f} ms a launch (plain {row[1]:.4f}, '
                         f'bound {row[2]["bound_ms"]:.4f} ms ({row[2]["bound_by"]}), '
                         f'share {row[2]["bound_ms"] / row[0]:.1%})')

    # ---- the main path, serving: a server answering requests -------------
    # the server's default buckets (1, 2, 4, 8, 16, 32, 64): requests of 1,
    # 5 (bucket 8), 16, 20 (bucket 32) and 64, the first request again inside
    # the last three; the extra clouds come from a generator of their own, so
    # every later phase draws what it drew before
    server = CounterfactualServer(vqvae, classifier, seed=args.seed)
    check(server.buckets == (1, 2, 4, 8, 16, 32, 64), f'server buckets {server.buckets}')
    clouds = (rng.standard_normal((22, n, 3)) / 2).astype(np.float32)
    serve_rng = np.random.default_rng([args.seed, 12])
    extra = (serve_rng.standard_normal((63, n, 3)) / 2).astype(np.float32)

    def with_first(cl: np.ndarray, at: int, seed0: int) -> tuple:
        """``cl`` with the first request's cloud (target 1, seed 11) at ``at``."""
        m = cl.shape[0] + 1
        tdim, seeds = np.arange(m) % 2, seed0 + np.arange(m)
        tdim[at], seeds[at] = 1, 11
        return np.concatenate([cl[:at], clouds[:1], cl[at:]]), tdim, seeds

    requests = [
        (clouds[:1], np.asarray([1]), np.asarray([11])),
        (clouds[1:6], np.asarray([0, 1, 0, 1, 1]), np.asarray([21, 22, 3, 24, 25])),
        # the first request again, at position 7 of a full batch
        (np.concatenate([clouds[6:13], clouds[:1], clouds[13:21]]),
         np.arange(16) % 2 | (np.arange(16) == 7), np.concatenate([np.arange(100, 107), [11], np.arange(107, 115)])),
        with_first(clouds[1:20], 13, 300),  # 20: one batch of bucket 32, padded by 12
        with_first(extra, 40, 400),  # 64: the largest bucket, full
    ]
    first_at = {2: 7, 3: 13, 4: 40}
    served_before = dict(server.stats)
    api.reset_launch_counts()
    outs, req_ms = [], []
    for cl, tdim, seeds in requests:
        t0 = time.perf_counter()
        outs.append(server.counterfactual(cl, tdim, sampling_seed=seeds))
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
    launches = api.launch_counts()
    for (cl, _, _), out in zip(requests, outs):
        check(out.shape == (cl.shape[0], cfg.data.n_target_points, 3) and bool(np.isfinite(out).all()),
              f'request of {cl.shape[0]}: output {out.shape} finite')
    for i, at in first_at.items():
        diff = float(np.abs(outs[0][0] - outs[i][at]).max() / (np.sqrt(np.mean(outs[0] ** 2)) + 1e-12))
        check(diff <= BATCH_INVARIANCE, f'request alone vs at {at} of a batch of {len(requests[i][0])} (bucket '
                                        f'{next_bucket(len(requests[i][0]), server.buckets)}): rel max diff {diff:.2e}')
    sizes = [len(r[0]) for r in requests]
    buckets = [next_bucket(s, server.buckets) for s in sizes]
    check(server.stats == {'served': served_before['served'] + sum(sizes),
                           'batches': served_before['batches'] + len(sizes),
                           'padded': served_before['padded'] + sum(buckets) - sum(sizes)},
          f'serving stats {server.stats}: one batch a request, buckets {buckets}')
    for name in SERVING_KERNELS:
        check(launches[name] > 0, f'{name}: {launches[name]} launches on the serving path')
    for name in KERNEL_INFO:
        want = REQUEST_LAUNCHES.get(name, 0) * len(requests)
        check(launches[name] == want, f'{name}: {launches[name]} launches on the serving path == {want}')
    print(f'request ms (batch {", ".join(map(str, sizes))}; host clock incl. copies): '
          f'{[round(v, 3) for v in req_ms]}', flush=True)
    for i in (0, 2, 3, 4):  # warm requests, batch 1, 16, 20, 64: device time by kernel (1, 16), then latency
        cl, tdim, seeds = requests[i]
        if i in (0, 2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                server.counterfactual(cl, tdim, sampling_seed=seeds)
                torch.cuda.synchronize()
            print(f'profile of one batch-{cl.shape[0]} request:', flush=True)
            print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=12, max_name_column_width=50),
                  flush=True)
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            server.counterfactual(cl, tdim, sampling_seed=seeds)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(times, [25, 50, 75])
        print(f'warm request batch {cl.shape[0]} (bucket {next_bucket(cl.shape[0], server.buckets)}): median '
              f'{med:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms over {REPS} (host clock incl. copies)', flush=True)
    # the decoder scaffold of a bucket-64 chunk on the host: 64 generators and
    # their draws, then one copy to the card
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.initial_sampling(np.arange(64))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f'request scaffold of a bucket-64 chunk on the host: median {np.median(times):.3f} ms over 5 (64 '
          f'generators, (64, {n}, {vqvae.decoder.sample_dim}) draws and their copy)', flush=True)

    # ---- card vs CPU on a batch of 2 --------------------------------------
    pair = torch.from_numpy(clouds[1:3])
    samp = server.initial_sampling(np.asarray([1, 2])).cpu()
    tdim = torch.tensor([1, 0])

    def run(vq, cls, device):
        with torch.inference_mode():
            cloud = pair.to(device)
            logits = cls(Inputs(cloud=cloud))
            out = vq.generate_counterfactual(Inputs(cloud=cloud, initial_sampling=samp.to(device)), logits,
                                             tdim.to(device))
            return logits.cpu(), out.idx.cpu(), out.recon.cpu()

    gpu = run(vqvae, classifier, dev)
    cpu_vqvae = copy.deepcopy(vqvae).cpu()
    cpu_vqvae.prepack()  # the folded weights are not module state: fold again on the CPU
    cpu = run(cpu_vqvae, copy.deepcopy(classifier).cpu(), torch.device('cpu'))
    lerr = float((gpu[0] - cpu[0]).abs().max() / (cpu[0].abs().max() + 1e-12))
    check(lerr <= 1e-3, f'card vs CPU logits: rel max diff {lerr:.2e}')
    agree = float((gpu[1] == cpu[1]).float().mean())
    check(agree >= CODE_AGREEMENT, f'card vs CPU code agreement {agree:.4f} >= {CODE_AGREEMENT}')
    same = (gpu[1] == cpu[1]).all(dim=1)
    check(bool(same.any()), f'card vs CPU: {int(same.sum())} of 2 samples with all codes equal')
    if same.any():
        r = rel_l2(gpu[2][same], cpu[2][same])
        check(r <= RECON_REL_L2, f'card vs CPU recon rel L2 {r:.3e} <= {RECON_REL_L2}')

    # ---- serving: microbatching, requests in flight, warmup ---------------
    # submit x 5 (two without logits) then flush: equal to counterfactual on
    # the same batch; then a flush on a second thread while five submits land
    mb = (serve_rng.standard_normal((8, n, 3)) / 2).astype(np.float32)
    mb_tdim, mb_seeds = np.arange(8) % 2, 200 + np.arange(8)
    mb_logits = server.classify(mb)
    tickets = [server.submit(mb[i], int(mb_tdim[i]), None if i in (1, 3) else mb_logits[i], 1.0, int(mb_seeds[i]))
               for i in range(5)]
    flushed = server.flush()
    direct = server.counterfactual(mb[:5], mb_tdim[:5], None, 1.0, mb_seeds[:5])
    scale = np.sqrt(np.mean(direct ** 2)) + 1e-12
    diff = max(float(np.abs(flushed[t] - direct[i]).max() / scale) for i, t in enumerate(tickets)) \
        if sorted(flushed) == tickets else float('inf')
    check(diff <= BATCH_INVARIANCE and server.flush() == {},
          f'submit x 5 (2 without logits), flush: tickets {sorted(flushed)}, rel max diff to counterfactual on '
          f'the batch {diff:.2e} <= {BATCH_INVARIANCE}, the queue drained')
    early = [server.submit(mb[i], int(mb_tdim[i]), mb_logits[i], 1.0, int(mb_seeds[i])) for i in range(3)]
    thread_results, thread_errors = {}, []

    def flush_on_thread() -> None:
        try:
            thread_results.update(server.flush())
        except Exception as e:  # reported by the check below
            thread_errors.append(repr(e))

    worker = threading.Thread(target=flush_on_thread)
    worker.start()
    late = [server.submit(mb[i], int(mb_tdim[i]), mb_logits[i], 1.0, int(mb_seeds[i])) for i in range(3, 8)]
    worker.join(timeout=300)
    rest = server.flush()
    served = {**thread_results, **rest}
    direct = server.counterfactual(mb, mb_tdim, mb_logits, 1.0, mb_seeds)
    once = not (set(thread_results) & set(rest)) and sorted(served) == sorted(early + late)
    diff = max(float(np.abs(served[t] - direct[i]).max() / scale) for i, t in enumerate(early + late)) \
        if once else float('inf')
    check(not worker.is_alive() and not thread_errors and once and diff <= BATCH_INVARIANCE,
          f'flush on a second thread while 5 submits land: it served {len(thread_results)}, the next flush '
          f'{len(rest)}, each ticket once {once}, errors {thread_errors}; rel max diff to the batch of 8 {diff:.2e}')

    # counterfactual_async: four requests of 16 in flight, each equal to its
    # synchronous result; then the host clock of four pipelined requests
    # against four sequential ones (logits given: no classification waits)
    a_clouds = (serve_rng.standard_normal((4, 16, n, 3)) / 2).astype(np.float32)
    a_logits = [server.classify(c) for c in a_clouds]
    a_args = [(c, np.arange(16) % 2, lg, 1.0, 500 + 16 * i + np.arange(16)) for i, (c, lg) in
              enumerate(zip(a_clouds, a_logits))]
    sync = [server.counterfactual(*a) for a in a_args]
    futures = [server.counterfactual_async(*a) for a in a_args]
    pinned = all(host.is_pinned() for f in futures for _, host, _ in f._parts)
    got = [f.result() for f in futures]
    equal = all(np.array_equal(g, s) for g, s in zip(got, sync))
    check(equal and pinned, f'counterfactual_async: 4 requests of 16 in flight, each bit-equal to its synchronous '
                            f'result {equal}, host buffers pinned {pinned}')
    seq_ms, pipe_ms = [], []
    for _ in range(5):
        for pipelined, record in ((False, seq_ms), (True, pipe_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if pipelined:
                [f.result() for f in [server.counterfactual_async(*a) for a in a_args]]
            else:
                [server.counterfactual(*a) for a in a_args]
            record.append((time.perf_counter() - t0) * 1e3)
    print(f'4 requests of 16: sequential median {np.median(seq_ms):.3f} ms (quartiles '
          f'{np.percentile(seq_ms, 25):.3f} / {np.percentile(seq_ms, 75):.3f}), pipelined median '
          f'{np.median(pipe_ms):.3f} ms (quartiles {np.percentile(pipe_ms, 25):.3f} / '
          f'{np.percentile(pipe_ms, 75):.3f}), over 5 of each in turns (host clock)', flush=True)

    # warmup over every bucket: stats as they were
    before = dict(server.stats)
    t0 = time.perf_counter()
    server.warmup(n, cfg.data.n_classes)
    torch.cuda.synchronize()
    check(server.stats == before, f'warmup over buckets {server.buckets} in {time.perf_counter() - t0:.2f} s: '
                                  f'stats {server.stats} as before')

    # ---- the main path, generation: sampling from the prior --------------
    # server.generate at n = 1, 16 and 70 (chunks of 64 and 6, the second at
    # bucket 8), without and with probs, then the entry point at its
    # configured batch of 16 with a bias on z1; every chunk launches the
    # W-decoder stack, the fused PCGen and graph filtering once and nothing
    # else.  Its draws come from generators of their own
    gen_rng = np.random.default_rng([args.seed, 13])
    gen_seed, n_classes = args.seed + 3, cfg.data.n_classes
    gen_cfg = dataclasses.replace(cfg, user=dataclasses.replace(
        cfg.user, generate=dataclasses.replace(cfg.user.generate, bias_value=GENERATION_BIAS)))
    gen_probs = {s: gen_rng.dirichlet(np.ones(n_classes), s).astype(np.float32) for s in GENERATION_SIZES}
    api.reset_launch_counts()
    gen_outs, gen_ms = {}, {}
    for s in GENERATION_SIZES:
        for given in (False, True):
            t0 = time.perf_counter()
            gen_outs[s, given] = server.generate(s, probs=gen_probs[s] if given else None, seed=gen_seed)
            gen_ms[s, given] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    entry = generate_random_samples(gen_cfg, vqvae, seed=args.seed, device=dev)
    gen_ms['entry'] = (time.perf_counter() - t0) * 1e3
    gen_launches = api.launch_counts()
    chunks = 2 * sum(-(-s // next_bucket(s, server.buckets)) for s in GENERATION_SIZES) + 1
    for name in KERNEL_INFO:
        want = chunks if name in GENERATION_KERNELS else 0
        check(gen_launches[name] == want, f'{name}: {gen_launches[name]} launches on the generation path == {want} '
                                          f'({chunks} chunks)')
    for (s, given), out in gen_outs.items():
        check(out.shape == (s, cfg.data.n_target_points, 3) and bool(np.isfinite(out).all()),
              f'generate {s}{" with probs" if given else ""}: output {out.shape} finite')
    check(entry.shape == (cfg.user.generate.batch_size, cfg.data.n_target_points, 3)
          and bool(np.isfinite(entry).all()),
          f'generate_random_samples, bias {GENERATION_BIAS} on z1 column {cfg.user.generate.bias_dim}: output '
          f'{entry.shape} finite')
    print('generation ms, first calls (host clock incl. copies): ' + json.dumps(
        {f'{k[0]}{" probs" if k[1] else ""}' if isinstance(k, tuple) else k: round(v, 3)
         for k, v in gen_ms.items()}), flush=True)
    again = server.generate(16, seed=gen_seed)
    other = server.generate(16, seed=gen_seed + 1)
    check(np.array_equal(again, gen_outs[16, False]) and float(np.abs(other - again).max()) > 1e-4
          and np.array_equal(generate_random_samples(gen_cfg, vqvae, seed=args.seed, device=dev), entry),
          'generation: the same seed gives the same clouds (server and entry point), another seed other clouds')
    whole = gen_outs[70, False]
    head = server.generate(64, seed=gen_seed)
    apart = min(float(np.abs(whole[64:] - server.generate(6, seed=gen_seed + k)).max()) for k in range(1, 4))
    check(np.array_equal(whole[:64], head) and apart > 1e-5,
          f'generation chunks: the first chunk of 70 equals generate(64) of its seed, the second (6 at bucket 8) '
          f'none of generate(6) of seeds +1..+3 (min max |diff| {apart:.3e})')

    # the three kernels against their plain versions at generation's shapes:
    # the W-decoder with a z1 of one row broadcast over the code tokens (the
    # server's) and of a row per code (the entry point's), PCGen on the
    # generated codes, graph filtering on its output
    wae_g, dec_g = vqvae.w_autoencoder, vqvae.decoder
    wd = wae_g.decoder
    with torch.inference_mode():
        for bb in (1, 16, 64):
            noise_b, sampling = server.generation_draws(bb, gen_seed, 0)
            (eps1, eps2, prior), sampling = (x.to(dev) for x in noise_b), sampling.to(dev)
            bias = torch.zeros((bb, wd.n_codes, wae_g.z1_dim), device=dev)
            bias[:, :, cfg.user.generate.bias_dim] = GENERATION_BIAS
            p_mu2, p_log_var2 = wae_g.z2_prior(prior).chunk(2, dim=2)
            z2 = eps2 * torch.exp(0.5 * p_log_var2) + p_mu2
            shape = (bb, wd.n_codes, wd.proj_dim)
            spack = wformer.pack_decoder(wd.layers)
            x = (wd.z2_proj(z2).expand(shape) + wd.positional_embedding).contiguous()
            for form, z1 in (('z1 one row broadcast', eps1), ('z1 a row per code', eps1 + bias)):
                memory = (wd.z1_proj(z1).expand(shape) + wd.memory_positional_embedding).contiguous()
                run_k = functools.partial(wformer.wformer_decoder_cuda, x, memory, spack, wd.n_heads)
                run_p = functools.partial(wformer.plain_decoder, x, memory, spack, wd.n_heads)
                got, want = run_k(), run_p()
                r = rel_l2(got, want)
                kernels['wformer_decoder']['max_abs_err'] = max(kernels['wformer_decoder']['max_abs_err'],
                                                                float((got - want).abs().max()))
                check(r <= CVAE_REL_L2 and bool(torch.isfinite(got).all()),
                      f'wformer_decoder generation B={bb}, {form}: rel L2 {r:.3e} <= {CVAE_REL_L2}; '
                      f'{time_ms(run_k, REPS):.4f} ms (plain {time_ms(run_p, REPS):.4f})')
            codes = wae_g.decode(Outputs(z1=eps1, z2=z2, probs=prior), vqvae.codebook).idx
            w = ops.vq_lookup(codes, vqvae.codebook).contiguous()
            m = sampling
            for block in dec_g.map:
                m = block(m)
            m = m.contiguous()
            run_k = functools.partial(pcgen.pcgen_mix_cuda, m, w, dec_g.packed, tau=dec_g.tau, act_slope=0.0)
            run_p = functools.partial(pcgen.plain, m, w, dec_g.packed, tau=dec_g.tau, act_slope=0.0)
            mixed, want = run_k(), run_p()
            r = rel_l2(mixed, want)
            kernels['pcgen_mix']['max_abs_err'] = max(kernels['pcgen_mix']['max_abs_err'],
                                                      float((mixed - want).abs().max()))
            check(r <= PCGEN_REL_L2 and bool(torch.isfinite(mixed).all()),
                  f'pcgen_mix generation B={bb}: rel L2 {r:.3e} <= {PCGEN_REL_L2}; {time_ms(run_k, REPS):.4f} ms '
                  f'(plain {time_ms(run_p, REPS):.4f})')
            mixed = mixed.contiguous()
            out, idx, mean = graph_filter.graph_filter_cuda(mixed)
            want = ops.graph_filtering_with_idx(mixed, idx)
            r, same_idx = rel_max(out, want), torch.equal(idx, knn.knn_cuda(mixed, 4))
            kernels['graph_filter']['max_abs_err'] = max(kernels['graph_filter']['max_abs_err'],
                                                         float((out - want).abs().max()))
            check(same_idx and r <= FILTER_REL_MAX,
                  f'graph_filter generation B={bb}: indices equal knn_cuda(x, 4)\'s {same_idx}, rel max diff '
                  f'{r:.2e} <= {FILTER_REL_MAX}; {time_ms(lambda: graph_filter.graph_filter_cuda(mixed), REPS):.4f} '
                  f'ms (plain {time_ms(lambda: graph_filter.plain(mixed), REPS):.4f})')

    # card against CPU at batch 2 on the same host draws, z1 of one row and
    # of a row per code
    noise, sampling = server.generation_draws(2, gen_seed, 0)
    row_bias = torch.zeros((2, wd.n_codes, wae_g.z1_dim))
    row_bias[:, :, cfg.user.generate.bias_dim] = GENERATION_BIAS
    for form, z1_bias in (('one-row z1', 0.0), ('z1 a row per code', row_bias)):
        with torch.inference_mode():
            g_card = vqvae.generate(2, sampling, z1_bias, None, noise)
            g_cpu = cpu_vqvae.generate(2, sampling, z1_bias, None, noise)
        agree = float((g_card.idx.cpu() == g_cpu.idx).float().mean())
        same = (g_card.idx.cpu() == g_cpu.idx).all(dim=1)
        r = rel_l2(g_card.recon.cpu()[same], g_cpu.recon[same]) if same.any() else float('inf')
        check(agree >= CODE_AGREEMENT and bool(same.any()) and r <= RECON_REL_L2,
              f'generation card vs CPU, {form}: code agreement {agree:.4f} >= {CODE_AGREEMENT}, recon rel L2 '
              f'{r:.3e} <= {RECON_REL_L2} over the {int(same.sum())} of 2 samples with all codes equal')

    # warm generation at batch 1 and 16: latency, then one profiled call
    for bb in (1, 16):
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            server.generate(bb, seed=gen_seed)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(times, [25, 50, 75])
        print(f'warm generate batch {bb}: median {med:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms over {REPS} '
              f'(host clock incl. copies)', flush=True)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.generation_draws(64, gen_seed, 0)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f'generation draws of a bucket-64 chunk on the host: median {np.median(times):.3f} ms over 5', flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.generate(16, seed=gen_seed)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    print('profile of one batch-16 generate:', flush=True)
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=12, max_name_column_width=50), flush=True)
    events = device_events(prof)
    print(f'generate batch 16, device: busy {summed_ms(events):.3f} ms in {len(events)} activities (their union '
          f'{busy_ms(events):.3f} ms); host clock {host_ms:.3f} ms (profiled)', flush=True)

    # ---- the main path, training: stage-1 steps of the flagship VQ-VAE ---
    # under the flagship's ChamferEMD objective, then under Chamfer and
    # ChamferSinkhorn, each from the same weights on the same fixed batch
    tcfg = cfg.autoencoder.train
    model = build_vqvae(cfg)
    init_from_seed(model, args.seed + 2)
    base_state = copy.deepcopy(model.state_dict())
    del model
    batch = torch.from_numpy(synthetic.batch(args.seed + 3, TRAIN_BATCH, n)).to(dev)
    inputs, targets = Inputs(batch), Targets(batch)
    train_launches = dict.fromkeys(KERNEL_INFO, 0)  # ChamferEMD's steps
    objective_launches = dict.fromkeys(KERNEL_INFO, 0)  # the steps and the entry point of the other two

    def objective_cfg(recon_loss: str, **autoencoder) -> SliceConfig:
        return dataclasses.replace(cfg, autoencoder=dataclasses.replace(
            cfg.autoencoder, train=dataclasses.replace(tcfg, recon_loss=recon_loss), **autoencoder))

    def stage1_steps(recon_loss: str, totals: dict[str, int]) -> None:
        """Warm and timed steps: finite and falling losses, step time,
        samples/s, peak memory, a profile, and in every step the launches of
        the stage-1 kernels and of this objective's loss kernel alone."""
        label = f'stage-1 {recon_loss}'
        model = build_vqvae(cfg)
        model.load_state_dict(base_state)
        model = model.to(dev)
        trainer = Trainer(model, get_autoencoder_loss(objective_cfg(recon_loss)), tcfg, STEPS_PER_EPOCH,
                          seed=args.seed)
        losses, step_ms, step_launches = [], [], []
        for step in range(WARM_STEPS + TIMED_STEPS):
            if step == WARM_STEPS:
                torch.cuda.reset_peak_memory_stats()
                held_gib = torch.cuda.memory_allocated() / 2**30
            api.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = trainer.run_step(inputs, targets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = api.launch_counts()
            step_launches.append(counts)
            for name, count in counts.items():
                totals[name] += count
            losses.append({k: float(v) for k, v in metrics.items()})
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(all(np.isfinite(list(m.values())).all() for m in losses),
              f'{label}: every loss finite over {len(losses)} steps')
        first, last = losses[0]['Loss'], losses[-1]['Loss']
        check(last < first, f'{label}: loss {first:.4f} at step 1 -> {last:.4f} at step {len(losses)} on the same '
                            f'batch')
        print(f'{label} losses per step: ' + json.dumps([{k: round(v, 5) for k, v in m.items()} for m in losses]),
              flush=True)
        expected = {**dict.fromkeys(TRAINING_KERNELS, True),
                    **{name: name == LOSS_KERNELS[recon_loss] for name in LOSS_KERNELS.values()}}
        for name, launched in expected.items():
            per_step = [c[name] for c in step_launches]
            check(min(per_step) > 0 if launched else max(per_step) == 0,
                  f'{name}: launches per {label} step {per_step}')
        for name, count in STEP_LAUNCHES.items():
            per_step = [c[name] for c in step_launches]
            check(set(per_step) == {count}, f'{name}: launches per {label} step {per_step} == {count}')
        q1, med, q3 = np.percentile(step_ms[WARM_STEPS:], [25, 50, 75])
        print(f'{label} step (batch {TRAIN_BATCH}, {n} points): median {med:.3f} ms, quartiles {q1:.3f} / '
              f'{q3:.3f} ms over {TIMED_STEPS} (host clock, synchronised); {TRAIN_BATCH / med * 1e3:.1f} samples/s; '
              f'peak memory {peak_gib:.3f} GiB (max_memory_allocated; {held_gib:.3f} GiB held before the timed '
              f'steps)', flush=True)
        # the loss kernels' sources share sample_sum_kernel: only this objective's is read
        traced_names = {name: v for name, v in DEVICE_NAMES.items()
                        if name not in LOSS_KERNELS.values() or name == LOSS_KERNELS[recon_loss]}
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            api.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                trainer.run_step(inputs, targets)
                torch.cuda.synchronize()
            calls = api.launch_counts()
            events = device_events(prof)
            mine = {name: [ev for ev in events if re.search(pattern, ev[0])]
                    for name, (pattern, _) in traced_names.items()}
            wanted = {name: per_call * calls[name] for name, (_, per_call) in traced_names.items()}
            print(f'{label} step, trace {attempt} of at most {TRACE_ATTEMPTS}: {len(events)} device activities; '
                  + ', '.join(f'{name} {len(mine[name])} of {wanted[name]}' for name in traced_names), flush=True)
            # a trace short of launches lost records (PERF.md §7): take it
            # again; one with more launches than the wrappers made fails
            if all(len(mine[name]) >= wanted[name] for name in traced_names) or any(
                    len(mine[name]) > wanted[name] for name in traced_names):
                break
        print(f'profile of one {label} step:', flush=True)
        print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=25, max_name_column_width=60),
              flush=True)
        parts = []
        for name, (_, per_call) in traced_names.items():
            check(len(mine[name]) == wanted[name] > 0,
                  f'{label} step: {len(mine[name])} device launches of {name}\'s kernels == {per_call} x '
                  f'{calls[name]} calls (trace {attempt})')
            parts.append(f'{name} kernels {len(mine[name])} launches, {summed_ms(mine[name]):.4f} ms (union '
                         f'{busy_ms(mine[name]):.4f})')
        print(f'{label} step, device: busy {summed_ms(events):.3f} ms in {len(events)} activities (their union '
              f'{busy_ms(events):.3f} ms); ' + '; '.join(parts), flush=True)

    stage1_steps('ChamferEMD', train_launches)
    for recon_loss in ('Chamfer', 'ChamferSinkhorn'):
        stage1_steps(recon_loss, objective_launches)

    # ---- one training step on the card against the CPU, batch 2 x 512 ----
    pts = 512
    gen = torch.Generator().manual_seed(args.seed + 4)
    small = torch.from_numpy(synthetic.batch(args.seed + 5, 2, pts))
    sampling = torch.randn((2, pts, cfg.autoencoder.decoder.sample_dim), generator=gen)
    noise = gumbel_uniform((2, pts, cfg.autoencoder.decoder.n_components), gen, torch.device('cpu'))

    def one_step(device: torch.device, recon_loss: str):
        m = build_vqvae(cfg)
        m.load_state_dict(base_state)
        m = m.to(device)
        tr = Trainer(m, get_autoencoder_loss(objective_cfg(recon_loss)), tcfg, STEPS_PER_EPOCH)
        before = {k: p.detach().clone() for k, p in m.named_parameters()}
        cl = small.to(device)
        out = tr.run_step(Inputs(cl, initial_sampling=sampling.to(device)), Targets(cl), noise.to(device))
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters() if p.grad is not None}
        updates = {k: (p.detach() - before[k]).cpu() for k, p in m.named_parameters()}
        return {k: float(v) for k, v in out.items()}, grads, updates

    for recon_loss in LOSS_KERNELS:
        label = f'card vs CPU {recon_loss} step'
        t0 = time.perf_counter()
        gpu_step, cpu_step = one_step(dev, recon_loss), one_step(torch.device('cpu'), recon_loss)
        print(f'card and CPU {recon_loss} step at batch 2 x {pts}: {time.perf_counter() - t0:.1f} s', flush=True)
        for name, value in cpu_step[0].items():
            r = abs(gpu_step[0][name] - value) / abs(value)
            check(r <= STEP_LOSS_RTOL, f'{label}: {name} {gpu_step[0][name]:.6f} vs {value:.6f}, rel {r:.2e}')
        check(set(gpu_step[1]) == set(cpu_step[1]) and not any(k.startswith('w_autoencoder.') for k in gpu_step[1]),
              f'{label}: the same {len(cpu_step[1])} parameters have gradients, none of the frozen inner CVAE')
        grad_errs = {k: rel_l2(gpu_step[1][k], v) for k, v in cpu_step[1].items()}
        worst = max(grad_errs, key=grad_errs.get)
        check(grad_errs[worst] <= STEP_GRAD_REL_L2,
              f'{label}: largest per-parameter gradient rel L2 {grad_errs[worst]:.2e} ({worst}), '
              f'median {float(np.median(list(grad_errs.values()))):.2e}')
        upd = rel_l2(torch.cat([gpu_step[2][k].flatten() for k in cpu_step[1]]),
                     torch.cat([cpu_step[2][k].flatten() for k in cpu_step[1]]))
        frozen_still = all(not bool(v.any()) for k, v in gpu_step[2].items() if k.startswith('w_autoencoder.'))
        check(upd <= STEP_UPDATE_REL_L2 and frozen_still,
              f'{label}: AdamW update rel L2 {upd:.2e} <= {STEP_UPDATE_REL_L2}; frozen inner CVAE unmoved '
              f'{frozen_still}')

    # ---- the main path, the stage-1 entry point under Chamfer and ----------
    # ChamferSinkhorn: the flagship width, its depth cut to 2 epochs over 16
    # training and 8 test clouds, the codebook hook after every epoch
    e_train = torch.from_numpy(synthetic.batch(args.seed + 13, ENTRY_TRAIN, n))
    e_test = torch.from_numpy(synthetic.batch(args.seed + 14, ENTRY_TEST, n))
    for recon_loss in ('Chamfer', 'ChamferSinkhorn'):
        label = f'stage-1 entry point ({recon_loss})'
        e_cfg = objective_cfg(recon_loss, diagnose_every=1)
        e_model = build_vqvae(e_cfg)
        e_model.load_state_dict(base_state)
        api.reset_launch_counts()
        t0 = time.perf_counter()
        result = train_autoencoder(e_cfg, e_model, e_train, e_test, n_epochs=ENTRY_EPOCHS, seed=args.seed,
                                   device=dev)
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t0
        counts = api.launch_counts()
        for name, count in counts.items():
            objective_launches[name] += count
        e_trainer, hook, e_test_metrics = result['trainer'], result['codebook_hook'], result['test']
        steps = ENTRY_TRAIN // tcfg.batch_size * ENTRY_EPOCHS
        check(e_trainer.step == steps and e_trainer.epoch == ENTRY_EPOCHS
              and len(e_trainer.validation_log) == ENTRY_EPOCHS
              and all(np.isfinite(list(v.values())).all() for v in e_trainer.validation_log),
              f'{label}, {ENTRY_EPOCHS} epochs of {ENTRY_TRAIN} clouds in {entry_s:.1f} s: {e_trainer.step} steps, '
              f'validation {json.dumps(e_trainer.validation_log)}')
        usage = hook.last_usage
        dead = torch.from_numpy(usage == 0).to(dev)
        check(bool((usage.sum(axis=1) == ENTRY_TRAIN).all()) and bool((e_model.codebook[dead] == DEAD_ENTRY).all()),
              f'{label}: the codebook hook ran, every slot has a used entry ({int((usage > 0).sum())} of '
              f'{usage.size} entries used), the {int(dead.sum())} unused ones at {DEAD_ENTRY} after the final epoch')
        check(np.isfinite(list(e_test_metrics.values())).all() and ('EMD' in e_test_metrics),
              f'{label}: final test {json.dumps(e_test_metrics)}')
        launched = (LOSS_KERNELS[recon_loss], 'pcgen_mix', 'knn') + (
            ('chamfer_match_cost',) if recon_loss == 'Chamfer' else ())  # the EMD the final test attaches
        for name in launched:
            check(counts[name] > 0, f'{name}: {counts[name]} launches in the {label}')
        print(f'launches, {label}: {json.dumps(counts)}', flush=True)

    # ---- the main path, stage 2: the entry point for one epoch ------------
    wcfg = cfg.w_autoencoder.train
    w_train = torch.from_numpy(synthetic.batch(args.seed + 7, 2 * bw, n))
    w_test = torch.from_numpy(synthetic.batch(args.seed + 8, 2 * bw, n))
    stage2_launches = dict.fromkeys(KERNEL_INFO, 0)

    def add_launches(what: str) -> dict[str, int]:
        """Read the counts of one run of the stage-2 path into its total."""
        counts = api.launch_counts()
        for name, count in counts.items():
            stage2_launches[name] += count
        print(f'launches, {what}: {json.dumps(counts)}', flush=True)
        return counts

    api.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_w_autoencoder(cfg, copy.deepcopy(vqvae), classifier, w_train, w_test, n_epochs=1, seed=args.seed,
                                 device=dev)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    counts = add_launches('stage-2 entry point')
    w_trainer = result['trainer']
    check(w_trainer.step == 2 and len(w_trainer.validation_log) == 1 and bool(np.isfinite(result['loss'])),
          f'stage 2 entry point, 1 epoch of {2 * bw} clouds in {entry_s:.1f} s: {w_trainer.step} steps, '
          f'validation {json.dumps(w_trainer.validation_log)}, test loss {result["loss"]:.4f}')
    for name in STAGE2_KERNELS:
        check(counts[name] > 0, f'{name}: {counts[name]} launches in the stage-2 entry point')
    # a validation pass and the final test, two batches each: the W-encoder
    # and the posterior are encoder stacks, the W-decoder a decoder stack
    check((counts['wformer_encoder'], counts['wformer_decoder']) == (8, 4),
          f'stage 2 entry point: wformer launches {counts["wformer_encoder"]} / {counts["wformer_decoder"]} == 8 / 4')

    # ---- stage-2 steps on one derived batch of 32 -------------------------
    api.reset_launch_counts()
    w_loader = Loader(WDatasetWithLogits(w_train.to(dev), vqvae, classifier), bw, args.seed)
    w_batches = list(w_loader.batches())
    w_model = build_w_train_model(cfg, vqvae, seed=args.seed + 9)
    w_loss = get_w_autoencoder_loss(wcfg)
    trainer = Trainer(w_model, w_loss, wcfg, STEPS_PER_EPOCH, seed=args.seed)
    winputs, wtargets = w_batches[0]
    w_losses, w_step_ms = [], []
    for step in range(WARM_STEPS + TIMED_STEPS):
        if step == WARM_STEPS:
            torch.cuda.reset_peak_memory_stats()
            w_held_gib = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        metrics = trainer.run_step(winputs, wtargets)
        torch.cuda.synchronize()
        w_step_ms.append((time.perf_counter() - t0) * 1e3)
        w_losses.append({k: float(v) for k, v in metrics.items()})
    w_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    add_launches(f'deriving {len(w_batches)} batches and {len(w_losses)} stage-2 steps')
    check(all(np.isfinite(list(m.values())).all() for m in w_losses),
          f'stage 2: every loss finite over {len(w_losses)} steps')
    first, last = w_losses[0]['MSE'], w_losses[-1]['MSE']
    check(last < first, f'stage 2: MSE {first:.4f} at step 1 -> {last:.4f} at step {len(w_losses)} on the same batch')
    print('stage-2 losses per step: ' + json.dumps([{k: round(v, 6) for k, v in m.items()} for m in w_losses]),
          flush=True)
    q1, med, q3 = np.percentile(w_step_ms[WARM_STEPS:], [25, 50, 75])
    print(f'stage-2 step (batch {bw}, {t} codes, d {d}): median {med:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms '
          f'over {TIMED_STEPS} (host clock, synchronised); {bw / med * 1e3:.1f} samples/s; '
          f'peak memory {w_peak_gib:.3f} GiB (max_memory_allocated; {w_held_gib:.3f} GiB held before the timed '
          f'steps, earlier phases included)', flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_step(winputs, wtargets)
        torch.cuda.synchronize()
    print('profile of one stage-2 step:', flush=True)
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=20, max_name_column_width=60), flush=True)

    # ---- the stage-2 validation pass over two derived batches -------------
    validation = Test(w_model, w_loader, w_loss, 'Validation', seed=args.seed)
    api.reset_launch_counts()
    val_metrics = validation(trainer.epoch)
    torch.cuda.synchronize()
    counts = add_launches('one validation pass')
    check((counts['wformer_encoder'], counts['wformer_decoder']) == (2 * len(w_batches), len(w_batches))
          and all(np.isfinite(list(val_metrics.values()))),
          f'validation over {len(w_batches)} batches: wformer launches {counts["wformer_encoder"]} / '
          f'{counts["wformer_decoder"]} (2 and 1 per batch), metrics {json.dumps(val_metrics)}')
    val_ms, fwd_ms = [], []
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for _ in range(VALIDATION_REPS):
        t0 = time.perf_counter()
        validation(trainer.epoch)
        torch.cuda.synchronize()
        val_ms.append((time.perf_counter() - t0) * 1e3 / len(w_batches))
        with torch.no_grad():
            w_model.eval()
            t0 = time.perf_counter()
            for wi, wt in w_batches:
                w_loss.loss_and_metrics(w_model(wi, None, gen).replace(model_epoch=float(trainer.epoch)), wt)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3 / len(w_batches))
    print(f'validation ms per batch of {bw}: median {np.median(val_ms):.3f} over {VALIDATION_REPS} passes '
          f'(derived dataset included: VQ-VAE encoder and classifier on 2048-point clouds), '
          f'{np.median(fwd_ms):.3f} for the W-autoencoder and its loss alone (host clock, synchronised)', flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, torch.no_grad():
        w_loss.loss_and_metrics(w_model(winputs, None, gen).replace(model_epoch=float(trainer.epoch)), wtargets)
        torch.cuda.synchronize()
    print('profile of one validation batch (W-autoencoder and loss, eval):', flush=True)
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=15, max_name_column_width=60), flush=True)

    # ---- one stage-2 step at a small width on the card against the CPU ---
    tnet = pc.TransformerNetConfig
    small_cfg = SliceConfig(
        autoencoder=pc.AutoEncoderConfig(book_size=8, w_dim=512),
        w_autoencoder=pc.WAutoEncoderConfig(
            z1_dim=4, z2_dim=4, w_encoder=tnet(128, 2, (256,)), w_decoder=tnet(128, 2, (128, 256)),
            conditional_w_encoder=tnet(128, 2, (128,)), train=pc.WAutoEncoderTrainConfig(batch_size=4)))
    s_t, s_e = small_cfg.autoencoder.n_codes, small_cfg.autoencoder.embedding_dim
    s_model = WAETrainModule(build_w_autoencoder(small_cfg), small_cfg.autoencoder.book_size)
    init_from_seed(s_model, args.seed + 10)
    s_state = copy.deepcopy(s_model.state_dict())
    s_rng = np.random.default_rng(args.seed + 11)

    def s_randn(*shape: int) -> torch.Tensor:
        return torch.from_numpy(s_rng.standard_normal(shape).astype(np.float32))

    s_in = WInputs(s_randn(4, s_t * s_e), 2 * s_randn(4, cfg.data.n_classes))
    s_idx = torch.from_numpy(s_rng.integers(0, 8, (4, s_t)))
    s_tg = WTargets(s_randn(4, s_t * s_e), torch.eye(8)[s_idx], s_in.logits)
    s_eps = (s_randn(4, s_t, 4), s_randn(4, s_t, 4))
    s_tcfg = small_cfg.w_autoencoder.train

    def w_step(device: torch.device):
        m = WAETrainModule(build_w_autoencoder(small_cfg), small_cfg.autoencoder.book_size)
        m.load_state_dict(s_state)
        m = m.to(device)
        tr = Trainer(m, get_w_autoencoder_loss(s_tcfg), s_tcfg, STEPS_PER_EPOCH)
        before = {k: p.detach().clone() for k, p in m.named_parameters()}
        out = tr.run_step(WInputs(s_in.w_q.to(device), s_in.logits.to(device)),
                          WTargets(s_tg.w_e.to(device), s_tg.one_hot_idx.to(device), s_tg.logits.to(device)),
                          tuple(e.to(device) for e in s_eps))
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters() if p.grad is not None}
        updates = {k: (p.detach() - before[k]).cpu() for k, p in m.named_parameters()}
        return {k: float(v) for k, v in out.items()}, grads, updates, tr.grad_op.state()

    gpu_w, cpu_w = w_step(dev), w_step(torch.device('cpu'))
    for name, value in cpu_w[0].items():
        if name == 'Quantisation Accuracy':
            ok, r = abs(gpu_w[0][name] - value) <= W_STEP_ACCURACY_ATOL, abs(gpu_w[0][name] - value)
        else:
            r = abs(gpu_w[0][name] - value) / max(abs(value), 1e-30)
            ok = r <= W_STEP_LOSS_RTOL
        check(ok, f'card vs CPU stage-2 step: {name} {gpu_w[0][name]:.6g} vs {value:.6g}, diff {r:.2e}')
    compared = [k for k in cpu_w[1] if not rounding_gradient(k)]
    grad_errs = {k: rel_l2(gpu_w[1][k], cpu_w[1][k]) for k in compared}
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= W_STEP_GRAD_REL_L2,
          f'card vs CPU stage-2 step: largest per-parameter gradient rel L2 {grad_errs[worst]:.2e} ({worst}), '
          f'median {float(np.median(list(grad_errs.values()))):.2e}, over {len(compared)} of {len(cpu_w[1])}')
    upd = rel_l2(torch.cat([gpu_w[2][k].flatten() for k in compared]),
                 torch.cat([cpu_w[2][k].flatten() for k in compared]))
    clip_err = max(abs(gpu_w[3][k][0] - cpu_w[3][k][0]) / max(abs(cpu_w[3][k][0]), 1e-30) for k in compared)
    check(upd <= STEP_UPDATE_REL_L2 and clip_err <= W_STEP_LOSS_RTOL,
          f'card vs CPU stage-2 step: AdamW update rel L2 {upd:.2e} <= {STEP_UPDATE_REL_L2}; clipper norm EMA '
          f'max rel diff {clip_err:.2e}')

    # ---- the counterfactual route with the fused chain's gate failing -----
    # a W-encoder 256 wide (4 heads of 64) beside 512-wide nets: the three
    # nets run one by one, each stack through its wformer kernel
    u_cfg = dataclasses.replace(cfg, w_autoencoder=dataclasses.replace(cfg.w_autoencoder,
                                                                       w_encoder=tnet(256, 4)))
    u_wae = build_w_autoencoder(u_cfg)
    init_from_seed(u_wae, args.seed + 12)
    u_wae.eval()
    u_in = WInputs(torch.from_numpy(rng.standard_normal((2, cfg.autoencoder.w_dim)).astype(np.float32)),
                   torch.from_numpy(2 * rng.standard_normal((2, cfg.data.n_classes)).astype(np.float32)))
    u_book = vqvae.codebook.detach().cpu()
    with torch.inference_mode():
        want = u_wae.generate_counterfactual(u_in, u_book, 1)
        u_wae = u_wae.to(dev)
        api.reset_launch_counts()
        got = u_wae.generate_counterfactual(WInputs(u_in.w_q.to(dev), u_in.logits.to(dev)), u_book.to(dev), 1)
        counts = api.launch_counts()  # a check of another route: not added to the main path's launches
    r = rel_l2(got.w_recon.cpu(), want.w_recon)
    agree = float((got.idx.cpu() == want.idx).float().mean())
    check(not u_wae.fused_ok() and (counts['wformer_encoder'], counts['wformer_decoder'], counts['cvae_cf']) == (2, 1, 0)
          and r <= CVAE_REL_L2 and agree >= CODE_AGREEMENT,
          f'unfused counterfactual route: wformer launches {counts["wformer_encoder"]} / {counts["wformer_decoder"]}, '
          f'cvae_cf {counts["cvae_cf"]}; card vs CPU w_recon rel L2 {r:.2e} <= {CVAE_REL_L2}, code agreement '
          f'{agree:.4f}')

    # ---- the main path, classifier training: SGD steps at batch 16 x 2048 --
    # on a fixed batch of 8 spheres and 8 boxes, dropout on (masks from the
    # trainer's generator), every step launching the streaming-BN EdgeConv
    # kernels of its four blocks at k = 20 and nothing else
    print(f'chip_smoke: {time.perf_counter() - started:.1f} s before the classifier phase', flush=True)
    ccfg = cfg.classifier.train
    c_init = build_classifier(cfg)
    init_from_seed(c_init, args.seed + 15)
    c_state = copy.deepcopy(c_init.state_dict())
    classifier_launches = dict.fromkeys(KERNEL_INFO, 0)

    def c_model(c_cfg: SliceConfig, device: torch.device) -> ClassifierTrainModule:
        m = build_classifier(c_cfg)
        m.load_state_dict(c_state)
        return ClassifierTrainModule(m).to(device)

    c_clouds, c_labels = labelled_clouds(args.seed + 16, (ccfg.batch_size // 2,) * 2, n)
    c_in = Inputs(torch.from_numpy(c_clouds).to(dev))
    c_tg = Targets(c_in.cloud, torch.from_numpy(c_labels).to(dev))
    trainer = Trainer(c_model(cfg, dev), get_classification_loss(), ccfg, STEPS_PER_EPOCH, seed=args.seed)
    c_losses, c_ms, c_step_launches = [], [], []
    for step in range(WARM_STEPS + TIMED_STEPS):
        if step == WARM_STEPS:
            torch.cuda.reset_peak_memory_stats()
            c_held_gib = torch.cuda.memory_allocated() / 2**30
        api.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = trainer.run_step(c_in, c_tg)
        torch.cuda.synchronize()
        c_ms.append((time.perf_counter() - t0) * 1e3)
        counts = api.launch_counts()
        c_step_launches.append(counts)
        for name, count in counts.items():
            classifier_launches[name] += count
        c_losses.append({k: float(v) for k, v in metrics.items()})
    c_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(list(m.values())).all() for m in c_losses),
          f'classifier: every loss finite over {len(c_losses)} steps')
    print('classifier losses per step: ' + json.dumps([{k: round(v, 5) for k, v in m.items()} for m in c_losses]),
          flush=True)
    for name in KERNEL_INFO:
        per_step = [c[name] for c in c_step_launches]
        want = len(cfg.classifier.conv_dims) if name in CLASSIFIER_STEP_KERNELS else 0
        check(set(per_step) == {want}, f'{name}: launches per classifier step {per_step} == {want}')
    q1, med, q3 = np.percentile(c_ms[WARM_STEPS:], [25, 50, 75])
    print(f'classifier step (batch {ccfg.batch_size}, {n} points, SGD): median {med:.3f} ms, quartiles {q1:.3f} / '
          f'{q3:.3f} ms over {TIMED_STEPS} (host clock, synchronised); {ccfg.batch_size / med * 1e3:.1f} samples/s; '
          f'peak memory {c_peak_gib:.3f} GiB (max_memory_allocated; {c_held_gib:.3f} GiB held before the timed '
          f'steps, earlier phases included)', flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_step(c_in, c_tg)
        torch.cuda.synchronize()
    print('profile of one classifier step:', flush=True)
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=20, max_name_column_width=60), flush=True)
    events = device_events(prof)
    print(f'classifier step, device: busy {summed_ms(events):.3f} ms in {len(events)} activities (their union '
          f'{busy_ms(events):.3f} ms)', flush=True)

    # one classifier step on the card against the CPU, batch 4 x 512, with
    # dropout 0 (the two devices' generators draw different masks).  Not 2:
    # the head's BatchNorm over two samples leaves the step ill-conditioned
    # in float32 itself (on the CPU, float32 and float64 part as far as the
    # card and the CPU do).  The CPU step takes the card's kNN lists: the
    # graph is rebuilt on the features before every block, so one neighbour
    # that a near-tie swaps (distances in 3xTF32 on the card) changes every
    # later block's graph, and the two steps then differ by more than
    # rounding; how many lists the CPU's own kNN would give alike is printed
    nodrop = dataclasses.replace(cfg, classifier=dataclasses.replace(cfg.classifier, dropout_rates=(0.0, 0.0)))
    s_clouds, s_labels = labelled_clouds(args.seed + 17, (2, 2), 512)
    card_graphs, own_agree = [], []
    build_graph = api.knn

    def card_graph(x: torch.Tensor, k: int) -> torch.Tensor:
        card_graphs.append(build_graph(x, k))
        return card_graphs[-1]

    def replayed_graph(x: torch.Tensor, k: int) -> torch.Tensor:
        idx = card_graphs.pop(0).cpu()
        own_agree.append(knn_check(x.detach(), k, idx, build_graph(x, k))[0])
        return idx

    def c_step(device: torch.device, graph):
        m = c_model(nodrop, device)
        cl = torch.from_numpy(s_clouds).to(device)
        api.knn = graph
        try:
            out = Trainer(m, get_classification_loss(), ccfg, STEPS_PER_EPOCH).run_step(
                Inputs(cl), Targets(cl, torch.from_numpy(s_labels).to(device)))
        finally:
            api.knn = build_graph
        return {k: float(v) for k, v in out.items()}, {k: p.grad.detach().cpu() for k, p in m.named_parameters()}

    gpu_c, cpu_c = c_step(dev, card_graph), c_step(torch.device('cpu'), replayed_graph)
    print(f'card vs CPU classifier step: the CPU\'s own kNN lists agree with the card\'s at '
          f'{", ".join(f"{a:.6f}" for a in own_agree)} of the neighbours, block by block', flush=True)
    r = abs(gpu_c[0]['CrossEntropy'] - cpu_c[0]['CrossEntropy']) / abs(cpu_c[0]['CrossEntropy'])
    check(r <= STEP_LOSS_RTOL, f'card vs CPU classifier step at {len(s_labels)} x 512: cross entropy '
                               f'{gpu_c[0]["CrossEntropy"]:.6f} vs {cpu_c[0]["CrossEntropy"]:.6f}, rel {r:.2e} <= '
                               f'{STEP_LOSS_RTOL}')
    compared = [k for k in cpu_c[1] if not k.endswith(CLASSIFIER_ZERO_GRADIENT)]
    grad_errs = {k: rel_l2(gpu_c[1][k], cpu_c[1][k]) for k in compared}
    worst = max(grad_errs, key=grad_errs.get)
    check(set(gpu_c[1]) == set(cpu_c[1]) and grad_errs[worst] <= STEP_GRAD_REL_L2,
          f'card vs CPU classifier step: largest per-parameter gradient rel L2 {grad_errs[worst]:.2e} ({worst}) <= '
          f'{STEP_GRAD_REL_L2}, median {float(np.median(list(grad_errs.values()))):.2e}, over {len(compared)} of '
          f'{len(cpu_c[1])}; SGD moves each by lr x grad')

    # the classifier's entry point at the flagship width, its depth cut to 2
    # epochs over 32 training and 16 test clouds; its classifier is the one
    # the suites judge with
    e_clouds, e_labels = labelled_clouds(args.seed + 18, (CLASSIFIER_TRAIN // 2,) * 2, n)
    t_clouds, t_labels = labelled_clouds(args.seed + 19, (CLASSIFIER_TEST // 2,) * 2, n)
    judge = build_classifier(cfg)
    judge.load_state_dict(c_state)
    api.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_classifier(cfg, judge, torch.from_numpy(e_clouds), torch.from_numpy(e_labels),
                              torch.from_numpy(t_clouds), torch.from_numpy(t_labels), n_epochs=ENTRY_EPOCHS,
                              seed=args.seed, device=dev)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    counts = api.launch_counts()
    for name, count in counts.items():
        classifier_launches[name] += count
    c_trainer = result['trainer']
    check(c_trainer.step == CLASSIFIER_TRAIN // ccfg.batch_size * ENTRY_EPOCHS and c_trainer.epoch == ENTRY_EPOCHS
          and len(c_trainer.validation_log) == ENTRY_EPOCHS
          and all(np.isfinite(list(v.values())).all() for v in c_trainer.validation_log),
          f'classifier entry point, {ENTRY_EPOCHS} epochs of {CLASSIFIER_TRAIN} clouds in {entry_s:.1f} s: '
          f'{c_trainer.step} steps, validation {json.dumps(c_trainer.validation_log)}')
    cm = result['confusion_matrix']
    check(result['logits'].shape == (CLASSIFIER_TEST, cfg.data.n_classes) and bool(np.isfinite(result['logits']).all())
          and int(cm.sum()) == CLASSIFIER_TEST and np.isfinite(list(result['test'].values())).all(),
          f'classifier entry point: final test {json.dumps(result["test"])}, confusion matrix {cm.tolist()}, '
          f'{len(result["misclassified"])} misclassified')
    for name in CLASSIFIER_STEP_KERNELS:
        check(counts[name] > 0, f'{name}: {counts[name]} launches in the classifier entry point')
    print(f'launches, classifier entry point: {json.dumps(counts)}', flush=True)

    # ---- the main path, the five evaluation suites over 186 clouds --------
    # 86 spheres and 100 boxes (the flagship's ModelNet desk / table test
    # split), the entry point's classifier, the flagship VQ-VAE (random
    # weights, prepacked by the server); launch counts exact as the suites'
    # structure implies them, each suite's seconds from the time its line is
    # printed
    print(f'chip_smoke: {time.perf_counter() - started:.1f} s before the suites phase', flush=True)
    v_clouds, v_labels = labelled_clouds(args.seed + 20, SUITE_CLASS_COUNTS, n)
    stamped = StampedLines()
    api.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stamped):
        suites = evaluate_counterfactuals(cfg, judge, vqvae, torch.from_numpy(v_clouds), torch.from_numpy(v_labels),
                                          seed=args.seed, device=dev)
        torch.cuda.synchronize()
    suites_s = time.perf_counter() - t0
    suite_launches = api.launch_counts()
    print(f'evaluation suites over {len(v_labels)} clouds of {n} points: {suites_s:.2f} s (host clock, synchronised)',
          flush=True)
    for line, seconds in stamped.lines(t0):
        print(f'{line}    ({seconds:.3f} s)' if line.startswith('[') else line, flush=True)
    with torch.inference_mode():
        judge.eval()
        predictions = torch.cat([judge(Inputs(torch.from_numpy(v_clouds[i: i + ccfg.batch_size]).to(dev)))
                                 for i in range(0, len(v_labels), ccfg.batch_size)]).argmax(1).cpu().numpy()
    expected = suite_launch_counts(cfg, predictions, v_labels)
    for name in KERNEL_INFO:
        check(suite_launches[name] == expected.get(name, 0),
              f'{name}: {suite_launches[name]} launches in the evaluation suites == {expected.get(name, 0)}')
    check(all(np.isfinite(list(m.values())).all() for m in suites.values()) and len(suites) >= 5,
          f'evaluation suites: {len(suites)} suites, every metric finite')
    print('evaluation suites: ' + json.dumps(suites), flush=True)
    # one counterfactual chunk of 64: its device busy time and its kernels
    chunk_set = CounterfactualDatasetEncoder(LabelledClouds(torch.from_numpy(v_clouds[:MAX_BATCH]).to(dev),
                                                            torch.from_numpy(v_labels[:MAX_BATCH]), args.seed),
                                             vqvae, judge, 1, cfg.user.counterfactual_value)
    chunk_set.__getitems__([0])
    torch.cuda.synchronize()
    chunk_set.set_inference(True)  # the next fetch computes the chunk anew
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk_set.__getitems__(list(range(MAX_BATCH)))
        torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    print(f'profile of one counterfactual chunk of {MAX_BATCH} clouds (classifier logits, encode, CVAE chain, '
          f'decode, filter):', flush=True)
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=15, max_name_column_width=60), flush=True)
    events = device_events(prof)
    print(f'counterfactual chunk of {MAX_BATCH}, device: busy {summed_ms(events):.3f} ms in {len(events)} activities '
          f'(their union {busy_ms(events):.3f} ms); host clock {chunk_ms:.3f} ms (profiled)', flush=True)

    # the suites on the card against the CPU: 8 clouds of 512 points, the
    # VQ-VAE decoding 512; the noise comes from a host generator, so both
    # draw the same.  The original classification must agree but for argmax
    # near-ties; a derived suite's accuracy may differ only by clouds whose
    # codes differ or whose prediction sits at a near-tie (SUITE_TIE_MARGIN)
    p_cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_input_points=512, n_target_points=512))
    p_clouds, p_labels = labelled_clouds(args.seed + 21, (4, 4), 512)
    p_vq = build_vqvae(p_cfg)
    p_vq.load_state_dict(vqvae.state_dict())
    p_judge = build_classifier(cfg)
    p_judge.load_state_dict(judge.state_dict())
    pair_suites, pair_codes = {}, {}
    t0 = time.perf_counter()
    for label, where in (('card', dev), ('cpu', torch.device('cpu'))):
        vq_w, judge_w = copy.deepcopy(p_vq).to(where).eval(), copy.deepcopy(p_judge).to(where).eval()
        with contextlib.redirect_stdout(StampedLines()):
            pair_suites[label] = evaluate_counterfactuals(p_cfg, judge_w, vq_w, torch.from_numpy(p_clouds),
                                                          torch.from_numpy(p_labels), seed=args.seed, device=where)
        pair_codes[label] = suite_outcomes(vq_w, judge_w, p_clouds, p_labels, args.seed, p_cfg, where)
    print(f'suites card vs CPU on {len(p_labels)} clouds of 512 points, both devices: '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    card, host = pair_codes['card'], pair_codes['cpu']
    flipped = card['original'][1] != host['original'][1]
    near = host['original'][2] < SUITE_TIE_MARGIN
    orig_c, orig_h = pair_suites['card']['ClassificationOriginal'], pair_suites['cpu']['ClassificationOriginal']
    r = abs(orig_c['CrossEntropy'] - orig_h['CrossEntropy']) / abs(orig_h['CrossEntropy'])
    check(not (flipped & ~near).any() and r <= STEP_LOSS_RTOL and (flipped.any() or (
        orig_c['Accuracy'] == orig_h['Accuracy'] and orig_c['Macro Accuracy'] == orig_h['Macro Accuracy'])),
          f'suites card vs CPU: original classification {orig_c} vs {orig_h}, cross entropy rel {r:.2e} <= '
          f'{STEP_LOSS_RTOL}; {int(flipped.sum())} predictions differ, each at a near-tie (margins '
          f'{np.round(host["original"][2], 4).tolist()})')
    # a near-tie flip changes which clouds the subset suites take: only the
    # suites over every cloud are compared then
    derived = sorted(set(card) - {'original'}) if not flipped.any() else [
        name for name in sorted(card) if name == 'ClassificationReconstructed' or name.startswith('Counterfeit_to_')]
    check(flipped.any() or (set(pair_suites['card']) == set(pair_suites['cpu']) and set(derived) <= set(
        pair_suites['card'])), f'suites card vs CPU: the same suites {sorted(pair_suites["card"])}')
    agree_all = []
    for name in derived:
        codes_c, pred_c, _ = card[name]
        codes_h, pred_h, margin_h = host[name]
        same_codes = (codes_c == codes_h).all(1)
        agree_all.append((codes_c == codes_h).mean())
        flips = pred_c != pred_h
        unexplained = flips & same_codes & ~(margin_h < SUITE_TIE_MARGIN)
        gap = abs(pair_suites['card'][name]['Accuracy'] - pair_suites['cpu'][name]['Accuracy'])
        check(not unexplained.any() and gap <= flips.sum() / len(flips) + 1e-9,
              f'suites card vs CPU, {name}: accuracy {pair_suites["card"][name]["Accuracy"]:.4f} vs '
              f'{pair_suites["cpu"][name]["Accuracy"]:.4f}; {int(flips.sum())} of {len(flips)} predictions differ, '
              f'{int((~same_codes).sum())} clouds with a differing code, flips unexplained {int(unexplained.sum())}')
    agree = float(np.mean(agree_all)) if agree_all else 1.0
    check(agree >= CODE_AGREEMENT, f'suites card vs CPU: code agreement of the derived clouds {agree:.4f} >= '
                                   f'{CODE_AGREEMENT}')

    # ---- the model variants of the experiment tree: paths A-E -------------
    # each the flagship at full width with one override (variant_configs),
    # random weights from --seed; first each widened kernel against its plain
    # version at the shapes the variants give it, then each path's launches
    # counted from 0 just before it and read just after, and its card output
    # against the CPU
    v_cfgs = variant_configs(cfg)
    v_models = {}
    for key, v_cfg in v_cfgs.items():
        model = build_vqvae(v_cfg)
        init_from_seed(model, args.seed + 40 + ord(key))
        v_models[key] = model.to(dev).eval()
    variant_launches = {key: dict.fromkeys(KERNEL_INFO, 0) for key in v_cfgs}

    def add_variant(key: str) -> dict[str, int]:
        counts = api.launch_counts()
        for name, count in counts.items():
            variant_launches[key][name] += count
        return counts

    def unpadded(layers) -> list[dict]:
        """A stack's pack with each FF weight at its true width, for the bound."""
        return [{**p, 'w1': layer.dense_0.weight, 'b1': layer.dense_0.bias, 'w2': layer.dense_1.weight}
                for p, layer in zip((wformer.pack_decoder if hasattr(layers[0], 'attn_1') else wformer.pack_encoder)(
                    layers), layers)]

    with torch.inference_mode():
        # E's three W-nets: heads of 8 (W-decoder, 128 x 16, FF 137), 32
        # (W-encoder, 256 x 8, FF 1000) and 128 (the conditional encoder,
        # 512 x 4, FF 700) at the counterfactual's batch of 16; FF widths
        # off 64 run zero-padded copies (192, 1024, 704)
        wae_e = v_models['E'].w_autoencoder
        for label, net in (('W-decoder', wae_e.decoder), ('W-encoder', wae_e.encoder),
                           ('conditional W-encoder', wae_e.z2_posterior)):
            dec_net = label == 'W-decoder'
            d, heads = net.proj_dim, net.n_heads
            x = torch.from_numpy(rng.standard_normal((b, wae_e.n_codes, d)).astype(np.float32)).to(dev)
            pack = (wformer.pack_decoder if dec_net else wformer.pack_encoder)(net.layers)
            if dec_net:
                run_k = functools.partial(wformer.wformer_decoder_cuda, x, x, pack, heads)
                run_p = functools.partial(wformer.plain_decoder, x, x, pack, heads)
                work = roofline.decoder_stack_work(x, x, unpadded(list(net.layers)))
            else:
                run_k = functools.partial(wformer.wformer_encoder_cuda, x, pack, heads)
                run_p = functools.partial(wformer.plain_encoder, x, pack, heads)
                work = roofline.encoder_stack_work(x, unpadded(list(net.layers)))
            lib = library_stack(pack, heads, dec_net)
            run_l = (lambda: lib(x, x)) if dec_net else (lambda: lib(x))  # noqa: E731
            got, want = run_k(), run_p()
            r = rel_l2(got, want)
            ms, pms, lms = time_ms(run_k, REPS), time_ms(run_p, REPS), time_ms(run_l, REPS)
            bms, by = roofline.bound_ms(work)
            check(r <= CVAE_REL_L2 and bool(torch.isfinite(got).all()),
                  f'path E {label} stack ({b}, {wae_e.n_codes}, {d}), heads of {d // heads}, FF '
                  f'{list(net.mlp_dims)} (packed {[p["w1"].shape[0] for p in pack]}): rel L2 {r:.3e} <= '
                  f'{CVAE_REL_L2}; {ms:.4f} ms (plain {pms:.4f}, library {lms:.4f}, bound {bms:.4f} ms, {by})')

        # the general PCGen kernel at E's decoder: 500-300-77, map 200, 8 components
        dec_e = v_models['E'].decoder
        pack_e = dec_e.pack()
        gen_rows, gen_errs = {}, []
        for bb in (1, b):
            m = torch.relu(torch.from_numpy(rng.standard_normal((bb, n, 200)).astype(np.float32))).to(dev)
            w = torch.from_numpy(rng.standard_normal((bb, cfg.autoencoder.w_dim)).astype(np.float32)).to(dev)
            run_k = functools.partial(pcgen.pcgen_general_cuda, m, w, pack_e, tau=dec_e.tau, act_slope=0.0)
            run_p = functools.partial(pcgen.plain, m, w, pack_e, tau=dec_e.tau, act_slope=0.0)
            got, want = run_k(), run_p()
            r = rel_l2(got, want)
            gen_errs.append(float((got - want).abs().max()))
            row = gen_rows[bb] = {'rel_l2': r, 'ms': time_ms(run_k, REPS), 'plain_ms': time_ms(run_p, REPS),
                                  **bound(roofline.pcgen_general_work(m, w, pack_e))}
            check(r <= PCGEN_REL_L2 and bool(torch.isfinite(got).all()),
                  f'pcgen_general B={bb}, 1024-500-300-77, map 200, G=8: rel L2 {r:.3e} <= {PCGEN_REL_L2}; '
                  f'{row["ms"]:.4f} ms (plain {row["plain_ms"]:.3f} ms, bound {row["bound_ms"]:.4f} ms, '
                  f'{row["bound_by"]})')
        kernels['pcgen_general'] = {'max_abs_err': max(gen_errs), **gen_rows[b], 'library_ms': None,
                                    'shape': '(16, 2048, 200) -> (16, 2048, 3), G=8, 1024-500-300-77'}

        # the general PCGen kernel past four component layers (its device
        # table of layers): 5 and 6 layers at serving's batch 16, map 64, G=8
        deep = {}
        for dims in DEEP_PCGEN_DIMS:
            gen = torch.Generator().manual_seed(args.seed + len(dims))
            n_l = len(dims) - 1
            pk = pcgen.PCGenPack(
                map_w=(torch.randn((dims[0], 64), generator=gen) / 8).to(dev), map_b=torch.zeros(dims[0], device=dev),
                layer_ws=tuple((torch.randn((8, dims[i + 1], dims[i]), generator=gen) * dims[i] ** -0.5).to(dev)
                               for i in range(n_l)),
                layer_bs=tuple((0.1 * torch.randn((8, dims[i + 1]), generator=gen)).to(dev) for i in range(n_l)),
                head_w=(torch.randn((8, 3, dims[-1]), generator=gen) * dims[-1] ** -0.5).to(dev),
                head_b=(0.1 * torch.randn((8, 3), generator=gen)).to(dev),
                att_w=(0.1 * torch.randn((8, 8 * dims[-1]), generator=gen)).to(dev),
                att_b=(0.1 * torch.randn(8, generator=gen)).to(dev))
            m = torch.relu(torch.from_numpy(rng.standard_normal((b, n, 64)).astype(np.float32))).to(dev)
            w = torch.from_numpy(rng.standard_normal((b, dims[0])).astype(np.float32)).to(dev)
            api.reset_launch_counts()
            got = api.pcgen_mix(m, w, pk, tau=5.0, act_slope=0.0)
            launched = api.launch_counts()['pcgen_general']
            want = pcgen.plain(m, w, pk, tau=5.0, act_slope=0.0)
            r = rel_l2(got, want)
            row = deep[n_l] = {'rel_l2': r, 'max_abs_err': float((got - want).abs().max()),
                               'ms': time_ms(lambda m=m, w=w, pk=pk: pcgen.pcgen_general_cuda(m, w, pk, tau=5.0,
                                                                                             act_slope=0.0), REPS),
                               'plain_ms': time_ms(lambda m=m, w=w, pk=pk: pcgen.plain(m, w, pk, tau=5.0,
                                                                                       act_slope=0.0), REPS),
                               **bound(roofline.pcgen_general_work(m, w, pk))}
            check(launched == 1 and r <= PCGEN_REL_L2 and bool(torch.isfinite(got).all()),
                  f'pcgen_general {n_l} layers (B={b}, N={n}, map 64, G=8, {"-".join(map(str, dims))}): one launch '
                  f'{launched == 1}, rel L2 {r:.3e} <= {PCGEN_REL_L2}; {row["ms"]:.4f} ms (plain '
                  f'{row["plain_ms"]:.3f} ms, bound {row["bound_ms"]:.4f} ms, {row["bound_by"]}, share '
                  f'{row["bound_ms"] / row["ms"]:.1%})')
        kernels['pcgen_general']['deep'] = deep

        # heads past 128 wide: the W-encoder stack at d = 512 with 2 and 1
        # heads at stage 2's batch 32, and its attention launch alone
        wide = {}
        for heads in WIDE_HEADS:
            d_w, hd = 512, 512 // heads
            gen = torch.Generator().manual_seed(args.seed + heads)
            pack_w = [{**{f'ln{i}_{p}': (1 + 0.1 * torch.randn(d_w, generator=gen) if p == 'w' else
                                         0.1 * torch.randn(d_w, generator=gen)).to(dev)
                          for i in (1, 2) for p in ('w', 'b')},
                       **{f'w{x}': (torch.randn((d_w, d_w), generator=gen) * d_w ** -0.5).to(dev) for x in 'qkvo'},
                       **{f'b{x}': (0.1 * torch.randn(d_w, generator=gen)).to(dev) for x in 'qkvo'},
                       'w1': (torch.randn((1024, d_w), generator=gen) * d_w ** -0.5).to(dev),
                       'b1': (0.1 * torch.randn(1024, generator=gen)).to(dev),
                       'w2': (torch.randn((d_w, 1024), generator=gen) / 32).to(dev),
                       'b2': (0.1 * torch.randn(d_w, generator=gen)).to(dev)} for _ in range(2)]
            t_w = cfg.autoencoder.n_codes
            x = torch.from_numpy(rng.standard_normal((bw, t_w, d_w)).astype(np.float32)).to(dev)
            got = wformer.wformer_encoder_cuda(x, pack_w, heads)
            stack_r = rel_l2(got, wformer.plain_encoder(x, pack_w, heads))
            q, k_, v_ = (torch.from_numpy(rng.standard_normal((bw * t_w, d_w)).astype(np.float32)).to(dev)
                         for _ in range(3))
            out = torch.empty(bw * t_w, d_w, device=dev)
            st = wformer.Stacks(bw, t_w, d_w, dev)
            st.attend(q, k_, v_, out, heads)
            want = ops.attention(q.double().view(bw, t_w, d_w), k_.double().view(bw, t_w, d_w),
                                 v_.double().view(bw, t_w, d_w), heads)
            r = rel_l2(out.view(bw, t_w, d_w), want)
            q4, k4, v4 = (y.view(bw, -1, heads, hd).transpose(1, 2) for y in (q, k_, v_))
            row = wide[hd] = {
                'rel_l2': r, 'stack_rel_l2': stack_r,
                'max_abs_err': float((out.view(bw, t_w, d_w).double() - want).abs().max()),
                'ms': time_ms(functools.partial(st.attend, q, k_, v_, out, heads), REPS),
                'plain_ms': time_ms(functools.partial(ops.attention, q.view(bw, t_w, d_w), k_.view(bw, t_w, d_w),
                                                      v_.view(bw, t_w, d_w), heads), REPS),
                'library_ms': time_ms(functools.partial(torch.nn.functional.scaled_dot_product_attention, q4, k4, v4),
                                      REPS),
                **bound(roofline.attention_work(bw, t_w, t_w, heads, hd))}
            check(r <= ATTENTION_REL_L2 and stack_r <= CVAE_REL_L2,
                  f'pccf_attention (B, T, T_kv) = ({bw}, {t_w}, {t_w}), {heads} heads of {hd} (the wide instance): '
                  f'rel L2 vs float64 {r:.2e} <= {ATTENTION_REL_L2}; {row["ms"]:.4f} ms a launch (plain '
                  f'{row["plain_ms"]:.4f}, library {row["library_ms"]:.4f}, bound {row["bound_ms"]:.4f} ms '
                  f'({row["bound_by"]}), share {row["bound_ms"] / row["ms"]:.1%}); the 2-layer encoder stack at '
                  f'({bw}, {t_w}, {d_w}) against its plain version rel L2 {stack_r:.2e} <= {CVAE_REL_L2}')
        kernels['wformer_encoder']['wide_heads'] = wide

        # the graph pools at widths off four channels (E's LDGCNN pools at 17
        # and 130; 511 beside them): the eval max-pool at serving's 16, the
        # training max-pool with its slot and its slot scatter at stage 1's
        # 8, the sum-pool at 2 x 17 (E's EdgeConv statistics) and 511
        for c in ODD_POOL_WIDTHS:
            x16 = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(dev)
            idx16 = knn.knn_cuda(torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).to(dev), 25)
            got = gather.graph_max_pool_cuda(x16, idx16)
            ok_max = torch.equal(got, gather.plain(x16, idx16))
            x8, idx8 = x16[:TRAIN_BATCH].contiguous(), idx16[:TRAIN_BATCH].contiguous()
            out, slots = gather.graph_max_pool_src_cuda(x8, idx8)
            want, want_slots = ops.graph_max_pool_slots_strict(x8, idx8)
            g8 = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, n, c)).astype(np.float32)).to(dev)
            dx = gather.scatter_add_slots_cuda(g8, idx8, slots, n)
            ok_slot = torch.equal(out, want) and torch.equal(slots, want_slots) and torch.equal(
                dx.cpu(), ops.scatter_add_slots(g8.cpu(), idx8.cpu(), slots.cpu(), n))
            xs = x8 if c != ODD_POOL_WIDTHS[0] else torch.cat([x8, x8 * x8], -1)
            ok_sum = torch.equal(gather.graph_sum_pool_cuda(xs, idx8).cpu(),
                                 ops.graph_sum_pool_slot_order(xs.cpu(), idx8.cpu()))
            times = [time_ms(lambda: gather.graph_max_pool_cuda(x16, idx16), REPS),
                     time_ms(lambda: gather.plain(x16, idx16), REPS),
                     time_ms(lambda: gather.graph_max_pool_src_cuda(x8, idx8), REPS),
                     time_ms(lambda: ops.graph_max_pool_slots_strict(x8, idx8), REPS),
                     time_ms(lambda: gather.scatter_add_slots_cuda(g8, idx8, slots, n), REPS),
                     time_ms(lambda: ops.scatter_add_slots(g8, idx8, slots, n), REPS),
                     time_ms(lambda: gather.graph_sum_pool_cuda(xs, idx8), REPS),
                     time_ms(lambda: ops.graph_sum_pool(xs, idx8), REPS)]
            bounds = [roofline.bound_ms(w)[0] for w in (
                roofline.pool_work(x16, idx16), roofline.pool_work(x8, idx8, slots=True),
                roofline.scatter_slots_work(g8, idx8, slots, n), roofline.pool_work(xs, idx8))]
            check(ok_max and ok_slot and ok_sum,
                  f'pools at C={c}: max-pool (16, {n}, {c}) bit-exact {ok_max} {times[0]:.4f} ms (plain '
                  f'{times[1]:.4f}, bound {bounds[0]:.4f}); pool with slot (8, {n}, {c}) and its slot scatter '
                  f'bit-exact '
                  f'{ok_slot} {times[2]:.4f} / {times[4]:.4f} ms (plain {times[3]:.4f} / {times[5]:.4f}, bound '
                  f'{bounds[1]:.4f} / {bounds[2]:.4f}); sum-pool (8, {n}, {xs.shape[-1]}) bit-equal to the slot '
                  f'order {ok_sum} {times[6]:.4f} ms (plain {times[7]:.4f}, bound {bounds[3]:.4f})')

        # the gather and its backward, the row scatter, at D's GELU EdgeConvs
        # (8, 2048, 25, F)
        idx8 = knn.knn_cuda(torch.from_numpy(rng.standard_normal((TRAIN_BATCH, n, 3)).astype(np.float32)).to(dev), 25)
        for f in (64, 128, 256):
            u = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, n, f)).astype(np.float32)).to(dev)
            ok_g = torch.equal(gather.gather_neighbors_cuda(u, idx8), ops.gather_neighbors(u, idx8))
            g = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, n * 25, f)).astype(np.float32)).to(dev)
            sidx = idx8.reshape(TRAIN_BATCH, n * 25, 1)
            got = gather.scatter_add_rows_cuda(g, sidx, n)
            ok_s = torch.equal(got.cpu(), ops.scatter_add_rows(g.cpu(), sidx.cpu(), n)) and torch.equal(
                got, gather.scatter_add_rows_cuda(g, sidx, n))
            tg = time_ms(lambda: gather.gather_neighbors_cuda(u, idx8), REPS)
            tgp = time_ms(lambda: ops.gather_neighbors(u, idx8), REPS)
            ts = time_ms(lambda: gather.scatter_add_rows_cuda(g, sidx, n), REPS)
            tsp = time_ms(lambda: ops.scatter_add_rows(g, sidx, n), REPS)
            flat = (sidx[..., 0].long() + n * torch.arange(TRAIN_BATCH, device=dev)[:, None]).flatten()
            tsl = time_ms(lambda: torch.zeros((TRAIN_BATCH * n, f), device=dev).index_add_(0, flat, g.view(-1, f)),
                          REPS)
            bg = roofline.bound_ms(roofline.gather_work(u, idx8))[0]
            bs = roofline.bound_ms(roofline.scatter_rows_work(g, sidx, n))[0]
            check(ok_g and ok_s, f'path D gather (8, {n}, 25, {f}) bit-exact {ok_g} {tg:.4f} ms (plain {tgp:.4f}, '
                                 f'bound {bg:.4f}); its backward, the row scatter, bit-equal to the CPU and across '
                                 f'calls {ok_s} {ts:.4f} ms (plain {tsp:.4f}, index_add_ {tsl:.4f}, bound {bs:.4f})')

    def v_sampling(model, bb: int, seed: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(seed)
        return torch.randn((bb, n, model.decoder.sample_dim), generator=gen)

    def cf_card_vs_cpu(key: str) -> None:
        """The counterfactual of two clouds on the card and the CPU."""
        model = v_models[key]
        pair_cl = torch.from_numpy(clouds[1:3])
        samp = v_sampling(model, 2, args.seed + 50)
        outs = []
        for vq, cls, where in ((model, classifier, dev), (None, None, torch.device('cpu'))):
            if vq is None:
                vq, cls = copy.deepcopy(model).cpu(), copy.deepcopy(classifier).cpu()
                vq.prepack()
            with torch.inference_mode():
                cl = pair_cl.to(where)
                out = vq.generate_counterfactual(Inputs(cloud=cl, initial_sampling=samp.to(where)),
                                                 cls(Inputs(cloud=cl)), torch.tensor([1, 0], device=where))
            outs.append((out.idx.cpu(), out.recon.cpu()))
        agree = float((outs[0][0] == outs[1][0]).float().mean())
        same = (outs[0][0] == outs[1][0]).all(dim=1)
        r = rel_l2(outs[0][1][same], outs[1][1][same]) if same.any() else float('inf')
        check(agree >= CODE_AGREEMENT and bool(same.any()) and r <= RECON_REL_L2,
              f'path {key} counterfactual card vs CPU: code agreement {agree:.4f} >= {CODE_AGREEMENT}, recon rel L2 '
              f'{r:.3e} <= {RECON_REL_L2} over the {int(same.sum())} of 2 samples with all codes equal')

    def v_requests(key: str) -> None:
        """Requests of 1 and 16 through a server of the variant: exact launches
        a request, finite clouds, the warm latency at 16."""
        server_v = CounterfactualServer(v_models[key], classifier, seed=args.seed)
        for bb in (1, b):
            api.reset_launch_counts()
            out = server_v.counterfactual(clouds[:bb], np.arange(bb) % 2)
            counts = add_variant(key)
            want = {name: VARIANT_REQUEST_LAUNCHES[key].get(name, 0) for name in counts}
            check(counts == want and out.shape == (bb, n, 3) and bool(np.isfinite(out).all()),
                  f'path {key} request of {bb}: launches {json.dumps({k: v for k, v in counts.items() if v})} == '
                  f'{json.dumps(VARIANT_REQUEST_LAUNCHES[key])}, finite ({bb}, {n}, 3)')
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            server_v.counterfactual(clouds[:b], np.arange(b) % 2)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f'path {key} warm request of {b}: median {np.median(times):.3f} ms over 5 (host clock incl. copies)',
              flush=True)

    def v_stage1(key: str) -> None:
        """ChamferEMD steps at 8 x 2048 (exact launches a step, finite losses,
        the step time), then one step at 2 x 512 on the card and the CPU."""
        v_cfg = v_cfgs[key]
        state = copy.deepcopy(v_models[key].state_dict())
        model = build_vqvae(v_cfg)
        model.load_state_dict(state)
        model = model.to(dev)
        tr = Trainer(model, get_autoencoder_loss(v_cfg), v_cfg.autoencoder.train, STEPS_PER_EPOCH)
        v_losses, v_ms = [], []
        for step in range(WARM_STEPS + 5):
            api.reset_launch_counts()
            t0 = time.perf_counter()
            out = tr.run_step(inputs, targets, gumbel_uniform((TRAIN_BATCH, n, cfg.autoencoder.decoder.n_components),
                                                              torch.Generator(device=dev).manual_seed(step), dev))
            torch.cuda.synchronize()
            v_ms.append((time.perf_counter() - t0) * 1e3)
            counts = add_variant(key)
            v_losses.append(float(out['Loss']))
            want = {name: VARIANT_STEP_LAUNCHES[key].get(name, 0) for name in counts}
            if step == 0 or counts != want:
                check(counts == want, f'path {key} stage-1 step {step}: launches '
                                      f'{json.dumps({k: v for k, v in counts.items() if v})} == '
                                      f'{json.dumps(VARIANT_STEP_LAUNCHES[key])}')
        check(bool(np.isfinite(v_losses).all()), f'path {key} stage-1 losses finite: {np.round(v_losses, 5).tolist()}')
        print(f'path {key} stage-1 ChamferEMD step ({TRAIN_BATCH} x {n}): median {np.median(v_ms[WARM_STEPS:]):.3f} '
              f'ms over 5 (host clock, synchronised)', flush=True)
        pts = 512
        small_cl = torch.from_numpy(synthetic.batch(args.seed + 5, 2, pts))
        gen = torch.Generator().manual_seed(args.seed + 51)
        samp = torch.randn((2, pts, v_cfg.autoencoder.decoder.sample_dim), generator=gen)
        noise = gumbel_uniform((2, pts, v_cfg.autoencoder.decoder.n_components), gen, torch.device('cpu'))
        steps = []
        for where in (dev, torch.device('cpu')):
            m = build_vqvae(v_cfg)
            m.load_state_dict(state)
            m = m.to(where)
            tr = Trainer(m, get_autoencoder_loss(v_cfg), v_cfg.autoencoder.train, STEPS_PER_EPOCH)
            cl = small_cl.to(where)
            out = tr.run_step(Inputs(cl, initial_sampling=samp.to(where)), Targets(cl), noise.to(where))
            steps.append(({k: float(v) for k, v in out.items()},
                          {k: p.grad.detach().cpu() for k, p in m.named_parameters() if p.grad is not None}))
        for name, value in steps[1][0].items():
            r = abs(steps[0][0][name] - value) / abs(value)
            check(r <= STEP_LOSS_RTOL, f'path {key} step card vs CPU (2 x {pts}): {name} {steps[0][0][name]:.6f} vs '
                                       f'{value:.6f}, rel {r:.2e}')
        errs = {k: rel_l2(steps[0][1][k], v) for k, v in steps[1][1].items()}
        worst = max(errs, key=errs.get)
        check(set(steps[0][1]) == set(steps[1][1]) and errs[worst] <= STEP_GRAD_REL_L2,
              f'path {key} step card vs CPU: largest per-parameter gradient rel L2 {errs[worst]:.2e} ({worst})')

    def v_stage2(key: str) -> None:
        """W-autoencoder steps at batch 32 on random codes of the codebook:
        finite losses, falling MSE, no kernel launched (the W-nets train
        layer by layer), the step time; then one step of 4 of those codes on
        the card and the CPU from the same weights and posterior noise."""
        v_cfg = v_cfgs[key]
        w_m = WAETrainModule(build_w_autoencoder(v_cfg), v_cfg.autoencoder.book_size)
        init_from_seed(w_m, args.seed + 52)
        w_m.codebook.copy_(v_models[key].codebook.detach().cpu())
        w_state = copy.deepcopy(w_m.state_dict())
        w_m = w_m.to(dev)
        vcfg = v_cfg.w_autoencoder
        tr = Trainer(w_m, get_w_autoencoder_loss(vcfg.train, vcfg.n_pseudo_inputs), vcfg.train, STEPS_PER_EPOCH,
                     seed=args.seed)
        bw_, t_, e_, book = vcfg.train.batch_size, w_m.wae.n_codes, w_m.wae.embedding_dim, v_cfg.autoencoder.book_size
        sel = torch.from_numpy(rng.integers(0, book, (bw_, t_))).to(dev)
        w_e = w_m.codebook[torch.arange(t_, device=dev)[None], sel].reshape(bw_, t_ * e_)
        w_q = w_e + 0.1 * torch.randn(w_e.shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
        logits = torch.randn((bw_, cfg.data.n_classes), generator=torch.Generator(device=dev).manual_seed(4),
                             device=dev)
        one_hot = torch.nn.functional.one_hot(sel, book).float()
        mses, ms_ = [], []
        for step in range(WARM_STEPS + 5):
            api.reset_launch_counts()
            t0 = time.perf_counter()
            out = tr.run_step(WInputs(w_q, logits), WTargets(w_e, one_hot, logits))
            torch.cuda.synchronize()
            ms_.append((time.perf_counter() - t0) * 1e3)
            counts = add_variant(key)
            mses.append({k: float(v) for k, v in out.items()})
        check(all(np.isfinite(list(m.values())).all() for m in mses) and mses[-1]['MSE'] < mses[0]['MSE']
              and not any(counts.values()),
              f'path {key} stage 2 (batch {bw_}): finite losses, MSE {mses[0]["MSE"]:.4f} -> {mses[-1]["MSE"]:.4f}, '
              f'no launch ({sorted(mses[0])})')
        print(f'path {key} stage-2 step (batch {bw_}): median {np.median(ms_[WARM_STEPS:]):.3f} ms over 5 (host '
              f'clock, synchronised)', flush=True)
        # dropout off in every W-net: the card's and the CPU's generators draw
        # different masks; the nets' weights are the same
        rep = dataclasses.replace
        no_drop = {net: rep(getattr(vcfg, net), dropout_rates=(0.0,) * len(getattr(vcfg, net).dropout_rates))
                   for net in ('w_encoder', 'w_decoder', 'conditional_w_encoder')}
        s_cfg = rep(v_cfg, w_autoencoder=rep(vcfg, **no_drop))
        sb = 4
        gen = torch.Generator().manual_seed(args.seed + 53)
        eps = tuple(torch.randn((sb, t_, z), generator=gen) for z in (vcfg.z1_dim, vcfg.z2_dim))
        batch = [t[:sb].cpu() for t in (w_q, logits, w_e, one_hot)]
        steps = []
        for where in (dev, torch.device('cpu')):
            m = WAETrainModule(build_w_autoencoder(s_cfg), v_cfg.autoencoder.book_size)
            m.load_state_dict(w_state)
            m = m.to(where)
            tr = Trainer(m, get_w_autoencoder_loss(vcfg.train, vcfg.n_pseudo_inputs), vcfg.train, STEPS_PER_EPOCH)
            q_, l_, e_w, oh = (t.to(where) for t in batch)
            out = tr.run_step(WInputs(q_, l_), WTargets(e_w, oh, l_), tuple(e.to(where) for e in eps))
            steps.append(({k: float(v) for k, v in out.items()},
                          {k: p.grad.detach().cpu() for k, p in m.named_parameters() if p.grad is not None}))
        for name, value in steps[1][0].items():
            if name == 'Quantisation Accuracy':
                ok, r = abs(steps[0][0][name] - value) <= W_STEP_ACCURACY_ATOL, abs(steps[0][0][name] - value)
            else:
                r = abs(steps[0][0][name] - value) / max(abs(value), 1e-30)
                ok = r <= STEP_LOSS_RTOL
            check(ok, f'path {key} stage-2 step card vs CPU ({sb}, dropout off): {name} {steps[0][0][name]:.6g} vs '
                      f'{value:.6g}, diff {r:.2e}')
        n_conv = len(vcfg.w_encoder.conv_dims) if vcfg.w_encoder.class_name == 'Convolutional' else 0
        compared = [k for k in steps[1][1] if not rounding_gradient(k, n_conv)]
        errs = {k: rel_l2(steps[0][1][k], steps[1][1][k]) for k in compared}
        worst = max(errs, key=errs.get)
        check(set(steps[0][1]) == set(steps[1][1]) and errs[worst] <= STEP_GRAD_REL_L2,
              f'path {key} stage-2 step card vs CPU: largest per-parameter gradient rel L2 {errs[worst]:.2e} '
              f'({worst}), median {float(np.median(list(errs.values()))):.2e}, over {len(compared)} of '
              f'{len(steps[1][1])}')

    # A: the LDGCNN VQ-VAE
    v_requests('A')
    cf_card_vs_cpu('A')
    v_stage1('A')
    # B: the convolutional W-encoder and the linear W-decoder
    v_stage2('B')
    v_requests('B')
    cf_card_vs_cpu('B')
    # C: the VampPrior, the transformer nets
    v_stage2('C')
    server_c = CounterfactualServer(v_models['C'], classifier, seed=args.seed)
    api.reset_launch_counts()
    g_out = server_c.generate(b, seed=args.seed)
    counts = add_variant('C')
    want = {name: VAMP_GENERATION_LAUNCHES.get(name, 0) for name in counts}
    check(counts == want and g_out.shape == (b, n, 3) and bool(np.isfinite(g_out).all()),
          f'path C generate {b}: launches {json.dumps({k: v for k, v in counts.items() if v})} == '
          f'{json.dumps(VAMP_GENERATION_LAUNCHES)}, finite ({b}, {n}, 3)')
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        server_c.generate(b, seed=args.seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f'path C warm generate of {b}: median {np.median(times):.3f} ms over 5 (host clock incl. copies)', flush=True)
    v_noise, v_samp = server_c.generation_draws(2, args.seed, 0)
    cpu_c = copy.deepcopy(v_models['C']).cpu()
    cpu_c.prepack()
    with torch.inference_mode():
        g_card = v_models['C'].generate(2, v_samp.to(dev), 0.0, None, tuple(t.to(dev) for t in v_noise))
        g_cpu = cpu_c.generate(2, v_samp, 0.0, None, v_noise)
    agree = float((g_card.idx.cpu() == g_cpu.idx).float().mean())
    same = (g_card.idx.cpu() == g_cpu.idx).all(dim=1)
    r = rel_l2(g_card.recon.cpu()[same], g_cpu.recon[same]) if same.any() else float('inf')
    check(agree >= CODE_AGREEMENT and bool(same.any()) and r <= RECON_REL_L2,
          f'path C generation card vs CPU ({VAMP_PSEUDO_INPUTS} pseudo-inputs): code agreement {agree:.4f} >= '
          f'{CODE_AGREEMENT}, recon rel L2 {r:.3e} <= {RECON_REL_L2} over {int(same.sum())} of 2')
    # D: an encoder activation of GELU
    v_stage1('D')
    # E: the tuning corner
    v_requests('E')
    cf_card_vs_cpu('E')
    print('launches of the variants: ' + '; '.join(
        f'{key} {json.dumps({k: v for k, v in c.items() if v})}' for key, c in variant_launches.items()), flush=True)

    # ---- the main path through the experiment's own entry points, then --
    # tuning and the dataset readers
    import tempfile

    root = tempfile.mkdtemp(prefix='pccf_cli_')
    try:
        cli_launches = cli_phase(args.seed, check, dev, root)
        tune_launches, reader_launches = tuning_and_readers_phase(args.seed, check, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    print(f'launches: serving {json.dumps(launches)}; stage-1 ChamferEMD steps {json.dumps(train_launches)}; '
          f'stage 2 {json.dumps(stage2_launches)}; stage-1 Chamfer and ChamferSinkhorn steps and entry point '
          f'{json.dumps(objective_launches)}; classifier steps and entry point {json.dumps(classifier_launches)}; '
          f'evaluation suites {json.dumps(suite_launches)}; generation {json.dumps(gen_launches)}; the five '
          f'entry points {json.dumps({k: v for k, v in cli_launches.items() if v})}; tuning '
          f'{json.dumps({k: v for k, v in tune_launches.items() if v})}; the readers '
          f'{json.dumps({k: v for k, v in reader_launches.items() if v})}', flush=True)
    paths = (launches, train_launches, stage2_launches, objective_launches, classifier_launches, suite_launches,
             gen_launches, *variant_launches.values(), cli_launches, tune_launches, reader_launches)
    print('kernel | headline shape | ms | plain ms | library ms | bound ms (by) | share of bound | launches '
          'serving / stage 1 / stage 2 / stage-1 Chamfer and ChamferSinkhorn / classifier / suites / generation / '
          'variants A / B / C / D / E / CLI pipeline / tuning / readers', flush=True)
    for name in KERNEL_INFO:
        k = kernels[name]
        lib = 'none' if k['library_ms'] is None else f'{k["library_ms"]:.4f}'
        print(f'{name} | {k["shape"]} | {k["ms"]:.4f} | {k["plain_ms"]:.4f} | {lib} | {k["bound_ms"]:.4f} '
              f'({k["bound_by"]}) | {k["bound_ms"] / k["ms"]:.2%} | ' + ' / '.join(str(c[name]) for c in paths),
              flush=True)
    record = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': KERNEL_INFO[name][0], 'replaces': KERNEL_INFO[name][1],
         'launches': sum(c[name] for c in paths), **kernels[name]}
        for name in KERNEL_INFO
    ]}
    print(f'chip_smoke: {time.perf_counter() - started:.1f} s in all, the kernels\' build included', flush=True)
    if failures:
        print(f'chip_smoke: {len(failures)} check(s) failed: {failures}', file=sys.stderr)
        return 1
    print(json.dumps(record))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
