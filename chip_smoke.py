#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mlcomp_tpu_torch``) on one
NVIDIA card — the quickest proof that the port still builds, is right,
serves and trains on the GPU.

    python3 chip_smoke.py [--seed N]

It imports nothing of JAX or of the JAX package ``mlcomp_tpu``. Phases,
one line of output each (or more), any failure exits non-zero before the
last line:

1. device: the card's name and power limit (``nvidia-smi``), torch, CUDA
   and nvcc versions;
2. build: every kernel under ``mlcomp_tpu_torch/csrc/`` with nvcc, timed,
   with ptxas's register / spill report and wgmma advisories, and the
   HGMMA (wgmma) instructions in the SASS of every 16-bit instantiation
   of the attention forward and the two backward kernels and of every
   instantiation of the int8 matmul and the serving stack (cuobjdump;
   none fails the run);
3. kernels: each kernel's wrapper on tensors on the card against its
   plain PyTorch version at several shapes (the main path's shape first),
   by the largest relative error of an output row (see
   ``mlcomp_tpu_torch/testing/kernel_check.py``), with its time, the
   plain version's time, one PyTorch library call's time as a
   yardstick, and the least time the card could take (bytes over
   3.35 TB/s or operations over the dtype's peak): the forward at the
   serving shapes (timed at the serving shape, and with its lse at B=1
   with the flagship's 16 heads and the wide LM's 32, each beside SDPA
   and as a share of the card's peak), then the forward's lse and the
   two backward kernels
   at the training shapes (also held against torch autograd through the
   plain version, per head), timed at both training shapes (the
   flagship's 16 heads and the wide LM's 32) beside SDPA's backward, and
   run twice there for bitwise-equal gradients;
4. norm kernels: the fused batch-norm+ReLU kernel against its plain
   version (run in f64) at the CIFAR ResNet-18's norm sites at batch 512
   and 256 (the step's and the executor's; with and without the ReLU)
   and at ragged shapes in fp16 and f32 (``kernel_check.NORM_SHAPES``),
   by the mean, var and per-channel y errors, two runs at the largest
   site bitwise equal, then timed by CUDA events at each site shape of
   the step (inputs rotated through more than the L2 cache;
   back-to-back calls, so host launch gaps are included) against its
   bound, its plain version and ``F.batch_norm(training=True)`` +
   ``F.relu``; then (``[kernel-norm-bwd]``) the norm's backward kernel
   against ``norm_act_backward`` run in f64 at the same shapes (dx per
   channel, dgamma and dbeta; elements whose pre-activation is within
   rounding of 0 counted and left out, ``kernel_check.norm_bwd_check``),
   two runs at each site bitwise equal, timed at each site beside its
   bound, its plain version and autograd's backward of
   ``F.relu(F.batch_norm(..., training=True))``;
5. int8 kernels: the int8 matmul against its plain version run in f64
   at the bench's shape, the served LM's and ragged ones, and at the
   wgmma tiles' edges (``kernel_check.INT8_SHAPES``, a NaN canary after
   the output), its fused ``Int8Dense`` epilogue (bias, bf16 / fp16 out)
   bit for bit against the unfused formula
   (``kernel_check.INT8_EPILOGUE_SHAPES``), timed at the four main-path
   shapes beside its bound, the plain version and ``torch.matmul`` on
   bf16 weights; the serving stack per layer against f64 and over the
   chain against ``reference_stack`` (``kernel_check.STACK_SHAPES``),
   run twice at the bench's shape for bitwise-equal outputs, timed at
   8 × 8192² at M = 64 in int8 and bf16 beside the bf16 chain;
6. serving: the flagship transformer LM (vocab 32768, d_model 1024, 16
   heads, d_ff 4096, 8 layers, T=8192, bf16 activations, f32 params;
   weights from a seed) exported with the port's ``export_model``,
   served by ``ModelServer(device='cuda')`` and asked over HTTP; the
   launch counts are zeroed just before the requests and read just
   after, and one row's logits are held against the same model with the
   plain attention;
7. int8 serving: the flagship exported per layer and served with
   ``quantize='int8'`` (25 int8 launches a dispatch), then the stacked
   export (the head alone: 1); counts zeroed just before the requests,
   read just after; one row against the same int8 weights through the
   plain product and against the unquantized model; weight bytes; where
   one dispatch of the per-layer export goes (``[serve-int8-split]``,
   profiler: the int8 kernel by shape, ``Int8Dense``'s passes around
   it, attention, the rest, the device's busy share);
8. ``serving_int8``: ``bench.py``'s leg (8 layers of 8192² at M = 64, 7
   interleaved trials × 100 stacks through ``make_chain_runner``): bf16
   chain, plain int8 chain, per-layer int8 kernel, int8 and bf16 stack
   kernel; the ratio of the min times, the paired range, p50/p99 from
   the recorder's ``histogram_summaries``;
9. train: ``Executor.from_config('train', config)`` on the card — the
   flagship at batch 1 over an npz of random tokens, AdamW with
   ``warmup_cosine``, one epoch, checkpoints and a ``model_name`` export
   that ``make_predictor`` then loads; the launch counts are zeroed just
   before and read just after (8 forward and 8 of each backward kernel
   per step);
10. CIFAR train: ``Executor.from_config('train', config)`` on the card
   with ``examples/cifar_simple/config.yml``'s train executor (ResNet-18
   at full width, ``norm: fused``, ``synthetic_images`` 8192/1024, batch
   256, AdamW ``warmup_cosine``, ``device_data: auto``, ``mesh: {dp:
   -1}``) for one epoch: checkpoints, the export loaded by
   ``make_predictor`` and served by ``ModelServer`` over HTTP; the norm
   kernels' launch counts zeroed just before and read just after (20
   forward and 20 backward per train step, none in eval; no dy copied);
11. CIFAR step: ResNet-18 at batch 512 with SGD (lr 0.1, momentum 0.9)
   as ``bench.py``'s CIFAR legs run it, ``norm: batch`` and ``norm:
   fused`` from the same weights on the same batch: step ms and
   images/s for each (timed in turns), the norm kernels' share of the
   step (forward and backward in both variants) and the longest kernels
   (profiler), and the cosine of every parameter's gradient between the
   two variants;
12. step: the flagship's train step as ``bench.py``'s ``bench_lm``
   measures it (B=1, T=8192, AdamW): tokens/s, MFU, device time, the
   attention share of it and the step's longest kernels (profiler), and
   one step's gradients against the same weights with the plain
   attention (cosine per parameter tensor);
13. norm device time: the fused norm kernels' own device time per call
   (profiler) at each site shape of the step: the forward with and
   without the ReLU, the backward with it; then (``[vit-kernels-device]``)
   the flash kernels' and SDPA's device time per call at the ViT's shape;
14. the ``{"kernels": [...]}`` line, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Phases of the int8 training slice, run among the above (ce-kernels and
int8-train after the int8 kernels, train-wide-int8 after train,
step-wide after step):

- int8-train: ``int8_train_matmul`` (``torch._int_mm`` on the card: a
  library call, no kernel of the port's) and both its gradients against
  autograd through its STE oracle run in f32, by relative L2 error
  (``kernel_check.INT8_TRAIN_SHAPES``: the wide step's ``qkv`` with bf16
  masters, its ``wo`` with f32 params);
- ce-kernels: the blocked cross-entropy's forward and backward kernels
  against their plain versions run in f64 (``kernel_check.CE_SHAPES``:
  the wide LM step's 8191 × 32768 bf16 with each (z, ε) of {0, 1e-4} ×
  {0, 0.1}, bench_fused_ce's 8192 × 32768, ragged shapes in fp16 and
  f32, strided rows; labels partly out of range; NaN canaries after
  loss, lse and dx), timed at the step's shape beside their bounds,
  their plain versions and ``F.cross_entropy`` (its autograd for the
  backward);
- train-wide-int8: ``Executor.from_config('train', config)`` on the
  wide LM of ``bench_lm`` (d_model 2048, 32 heads, d_ff 8192, 8 layers,
  T=8192, 687,900,672 parameters) with ``matmul_precision: int8``,
  ``param_dtype: bfloat16``, AdamW with ``master_dtype: bfloat16`` and
  ``loss: {name: lm_ce, impl: pallas, z_loss: 1e-4, label_smoothing:
  0.1}``: one epoch over an npz of random tokens, checkpoints, the
  export loaded by ``make_predictor``; launch counts zeroed just before
  and read just after (per step 1 CE forward and 1 backward, 8 flash
  forwards and 8 of each backward; no serving int8 launch);
- step-wide: ``bench_lm``'s wide legs on the same weights, timed in
  turns: (a) bf16, (b) int8 with bf16 masters (``lm_wide_int8_vs_bf16``),
  (c) int8 with the fused-CE kernels, z-loss and smoothing, (d) that
  loss dense; step ms, tokens/s, MFU; the CE kernels' and ``_int_mm``'s
  device time in (c) (profiler), the quantize passes, the dense CE and
  the two [N, V] passes around the kernels (CUDA events); checks (c)
  against (d) (logits-gradient cosine, loss) and (a) against (b) (every
  parameter's gradient cosine).

Phases of the MoE and ViT slice, run after train-wide-int8 (the MoE
step among the step phases, after step):

- moe-train: ``examples/moe``'s knobs (4 experts, every 2nd layer,
  capacity factor 1.25) at the flagship widths (293,635,072
  parameters) trained through ``Executor.from_config('train', ...)``
  for one epoch of ``synthetic_lm`` at B=1 (4 steps, 1 valid row of
  8192 tokens), checkpoints and the export reloaded; the flash launches
  zeroed just before and read just after (8 forward per step and valid
  row, 8 of each backward per step); then the timed step (ms, tokens/s,
  MFU over the model FLOPs with the dispatch einsums' FLOPs apart,
  ``moe_aux``, the flash launches per step, the profiler's longest
  kernels) and one step's gradients against the plain attention
  (cosine per parameter tensor);
- moe-serve: the MoE LM's per-layer export served over HTTP at batch 4
  in bf16 and with ``quantize='int8'`` (13 int8 modules: the dense
  layers' MLP projections and the head, as JAX's rule counts them on
  the same tree; the router and the 3-D expert weights stay): p50,
  launches per dispatch, one row against the plain attention (bf16) or
  the plain int8 product (int8);
- vit-train: the flash kernels at ``kernel_check.VIT_SHAPE`` (B=256,
  64 patches, 3 heads of 64, non-causal) timed beside SDPA and their
  bounds; ``examples/encoder_grid``'s ViT (3,564,864 parameters) on
  ``synthetic_images`` at batch 256 through the executor for one epoch
  (6 non-causal forward launches per batch, 6 of each backward per
  step), its step timed (ms, images/s), one step's gradients against
  the plain attention, its export served over HTTP and the served
  logits against the plain attention.

Phases of the export consumers' slice, run after cifar-train (each
executor of a DAG config run in turn after its ``depends`` through
``Executor.from_config(name, config)`` and ``executor(logger=...)`` in
one work directory, every kernel's count zeroed just before each
executor and read just after; configs are dicts written from the YAML
files with ``type: train`` for ``jax_train``, their cuts in comments and
in the output):

- dag-cifar10: ``examples/cifar10`` (ResNet-18 bf16 ``norm: fused``,
  batch 512, ``pad_crop`` + ``hflip``, SGD ``warmup_cosine`` on the
  50000/10000 synthetic CIFAR; 5 epochs cut to 1, ``report_imgs``
  dropped), ``infer`` with the default equation, ``valid`` over
  ``load('cifar10_resnet18')``; then a fine-tune of the same spec from
  that export (``model.params_file``) with ``infer_valid``. Checks: the
  predictions [10000, 10] with rows summing to 1, ``valid``'s score equal
  to their accuracy, which is within 0.2 points of the trainer's, the
  fine-tune's ``MergeSummary`` loading every leaf and its state before
  the first step equal to the export bit for bit, ``cifar10_ft.npy``'s
  accuracy within 0.2 points of its best score, 20 forward and 20
  backward norm launches a train step on both trains;
- dag-ensemble: (a) ``examples/ensemble`` verbatim (two MLPs, 3 epochs,
  ``valid_ens`` over ``(load('a') + load('b')) / 2``), its score equal to
  the accuracy of the saved arrays' mean; (b) ``encoder_grid``'s
  ``resnet18`` (``norm: fused``) and ``vit`` cells (1 epoch of 2),
  ``infer_classify`` of each at batch 512 with ``hflip`` TTA, the ViT
  through ``quantize='int8'`` (the flash forward at B=512, the int8
  matmul at M = 32768) and again in bf16, rows of the two held by
  cosine and top-1, ``predict.quantized`` against ``quantized_modules``,
  the launch counts of every train and infer, and ``valid_classify``
  over the two models' mean scored as in (a); each infer's wall time and
  images/s beside the card's name and power limit.

  Extended with the grid's four other cells (``seresnet18``, ``vgg13``,
  ``densenet121``, ``efficientnet_lite0``, their factories dropping the
  spec's ``norm`` as JAX's do), each inferred with ``hflip`` TTA, and
  ``valid_classify`` over the mean of all six saved arrays; each cell's
  predictions [512, 10] with rows summing to 1, the six-way score equal
  to the numpy accuracy of that mean;
- dag-segmentation: ``examples/segmentation`` (FPN over ResNet-18,
  bf16, ``cifar_stem``, ``bce_dice``, batch 32, Adam, 4 epochs of
  ``synthetic_segmentation`` 512/64 at 64x64; ``report_imgs`` dropped),
  ``infer_classify`` with ``activation: argmax``, then ``valid_segment``
  over ``load('seg_fpn')`` by iou and by dice: the predictions [64, 64,
  64] int32, each score equal to ``iou_numpy`` / ``dice_numpy`` of the
  saved arrays and the masks, the last epoch's train loss below the
  first's.

Phase of the model zoo's slice, run after the DAGs:

- zoo: the 13 encoder families as classifiers (``num_classes`` 10,
  ``cifar_stem``, 32x32x3), FPN / LinkNet / PSPNet / DeepLabV3 / U-Net
  over ResNet-18, DeepLabV3 over DRN-26 and the standalone U-Net
  (``num_classes`` 2, ``cifar_stem``, 64x64x3), at JAX's default widths
  with random weights from ``--seed``: the parameter count against the
  JAX package's (``ZOO_PARAMS``), an f32 copy on the card against the
  same weights on the CPU (TF32 off; batch 2; eval and train mode: the
  output and the updated running statistics, by the largest error of a
  row over its largest magnitude, a statistics row over at least 1e-3
  of the model's largest statistic), and bf16 AdamW train steps
  (``softmax_ce`` or ``bce_dice``): finite loss and gradients, every
  parameter moved after two steps (a zero-init residual scale leaves its
  branch's zero-init biases without gradient in the first); then the
  step timed at the configs' batches (256 for the classifiers, 32 for
  the segmentation models): ms, images/s, peak allocated memory. These
  models run no kernel of the port's: JAX normalises them with a plain
  ``nn.BatchNorm`` and so does the port.

Phase of the command line's slice, run after the zoo:

- cli: the repository's YAML through ``python -m mlcomp_tpu_torch`` and
  its sqlite DB under the run's fresh root. (a) ``init`` and ``execute
  examples/cifar_simple/config.yml --params model/norm:fused`` as
  processes: the last line ``{"train": "Success"}``, the task's steps
  (levels 1 and 2), Log rows and spans, a finite train and valid loss
  and an ``images_per_sec`` row each of the 2 epochs, the export under
  ``models/cifar_simple/cifar_resnet18`` and ``config.yml`` stored as
  the dag's code; (b) that command and ``execute
  examples/encoder_grid/config.yml`` again through the CLI's ``main`` in
  this process, every kernel's count zeroed just before and read just
  after: 1280 of each norm kernel (32 steps x 2 epochs x 20 sites), all
  six grid tasks ``Success``, the ``vit`` cell's 216 flash forwards and
  192 of each backward kernel, no other cell launching any; (c) every
  task's wall seconds and images/s beside the card's name and power
  limit.

Phase of the scheduler's slice, run after the command line's:

- sched: a DAG submitted with ``dag`` runs to Success with no
  ``execute``. (a) ``init``, then ``python -m mlcomp_tpu_torch.worker
  worker-supervisor`` and ``worker 0`` (a ``run-task`` process per task)
  as child processes, the supervisor loop
  (``register_supervisor(ha=False)``) in this process, and ``dag
  examples/cifar_simple/config.yml --params model/norm:fused`` as a
  process once the host agent heartbeats: the task Success, its queue
  message ``done`` and claimed by ``<host>:0``, its steps, spans and
  series as ``[cli]`` checks them, the computer row's usage and
  heartbeat; the seconds from start to the agent's first heartbeat,
  from the dag row to Queued and from the ``dag`` command's return to
  Queued (the dispatch), Queued to claim and to InProgress, the task's
  wall and its process's. A daemon that dies fails the run. (b) ``dag`` of that
  config and of ``examples/encoder_grid/config.yml`` in this process,
  driven by supervisor ticks and the worker's ``_consume_one(...,
  in_process=True)``, every kernel's count zeroed just before and read
  just after: ``[cli]``'s counts (1280 of each norm kernel, the ``vit``
  cell's 216 / 192 / 192 flash launches, nothing else), all seven tasks
  Success, the card's memory in the computer row's usage.

Phase of the site's slice, run after the scheduler's:

- site: the site started the documented way. (a) ``python -m
  mlcomp_tpu_torch.server start 1`` on a free port (``start-site`` with
  the HA supervisor and the API, ``worker-supervisor``, ``worker 0``),
  ``dag`` of ``cifar_simple`` (``--params model/norm:fused``, its 2
  epochs raised to 6 in a copy) as a process; ``/api/tasks`` polled
  until the first epoch's checkpoint is on disk, ``/api/task/stop``
  (Stopped, the ``run-task`` process gone, before the last epoch),
  ``/api/dag/start`` (reset with ``resume``), the site's supervisor
  re-dispatching and the worker resuming from that checkpoint through
  the epochs left to Success ("resumed from checkpoint" in the log, the
  epoch series after the restart); ``/api/graph``, ``GET /``, ``GET
  /metrics`` (task counts those of the rows, the leader and its epoch),
  ``/api/auxiliary``; no site process mapping the CUDA driver or listed
  by ``nvidia-smi --query-compute-apps``; SIGTERM to the site (lease
  released, the group restarting it, the lease taken at the next epoch)
  and ``server stop`` leaving no process (the training process mapping
  the driver is the check's positive control: ``nvidia-smi`` may list
  no pid inside a container). The times from spawn to
  ``/api/token``, of the dispatch, stop to Stopped, ``/api/dag/start``
  to InProgress, the resumed attempt's wall and the lease handover,
  beside the card's name and power limit. (b) ``start_server(
  background=True)`` in this process with the worker's in-process
  consume: ``cifar_simple`` as written to Success with 1280 launches of
  each norm kernel and the card's memory in ``/api/computers``; marked
  Failed and restarted through ``/api/dag/start``, its resume runs no
  epoch (``samples_per_sec`` 0) and launches nothing.

Phase of the device telemetry's slice, run after the wide step's:

- telemetry: ``encoder_grid``'s ViT (one epoch, ``VIT_SPEC``) and
  ``cifar_simple``'s ResNet-18 (``norm: fused``, 4 epochs of 16 steps)
  as ``train`` tasks with a sqlite session (``dag_standard`` then
  ``execute_by_id``), under ``telemetry: {profile_every: N,
  profile_steps: 3}``, every kernel's count zeroed just before each run
  and read just after (the ``[vit-train]`` and CIFAR counts a step). It
  prints the means and medians of ``step.phase.*_ms``,
  ``step.pipeline_efficiency``, ``mfu`` beside the smoke's analytic
  count, the ViT's first-step FLOPs (the kernel path's, from the mfu row)
  beside the trainer's counter's count of the ``attn_impl: 'dense'``
  step (they agree within 0.1%), the counted steps' host times and
  whether counting imported ``torch._dynamo``, ``device0.hbm_*``,
  ``host_sync.suspect_ms``, the step time after the last window against
  the clean median, and each ``devtime`` window's buckets, busy share
  and host dispatch gap (at least one window per model with compute > 0
  and 0 < busy <= 1; no profiler failure in the log). The CIFAR task
  runs on a thread beside ``start_server(background=True)``:
  ``/api/telemetry/profile`` start (before the run), status until
  ``tracing``, stop, then ``done`` with
  its trace on disk; ``/metrics`` during the run carries
  ``mlcomp_step_phase_ms`` and ``mlcomp_pipeline_efficiency``;
  ``/api/task/devtime`` answers for both tasks. A ViT run killed by an
  injected ``train.epoch`` ``resource`` fault ends Failed / ``oom`` with
  a postmortem holding ``device0.hbm_*``. The host time of the ViT's
  marked steps in a window and of the CIFAR on-demand trace splits into
  aten ops and CUDA calls (launches and waits apart) against the rest
  (``trace_parse.host_time_split``), with the window's start and its
  stop-and-write time. Last, the instrumented ViT step against the bare
  one (windows off), in turns: the overhead fails the run above 5%.

Without CUDA, or in a directory that holds this script and nothing else
of the repository, it exits non-zero and prints no result.
"""

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

#: published peaks of one H100 SXM (dense, no sparsity) at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                  torch.float32: 67e12}
#: a train step's gradients vs the same weights with plain attention:
#: least cosine similarity of any parameter tensor's gradient (bf16
#: activations; the kernels round P and dS to bf16 where the plain
#: attention keeps f32)
MIN_GRAD_COSINE = 0.99
#: batch-vs-fused train step of the CIFAR ResNet-18: least cosine of
#: any parameter's gradient (bf16 activations; the fused variant's
#: backward runs in f32 where cuDNN's rounds differently)
MIN_NORM_GRAD_COSINE = 0.99
#: the residual branches' end scale in the gradient comparison
BRANCH_SCALE = 0.2
CIFAR_STEP_BATCH = 512
CIFAR_STEP_ITERS = 10
#: bytes the norm timing rotates its inputs through, past the 50 MB L2
ROTATE_BYTES = 256 << 20
#: rows of 8192 random tokens in the train phase's npz: 4 train, 1 valid
TRAIN_ROWS = 5
STEP_ITERS = 5
#: kernels of the step printed with their device time, longest first
TOP_KERNELS = 12
#: served LM vs the same weights with plain attention: cosine similarity
#: of the [T, V] logits, and top-1 agreement where a pick counts when its
#: reference logit is within TIE_DELTA (two bf16 ulps at logits of 4-8)
#: of the reference maximum — bf16 logits of random weights tie often
MIN_COSINE = 0.999
MIN_TOP1 = 0.99
TIE_DELTA = 0.0625
#: the int8-served LM against the same weights unquantized: cosine of
#: the [T, V] logits. Per-channel absmax/127 rounding moves each
#: projection's output by ~1% (a rounding error of scale/√12 against
#: columns whose absmax is ~4σ); through 8 layers and the head the
#: logits stay within a few percent, a cosine above 0.999 — 0.99 leaves
#: room for the bf16 activations' own rounding
MIN_INT8_COSINE = 0.99

FLAGSHIP = {'name': 'transformer_lm', 'vocab_size': 32768, 'd_model': 1024,
            'n_layers': 8, 'n_heads': 16, 'd_ff': 4096, 'max_seq_len': 8192,
            'dtype': 'bfloat16'}
SERVE_BATCH = 4
REQUEST_ROWS = (1, 4, 2, 3) * 3


def fail(msg: str):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def say(phase: str, **fields):
    print(f'[{phase}] ' + ' '.join(f'{k}={v}' for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------- phase 1-2
def phase_device():
    smi = nvidia_smi_line()
    nvcc_v = 'not found'
    from mlcomp_tpu_torch.ops import _build
    try:
        out = subprocess.run([_build.nvcc(), '--version'],
                             capture_output=True, text=True, timeout=60)
        nvcc_v = out.stdout.strip().splitlines()[-1]
    except RuntimeError as e:
        fail(str(e))
    say('device', card=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc_v),
        python=sys.version.split()[0])
    return smi


#: the wgmma kernels by their kernels-line entry: (library, kernel); and
#: the HGMMA instructions in their SASS ({'instantiations', 'min_hgmma'}),
#: which phase_build reads with cuobjdump
WGMMA_KERNELS = {
    'flash_attention_fwd': ('flash_attention_fwd', 'fa_fwd_wgmma_kernel'),
    'flash_attention_bwd_dq': ('flash_attention_bwd',
                               'fa_bwd_dq_wgmma_kernel'),
    'flash_attention_bwd_dkv': ('flash_attention_bwd',
                                'fa_bwd_dkv_wgmma_kernel'),
    'int8_matmul': ('int8_matmul', 'int8_wgmma_kernel'),
    'serving_stack': ('serving_stack', 'stack_wgmma_kernel')}
SASS_COUNTS = {}


def sass_hgmma(path: str):
    """{SASS function name: HGMMA instructions} of a built library, from
    the toolkit's cuobjdump (or Triton's copy); None without one."""
    from mlcomp_tpu_torch.ops import _build
    tools = [os.path.join(os.path.dirname(_build.nvcc()), 'cuobjdump')]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__),
                                  'backends', 'nvidia', 'bin', 'cuobjdump'))
    except ImportError:
        pass
    tool = next((x for x in tools if os.path.exists(x)), None)
    if tool is None:
        return None
    out = subprocess.run([tool, '-sass', path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f'cuobjdump -sass {path}: {out.stderr.strip()[:500]}')
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if 'Function :' in line:
            name = line.split('Function :')[-1].strip()
            counts[name] = 0
        elif name is not None and 'HGMMA' in line:
            counts[name] += 1
    return counts


def phase_build():
    from mlcomp_tpu_torch.ops import _build
    t0 = time.monotonic()
    try:
        libs = _build.build()
    except RuntimeError as e:
        fail(str(e))
    seconds = time.monotonic() - t0
    for name, path in libs.items():
        log = _build.BUILD_LOGS.get(name, {}).get('log', '(cached)')
        # the register and spill report, and every wgmma advisory
        # (C7512, C7515, ...)
        lines = [ln.split('ptxas info    : ')[-1] for ln in log.splitlines()
                 if 'registers' in ln or 'spill' in ln
                 or 'entry function' in ln or re.search(r'\(C75\d\d\)', ln)]
        say('build', kernel=name, seconds=f'{seconds:.1f}',
            library=os.path.relpath(path, HERE))
        for ln in lines:
            print(f'    ptxas: {ln}', flush=True)
    # proof that wgmma was emitted: HGMMA in every instantiation's SASS
    sass = {lib: sass_hgmma(libs[lib]) for lib, _ in WGMMA_KERNELS.values()}
    if None in sass.values():
        say('sass', hgmma='not measured (no cuobjdump)')
    for entry, (lib, kernel) in WGMMA_KERNELS.items():
        counts = sass[lib]
        if counts is None:
            continue
        found = [c for f, c in counts.items() if kernel in f]
        say('sass', kernel=kernel, instantiations=len(found),
            hgmma_min=min(found, default=0), hgmma_max=max(found, default=0))
        if not found or min(found) == 0:
            fail(f'{kernel}: no HGMMA in the SASS of some instantiation')
        SASS_COUNTS[entry] = {'instantiations': len(found),
                              'min_hgmma': min(found)}
    return libs


# ---------------------------------------------------------------- phase 3
def attention_bound_ms(b, t, h, d, dtype, causal):
    """Least time for the work: every q·k pair the mask leaves live, two
    multiply-adds per element of D for QKᵀ and PV; each of q, k, v read
    once and out written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 4 * b * h * d * pairs
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * t * h * d * size
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def phase_kernels(seed: int):
    from mlcomp_tpu_torch.ops.flash_attention import (
        flash_attention_forward, reference_attention,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        ATTENTION_ROW_TOL, ATTENTION_SHAPES, VIT_INFER_SHAPE, qkv_views,
        row_relative_error,
    )
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(seed)
    main = None
    # timed: the serving shape (first) and the ViT's inference batch
    times = {}
    for i, (b, t, h, d, dtype, causal) in enumerate(ATTENTION_SHAPES):
        timed = i == 0 or (b, t, h, d, dtype, causal) == VIT_INFER_SHAPE
        q, k, v = qkv_views(b, t, h, d, dtype, gen)
        try:
            out = flash_attention_forward(q, k, v, causal=causal)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'flash_attention_fwd at B={b} T={t} H={h} D={d} '
                 f'{dtype} causal={causal}: {e}')
        ref = reference_attention(q, k, v, causal=causal, round_p=True)
        err = float((out.float() - ref.float()).abs().max())
        row_err = row_relative_error(out, ref)
        tol = ATTENTION_ROW_TOL[dtype]
        ok = bool(torch.isfinite(out).all()) and row_err <= tol
        fields = dict(shape=f'{b}x{t}x{h}x{d}', dtype=str(dtype)[6:],
                      causal=causal, row_err=f'{row_err:.3e}', tol=tol,
                      max_abs_err=f'{err:.3e}')
        if timed:
            bound, bound_by = attention_bound_ms(b, t, h, d, dtype, causal)
            ms = time_ms(lambda: flash_attention_forward(
                q, k, v, causal=causal), iters=20)
            plain_ms = time_ms(lambda: reference_attention(
                q, k, v, causal=causal, round_p=True), iters=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters=20)
            fields.update(ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.3f}',
                          library_ms=f'{library_ms:.4f}',
                          bound_ms=f'{bound:.4f}', bound_by=bound_by,
                          pct_of_peak=f'{100 * bound / ms:.1f}')
            times[(b, t, h, d, dtype, causal)] = {
                'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
                'bound_ms': bound, 'bound_by': bound_by,
                'max_abs_err': err, 'row_err': row_err}
        if i == 0:
            main = {'name': 'flash_attention_fwd', 'route': 'cuda',
                    'source': 'mlcomp_tpu_torch/csrc/flash_attention_fwd.cu',
                    'replaces': 'mlcomp_tpu/ops/flash_attention.py:83',
                    'design': 'wgmma + TMA, three consumer warpgroups '
                              'taking turns',
                    'sass_hgmma': SASS_COUNTS.get('flash_attention_fwd'),
                    'max_abs_err': err, 'row_err': row_err,
                    'ms': ms, 'plain_ms': plain_ms,
                    'bound_ms': bound, 'bound_by': bound_by,
                    'library_ms': library_ms,
                    'shape': [b, t, h, d], 'dtype': str(dtype)[6:],
                    'causal': causal}
        say('kernel', ok=ok, **fields)
        if not ok:
            fail(f'flash_attention_fwd disagrees with reference_attention '
                 f'at {fields}')
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    # the ViT's inference attention (infer_classify of an encoder_grid
    # export at Equation.infer's batch 512)
    b, t, h, d, dtype, causal = VIT_INFER_SHAPE
    main['vit_infer'] = {'shape': [b, t, h, d], 'causal': causal,
                         **times[VIT_INFER_SHAPE]}
    # the training steps' forward: with lse at B=1, the flagship's 16
    # heads and the wide LM's 32
    main['lse_b1'] = {}
    for b, t, h, d, dtype, causal in ((1, 8192, 16, 64, torch.bfloat16, True),
                                      (1, 8192, 32, 64, torch.bfloat16, True)):
        q, k, v = qkv_views(b, t, h, d, dtype, gen)
        bound, _ = attention_bound_ms(b, t, h, d, dtype, causal)
        ms = time_ms(lambda: flash_attention_forward(
            q, k, v, causal=causal, with_lse=True), iters=20)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), iters=20)
        say('kernel-lse', shape=f'{b}x{t}x{h}x{d}', dtype=str(dtype)[6:],
            causal=causal, ms=f'{ms:.4f}', sdpa_ms=f'{library_ms:.4f}',
            bound_ms=f'{bound:.4f}', pct_of_peak=f'{100 * bound / ms:.1f}')
        main['lse_b1'][f'H={h}'] = {'ms': ms, 'library_ms': library_ms,
                                    'bound_ms': bound}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return main


def backward_bound_ms(b, t, h, d, dtype, causal, products, n_in, n_out):
    """Least time for a backward: ``products`` matrix products of 2·D
    operations for every live (query, key) pair; ``n_in`` [B, T, H, D]
    inputs and the f32 row statistics (lse, delta: two [B, H, T]) read
    once, ``n_out`` gradients written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 2 * products * b * h * d * pairs
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n_in + n_out) * b * t * h * d * size + 2 * b * h * t * 4
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def _fields(errors: dict) -> str:
    return ','.join(f'{n}:{e:.3e}' for n, e in errors.items())


def phase_backward_kernels(seed: int):
    """The forward's lse and both backward kernels against their plain
    versions at every backward shape; both training shapes and the
    ViT's timed, and each run twice for bitwise-equal gradients.
    Returns the kernels line's entries for the two backward kernels and
    the times at the ViT's shape."""
    from mlcomp_tpu_torch.ops import flash_attention as fa
    from mlcomp_tpu_torch.testing.kernel_check import (
        AUTOGRAD_HEAD_TOL, BACKWARD_ROW_TOL, BACKWARD_SHAPES, LSE_TOL,
        VIT_SHAPE, backward_check, backward_head_tol, backward_ok,
    )
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(seed)
    for b, t, h, d, dtype, causal in BACKWARD_SHAPES:
        shape = (b, t, h, d, dtype, causal)
        try:
            r = backward_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'flash attention backward at B={b} T={t} H={h} D={d} '
                 f'{dtype} causal={causal}: {e}')
        ok = backward_ok(r, dtype, shape)
        say('kernel-bwd', ok=ok, shape=f'{b}x{t}x{h}x{d}',
            dtype=str(dtype)[6:], causal=causal,
            lse_err=f'{r["lse_err"]:.3e}', lse_tol=LSE_TOL,
            row_err=_fields(r['row_err']), tol=BACKWARD_ROW_TOL[dtype],
            head_err=_fields(r['head_err']),
            head_tol=backward_head_tol(shape),
            autograd_head_err=_fields(r['autograd_head_err']),
            autograd_tol=AUTOGRAD_HEAD_TOL[dtype])
        if not ok:
            fail(f'flash attention backward disagrees with its plain '
                 f'version at {shape}: {r}')
        if shape == BACKWARD_SHAPES[0]:
            main = r
        torch.cuda.empty_cache()

    # both training shapes (the flagship's 16 heads, the wide LM's 32)
    # and the ViT's, timed: forward with lse, each backward kernel, the
    # whole backward, the plain versions, and scaled_dot_product_attention
    # forward and backward as the library yardstick; each also run twice
    # for bitwise-equal gradients
    flagship, wide, vit = (_time_backward(shape, gen, fa, F) for shape in (
        BACKWARD_SHAPES[0], BACKWARD_SHAPES[1], VIT_SHAPE))
    b, t, h, d, dtype, causal = BACKWARD_SHAPES[0]
    entries = []
    for name, products, n_out, grads in (
            ('flash_attention_bwd_dq', 3, 1, ('dq',)),
            ('flash_attention_bwd_dkv', 4, 2, ('dk', 'dv'))):
        ms_key = 'dq_ms' if n_out == 1 else 'dkv_ms'
        kb, kb_by = backward_bound_ms(b, t, h, d, dtype, causal, products,
                                      4, n_out)
        wb, _ = backward_bound_ms(*BACKWARD_SHAPES[1], products, 4, n_out)
        vb, vb_by = backward_bound_ms(*VIT_SHAPE, products, 4, n_out)
        entries.append({
            'name': name, 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/flash_attention_bwd.cu',
            'replaces': 'mlcomp_tpu/ops/flash_attention.py:'
                        + ('309' if n_out == 1 else '336'),
            'redesigned': 'PR 6',
            'max_abs_err': max(main['max_abs_err'][g] for g in grads),
            'row_err': max(main['row_err'][g] for g in grads),
            'ms': flagship[ms_key], 'plain_ms': flagship['plain_bwd_ms'],
            'bound_ms': kb, 'bound_by': kb_by, 'library_ms': None,
            'sdpa_bwd_ms': flagship['sdpa_bwd_ms'],
            'bwd_ms': flagship['bwd_ms'],
            'bitwise_equal_over_two_runs': flagship['bitwise_equal'],
            'sass_hgmma': SASS_COUNTS.get(name),
            'shape': [b, t, h, d], 'dtype': str(dtype)[6:],
            'causal': causal,
            'wide': {'shape': list(BACKWARD_SHAPES[1][:4]),
                     'ms': wide[ms_key], 'bound_ms': wb,
                     'plain_ms': wide['plain_bwd_ms'],
                     'sdpa_bwd_ms': wide['sdpa_bwd_ms'],
                     'bwd_ms': wide['bwd_ms']},
            'vit': {'shape': list(VIT_SHAPE[:4]), 'causal': VIT_SHAPE[5],
                    'ms': vit[ms_key], 'bound_ms': vb, 'bound_by': vb_by,
                    'plain_ms': vit['plain_bwd_ms'],
                    'sdpa_bwd_ms': vit['sdpa_bwd_ms'],
                    'bwd_ms': vit['bwd_ms'],
                    'bitwise_equal_over_two_runs': vit['bitwise_equal']}})
    torch.cuda.empty_cache()
    return entries, vit


def _time_backward(shape, gen, fa, F) -> dict:
    """Times of the forward with lse and the backward at a training
    shape (CUDA events), beside the plain versions and SDPA's, and
    whether two runs of it give bitwise-equal dq, dk and dv."""
    from mlcomp_tpu_torch.testing.kernel_check import qkv_views
    b, t, h, d, dtype, causal = shape
    q, k, v = qkv_views(b, t, h, d, dtype, gen)
    do = torch.randn((b, t, h, d), generator=gen, device='cuda',
                     dtype=torch.float32).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                          with_lse=True)
    delta = fa.attention_delta(out, do)
    first = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    again = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(first, again))
    if not bitwise:
        fail(f'the backward kernels gave different gradients in two runs '
             f'at {shape}')
    del first, again
    fwd_ms = time_ms(lambda: fa.flash_attention_forward(
        q, k, v, causal=causal, with_lse=True), iters=20)
    dq_ms = time_ms(lambda: fa.flash_attention_backward_dq(
        q, k, v, do, lse, delta, causal=causal), iters=20)
    dkv_ms = time_ms(lambda: fa.flash_attention_backward_dkv(
        q, k, v, do, lse, delta, causal=causal), iters=20)
    bwd_ms = time_ms(lambda: fa.flash_attention_backward(
        q, k, v, out, lse, do, causal=causal), iters=20)
    plain_fwd_ms = time_ms(lambda: fa.reference_attention(
        q, k, v, causal=causal, with_lse=True), iters=2)
    torch.cuda.empty_cache()
    plain_bwd_ms = time_ms(lambda: fa.reference_attention_backward(
        q, k, v, out, lse, do, causal=causal), iters=2)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    sdpa_ms = time_ms(sdpa_fwd_bwd, iters=20)
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), iters=20)
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), dot, retain_graph=True), iters=20)
    fwd_bound, _ = attention_bound_ms(b, t, h, d, dtype, causal)
    bound, bound_by = backward_bound_ms(b, t, h, d, dtype, causal, 5, 5, 3)
    say('kernel-bwd', shape=f'{b}x{t}x{h}x{d}', dtype=str(dtype)[6:],
        causal=causal, fwd_lse_ms=f'{fwd_ms:.4f}',
        fwd_bound_ms=f'{fwd_bound:.4f}', bwd_ms=f'{bwd_ms:.4f}',
        dq_ms=f'{dq_ms:.4f}', dkv_ms=f'{dkv_ms:.4f}',
        bwd_bound_ms=f'{bound:.4f}', bwd_bound_by=bound_by,
        fwd_bwd_ms=f'{fwd_ms + bwd_ms:.4f}',
        sdpa_fwd_bwd_ms=f'{sdpa_ms:.4f}', sdpa_fwd_ms=f'{sdpa_fwd_ms:.4f}',
        sdpa_bwd_ms=f'{sdpa_bwd_ms:.4f}', plain_fwd_lse_ms=f'{plain_fwd_ms:.3f}',
        plain_bwd_ms=f'{plain_bwd_ms:.3f}', bitwise_equal=bitwise)
    del q, k, v, do, out, lse, delta, qt, kt, vt, dot, o_lib
    torch.cuda.empty_cache()
    return {'fwd_lse_ms': fwd_ms, 'fwd_bound_ms': fwd_bound,
            'dq_ms': dq_ms, 'dkv_ms': dkv_ms, 'bwd_ms': bwd_ms,
            'plain_fwd_ms': plain_fwd_ms, 'plain_bwd_ms': plain_bwd_ms,
            'sdpa_fwd_ms': sdpa_fwd_ms, 'sdpa_bwd_ms': sdpa_bwd_ms,
            'bitwise_equal': bitwise}


# ---------------------------------------------------------------- phase 4
def flagship_params(seed: int) -> dict:
    """The flagship LM's weights in the JAX parameter layout (stacked
    ``layers``), from a seed: normal(0.02) embeddings, lecun-normal
    projections, unit norm scales — f32, as the JAX trainer keeps them."""
    rng = np.random.default_rng(seed)
    cfg = FLAGSHIP
    v, m, n_l = cfg['vocab_size'], cfg['d_model'], cfg['n_layers']
    h, f, s = cfg['n_heads'], cfg['d_ff'], cfg['max_seq_len']
    d = m // h

    def normal(shape, std):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(std)
        return x

    return {
        'embed': normal((v, m), 0.02),
        'pos_embed': normal((s, m), 0.02),
        'layers': {
            'norm_attn': {'scale': np.ones((n_l, m), np.float32)},
            'attn': {'qkv': {'kernel': normal((n_l, m, 3, h, d), m ** -0.5)},
                     'out': {'kernel': normal((n_l, h, d, m),
                                              (h * d) ** -0.5)}},
            'norm_mlp': {'scale': np.ones((n_l, m), np.float32)},
            'mlp': {'wi_gate': {'kernel': normal((n_l, m, f), m ** -0.5)},
                    'wi_up': {'kernel': normal((n_l, m, f), m ** -0.5)},
                    'wo': {'kernel': normal((n_l, f, m), f ** -0.5)}}},
        'norm_final': {'scale': np.ones((m,), np.float32)},
        'lm_head': {'kernel': normal((m, v), m ** -0.5)},
    }


def _http(port, path, body=None, token=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}',
        data=None if body is None else json.dumps(body).encode(),
        headers={'Authorization': token} if token else {})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def top1_agreement(logits, ref):
    """(raw, tie-aware) share of positions whose argmax over ``logits``
    is the argmax over ``ref`` (see TIE_DELTA)."""
    pick = logits.argmax(dim=-1)
    ref_max, ref_pick = ref.max(dim=-1)
    raw = float((pick == ref_pick).float().mean())
    picked = ref.gather(-1, pick.unsqueeze(-1)).squeeze(-1)
    tie = float((picked >= ref_max - TIE_DELTA).float().mean())
    return raw, tie


def _cosine(a, b) -> float:
    import torch.nn.functional as F
    return float(F.cosine_similarity(a.flatten().float(),
                                     b.flatten().float(), dim=0))


def _grad_cosines(model, dense, loss_of) -> dict:
    """{parameter: cosine of its gradient in ``model`` (the kernels) and
    in ``dense`` (the same weights on the plain version)}."""
    grads = []
    for m in (model, dense):
        loss = loss_of(m)
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
    names = [n for n, _ in model.named_parameters()]
    return {n: _cosine(a, b) for n, a, b in zip(names, *grads)}


def _say_cosines(phase: str, cosines: dict, least: float):
    worst = min(cosines, key=cosines.get)
    say(phase, grad_min_cosine=f'{cosines[worst]:.6f}', worst=worst,
        mean_cosine=f'{sum(cosines.values()) / len(cosines):.6f}',
        tensors=len(cosines), min_cosine=least)
    if not cosines[worst] >= least:
        fail(f'{phase}: gradients disagree with the plain version: '
             f'{worst} cosine {cosines[worst]}')


def _compare_rows(phase: str, kern, ref, served=None, **extra):
    """Rows of ``kern`` (the served path) against ``ref`` (its plain
    version): cosine of all rows, tie-aware top-1 (and of the served
    picks, when given)."""
    finite = bool(torch.isfinite(kern).all() and torch.isfinite(ref).all())
    cos = _cosine(kern, ref)
    raw, tie = top1_agreement(kern, ref)
    fields = dict(finite=finite, cosine=f'{cos:.6f}', top1_raw=f'{raw:.4f}',
                  top1_tie_aware=f'{tie:.4f}')
    served_tie = 1.0
    if served is not None:
        picked = ref.gather(-1, served[..., None]).squeeze(-1)
        served_tie = float((picked >= ref.max(dim=-1).values - TIE_DELTA)
                           .float().mean())
        fields['served_top1_tie_aware'] = f'{served_tie:.4f}'
    say(phase, **fields, max_abs_err=f'{float((kern - ref).abs().max()):.4f}',
        min_cosine=MIN_COSINE, min_top1=MIN_TOP1, **extra)
    if not finite or cos < MIN_COSINE or tie < MIN_TOP1 \
            or served_tie < MIN_TOP1:
        fail(f'{phase}: the served rows disagree with the plain version')


def phase_serving(seed: int):
    from mlcomp_tpu_torch import MODEL_FOLDER, TOKEN
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.ops.flash_attention import flash_attention_forward
    from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
    from mlcomp_tpu_torch.train.export import export_model

    t0 = time.monotonic()
    params = flagship_params(seed)
    export_model(os.path.join(MODEL_FOLDER, 'smoke', 'flagship_lm'), params,
                 FLAGSHIP, meta={'input_shape': [FLAGSHIP['max_seq_len']],
                                 'input_dtype': 'int32'})
    del params
    path = resolve_model('flagship_lm', 'smoke')
    export_s = time.monotonic() - t0
    t0 = time.monotonic()
    server = ModelServer(path, batch_size=SERVE_BATCH, activation='argmax',
                         port=0, device='cuda')
    load_s = time.monotonic() - t0
    t0 = time.monotonic()
    if not server.warmup():
        fail('export carries no input_shape to warm up with')
    warm_s = time.monotonic() - t0
    server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    model = server.primary.predict.model
    say('serve', export_s=f'{export_s:.1f}', load_s=f'{load_s:.1f}',
        warmup_s=f'{warm_s:.2f}', port=server.port,
        params=sum(p.numel() for p in model.parameters()))
    try:
        rng = np.random.default_rng(seed + 1)
        t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
        requests = [rng.integers(0, vocab, (n, t), dtype=np.int32)
                    for n in REQUEST_ROWS]
        latencies, served = [], []
        # the main path: counts zeroed just before, read just after
        flash_attention_forward.launches = 0
        per_dispatch = []
        for x in requests:
            before = flash_attention_forward.launches
            t1 = time.monotonic()
            out = _http(server.port, '/predict', {'x': x.tolist()}, TOKEN)
            latencies.append((time.monotonic() - t1) * 1e3)
            per_dispatch.append(flash_attention_forward.launches - before)
            y = np.asarray(out['y'])
            if y.shape != x.shape or not np.issubdtype(y.dtype, np.integer) \
                    or y.min() < 0 or y.max() >= vocab:
                fail(f'/predict answered shape {y.shape} dtype {y.dtype} '
                     f'for {x.shape} tokens')
            served.append(y)
        launches = flash_attention_forward.launches
        health = _http(server.port, '/health')
        say('serve', requests=len(requests), rows=list(REQUEST_ROWS),
            launches=launches, per_dispatch=per_dispatch,
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            max_ms=f'{max(latencies):.1f}',
            health_p50_ms=health['models']['flagship_lm']['latency_ms'][
                'p50'],
            health=health['status'], platform=health['platform'],
            device=repr(health['device']))
        if health['status'] != 'ok' or health['platform'] != 'gpu' \
                or health['requests'] != len(requests):
            fail(f'/health disagrees: {health}')
        if per_dispatch != [FLAGSHIP['n_layers']] * len(requests):
            fail(f'expected {FLAGSHIP["n_layers"]} flash launches per '
                 f'dispatch, got {per_dispatch}')

        # where a dispatch's time goes: the model's forward at the served
        # batch shape on the card, against the request as the client saw it
        batch = torch.from_numpy(np.concatenate(requests[:2])[:SERVE_BATCH]
                                 ).cuda()
        with torch.inference_mode():
            forward_ms = time_ms(lambda: model(batch).argmax(dim=-1),
                                 iters=3)
        say('serve', forward_ms=f'{forward_ms:.2f}',
            batch=SERVE_BATCH)

        # one row against the same weights with the plain attention
        tokens = torch.from_numpy(requests[0]).cuda()
        dense = create_model(**{**FLAGSHIP, 'attn_impl': 'dense'},
                             device='cuda')
        dense.load_state_dict(model.state_dict())
        with torch.inference_mode():
            kern = model(tokens)[0].float()
            ref = dense(tokens)[0].float()
        del dense
        _compare_rows('compare', kern, ref,
                      torch.from_numpy(served[0][0]).cuda().long())
        return launches
    finally:
        server.shutdown()
        thread.join(timeout=30)


# ---------------------------------------------------------------- phase 5
def _train_logger():
    """The executor's log lines on stdout, marked as this phase's."""
    log = logging.getLogger('chip_smoke.train')
    if not log.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter('[train]   %(message)s'))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        log.propagate = False
    return log


def phase_train(seed: int) -> dict:
    """The training entry point at the flagship width on the card;
    returns the launches of each kernel in its run."""
    import gc
    from mlcomp_tpu_torch.ops import flash_attention as fa
    from mlcomp_tpu_torch.train.export import make_predictor
    from mlcomp_tpu_torch.worker.executors import Executor

    t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_train_')
    cwd = os.getcwd()
    try:
        tokens = np.random.default_rng(seed + 2).integers(
            0, vocab, (TRAIN_ROWS, t), dtype=np.int32)
        data = os.path.join(work, 'tokens.npz')
        np.savez(data, x=tokens, y=tokens)
        ck_dir = os.path.join(work, 'checkpoints')
        config = {'executors': {'train': {
            'type': 'train',
            'model': {**FLAGSHIP, 'attn_impl': 'auto'},
            'dataset': {'name': 'npz', 'path': data},
            'loss': 'lm_ce', 'batch_size': 1,
            'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
                'name': 'adamw', 'lr': 3e-4,
                'schedule': {'name': 'warmup_cosine'}}}],
            'main_metric': 'loss', 'minimize': True,
            'checkpoint_dir': ck_dir, 'model_name': 'flagship_lm_trained',
            'seed': seed, 'device': 'cuda'}}}
        os.chdir(work)          # the export lands in models/ under it
        executor = Executor.from_config('train', config)
        n_train = int(TRAIN_ROWS * 0.8)       # the npz loader's split
        n_valid = TRAIN_ROWS - n_train
        counters = {'flash_attention_fwd': fa.flash_attention_forward,
                    'flash_attention_bwd_dq': fa.flash_attention_backward_dq,
                    'flash_attention_bwd_dkv':
                        fa.flash_attention_backward_dkv}
        # the main path: counts zeroed just before, read just after
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        result = executor(logger=_train_logger())
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        del executor
        gc.collect()
        torch.cuda.empty_cache()
        layers = FLAGSHIP['n_layers']
        want = {'flash_attention_fwd': layers * (n_train + n_valid),
                'flash_attention_bwd_dq': layers * n_train,
                'flash_attention_bwd_dkv': layers * n_train}
        files = sorted(os.listdir(ck_dir))
        export = os.path.join(work, 'models', 'flagship_lm_trained')
        say('train', steps=n_train, valid_rows=n_valid,
            seconds=f'{train_s:.1f}', valid_loss=result['best_score'],
            params=result['n_params'], launches=launches,
            checkpoints=files)
        if launches != want:
            fail(f'expected launches {want} (8 forward per step and per '
                 f'valid batch, 8 of each backward kernel per step), '
                 f'got {launches}')
        if not np.isfinite(result['best_score']):
            fail(f'train loss is not finite: {result}')
        if not {'best.msgpack', 'last.msgpack'} <= set(files) \
                or not os.path.exists(export + '.msgpack'):
            fail(f'checkpoints {files} or the export {export} missing')
        predict = make_predictor(export, batch_size=1, activation='argmax',
                                 device='cuda')
        y = predict(tokens[:1])
        ok = y.shape == (1, t) and 0 <= y.min() and y.max() < vocab
        say('train', export=os.path.basename(export), predictor_device=str(
            next(predict.model.parameters()).device), predict_shape=y.shape,
            ok=ok)
        if not ok:
            fail(f'the trained export predicts {y.shape} {y.dtype}')
        del predict
        return launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 6
def _event_us(event) -> float:
    """An averaged profiler event's own device time, us."""
    us = getattr(event, 'self_device_time_total', None)
    return getattr(event, 'self_cuda_time_total', 0.0) if us is None else us


def _device_times_us(prof, is_part) -> tuple:
    """(all kernels' device time in a profile, us; that of the kernels
    whose name ``is_part`` accepts; the kernels by time, [(us, name),
    ...] longest first)."""
    total = part = 0.0
    by_name = []
    for event in prof.key_averages():
        us = _event_us(event)
        total += us
        if is_part(event.key):
            part += us
        if us > 0:
            by_name.append((us, event.key))
    return total, part, sorted(by_name, reverse=True)


def _is_attention(key: str) -> bool:
    return 'fa_fwd' in key or 'fa_bwd' in key


def profile_step(tag: str, run, step_ms: float, is_part, part: str,
                 **extra) -> tuple:
    """Two train steps (``run``) under the profiler: the longest kernels
    as ``[{tag}-kernel]`` lines, and (fields, the ms a step of the
    kernels ``is_part`` accepts): the device ms a step, the part's ms and
    share (``{part}_ms``, ``{part}_share``) and the busy share against
    ``step_ms``; 'not measured' (and None) where the profiler reads no
    device time."""
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                run()
            torch.cuda.synchronize()
        total_us, part_us, by_name = _device_times_us(prof, is_part)
        if total_us <= 0:
            raise RuntimeError('the profile holds no device time')
    except Exception as e:      # the profiler's view of the card
        return {'device_ms': 'not measured',
                'profiler': repr(str(e)[:80])}, None
    for us, name in by_name[:TOP_KERNELS]:
        say(f'{tag}-kernel', **extra, ms_per_step=f'{us / 2e3:.3f}',
            share=f'{us / total_us:.4f}', name=repr(name[:90]))
    return {'device_ms': f'{total_us / 2e3:.3f}',
            f'{part}_ms': f'{part_us / 2e3:.3f}',
            f'{part}_share': f'{part_us / total_us:.4f}',
            'device_busy': f'{total_us / 2e3 / step_ms:.4f}'}, part_us / 2e3


def phase_step(seed: int):
    """The flagship's train step at B=1, T=8192 as bench_lm measures it,
    and one step's gradients against the plain attention."""
    from mlcomp_tpu_torch.models import create_model, param_count
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
    layers, d = FLAGSHIP['n_layers'], FLAGSHIP['d_model']
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (1, t)).astype(np.int32)).cuda()
    loss_fn = loss_for_task('lm_ce')
    model = create_model(**FLAGSHIP, device='cuda',
                         generator=torch.Generator('cuda').manual_seed(seed))
    n_params = param_count(model)
    # the plain attention keeps [T, T] f32 scores per layer: remat keeps
    # one layer's at a time
    dense = create_model(**{**FLAGSHIP, 'attn_impl': 'dense',
                            'remat': True}, device='cuda')
    dense.load_state_dict(model.state_dict())
    cosines = _grad_cosines(model, dense, lambda m: loss_fn(
        m(tokens, train=True), tokens)[0])
    del dense
    torch.cuda.empty_cache()

    optimizer, _ = make_optimizer({'name': 'adamw', 'lr': 3e-4}, 1000)
    state = create_train_state(model, optimizer, seed=seed)
    step = make_train_step(model, optimizer, loss_fn, self_supervised=True)
    for _ in range(3):                   # warm-up, as bench_lm does
        state, metrics = step(state, tokens, None)
    step_ms = time_ms(lambda: step(state, tokens, None), iters=STEP_ITERS,
                      warmup=0)
    loss = float(step(state, tokens, None)[1]['loss'])
    tok_s = t / (step_ms / 1e3)
    flops_per_token = 6 * n_params + 6 * layers * t * d
    mfu = tok_s * flops_per_token / PEAK_OPS_PER_S[torch.bfloat16]
    fields = dict(params=n_params, step_ms=f'{step_ms:.2f}',
                  tokens_per_s=f'{tok_s:.1f}', mfu=f'{mfu:.4f}',
                  loss=f'{loss:.4f}')
    fields.update(profile_step('step', lambda: step(state, tokens, None),
                               step_ms, _is_attention, 'attention')[0])
    say('step', **fields)
    _say_cosines('step', cosines, MIN_GRAD_COSINE)
    if not np.isfinite(loss):
        fail(f'train step loss is not finite: {loss}')
    del state, model, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7
def norm_bound_ms(r, c, dtype):
    """Least time for the norm: x read once and y written once (gamma,
    beta, mean and var are [C] f32), or ~6 f32 operations per element
    (square-add, sum, subtract, multiply-add, max) over the card's f32
    peak outside the tensor cores, whichever is larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * r * c * size + 4 * c * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 6 * r * c / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def time_rotating_ms(fn, inputs, iters: int) -> float:
    """``time_ms`` of ``fn(*inputs[i % len])``: each launch reads inputs
    the previous ones did not, so they come from device memory and not
    from L2, as a norm site's activation does at batch 512."""
    count = [0]

    def call():
        fn(*inputs[count[0] % len(inputs)])
        count[0] += 1
    return time_ms(call, iters=iters, warmup=len(inputs))


def rotating_copies(r, c) -> int:
    """Copies of a bf16 [R, C] that make ROTATE_BYTES (at least 8)."""
    return max(8, -(-ROTATE_BYTES // (r * c * 2)))


def rotating_norm_inputs(r, c, gen) -> list:
    """bf16 norm inputs at [R, C], ``rotating_copies`` of them."""
    from mlcomp_tpu_torch.testing.kernel_check import norm_inputs
    return [norm_inputs(r, c, torch.bfloat16, gen)
            for _ in range(rotating_copies(r, c))]


def phase_norm_kernel(seed: int) -> dict:
    """The fused norm kernel against its plain version at every norm
    shape; timed at the CIFAR sites. Returns its kernels-line entry."""
    import torch.nn.functional as F
    from mlcomp_tpu_torch.ops.fused_norm import (
        norm_act_forward, reference_norm_act,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        NORM_SHAPES, NORM_STAT_TOL, NORM_Y_TOL, cifar_norm_sites, norm_check,
        norm_inputs, norm_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    main = None
    for shape in NORM_SHAPES:
        r_, c, dtype, act = shape
        try:
            r = norm_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'fused_norm at R={r_} C={c} {dtype} act={act}: {e}')
        ok = norm_ok(r, dtype)
        say('kernel-norm', ok=ok, shape=f'{r_}x{c}', dtype=str(dtype)[6:],
            act=act, mean_err=f'{r["mean_err"]:.3e}',
            var_err=f'{r["var_err"]:.3e}', stat_tol=NORM_STAT_TOL,
            y_err=f'{r["y_err"]:.3e}', tol=NORM_Y_TOL[dtype],
            max_abs_err=f'{r["max_abs_err"]:.3e}')
        if not ok:
            fail(f'fused_norm disagrees with reference_norm_act at {shape}: '
                 f'{r}')
        if main is None:
            main = dict(r, shape=[r_, c], dtype=str(dtype)[6:])
        torch.cuda.empty_cache()
    # two runs at the largest site: bitwise equal (no float atomics)
    r_, c, dtype, act = NORM_SHAPES[0]
    x, g, b = norm_inputs(r_, c, dtype, gen)
    runs = [norm_act_forward(x, g, b, act=act) for _ in range(2)]
    same = all(torch.equal(u, v) for u, v in zip(*runs))
    say('kernel-norm', shape=f'{r_}x{c}', dtype=str(dtype)[6:], act=act,
        bitwise_equal_runs=same)
    if not same:
        fail(f'two fused_norm runs at {r_}x{c} differ')
    del x, g, b, runs

    # timed at each CIFAR site shape of the step (bf16, with the ReLU) by
    # CUDA events over back-to-back calls: host launch gaps included,
    # which hold the small sites (``profile_norm_sites`` reads the
    # kernels' own device time)
    sites = {}
    for r_, c in cifar_norm_sites(CIFAR_STEP_BATCH):
        hw = int(round((r_ / CIFAR_STEP_BATCH) ** 0.5))
        inputs = rotating_norm_inputs(r_, c, gen)
        ms = time_rotating_ms(lambda x, g, b: norm_act_forward(x, g, b),
                              inputs, iters=max(20, 2 * len(inputs)))
        plain_ms = time_rotating_ms(lambda x, g, b: reference_norm_act(
            x, g, b), inputs, iters=max(5, len(inputs)))
        # the library yardstick on the same memory, as NCHW channels_last
        lib_inputs = [(x.view(CIFAR_STEP_BATCH, hw, hw, c).permute(
            0, 3, 1, 2), g, b) for x, g, b in inputs]
        library_ms = time_rotating_ms(lambda x, g, b: F.relu(F.batch_norm(
            x, None, None, g, b, training=True)), lib_inputs,
            iters=max(20, 2 * len(inputs)))
        bound, bound_by = norm_bound_ms(r_, c, torch.bfloat16)
        sites[f'{r_}x{c}'] = dict(ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound,
                                  bound_by=bound_by)
        say('kernel-norm', shape=f'{r_}x{c}', dtype='bfloat16', act=True,
            ms=f'{ms:.4f}', bound_ms=f'{bound:.4f}', bound_by=bound_by,
            plain_ms=f'{plain_ms:.4f}', library_ms=f'{library_ms:.4f}',
            gbytes_per_s=f'{2 * r_ * c * 2 / ms / 1e6:.1f}',
            timing='cuda_events_with_host_gaps')
        del inputs, lib_inputs
        torch.cuda.empty_cache()
    first = sites[f'{main["shape"][0]}x{main["shape"][1]}']
    return {'name': 'fused_norm', 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/fused_norm.cu',
            'replaces': 'mlcomp_tpu/ops/fused_norm.py:83',
            'max_abs_err': main['max_abs_err'], 'y_err': main['y_err'],
            'mean_err': main['mean_err'], 'var_err': main['var_err'],
            **first, 'shape': main['shape'], 'dtype': main['dtype'],
            'timing': 'cuda_events_with_host_gaps', 'sites': sites}


def norm_bwd_bound_ms(r, c, dtype):
    """Least time for the norm's backward: x and dy read once and dx
    written once (gamma, beta, mean, var in, dgamma, dbeta out: [C] f32),
    or ~10 f32 operations per element over the card's f32 peak, whichever
    is larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 3 * r * c * size + 6 * c * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 10 * r * c / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def phase_norm_bwd_kernel(seed: int) -> dict:
    """The norm's backward kernel against its plain version run in f64
    at every norm shape, twice at each CIFAR site for bitwise-equal
    gradients; timed at the CIFAR sites of the step beside its plain
    version and the autograd backward of ``F.relu(F.batch_norm(...,
    training=True))``. Returns its kernels-line entry."""
    import torch.nn.functional as F
    from mlcomp_tpu_torch.ops.fused_norm import (
        norm_act_backward, norm_act_backward_kernel, norm_act_forward,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        NORM_DX_TOL, NORM_EPS, NORM_GRAD_TOL, NORM_SHAPES, cifar_norm_sites,
        norm_bwd_check, norm_bwd_inputs, norm_bwd_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    main = None
    for shape in NORM_SHAPES:
        r_, c, dtype, act = shape
        try:
            r = norm_bwd_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'fused_norm_bwd at R={r_} C={c} {dtype} act={act}: {e}')
        ok = norm_bwd_ok(r, shape)
        say('kernel-norm-bwd', ok=ok, shape=f'{r_}x{c}',
            dtype=str(dtype)[6:], act=act, dx_err=f'{r["dx_err"]:.3e}',
            tol=NORM_DX_TOL[dtype], dgamma_err=f'{r["dgamma_err"]:.3e}',
            dbeta_err=f'{r["dbeta_err"]:.3e}', grad_tol=NORM_GRAD_TOL,
            band=r['band'], flips=r['flips'],
            flips_outside_band=r['flips_outside_band'],
            max_abs_err=f'{r["max_abs_err"]:.3e}')
        if not ok:
            fail(f'fused_norm_bwd disagrees with norm_act_backward in f64 '
                 f'at {shape}: {r}')
        if main is None:
            main = dict(r, shape=[r_, c], dtype=str(dtype)[6:])
        torch.cuda.empty_cache()

    sites = {}
    for r_, c in cifar_norm_sites(CIFAR_STEP_BATCH):
        hw = int(round((r_ / CIFAR_STEP_BATCH) ** 0.5))
        copies = rotating_copies(r_, c)
        inputs = []
        for _ in range(copies):
            x, g, b, dy = norm_bwd_inputs(r_, c, torch.bfloat16, gen)
            _, mean, var = norm_act_forward(x, g, b)
            inputs.append((x, g, b, mean, var, dy))
        runs = [norm_act_backward_kernel(*inputs[0]) for _ in range(2)]
        same = all(torch.equal(u, v) for u, v in zip(*runs))
        del runs
        if not same:
            fail(f'two fused_norm_bwd runs at {r_}x{c} differ')
        ms = time_rotating_ms(norm_act_backward_kernel, inputs,
                              iters=max(20, 2 * len(inputs)))
        plain_ms = time_rotating_ms(
            lambda *a: norm_act_backward(*a, NORM_EPS, True), inputs,
            iters=max(5, len(inputs)))
        # the library yardstick: autograd's backward of batch_norm + relu
        # on the same memory as NCHW channels_last, the graph kept
        graphs = []
        for x, g, b, _, _, dy in inputs:
            leaves = [t.detach().requires_grad_() for t in (x, g, b)]
            y = F.relu(F.batch_norm(
                leaves[0].view(CIFAR_STEP_BATCH, hw, hw, c).permute(
                    0, 3, 1, 2), None, None, leaves[1], leaves[2],
                training=True, eps=NORM_EPS))
            graphs.append((y, leaves, dy.view(CIFAR_STEP_BATCH, hw, hw,
                                              c).permute(0, 3, 1, 2)))
        library_ms = time_rotating_ms(
            lambda y, leaves, dy: torch.autograd.grad(
                y, leaves, dy, retain_graph=True), graphs,
            iters=max(20, 2 * len(inputs)))
        bound, bound_by = norm_bwd_bound_ms(r_, c, torch.bfloat16)
        sites[f'{r_}x{c}'] = dict(ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound,
                                  bound_by=bound_by)
        say('kernel-norm-bwd', shape=f'{r_}x{c}', dtype='bfloat16',
            act=True, bitwise_equal_runs=same, ms=f'{ms:.4f}',
            bound_ms=f'{bound:.4f}', bound_by=bound_by,
            plain_ms=f'{plain_ms:.4f}', library_ms=f'{library_ms:.4f}',
            gbytes_per_s=f'{3 * r_ * c * 2 / ms / 1e6:.1f}',
            timing='cuda_events_with_host_gaps')
        del inputs, graphs
        torch.cuda.empty_cache()
    first = sites[f'{main["shape"][0]}x{main["shape"][1]}']
    return {'name': 'fused_norm_bwd', 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/fused_norm_bwd.cu',
            'replaces': 'mlcomp_tpu/ops/fused_norm.py:211 (_fused_bwd, '
                        'jnp: no TPU kernel)',
            'max_abs_err': main['max_abs_err'], 'dx_err': main['dx_err'],
            'dgamma_err': main['dgamma_err'],
            'dbeta_err': main['dbeta_err'], **first,
            'shape': main['shape'], 'dtype': main['dtype'],
            'timing': 'cuda_events_with_host_gaps', 'sites': sites}


def kernel_ms_per_call(tag: str, run, calls: int,
                       is_kernel=lambda key: True) -> tuple:
    """Device time per call of the kernels ``is_kernel`` accepts, by the
    profiler: ``run`` makes ``calls`` calls, once to warm and once in
    the window. Each kernel's time per record the window kept, times its
    records a call (a window can lose some records of back-to-back
    launches). Returns (ms, or None where not measured; records)."""
    run()
    torch.cuda.synchronize()
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    except Exception as e:      # the profiler's view of the card
        say(tag, profiler=repr(str(e)[:80]))
        return None, 0
    us, records = 0.0, 0
    for event in prof.key_averages():
        if event.count and is_kernel(event.key) and _event_us(event) > 0:
            us += _event_us(event) / event.count * max(
                1, round(event.count / calls))
            records += event.count
    return (us / 1e3 if records else None), records


def profile_norm_sites(seed: int) -> dict:
    """The fused norm kernels' own device time per call (profiler) at
    each CIFAR site shape of the step, forward with and without the ReLU
    and the backward with it, on rotating inputs; {'RxC': {'act': ms,
    'no_act': ms, 'bwd': ms}}."""
    from mlcomp_tpu_torch.ops.fused_norm import (
        norm_act_backward_kernel, norm_act_forward,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        cifar_norm_sites, norm_bwd_inputs,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    out = {}
    for r_, c in cifar_norm_sites(CIFAR_STEP_BATCH):
        copies = rotating_copies(r_, c)
        inputs = [norm_bwd_inputs(r_, c, torch.bfloat16, gen)
                  for _ in range(copies)]
        stats = [norm_act_forward(x, g, b)[1:] for x, g, b, _ in inputs]
        calls = {
            'act': lambda x, g, b, dy, m, v: norm_act_forward(x, g, b),
            'no_act': lambda x, g, b, dy, m, v: norm_act_forward(
                x, g, b, act=False),
            'bwd': lambda x, g, b, dy, m, v: norm_act_backward_kernel(
                x, g, b, m, v, dy)}
        bounds = {'act': norm_bound_ms(r_, c, torch.bfloat16)[0],
                  'bwd': norm_bwd_bound_ms(r_, c, torch.bfloat16)[0]}
        out[f'{r_}x{c}'] = {}
        args = [(*a, *st) for a, st in zip(inputs, stats)]
        for key, call in calls.items():
            ms, captured = kernel_ms_per_call(
                'kernel-norm-device', lambda: [call(*a) for a in args],
                len(args), _is_norm_kernel(True))
            out[f'{r_}x{c}'][key] = ms
            say('kernel-norm-device', shape=f'{r_}x{c}', dtype='bfloat16',
                call=key, calls=len(args), kernels_recorded=captured,
                device_ms='not measured' if ms is None else f'{ms:.4f}',
                bound_ms=f'{bounds.get(key, bounds["act"]):.4f}')
        del inputs, stats, args
        torch.cuda.empty_cache()
    return out


def profile_vit(seed: int, step_ms: float) -> dict:
    """The ViT's device times by the profiler, after every step timing:
    the flash kernels' and SDPA's own time per call at
    ``kernel_check.VIT_SHAPE`` (CUDA events over back-to-back calls of a
    ~40 us kernel time the host's launch gaps too), and two train steps
    (``vit_step``): device ms, the attention's share, the busy share
    against ``step_ms``. {'fwd', 'dq', 'dkv', 'sdpa', 'sdpa_bwd': ms or
    None, 'step': the step's fields}."""
    import torch.nn.functional as F
    from mlcomp_tpu_torch.ops import flash_attention as fa
    from mlcomp_tpu_torch.testing.kernel_check import VIT_SHAPE, qkv_views
    b, t, h, d, dtype, causal = VIT_SHAPE
    gen = torch.Generator(device='cuda').manual_seed(seed)
    q, k, v = qkv_views(b, t, h, d, dtype, gen)
    do = torch.randn((b, t, h, d), generator=gen, device='cuda').to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                          with_lse=True)
    delta = fa.attention_delta(out, do)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    calls = {
        'fwd': lambda: fa.flash_attention_forward(q, k, v, causal=causal),
        'dq': lambda: fa.flash_attention_backward_dq(
            q, k, v, do, lse, delta, causal=causal),
        'dkv': lambda: fa.flash_attention_backward_dkv(
            q, k, v, do, lse, delta, causal=causal),
        'sdpa': lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal),
        'sdpa_bwd': lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), dot, retain_graph=True)}
    n, result = 20, {}
    for key, call in calls.items():
        ms, records = kernel_ms_per_call(
            'vit-kernels-device', lambda: [call() for _ in range(n)], n)
        result[key] = ms
        say('vit-kernels-device', shape=f'{b}x{t}x{h}x{d}', call=key,
            calls=n, kernel_records=records,
            device_ms='not measured' if ms is None else f'{ms:.4f}')
    del q, k, v, do, out, lse, delta, qt, kt, vt, dot, o_lib
    run, _ = vit_step(seed)
    for _ in range(3):
        run()
    result['step'], _ = profile_step('vit-step', run, step_ms, _is_attention,
                                     'attention')
    say('vit-step', profiled=True, **result['step'])
    del run
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 8
def cifar_train_spec() -> dict:
    """``examples/cifar_simple/config.yml``'s train executor, as the
    port runs it: ``type: train`` and the model's ``norm: fused``."""
    return {
        'type': 'train',
        'model': {'name': 'resnet18', 'num_classes': 10,
                  'dtype': 'bfloat16', 'norm': 'fused'},
        'dataset': {'name': 'synthetic_images', 'n_train': 8192,
                    'n_valid': 1024, 'image_size': 32, 'channels': 3,
                    'num_classes': 10},
        'loss': 'softmax_ce', 'batch_size': 256, 'mesh': {'dp': -1},
        'main_metric': 'accuracy', 'model_name': 'cifar_resnet18',
        'device_data': 'auto',
        'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
            'name': 'adamw', 'lr': 0.001,
            'schedule': {'name': 'warmup_cosine'}}}]}


def phase_cifar_train(seed: int) -> dict:
    """ResNet-18 with the fused norm trained through the executor on the
    card, its export served; returns the norm kernels' launches,
    {'fused_norm': n, 'fused_norm_bwd': n}."""
    import gc
    from mlcomp_tpu_torch import TOKEN
    from mlcomp_tpu_torch.ops.fused_norm import (
        norm_act_backward_kernel, norm_act_forward,
    )
    from mlcomp_tpu_torch.server.serve import ModelServer
    from mlcomp_tpu_torch.train.data import create_dataset
    from mlcomp_tpu_torch.train.export import make_predictor
    from mlcomp_tpu_torch.utils.msgpack_io import msgpack_restore
    from mlcomp_tpu_torch.worker.executors import Executor

    work = tempfile.mkdtemp(prefix='mlcomp_smoke_cifar_')
    cwd = os.getcwd()
    spec = cifar_train_spec()
    try:
        ck_dir = os.path.join(work, 'checkpoints')
        config = {'executors': {'train': dict(
            spec, checkpoint_dir=ck_dir, seed=seed, device='cuda')}}
        os.chdir(work)          # the export lands in models/ under it
        executor = Executor.from_config('train', config)
        # the main path: counts zeroed just before, read just after
        norm_act_forward.launches = 0
        norm_act_backward_kernel.launches = 0
        norm_act_backward_kernel.copies = 0
        t0 = time.monotonic()
        result = executor(logger=_train_logger())
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = {'fused_norm': norm_act_forward.launches,
                    'fused_norm_bwd': norm_act_backward_kernel.launches}
        dy_copies = norm_act_backward_kernel.copies
        del executor
        gc.collect()
        torch.cuda.empty_cache()
        steps = spec['dataset']['n_train'] // spec['batch_size']
        files = sorted(os.listdir(ck_dir))
        export = os.path.join(work, 'models', spec['model_name'])
        say('cifar-train', steps=steps, seconds=f'{train_s:.1f}',
            valid_accuracy=result['best_score'], params=result['n_params'],
            samples_per_s=f'{result["samples_per_sec"]:.1f}',
            launches=launches['fused_norm'],
            bwd_launches=launches['fused_norm_bwd'], dy_copies=dy_copies,
            checkpoints=files)
        for name, n in launches.items():
            if n != 20 * steps:
                fail(f'expected {20 * steps} {name} launches (20 norm sites '
                     f'per train step, none in eval), got {n}')
        if dy_copies:
            fail(f'the norm backward copied {dy_copies} dy to make them '
                 f'contiguous')
        if not np.isfinite(result['best_score']):
            fail(f'CIFAR valid accuracy is not finite: {result}')
        if not {'best.msgpack', 'last.msgpack'} <= set(files) \
                or not os.path.exists(export + '.msgpack'):
            fail(f'checkpoints {files} or the export {export} missing')
        with open(os.path.join(ck_dir, 'last.msgpack'), 'rb') as fh:
            if 'batch_stats' not in msgpack_restore(fh.read()):
                fail('the CIFAR checkpoint holds no batch_stats')

        data = create_dataset(**spec['dataset'])
        x, y = data['x_valid'][:64], data['y_valid'][:64]
        predict = make_predictor(export, batch_size=16, activation='argmax',
                                 device='cuda')
        want = predict(x)
        accuracy = float((want == y).mean())
        server = ModelServer(export + '.msgpack', batch_size=16,
                             activation='argmax', port=0, device='cuda')
        if not server.warmup():
            fail('the CIFAR export carries no input_shape to warm up with')
        server.bind()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            got, latencies = [], []
            for start, n in ((0, 1), (1, 16), (17, 7), (24, 40)):
                t1 = time.monotonic()
                out = _http(server.port, '/predict',
                            {'x': x[start:start + n].tolist()}, TOKEN)
                latencies.append((time.monotonic() - t1) * 1e3)
                got.append(np.asarray(out['y']))
            got = np.concatenate(got)
            health = _http(server.port, '/health')
        finally:
            server.shutdown()
            thread.join(timeout=30)
        say('cifar-serve', requests=len(latencies), rows=len(got),
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            served_accuracy=f'{accuracy:.4f}',
            agrees_with_predictor=bool(np.array_equal(got, want)),
            platform=health['platform'], device=repr(health['device']))
        if got.shape != (64,) or not np.array_equal(got, want) \
                or got.min() < 0 or got.max() >= 10:
            fail(f'/predict answered {got} where the predictor gives {want}')
        if health['platform'] != 'gpu':
            fail(f'/health disagrees: {health}')
        del predict, server
        return launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 9
def _open_branches(model):
    """Every residual branch's end scale (zero at init, which would leave
    the branches without a gradient to compare) set to BRANCH_SCALE.
    Random norm scales instead make a per-tensor cosine meaningless: at
    bf16 the gradients of the norms' scales and biases are then sums
    that cancel to a small remainder, which rounding moves by a large
    share even between two runs of one variant."""
    from mlcomp_tpu_torch.models.resnet import BatchNorm, FusedNormAct
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, FusedNormAct)) and m.zero_scale:
                m.scale.fill_(BRANCH_SCALE)


def _is_norm_kernel(fused: bool):
    """The profile's norm kernels, forward and backward: those of
    ``fused_norm.cu`` and ``fused_norm_bwd.cu``, or the library's
    batch-norm kernels."""
    if fused:
        return lambda key: ('fused_norm_fwd_kernel' in key
                            or 'fused_norm_bwd_kernel' in key)
    return lambda key: 'batch_norm' in key or 'bn_' in key


def phase_cifar_step(seed: int) -> dict:
    """ResNet-18's train step at batch 512, ``norm: batch`` against
    ``norm: fused`` from the same weights on the same batch. Returns the
    profiled device ms per step of each variant's norm kernels, forward
    and backward (the fused variant's: 20 launches of each kernel)."""
    from mlcomp_tpu_torch.models import create_model, param_count
    from mlcomp_tpu_torch.train.data import create_dataset
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    gen = torch.Generator('cuda').manual_seed(seed)
    spec = {'name': 'resnet18', 'num_classes': 10, 'dtype': 'bfloat16'}
    fused = create_model(**spec, norm='fused', device='cuda', generator=gen)
    _open_branches(fused)
    plain = create_model(**spec, norm='batch', device='cuda')
    plain.load_state_dict(fused.state_dict())
    n_params = param_count(fused)
    data = create_dataset('synthetic_images', n_train=CIFAR_STEP_BATCH,
                          n_valid=1, seed=seed)
    x = torch.from_numpy(data['x_train']).cuda()
    y = torch.from_numpy(data['y_train']).cuda()
    loss_fn = loss_for_task('softmax_ce')
    cosines = _grad_cosines(fused, plain, lambda m: loss_fn(
        m(x, train=True), y)[0])

    steps, norm_ms = {}, {}
    for name, model in (('batch', plain), ('fused', fused)):
        optimizer, _ = make_optimizer(
            {'name': 'sgd', 'lr': 0.1, 'momentum': 0.9}, 1000)
        state = create_train_state(model, optimizer, seed=seed)
        step = make_train_step(model, optimizer, loss_fn)
        for _ in range(3):
            state, metrics = step(state, x, y)
        steps[name] = (state, step)
    times = {'batch': [], 'fused': []}
    for name in ('batch', 'fused', 'fused', 'batch'):     # in turns
        state, step = steps[name]
        times[name].append(time_ms(lambda: step(state, x, y),
                                   iters=CIFAR_STEP_ITERS, warmup=0))
    for name in ('batch', 'fused'):
        state, step = steps[name]
        loss = float(step(state, x, y)[1]['loss'])
        step_ms = sum(times[name]) / len(times[name])
        fields = dict(norm=name, params=n_params, batch=CIFAR_STEP_BATCH,
                      step_ms=f'{step_ms:.3f}',
                      runs_ms=[f'{t:.3f}' for t in times[name]],
                      images_per_s=f'{CIFAR_STEP_BATCH / step_ms * 1e3:.1f}',
                      loss=f'{loss:.4f}')
        profiled, ms = profile_step(
            'cifar-step', lambda: step(state, x, y), step_ms,
            _is_norm_kernel(name == 'fused'), 'norm_kernel', norm=name)
        if ms is not None:
            norm_ms[name] = ms
        say('cifar-step', **fields, **profiled)
        if not np.isfinite(loss):
            fail(f'CIFAR {name} step loss is not finite: {loss}')
    _say_cosines('cifar-step', cosines, MIN_NORM_GRAD_COSINE)
    del steps, fused, plain, x, y
    torch.cuda.empty_cache()
    return norm_ms


# ------------------------------------------------------------ int8 serving
def int8_bound_ms(m, k, n):
    """Least time for the int8 product: x (bf16), w_qt (int8) and scale
    read once and the f32 out written once, or 2·M·N·K operations at the
    bf16 tensor-core peak, whichever is larger."""
    nbytes = m * k * 2 + n * k + n * 4 + m * n * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def phase_int8_kernel(seed: int) -> dict:
    """The int8 matmul kernel against its plain version (run in f64) at
    every INT8_SHAPES shape; timed at the bench's shape, the served LM's
    and the ViT's MLP projections at its inference batch. Returns its kernels-line entry (the top-level times at the
    LM's d_ff projection, the most launched shape of the main path)."""
    from mlcomp_tpu_torch.ops.int8_matmul import (
        int8_matmul, reference_int8_matmul,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        INT8_EPILOGUE_SHAPES, INT8_ROW_TOL, INT8_SHAPES, INT8_VIT_SHAPES,
        int8_check, int8_epilogue_check, int8_epilogue_ok, int8_inputs,
        int8_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    errors = {}
    for shape in INT8_SHAPES:
        try:
            r = int8_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'int8_matmul at (M, K, N)={shape}: {e}')
        ok = int8_ok(r)
        say('kernel-int8', ok=ok, shape='x'.join(map(str, shape)),
            row_err=f'{r["row_err"]:.3e}', tol=INT8_ROW_TOL,
            max_abs_err=f'{r["max_abs_err"]:.3e}', canary=r['canary'])
        if not ok:
            fail(f'int8_matmul disagrees with its plain version at {shape}: '
                 f'{r}')
        errors[shape] = r
        torch.cuda.empty_cache()
    # the fused Int8Dense epilogue, bit for bit
    for shape in INT8_EPILOGUE_SHAPES:
        try:
            r = int8_epilogue_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'int8_matmul epilogue at (M, K, N)={shape}: {e}')
        ok = int8_epilogue_ok(r)
        say('kernel-int8-epilogue', ok=ok, shape='x'.join(map(str, shape)),
            differing_elements=r)
        if not ok:
            fail(f'the fused int8 epilogue differs from the unfused formula '
                 f'at {shape}: {r}')
        torch.cuda.empty_cache()

    timed = {}
    for shape in INT8_SHAPES[:4] + INT8_VIT_SHAPES:
        m, k, n = shape
        # the bench's 67 MB weight is read from device memory: turns over
        # copies that together exceed the 50 MB L2
        copies = 3 if m <= 64 else 1
        inputs = [int8_inputs(m, k, n, gen) for _ in range(copies)]
        w_bf16 = [w.to(torch.bfloat16) for _, w, _ in inputs]
        iters = 50 if m <= 64 else 10
        ms = time_rotating_ms(lambda x, w, s: int8_matmul(x, w, s),
                              inputs, iters=iters)
        plain_ms = time_rotating_ms(reference_int8_matmul, inputs,
                                    iters=max(3, copies))
        library_convert_ms = time_rotating_ms(lambda x, w, s: torch.matmul(
            x, w.to(torch.bfloat16).t()) * s, inputs, iters=iters)
        bf_inputs = [(x, wb, s) for (x, _, s), wb in zip(inputs, w_bf16)]
        library_ms = time_rotating_ms(lambda x, w, s: torch.matmul(
            x, w.t()) * s, bf_inputs, iters=iters)
        bound, bound_by = int8_bound_ms(m, k, n)
        timed[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            library_convert_ms=library_convert_ms,
                            bound_ms=bound, bound_by=bound_by)
        say('kernel-int8', shape='x'.join(map(str, shape)), ms=f'{ms:.4f}',
            bound_ms=f'{bound:.4f}', bound_by=bound_by,
            plain_ms=f'{plain_ms:.3f}', library_ms=f'{library_ms:.4f}',
            library_convert_ms=f'{library_convert_ms:.4f}',
            tflops=f'{2 * m * n * k / ms / 1e9:.1f}',
            weight_gbytes_per_s=f'{n * k / ms / 1e6:.1f}')
        del inputs, w_bf16, bf_inputs
        torch.cuda.empty_cache()
    main = INT8_SHAPES[1]
    return {'name': 'int8_matmul', 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/int8_matmul.cu',
            'replaces': 'mlcomp_tpu/ops/int8_matmul.py:87',
            'design': 'wgmma + TMA, the int8 weight as the register A '
                      'operand (swap AB), a producer thread, two consumer '
                      'warpgroups, fused Int8Dense epilogue',
            'sass_hgmma': SASS_COUNTS.get('int8_matmul'),
            'max_abs_err': errors[main]['max_abs_err'],
            'row_err': errors[main]['row_err'], **timed[main],
            'shape': list(main), 'library': 'torch.matmul(x, w_bf16.t()) '
                                              '* scale, bf16 weight made '
                                              'beforehand',
            'shapes': {'x'.join(map(str, s)): t for s, t in timed.items()},
            'row_errs': {'x'.join(map(str, s)): r['row_err']
                         for s, r in errors.items()}}


def stack_bound_ms(layers, m, k, wbytes):
    """Least time for the stack: every layer's weight read once, x read
    and the f32 out written once (the activations between layers need not
    leave the chip), or the products at the bf16 peak."""
    nbytes = layers * k * k * wbytes + m * k * 2 + m * k * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * layers * m * k * k / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def bf16_chain(x, ws):
    """The bench's ``bf16`` variant: one bf16 product per layer and the
    feed between them (``ws`` [L, K, N] bf16)."""
    from mlcomp_tpu_torch.ops.serving_stack import stack_feed
    y = None
    for i in range(ws.shape[0]):
        if i:
            x = stack_feed(y)
        y = torch.matmul(x, ws[i])
    return y


def phase_stack_kernel(seed: int) -> dict:
    """The serving-stack kernel against ``reference_stack`` at every
    STACK_SHAPES shape; timed at the bench's 8 × 8192² at M = 64, int8
    and bf16. Returns its kernels-line entry."""
    from mlcomp_tpu_torch.ops.serving_stack import (
        reference_stack, serving_stack, stack_grid,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        STACK_ROW_TOL, STACK_SHAPES, stack_check, stack_inputs, stack_ok,
        stack_tol,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    errors = {}
    for shape in STACK_SHAPES:
        layers, m, k, wdtype, feed = shape
        try:
            r = stack_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'serving_stack at {shape}: {e}')
        ok = stack_ok(r, layers)
        say('kernel-stack', ok=ok, layers=layers, shape=f'{m}x{k}',
            w=str(wdtype)[6:], feed=feed, row_err=f'{r["row_err"]:.3e}',
            tol=stack_tol(layers), step_err=f'{r["step_err"]:.3e}',
            step_tol=STACK_ROW_TOL['step'],
            max_abs_err=f'{r["max_abs_err"]:.3e}')
        if not ok:
            fail(f'serving_stack disagrees with reference_stack at {shape}: '
                 f'{r}')
        errors[shape] = r
        torch.cuda.empty_cache()

    timed = {}
    for shape in STACK_SHAPES[:2]:
        layers, m, k, wdtype, feed = shape
        x, w, scales = stack_inputs(layers, m, k, wdtype, gen)
        # deterministic: two runs bitwise equal (no float atomics)
        runs = [serving_stack(x, w, scales, feed=feed, block_n=1024,
                              block_k=2048) for _ in range(2)]
        bitwise = bool(torch.equal(runs[0], runs[1]))
        grid = stack_grid(k, wdtype)
        say('kernel-stack', layers=layers, shape=f'{m}x{k}',
            w=str(wdtype)[6:], bitwise_equal_runs=bitwise, grid=grid,
            clusters=grid // 8)
        if not bitwise:
            fail(f'serving_stack is not deterministic at {shape}')
        del runs
        ms = time_ms(lambda: serving_stack(x, w, scales, feed=feed,
                                           block_n=1024, block_k=2048),
                     iters=50)
        plain_ms = time_ms(lambda: reference_stack(x, w, scales, feed=feed),
                           iters=5)
        # the bench's bf16 chain on the same weights (as bf16 [K, N])
        w_kn = torch.stack([(wl.float() * (1 if scales is None else
                                           scales[i][:, None])).t()
                            .to(torch.bfloat16).contiguous()
                            for i, wl in enumerate(w)])
        chain_ms = time_ms(lambda: bf16_chain(x, w_kn), iters=50)
        bound, bound_by = stack_bound_ms(layers, m, k, w.element_size())
        name = f'{str(wdtype)[6:]}'
        # no one library call computes the stack: library_ms is null and
        # the bench's bf16 chain is the yardstick
        timed[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                           bf16_chain_ms=chain_ms, bound_ms=bound,
                           bound_by=bound_by, grid=grid)
        wbytes = layers * k * k * w.element_size()
        say('kernel-stack', layers=layers, shape=f'{m}x{k}', w=name,
            ms=f'{ms:.4f}', bound_ms=f'{bound:.4f}', bound_by=bound_by,
            plain_ms=f'{plain_ms:.3f}', bf16_chain_ms=f'{chain_ms:.4f}',
            weight_gbytes_per_s=f'{wbytes / ms / 1e6:.1f}')
        del x, w, scales, w_kn
        torch.cuda.empty_cache()
    main = STACK_SHAPES[0]
    return {'name': 'serving_stack', 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/serving_stack.cu',
            'replaces': 'mlcomp_tpu/ops/serving_stack.py:67',
            'design': 'one cooperative launch of 8-CTA clusters splitting '
                      'K, x slices resident, the wgmma tile with TMA-'
                      'streamed weights, partial sums reduced through '
                      'distributed shared memory by reducer warps',
            'sass_hgmma': SASS_COUNTS.get('serving_stack'),
            'max_abs_err': errors[main]['max_abs_err'],
            'row_err': errors[main]['row_err'],
            'step_err': errors[main]['step_err'], **timed['int8'],
            'shape': list(main[:3]), 'dtype': 'int8',
            'bf16_weights': timed['bfloat16'],
            'row_errs': {f'{s[0]}x{s[1]}x{s[2]}-{str(s[3])[6:]}-'
                         f'feed{int(s[4])}': r['row_err']
                         for s, r in errors.items()}}


def _model_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def _serve_rows(server, requests, counter) -> tuple:
    """The requests over HTTP: (latencies ms, answers, launches of
    ``counter`` per dispatch)."""
    from mlcomp_tpu_torch import TOKEN
    latencies, served, per_dispatch = [], [], []
    vocab = FLAGSHIP['vocab_size']
    for x in requests:
        before = counter.launches
        t1 = time.monotonic()
        out = _http(server.port, '/predict', {'x': x.tolist()}, TOKEN)
        latencies.append((time.monotonic() - t1) * 1e3)
        per_dispatch.append(counter.launches - before)
        y = np.asarray(out['y'])
        if y.shape != x.shape or not np.issubdtype(y.dtype, np.integer) \
                or y.min() < 0 or y.max() >= vocab:
            fail(f'/predict answered shape {y.shape} dtype {y.dtype} '
                 f'for {x.shape} tokens')
        served.append(y)
    return latencies, served, per_dispatch


def _kernels_under(event) -> list:
    """[(kernel name, device us)] of a profiler event and its CPU
    descendants."""
    out = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _kernels_under(child)
    return out


def _is_int8_kernel(name: str) -> bool:
    return 'int8' in name or 'splitk_reduce' in name


#: the profiler label around each Int8Dense.forward (no 'int8' in it: its
#: device-side span must not read as a kernel)
SPLIT_LABEL = 'Int8Dense.forward'


def int8_dispatch_split(predict, batch) -> dict:
    """Where one served dispatch of the per-layer int8 export goes:
    ``predict(batch)`` (batch 4) under ``torch.profiler``. Device time by
    kernel name, from the kernel events themselves (``key_averages``
    would count an op's kernels under the op's key too): the int8 kernel
    (names with int8 or split-K), the attention forward (``fa_fwd``),
    the rest; the int8 kernel by M x K x N, its launches taken in order
    against the order of the ``Int8Dense`` calls; the passes
    ``Int8Dense.forward`` adds around the kernel (bias add, cast: the
    PyTorch ops under a ``record_function`` around each call). The
    device's busy share is the kernel time over the dispatch's time
    without the profiler (host clock after a synchronise, best of 3).
    Prints facts; decides nothing."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from mlcomp_tpu_torch.ops.int8_matmul import Int8Dense

    forward = Int8Dense.forward
    shapes = []

    def labelled(self, x):
        shapes.append(f'{x.numel() // x.shape[-1]}x{x.shape[-1]}x'
                      f'{self.w_qt.shape[0]}')
        with record_function(SPLIT_LABEL):
            return forward(self, x)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    fields = {'batch': len(batch), 'wall_ms': min(walls)}
    Int8Dense.forward = labelled
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            predict(batch)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType
        # the kernels themselves (not the label's device-side span, a
        # user annotation; not the ops' keys, which carry their kernels'
        # time too), by name
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False)]
        per_name = {}
        for e in kernels:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        by_name = sorted(((us, k, n) for k, (us, n) in per_name.items()),
                         reverse=True)
        total_us = sum(us for us, _, _ in by_name)
        if total_us <= 0:
            raise RuntimeError('the profile holds no device time')
        int8_us = sum(us for us, k, _ in by_name if _is_int8_kernel(k))
        attention_us = sum(us for us, k, _ in by_name if 'fa_fwd' in k)
        launches = sum(n for _, k, n in by_name if _is_int8_kernel(k))
        passes_us = sum(us for e in prof.events()
                        if e.device_type == DeviceType.CPU
                        and e.name == SPLIT_LABEL
                        for name, us in _kernels_under(e)
                        if not _is_int8_kernel(name))
        # the int8 launches in the order they ran, against the calls'
        int8_events = sorted((e for e in kernels if _is_int8_kernel(e.name)),
                             key=lambda e: e.time_range.start)
        by_shape = {}
        if len(int8_events) == len(shapes):
            for shape, e in zip(shapes, int8_events):
                entry = by_shape.setdefault(shape, [0, 0.0])
                entry[0] += 1
                entry[1] += e.time_range.elapsed_us() / 1e3
        fields.update(
            device_ms=total_us / 1e3, busy=total_us / 1e3 / min(walls),
            int8_kernel_ms=int8_us / 1e3, int8_launches=launches,
            int8dense_calls=len(shapes),
            int8dense_passes_ms=passes_us / 1e3,
            attention_ms=attention_us / 1e3,
            rest_ms=(total_us - int8_us - passes_us - attention_us) / 1e3,
            int8_by_shape={s: [n, round(ms, 4)]
                           for s, (n, ms) in sorted(by_shape.items())}
            if by_shape else f'not attributed ({len(int8_events)} '
                             f'events, {len(shapes)} calls)')
        for us, name, count in by_name[:8]:
            say('serve-int8-split-kernel', ms=f'{us / 1e3:.3f}',
                launches=count, name=repr(name[:90]))
    except Exception as e:      # a profiler that reads no device time
        fields.update(device_ms='not measured', profiler=repr(str(e)[:80]))
    finally:
        Int8Dense.forward = forward
    say('serve-int8-split', **{k: (f'{v:.4f}' if isinstance(v, float)
                                   else v) for k, v in fields.items()})
    return fields


def phase_serve_int8(seed: int) -> dict:
    """The flagship served with ``quantize='int8'`` over HTTP, from a
    per-layer export (every MLP projection and the head quantized: 25
    int8 launches a dispatch) and from the stacked export of the serving
    phase (the head alone: 1); one row's logits held against the same
    int8 weights through the plain product, and against the unquantized
    model. Returns the int8 kernel's launches by path."""
    import gc
    from mlcomp_tpu_torch import MODEL_FOLDER
    from mlcomp_tpu_torch.ops.int8_matmul import Int8Dense, int8_matmul
    from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
    from mlcomp_tpu_torch.train.export import export_model, make_predictor
    from mlcomp_tpu_torch.train.layer_stack import unstack_layer_tree

    layers = FLAGSHIP['n_layers']
    spec = {**FLAGSHIP, 'scan_layers': False}
    export_model(os.path.join(MODEL_FOLDER, 'smoke', 'flagship_lm_layers'),
                 unstack_layer_tree(flagship_params(seed)), spec,
                 meta={'input_shape': [FLAGSHIP['max_seq_len']],
                       'input_dtype': 'int32'})
    rng = np.random.default_rng(seed + 1)
    t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
    requests = [rng.integers(0, vocab, (n, t), dtype=np.int32)
                for n in REQUEST_ROWS]
    launches = {}
    for name, want in (('flagship_lm_layers', 3 * layers + 1),
                       ('flagship_lm', 1)):
        path = resolve_model(name, 'smoke')
        # the earlier servers' garbage freed first, or the build's delta
        # reads low
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        server = ModelServer(path, batch_size=SERVE_BATCH,
                             activation='argmax', port=0, quantize='int8',
                             device='cuda')
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        int8_bytes = torch.cuda.memory_allocated() - base
        predict = server.primary.predict
        model = predict.model
        if not server.warmup():
            fail('export carries no input_shape to warm up with')
        server.bind()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            # the main path: counts zeroed just before, read just after
            int8_matmul.launches = 0
            latencies, served, per_dispatch = _serve_rows(
                server, requests, int8_matmul)
            launches[name] = int8_matmul.launches
            health = _http(server.port, '/health')
        finally:
            server.shutdown()
            thread.join(timeout=30)
        say('serve-int8', export=name, quantized=predict.quantized,
            load_s=f'{load_s:.1f}', requests=len(requests),
            launches=launches[name], per_dispatch=per_dispatch,
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            max_ms=f'{max(latencies):.1f}', platform=health['platform'],
            int8_model_bytes=_model_bytes(model),
            int8_allocated_bytes=int8_bytes)
        if predict.quantized != want or per_dispatch != [want] * len(
                requests):
            fail(f'{name}: expected {want} int8 modules and as many '
                 f'launches a dispatch, got {predict.quantized} and '
                 f'{per_dispatch}')
        if health['platform'] != 'gpu':
            fail(f'/health disagrees: {health}')
        if name != 'flagship_lm_layers':
            del server, predict, model
            continue
        split = int8_dispatch_split(predict, requests[1])

        # one row: the kernel against the plain product on the same int8
        # weights, and against the unquantized model
        tokens = torch.from_numpy(requests[0]).cuda()
        int8_modules = [m for m in model.modules()
                        if isinstance(m, Int8Dense)]
        with torch.inference_mode():
            kern = model(tokens)[0].float()
            for m in int8_modules:
                m.impl = 'dense'
            dense = model(tokens)[0].float()
            for m in int8_modules:
                m.impl = 'auto'
        del server, predict, model
        gc.collect()
        base = torch.cuda.memory_allocated()
        full = make_predictor(path, batch_size=SERVE_BATCH,
                              activation='argmax', device='cuda')
        torch.cuda.synchronize()
        full_bytes = torch.cuda.memory_allocated() - base
        with torch.inference_mode():
            ref = full.model(tokens)[0].float()
        full_model_bytes = _model_bytes(full.model)
        del full
        torch.cuda.empty_cache()
        cos_full = _cosine(kern, ref)
        raw_full, tie_full = top1_agreement(kern, ref)
        # the kernel against the plain int8 product
        _compare_rows('compare-int8', kern, dense,
                      torch.from_numpy(served[0][0]).cuda().long(),
                      cosine_vs_unquantized=f'{cos_full:.6f}',
                      top1_raw_vs_unquantized=f'{raw_full:.4f}',
                      top1_tie_aware_vs_unquantized=f'{tie_full:.4f}',
                      min_cosine_vs_unquantized=MIN_INT8_COSINE,
                      full_model_bytes=full_model_bytes,
                      full_allocated_bytes=full_bytes)
        if cos_full < MIN_INT8_COSINE:
            fail(f'the int8-served LM is too far from the unquantized one: '
                 f'cosine {cos_full}')
        del kern, dense, ref, tokens
        torch.cuda.empty_cache()
    return launches, split


def phase_serving_int8(seed: int) -> dict:
    """``bench.py``'s ``serving_int8`` leg on the port: an 8-layer
    K = N = 8192 stack at M = 64 tokens, 7 interleaved trials of 100
    stacks a variant through ``make_chain_runner`` with a recorder.
    Returns the launches of the int8 kernels in it and its numbers."""
    from mlcomp_tpu_torch.ops.int8_matmul import (
        int8_matmul, quantize_int8, reference_int8_matmul,
    )
    from mlcomp_tpu_torch.ops.serving_stack import (
        make_chain_runner, serving_stack, stack_feed,
    )
    from mlcomp_tpu_torch.telemetry import MetricRecorder

    m, kn, layers, reps, trials = 64, 8192, 8, 100, 7
    gen = torch.Generator(device='cuda').manual_seed(seed)
    w_bf, packs = [], []
    for _ in range(layers):
        w = torch.randn((kn, kn), generator=gen, device='cuda') * 0.02
        packs.append(quantize_int8(w))
        w_bf.append(w.to(torch.bfloat16))
        del w
    x0 = torch.randn((m, kn), generator=gen, device='cuda').to(
        torch.bfloat16)
    tel = MetricRecorder(component='serving')

    def per_layer(body, args, name):
        def step(x, *a):
            for i in range(layers):
                x = stack_feed(body(x, i, *a))
            return x
        return make_chain_runner(step, args, x0, reps, recorder=tel,
                                 metric=f'serving.{name}_ms')

    flat = [t for pack in packs for t in pack]
    wq = torch.stack([p[0] for p in packs])
    sc = torch.stack([p[1] for p in packs])
    w_t = torch.stack([w.t() for w in w_bf]).contiguous()
    variants = {
        'bf16': per_layer(lambda x, i, *ws: torch.matmul(x, ws[i]), w_bf,
                          'bf16'),
        'int8_dense': per_layer(lambda x, i, *fl: reference_int8_matmul(
            x, fl[2 * i], fl[2 * i + 1]), flat, 'int8_dense'),
        'int8_matmul': per_layer(lambda x, i, *fl: int8_matmul(
            x, fl[2 * i], fl[2 * i + 1]), flat, 'int8_matmul'),
        'int8_stack': make_chain_runner(
            lambda x, wq, sc: stack_feed(serving_stack(
                x, wq, sc, block_n=1024, block_k=2048)),
            [wq, sc], x0, reps, recorder=tel,
            metric='serving.int8_stack_ms'),
        'bf16_stack': make_chain_runner(
            lambda x, w: stack_feed(serving_stack(
                x, w, block_n=1024, block_k=2048)),
            [w_t], x0, reps, recorder=tel, metric='serving.bf16_stack_ms'),
    }
    # the main path of the stack kernel (and of the per-layer int8
    # kernel's chain): counts zeroed just before, read just after
    serving_stack.launches = 0
    int8_matmul.launches = 0
    results = {name: fn() for name, fn in variants.items()}   # warm
    times = {name: [] for name in variants}
    for _ in range(trials):
        for name, fn in variants.items():
            t0 = time.perf_counter()
            results[name] = fn()
            times[name].append(time.perf_counter() - t0)
    launches = {'serving_stack': serving_stack.launches,
                'int8_matmul': int8_matmul.launches}
    if not all(np.isfinite(v) for v in results.values()):
        fail(f'serving_int8 chains are not finite: {results}')
    want = {'serving_stack': 2 * reps * (trials + 1),
            'int8_matmul': layers * reps * (trials + 1)}
    if launches != want:
        fail(f'serving_int8 launches {launches}, expected {want}')

    def ms(name):
        return min(times[name]) / reps * 1e3

    ratios = sorted(b / q for b, q in zip(times['bf16'],
                                          times['int8_stack']))
    hist = {name.split('.')[1][:-3]: s
            for name, s in tel.histogram_summaries().items()}
    out = {
        'serving_int8_speedup': ms('bf16') / ms('int8_stack'),
        'serving_int8_speedup_paired_range': [ratios[0], ratios[-1]],
        'serving_int8_ms': ms('int8_stack'),
        'serving_bf16_ms': ms('bf16'),
        'serving_int8_dense_ms': ms('int8_dense'),
        'serving_int8_matmul_ms': ms('int8_matmul'),
        'serving_stack_bf16_ms': ms('bf16_stack'),
        # the bf16 weights' bytes over the int8 weights' and scales'
        'serving_int8_weight_memory_ratio':
            sum(w.numel() * w.element_size() for w in w_bf)
            / (wq.numel() * wq.element_size()
               + sc.numel() * sc.element_size()),
    }
    say('serving-int8', **{k: (f'{v:.4f}' if isinstance(v, float) else
                               [f'{r:.3f}' for r in v] if isinstance(v, list)
                               else v) for k, v in out.items()},
        launches=launches, trials=trials, reps=reps)
    for name, s in hist.items():
        say('serving-int8-hist', variant=name, count=int(s['count']),
            p50_ms=f'{s["p50"]:.4f}', p99_ms=f'{s["p99"]:.4f}',
            min_ms=f'{s["min"]:.4f}', max_ms=f'{s["max"]:.4f}')
    out['latency_hist'] = hist
    del w_bf, packs, flat, wq, sc, w_t, x0, variants
    torch.cuda.empty_cache()
    return {'launches': launches, 'numbers': out}


# ----------------------------------------------------------- cross-entropy
#: the step's CE operands, timed: B(T-1) = 8191 rows at B = 1, T = 8192,
#: the wide LM's vocabulary, bf16, with the loss's z-loss and smoothing
CE_TIMED = [(8191, 32768, torch.bfloat16, 1e-4, 0.1),
            (8192, 32768, torch.bfloat16, 1e-4, 0.1)]


def ce_bound_ms(n, v, dtype, backward: bool):
    """Least time for a CE kernel: forward, x read once, labels read and
    loss and lse written; backward, x, labels, lse and g read and dx
    written — or its f32 operations (forward ~5 an element: max, the
    exponent's FFMA and ex2, the add, the smoothing sum; backward ~6) at
    the card's f32 peak outside the tensor cores, whichever is larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    if backward:
        nbytes, ops = 2 * n * v * size + 3 * n * 4, 6 * n * v
    else:
        nbytes, ops = n * v * size + 3 * n * 4, 5 * n * v
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def library_ce(x, labels, z, eps):
    """One PyTorch call per term as the yardstick: ``F.cross_entropy``
    with ``label_smoothing`` (the same function: lse − (1−ε)·x[y] −
    (ε/V)·Σx), plus ``z · logsumexp²`` where z ≠ 0."""
    import torch.nn.functional as F
    loss = F.cross_entropy(x, labels, reduction='none', label_smoothing=eps)
    if z:
        loss = loss + z * torch.logsumexp(x.float(), dim=-1).square()
    return loss


def phase_ce_kernels(seed: int) -> list:
    """The CE forward and backward kernels against their plain versions
    (run in f64) at every CE_SHAPES shape, then timed at the step's and
    bench_fused_ce's shapes. Returns their kernels-line entries."""
    from mlcomp_tpu_torch.ops.fused_ce import (
        ce_backward, ce_forward, reference_ce_bwd, reference_ce_fwd,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        CE_LOSS_TOL, CE_ROW_TOL, CE_SHAPES, ce_check, ce_inputs, ce_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    errors = {}
    for shape in CE_SHAPES:
        n, v, dtype, z, eps, pad = shape
        try:
            r = ce_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'fused_ce at N={n} V={v} {dtype}: {e}')
        ok = ce_ok(r, dtype)
        say('ce-kernels', ok=ok, shape=f'{n}x{v}', dtype=str(dtype)[6:],
            z=z, eps=eps, pad=pad, loss_err=f'{r["loss_err"]:.3e}',
            lse_err=f'{r["lse_err"]:.3e}', tol=CE_LOSS_TOL,
            dx_row_err=f'{r["dx_row_err"]:.3e}', dx_tol=CE_ROW_TOL[dtype],
            canary=r['canary'], finite=r['finite'])
        if not ok:
            fail(f'fused_ce disagrees with its plain version at {shape}: '
                 f'{r}')
        errors[shape] = r
        torch.cuda.empty_cache()

    timed = {}
    for n, v, dtype, z, eps in CE_TIMED:
        # two copies of 537 MB, ten times the L2: every call reads x from
        # device memory, as the step's loss does
        inputs = []
        for _ in range(2):
            x, labels, g = ce_inputs(n, v, dtype, gen)
            labels = labels.clamp(0, v - 1)
            _, lse = ce_forward(x, labels, z, eps)
            inputs.append((x, labels, g, lse))
        fwd_ms = time_rotating_ms(
            lambda x, y, g, lse: ce_forward(x, y, z, eps), inputs, iters=20)
        bwd_ms = time_rotating_ms(
            lambda x, y, g, lse: ce_backward(x, y, lse, g, z, eps), inputs,
            iters=20)
        plain_fwd = time_rotating_ms(
            lambda x, y, g, lse: reference_ce_fwd(x, y, z, eps), inputs,
            iters=4)
        plain_bwd = time_rotating_ms(
            lambda x, y, g, lse: reference_ce_bwd(x, y, lse, g, z, eps),
            inputs, iters=4)
        lib_fwd = time_rotating_ms(
            lambda x, y, g, lse: library_ce(x, y.long(), z, eps), inputs,
            iters=10)
        graphs = []
        for x, y, g, lse in inputs:
            leaf = x.detach().requires_grad_()
            graphs.append((leaf, library_ce(leaf, y.long(), z, eps), g))
        lib_bwd = time_rotating_ms(
            lambda leaf, out, g: torch.autograd.grad(
                out, leaf, g.to(out.dtype), retain_graph=True),
            graphs, iters=10)
        bounds = {k: ce_bound_ms(n, v, dtype, k == 'bwd')
                  for k in ('fwd', 'bwd')}
        timed[n] = {'fwd': dict(ms=fwd_ms, plain_ms=plain_fwd,
                                library_ms=lib_fwd, bound_ms=bounds['fwd'][0],
                                bound_by=bounds['fwd'][1]),
                    'bwd': dict(ms=bwd_ms, plain_ms=plain_bwd,
                                library_ms=lib_bwd, bound_ms=bounds['bwd'][0],
                                bound_by=bounds['bwd'][1])}
        for k, t in timed[n].items():
            say('ce-kernels', kernel=k, shape=f'{n}x{v}',
                dtype=str(dtype)[6:], z=z, eps=eps, ms=f'{t["ms"]:.4f}',
                bound_ms=f'{t["bound_ms"]:.4f}', bound_by=t['bound_by'],
                bound_share=f'{t["bound_ms"] / t["ms"]:.3f}',
                plain_ms=f'{t["plain_ms"]:.3f}',
                library_ms=f'{t["library_ms"]:.4f}',
                gbytes_per_s=f'{(2 if k == "bwd" else 1) * n * v * 2 / t["ms"] / 1e6:.1f}')
        del inputs, graphs
        torch.cuda.empty_cache()
    step_n, step_v = CE_TIMED[0][:2]
    err = errors[(*CE_TIMED[0], 0)]
    library = ('F.cross_entropy(x, y, reduction="none", label_smoothing=eps)'
               ' + z * logsumexp(x)^2')
    entries = []
    for k, name, line in (('fwd', 'fused_ce_fwd', 79),
                          ('bwd', 'fused_ce_bwd', 124)):
        entries.append({
            'name': name, 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/fused_ce.cu',
            'replaces': f'mlcomp_tpu/ops/fused_ce.py:{line}',
            'max_abs_err': err['loss_err'] if k == 'fwd'
            else err['max_abs_err'],
            **timed[step_n][k], 'shape': [step_n, step_v, 'bfloat16'],
            'library': library if k == 'fwd' else f'autograd of {library}',
            'shapes': {f'{n}x{step_v}': timed[n][k] for n in timed}})
    return entries


# ------------------------------------------------------- the wide int8 LM
#: ``bench_lm``'s wide legs (bench.py:636-687): the flagship at d_model
#: 2048, 32 heads of 64, d_ff 8192 — 687,900,672 parameters
WIDE = {**FLAGSHIP, 'd_model': 2048, 'n_heads': 32, 'd_ff': 8192}
WIDE_INT8 = {**WIDE, 'matmul_precision': 'int8', 'param_dtype': 'bfloat16'}
#: the fused-CE loss as a JAX config writes it
FUSED_CE_LOSS = {'name': 'lm_ce', 'impl': 'pallas', 'z_loss': 1e-4,
                 'label_smoothing': 0.1}
#: rows of 8192 random tokens in the wide phase's npz: 2 train, 1 valid
WIDE_ROWS = 3
WIDE_STEP_ITERS = 3
#: (c) against (d) on the same logits: the kernels' loss and logits
#: gradient against the dense formulation (f32 sums in another order;
#: the gradient rounds to bf16 on both sides)
MIN_CE_GRAD_COSINE = 0.9999
MAX_CE_LOSS_REL = 1e-3
#: (a) bf16 against (b) int8 with bf16 masters from the same weights:
#: the least cosine of any parameter's gradient. STE int8 gradients
#: round each product's operands to a 127th of their channel's absmax
#: (and the bf16 masters round the weights): measured 0.9926 on the H100
#: (the MLP's wi_gate weights; mean 0.995). A cosine does not see a
#: gradient's scale: ``[int8-train]`` holds the product's gradients
#: against the STE oracle by relative norm
MIN_INT8_GRAD_COSINE = 0.98


def phase_int8_train_matmul(seed: int):
    """``int8_train_matmul`` forward and gradients against the STE
    oracle at the wide step's shapes (``kernel_check``'s bounds)."""
    from mlcomp_tpu_torch.testing.kernel_check import (
        INT8_TRAIN_SHAPES, INT8_TRAIN_TOL, int8_train_check, int8_train_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    for shape in INT8_TRAIN_SHAPES:
        try:
            r = int8_train_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused call or a fault in the run
            fail(f'int8_train_matmul at {shape}: {e}')
        ok = int8_train_ok(r)
        say('int8-train', ok=ok, shape='x'.join(map(str, shape[:3])),
            weight=str(shape[3])[6:],
            **{f'{k}_rel_err': f'{r[k]:.3e}' for k in INT8_TRAIN_TOL},
            tol=INT8_TRAIN_TOL)
        if not ok:
            fail(f'int8_train_matmul disagrees with its STE oracle at '
                 f'{shape}: {r}')
        torch.cuda.empty_cache()


def phase_train_wide_int8(seed: int) -> dict:
    """The training entry point on the wide LM with int8 training
    matmuls, bf16 masters and the fused-CE loss; returns the launches of
    each kernel in its run."""
    import gc
    from mlcomp_tpu_torch.ops import flash_attention as fa
    from mlcomp_tpu_torch.ops import fused_ce
    from mlcomp_tpu_torch.ops.int8_matmul import int8_matmul
    from mlcomp_tpu_torch.train.export import make_predictor
    from mlcomp_tpu_torch.worker.executors import Executor

    t, vocab = WIDE['max_seq_len'], WIDE['vocab_size']
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_wide_')
    cwd = os.getcwd()
    try:
        tokens = np.random.default_rng(seed + 3).integers(
            0, vocab, (WIDE_ROWS, t), dtype=np.int32)
        data = os.path.join(work, 'tokens.npz')
        np.savez(data, x=tokens, y=tokens)
        ck_dir = os.path.join(work, 'checkpoints')
        config = {'executors': {'train': {
            'type': 'train', 'model': dict(WIDE_INT8),
            'dataset': {'name': 'npz', 'path': data},
            'loss': dict(FUSED_CE_LOSS), 'batch_size': 1,
            'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
                'name': 'adamw', 'lr': 3e-4, 'master_dtype': 'bfloat16',
                'schedule': {'name': 'warmup_cosine'}}}],
            'main_metric': 'loss', 'minimize': True,
            'checkpoint_dir': ck_dir, 'model_name': 'wide_lm_int8',
            'seed': seed, 'device': 'cuda'}}}
        os.chdir(work)
        executor = Executor.from_config('train', config)
        n_train = int(WIDE_ROWS * 0.8)
        n_valid = WIDE_ROWS - n_train
        counters = {'flash_attention_fwd': fa.flash_attention_forward,
                    'flash_attention_bwd_dq': fa.flash_attention_backward_dq,
                    'flash_attention_bwd_dkv':
                        fa.flash_attention_backward_dkv,
                    'fused_ce_fwd': fused_ce.ce_forward,
                    'fused_ce_bwd': fused_ce.ce_backward,
                    'int8_matmul': int8_matmul}
        # the main path: counts zeroed just before, read just after
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        result = executor(logger=_train_logger())
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        del executor
        gc.collect()
        torch.cuda.empty_cache()
        layers = WIDE['n_layers']
        # the eval step's loss runs the CE forward too
        want = {'flash_attention_fwd': layers * (n_train + n_valid),
                'flash_attention_bwd_dq': layers * n_train,
                'flash_attention_bwd_dkv': layers * n_train,
                'fused_ce_fwd': n_train + n_valid,
                'fused_ce_bwd': n_train, 'int8_matmul': 0}
        files = sorted(os.listdir(ck_dir))
        export = os.path.join(work, 'models', 'wide_lm_int8')
        say('train-wide-int8', steps=n_train, valid_rows=n_valid,
            seconds=f'{train_s:.1f}', valid_loss=result['best_score'],
            params=result['n_params'], launches=launches,
            checkpoints=files)
        if launches != want:
            fail(f'expected launches {want} (per step 1 CE forward and 1 '
                 f'backward, 8 flash forwards and 8 of each backward; 1 CE '
                 f'forward and 8 flash forwards per valid batch; no '
                 f'serving int8 launch), got {launches}')
        if not np.isfinite(result['best_score']):
            fail(f'train loss is not finite: {result}')
        if not {'best.msgpack', 'last.msgpack'} <= set(files) \
                or not os.path.exists(export + '.msgpack'):
            fail(f'checkpoints {files} or the export {export} missing')
        predict = make_predictor(export, batch_size=1, activation='argmax',
                                 device='cuda')
        weight = predict.model.layers[0].mlp.wo.weight
        y = predict(tokens[:1])
        ok = (y.shape == (1, t) and 0 <= y.min() and y.max() < vocab
              and weight.dtype == torch.bfloat16
              and type(predict.model.layers[0].mlp.wo).__name__
              == 'Int8DenseGeneral')
        say('train-wide-int8', export=os.path.basename(export),
            param_dtype=str(weight.dtype)[6:],
            projection=type(predict.model.layers[0].mlp.wo).__name__,
            predict_shape=y.shape, ok=ok)
        if not ok:
            fail(f'the int8-trained export predicts {y.shape} {y.dtype} '
                 f'with {weight.dtype} weights')
        del predict, weight
        return launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_step_wide(seed: int) -> dict:
    """``bench_lm``'s wide legs at B=1, T=8192 on the same weights: (a)
    bf16 matmuls, f32 params, ``lm_ce``; (b) int8 matmuls with bf16
    masters, ``lm_ce`` (``lm_wide_int8_vs_bf16``); (c) the same with the
    fused-CE kernels, z-loss and smoothing; (d) that loss dense. Checks
    (c) against (d) and (a) against (b), times the four in turns and
    splits (c)'s step with the profiler. Returns its numbers."""
    import gc
    from mlcomp_tpu_torch.models import create_model, param_count
    from mlcomp_tpu_torch.ops.fused_ce import reference_ce
    from mlcomp_tpu_torch.ops.int8_matmul import _quantize_rows
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    t, vocab = WIDE['max_seq_len'], WIDE['vocab_size']
    layers, d, ff = WIDE['n_layers'], WIDE['d_model'], WIDE['d_ff']
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (1, t)).astype(np.int32)).cuda()
    bf16 = create_model(**WIDE, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(seed))
    int8 = create_model(**WIDE_INT8, device='cuda')
    int8.load_state_dict(bf16.state_dict())
    n_params = param_count(bf16)
    losses = {'lm_ce': loss_for_task('lm_ce'),
              'kernel': loss_for_task({**FUSED_CE_LOSS, 'impl': 'cuda'}),
              'dense': loss_for_task({**FUSED_CE_LOSS, 'impl': 'dense'})}

    def grads(model):
        loss, _ = losses['lm_ce'](model(tokens, train=True), tokens)
        return dict(zip((n for n, _ in model.named_parameters()),
                        torch.autograd.grad(loss, list(model.parameters()))))

    # (a) against (b): every parameter's gradient from the same weights
    ga = grads(bf16)
    gb = grads(int8)
    cosines = {n: _cosine(ga[n], gb[n]) for n in ga}
    worst = min(cosines, key=cosines.get)
    del ga, gb
    # (c) against (d): the loss and its gradient on the same logits
    logits = int8(tokens, train=True).detach()
    ce = {}
    for impl in ('kernel', 'dense'):
        leaf = logits.clone().requires_grad_()
        loss, _ = losses[impl](leaf, tokens)
        ce[impl] = (float(loss.detach()), torch.autograd.grad(loss, leaf)[0])
    ce_cos = _cosine(ce['kernel'][1], ce['dense'][1])
    ce_rel = abs(ce['kernel'][0] - ce['dense'][0]) / abs(ce['dense'][0])
    say('step-wide', params=n_params, grad_min_cosine_int8_vs_bf16=
        f'{cosines[worst]:.6f}', worst=worst,
        mean_cosine=f'{sum(cosines.values()) / len(cosines):.6f}',
        bound=MIN_INT8_GRAD_COSINE, ce_logits_grad_cosine=f'{ce_cos:.7f}',
        ce_cos_bound=MIN_CE_GRAD_COSINE, ce_loss_kernel=f'{ce["kernel"][0]:.6f}',
        ce_loss_dense=f'{ce["dense"][0]:.6f}', ce_loss_rel=f'{ce_rel:.2e}',
        ce_loss_bound=MAX_CE_LOSS_REL)
    for n in sorted(cosines, key=cosines.get)[:4]:
        say('step-wide-grad', tensor=n, cosine=f'{cosines[n]:.6f}')
    del logits, ce
    gc.collect()
    torch.cuda.empty_cache()
    if not cosines[worst] >= MIN_INT8_GRAD_COSINE:
        fail(f'int8 gradients disagree with bf16: {worst} cosine '
             f'{cosines[worst]}')
    if not (ce_cos >= MIN_CE_GRAD_COSINE and ce_rel <= MAX_CE_LOSS_REL):
        fail(f'the fused CE disagrees with the dense CE on the step: '
             f'cosine {ce_cos}, loss relative difference {ce_rel}')

    opt_a, _ = make_optimizer({'name': 'adamw', 'lr': 3e-4}, 1000)
    opt_i, _ = make_optimizer({'name': 'adamw', 'lr': 3e-4,
                               'master_dtype': 'bfloat16'}, 1000)
    state_a = create_train_state(bf16, opt_a, seed=seed)
    state_i = create_train_state(int8, opt_i, seed=seed)
    variants = {
        'a_bf16': (state_a, make_train_step(bf16, opt_a, losses['lm_ce'],
                                            self_supervised=True)),
        'b_int8': (state_i, make_train_step(int8, opt_i, losses['lm_ce'],
                                            self_supervised=True)),
        'c_int8_fused_ce': (state_i, make_train_step(
            int8, opt_i, losses['kernel'], self_supervised=True)),
        'd_int8_dense_ce': (state_i, make_train_step(
            int8, opt_i, losses['dense'], self_supervised=True)),
    }
    for state, step in variants.values():
        for _ in range(2):                   # warm-up
            step(state, tokens, None)
    times = {k: [] for k in variants}
    for _ in range(2):                       # in turns: a b c d a b c d
        for name, (state, step) in variants.items():
            times[name].append(time_ms(lambda: step(state, tokens, None),
                                       iters=WIDE_STEP_ITERS, warmup=0))
    flops_per_token = 6 * n_params + 6 * layers * t * d
    out = {}
    for name, ts in times.items():
        ms = min(ts)
        tok_s = t / (ms / 1e3)
        out[name] = {'step_ms': ms, 'step_ms_all': ts, 'tokens_per_s': tok_s,
                     'mfu': tok_s * flops_per_token
                     / PEAK_OPS_PER_S[torch.bfloat16]}
        say('step-wide', variant=name, step_ms=f'{ms:.2f}',
            runs=[f'{x:.2f}' for x in ts], tokens_per_s=f'{tok_s:.1f}',
            mfu=f'{out[name]["mfu"]:.4f}')
    out['lm_wide_int8_vs_bf16'] = (out['b_int8']['tokens_per_s']
                                   / out['a_bf16']['tokens_per_s'])
    loss = float(variants['c_int8_fused_ce'][1](state_i, tokens,
                                                None)[1]['loss'])
    if not np.isfinite(loss):
        fail(f'the wide int8 step loss is not finite: {loss}')

    # where (c)'s step goes: the CE kernels, the int8 GEMMs (profiler)
    state, step = variants['c_int8_fused_ce']
    fields = {}
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step(state, tokens, None)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType
        events = prof.events()
        kernels = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and not getattr(
                    e, 'is_user_annotation', False):
                kernels[e.name] = kernels.get(e.name, 0.0) \
                    + e.device_time_total
        total_us = sum(kernels.values())
        if total_us <= 0:
            raise RuntimeError('the profile holds no device time')
        ce_us = sum(us for name, us in kernels.items()
                    if 'ce_fwd_kernel' in name or 'ce_bwd_kernel' in name)
        # the kernels each aten::_int_mm call launched
        int_mm_us = sum(e.device_time_total for e in events
                        if e.name == 'aten::_int_mm'
                        and e.device_type == DeviceType.CPU)
        by_name = sorted(((us, name) for name, us in kernels.items()),
                         reverse=True)
        for us, name in by_name[:TOP_KERNELS]:
            say('step-wide-kernel', ms_per_step=f'{us / 2e3:.3f}',
                share=f'{us / total_us:.4f}', name=repr(name[:90]))
        fields.update(device_ms=total_us / 2e3, ce_kernels_ms=ce_us / 2e3,
                      int_mm_ms=int_mm_us / 2e3,
                      device_busy=total_us / 2e3
                      / out['c_int8_fused_ce']['step_ms'])
    except Exception as e:      # a profiler that reads no device time
        fields.update(device_ms='not measured', profiler=repr(str(e)[:80]))

    # the quantize passes of one step (CUDA events at the step's shapes:
    # per layer x of qkv, wi_gate, wi_up and out [T, d], of wo [T, ff];
    # the five weights), the dense CE's forward and backward, and the two
    # [N, V] passes around the kernels: the accuracy's f32 argmax and
    # the slice's gradient padded back to [B, T, V]
    x_d = torch.randn((t, d), device='cuda').to(torch.bfloat16)
    x_f = torch.randn((t, ff), device='cuda').to(torch.bfloat16)
    q_ms = layers * (4 * time_ms(lambda: _quantize_rows(x_d), iters=10)
                     + time_ms(lambda: _quantize_rows(x_f), iters=10))
    w_ms = 0.0
    for name, p in int8.named_parameters():
        if p.dim() == 2 and 'layers.' in name:
            w_ms += time_ms(lambda: _quantize_rows(p.detach()), iters=10)
    logits = torch.randn((1, t, vocab), device='cuda').to(torch.bfloat16)
    lg = logits[:, :-1]
    labels = tokens[:, 1:].reshape(-1).long()

    def dense_ce():
        leaf = lg.reshape(-1, vocab).detach().requires_grad_()
        loss = reference_ce(leaf, labels, 1e-4, 0.1).mean()
        torch.autograd.grad(loss, leaf)

    dense_ce_ms = time_ms(dense_ce, iters=5)
    argmax_ms = time_ms(lambda: lg.float().argmax(-1), iters=5)
    grad = torch.empty((1, t - 1, vocab), device='cuda',
                       dtype=torch.bfloat16)

    def pad_grad():
        full = torch.zeros_like(logits)
        full[:, :-1].copy_(grad)

    pad_ms = time_ms(pad_grad, iters=5)
    fields.update(quantize_x_ms=q_ms, quantize_w_ms=w_ms,
                  dense_ce_fwd_bwd_ms=dense_ce_ms, argmax_f32_ms=argmax_ms,
                  slice_grad_pad_ms=pad_ms)
    say('step-wide-split', **{k: (f'{v:.3f}' if isinstance(v, float) else v)
                              for k, v in fields.items()})
    out['split'] = fields
    out['checks'] = {'grad_min_cosine_int8_vs_bf16': cosines[worst],
                     'worst': worst, 'ce_logits_grad_cosine': ce_cos,
                     'ce_loss_rel': ce_rel}
    say('step-wide', lm_wide_int8_vs_bf16=f'{out["lm_wide_int8_vs_bf16"]:.3f}',
        fused_vs_dense_ce=f'{out["d_int8_dense_ce"]["step_ms"] / out["c_int8_fused_ce"]["step_ms"]:.3f}',
        loss=f'{loss:.4f}')
    del variants, state_a, state_i, state, step, bf16, int8, logits, lg, grad
    del x_d, x_f
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------- the MoE LM and the ViT
#: ``examples/moe``'s MoE knobs at the flagship widths of ``bench.py``
#: (293,635,072 parameters: 4 of the 8 layers MoE, 4 experts each)
MOE = {**FLAGSHIP, 'n_experts': 4, 'moe_every': 2, 'capacity_factor': 1.25}
#: the train phase's ``synthetic_lm``: 4 train rows and 1 valid row of
#: 8192 tokens over ``examples/moe``'s dataset vocabulary (its Markov
#: table is [V, V] f64 on the host: at the model's 32768 it is 8.6 GB)
MOE_DATA = {'name': 'synthetic_lm', 'n_train': 4, 'n_valid': 1,
            'seq_len': 8192, 'vocab_size': 1024}
#: ``examples/encoder_grid``'s ViT cell (its model spec; the JAX
#: defaults: 32x32 images in 4x4 patches, d 192, 6 layers, 3 heads,
#: d_ff 768; 3,564,864 parameters) on its dataset, batch and optimizer
VIT_SPEC = {
    'type': 'train',
    'model': {'name': 'vit', 'num_classes': 10, 'cifar_stem': True,
              'dtype': 'bfloat16'},
    'dataset': {'name': 'synthetic_images', 'n_train': 4096,
                'n_valid': 512, 'image_size': 32, 'channels': 3,
                'num_classes': 10},
    'batch_size': 256, 'mesh': {'dp': -1}, 'main_metric': 'accuracy',
    'model_name': 'vit_encoder_grid',
    'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
        'name': 'adamw', 'lr': 0.001,
        'schedule': {'name': 'warmup_cosine'}}}]}
#: the ViT's timed step: windows of steps (CUDA events), each a mean
VIT_STEP_ITERS = 30
VIT_STEP_WINDOWS = 3


def _flash_counters() -> dict:
    from mlcomp_tpu_torch.ops import flash_attention as fa
    return {'flash_attention_fwd': fa.flash_attention_forward,
            'flash_attention_bwd_dq': fa.flash_attention_backward_dq,
            'flash_attention_bwd_dkv': fa.flash_attention_backward_dkv}


def _run_executor(spec: dict, work: str) -> tuple:
    """``Executor.from_config('train', ...)`` of ``spec`` on the card in
    ``work`` (its export lands in models/ under it); the flash kernels'
    counts zeroed just before the run and read just after. Returns
    (result, launches, seconds)."""
    import gc
    from mlcomp_tpu_torch.worker.executors import Executor
    cwd = os.getcwd()
    os.chdir(work)
    try:
        executor = Executor.from_config('train', {'executors': {
            'train': spec}})
        counters = _flash_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        result = executor(logger=_train_logger())
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        del executor
        gc.collect()
        torch.cuda.empty_cache()
        return result, launches, seconds
    finally:
        os.chdir(cwd)


def _check_launches(phase: str, launches: dict, want: dict):
    if launches != want:
        fail(f'{phase}: expected launches {want}, got {launches}')


def moe_flops(spec: dict, n_params: int, t: int) -> dict:
    """A step's FLOPs at B=1: the model's, 6 per active parameter and
    token (top-1: one expert a token; the embedding counted as the
    flagship's MFU counts it) + 6·L·T·d for the causal attention; and
    apart from them the dispatch and combine einsums, 2·T·X·C·M each
    (forward: both; backward: dispatch's input gradient, combine's two).
    The capacity's empty slots (X·C - T) are counted in neither."""
    x, m, f = spec['n_experts'], spec['d_model'], spec['d_ff']
    n_moe = sum(i % spec['moe_every'] == spec['moe_every'] - 1
                for i in range(spec['n_layers']))
    active = n_params - n_moe * (x - 1) * 2 * m * f
    capacity = max(1, int(spec['capacity_factor'] * t / x))
    per_token = 6 * active + 6 * spec['n_layers'] * t * m
    dispatch = n_moe * 5 * 2 * t * x * capacity * m
    return {'active_params': active, 'model_flops_per_token': per_token,
            'model_flops': per_token * t, 'dispatch_flops': dispatch,
            'capacity': capacity}


def phase_moe_train(seed: int) -> dict:
    """``[moe-train]``: the MoE LM at the flagship widths trained
    through the executor on the card for one epoch of ``synthetic_lm``
    at B=1 (4 steps, 1 valid row), checkpoints and the export reloaded;
    returns the flash kernels' launches in the run."""
    from mlcomp_tpu_torch.train.export import make_predictor
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_moe_')
    try:
        ck_dir = os.path.join(work, 'checkpoints')
        spec = {'type': 'train', 'model': dict(MOE), 'dataset': MOE_DATA,
                'loss': 'lm_ce', 'batch_size': 1,
                'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
                    'name': 'adamw', 'lr': 3e-4,
                    'schedule': {'name': 'warmup_cosine'}}}],
                'main_metric': 'loss', 'minimize': True,
                'checkpoint_dir': ck_dir, 'model_name': 'moe_lm_trained',
                'seed': seed, 'device': 'cuda'}
        result, launches, seconds = _run_executor(spec, work)
        n_train, n_valid = MOE_DATA['n_train'], MOE_DATA['n_valid']
        layers = MOE['n_layers']
        files = sorted(os.listdir(ck_dir))
        export = os.path.join(work, 'models', 'moe_lm_trained')
        say('moe-train', param_count=result['n_params'], steps=n_train,
            valid_rows=n_valid, seconds=f'{seconds:.1f}',
            valid_loss=result['best_score'], launches=launches,
            checkpoints=files)
        _check_launches('moe-train', launches, {
            'flash_attention_fwd': layers * (n_train + n_valid),
            'flash_attention_bwd_dq': layers * n_train,
            'flash_attention_bwd_dkv': layers * n_train})
        if result['n_params'] != 293_635_072:
            fail(f'the MoE LM has {result["n_params"]} parameters, not '
                 f'293,635,072')
        if not np.isfinite(result['best_score']):
            fail(f'MoE train loss is not finite: {result}')
        if not {'best.msgpack', 'last.msgpack'} <= set(files) \
                or not os.path.exists(export + '.msgpack'):
            fail(f'checkpoints {files} or the export {export} missing')
        predict = make_predictor(export, batch_size=1, activation='argmax',
                                 device='cuda')
        tokens = np.random.default_rng(seed).integers(
            0, MOE_DATA['vocab_size'], (1, MOE['max_seq_len']),
            dtype=np.int32)
        y = predict(tokens)
        ok = y.shape == tokens.shape and 0 <= y.min() \
            and y.max() < MOE['vocab_size']
        say('moe-train', export=os.path.basename(export),
            layer_1_is_moe=hasattr(predict.model.layers[1], 'moe'),
            predict_shape=y.shape, ok=ok)
        if not ok or not hasattr(predict.model.layers[1], 'moe'):
            fail(f'the trained MoE export predicts {y.shape} {y.dtype}')
        del predict
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


def quantized_by_jax_rule(params: dict) -> int:
    """How many kernels the JAX package's int8 serving quantizes in a
    params tree: ``kernel`` leaves that are 2-D with at least 65,536
    elements (``mlcomp_tpu/train/export.py`` ``_quantized_interceptor``,
    restated here)."""
    if isinstance(params, dict):
        return sum(quantized_by_jax_rule(v) if k != 'kernel' else int(
            np.ndim(v) == 2 and np.size(v) >= 65536)
            for k, v in params.items())
    return 0


def phase_moe_serve(seed: int) -> dict:
    """``[moe-serve]``: the MoE LM (weights from the seed, exported in
    the per-layer layout an MoE stack has) served over HTTP at batch 4,
    in bf16 and with ``quantize='int8'``: p50, the flash and int8
    launches a dispatch (counts zeroed just before the requests, read
    just after), the quantized kernels against JAX's rule, and one row
    against the plain version (bf16: the same weights with the plain
    attention; int8: the same int8 weights through the plain product).
    Returns the launches by kernel."""
    import gc
    from mlcomp_tpu_torch import MODEL_FOLDER
    from mlcomp_tpu_torch.convert import variables_to_jax
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.ops.flash_attention import flash_attention_forward
    from mlcomp_tpu_torch.ops.int8_matmul import Int8Dense, int8_matmul
    from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
    from mlcomp_tpu_torch.train.export import export_model

    model = create_model(**MOE, device='cuda',
                         generator=torch.Generator('cuda').manual_seed(seed))
    params = variables_to_jax(model)['params']
    del model
    torch.cuda.empty_cache()
    want_quantized = quantized_by_jax_rule(params)
    export_model(os.path.join(MODEL_FOLDER, 'smoke', 'moe_lm'), params, MOE,
                 meta={'input_shape': [MOE['max_seq_len']],
                       'input_dtype': 'int32'})
    del params
    path = resolve_model('moe_lm', 'smoke')
    rng = np.random.default_rng(seed + 5)
    t, vocab = MOE['max_seq_len'], MOE['vocab_size']
    requests = [rng.integers(0, vocab, (n, t), dtype=np.int32)
                for n in (1, 4, 2, 3)]
    launches = {}
    for quantize in (None, 'int8'):
        gc.collect()
        server = ModelServer(path, batch_size=SERVE_BATCH,
                             activation='argmax', port=0, quantize=quantize,
                             device='cuda')
        predict = server.primary.predict
        if not server.warmup():
            fail('the MoE export carries no input_shape to warm up with')
        server.bind()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            # the main path: counts zeroed just before, read just after
            flash_attention_forward.launches = 0
            int8_matmul.launches = 0
            latencies, served, per_dispatch = _serve_rows(
                server, requests, flash_attention_forward)
            key = 'int8' if quantize else 'bf16'
            launches[key] = {'flash_attention_fwd':
                             flash_attention_forward.launches,
                             'int8_matmul': int8_matmul.launches}
            health = _http(server.port, '/health')
        finally:
            server.shutdown()
            thread.join(timeout=30)
        int8_want = want_quantized * len(requests) if quantize else 0
        say('moe-serve', quantize=quantize or 'none',
            quantized=predict.quantized, jax_rule_quantizes=want_quantized,
            requests=len(requests), launches=launches[key],
            flash_per_dispatch=per_dispatch,
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            max_ms=f'{max(latencies):.1f}', platform=health['platform'])
        if per_dispatch != [MOE['n_layers']] * len(requests) \
                or launches[key]['int8_matmul'] != int8_want \
                or predict.quantized != (want_quantized if quantize else 0):
            fail(f'moe-serve: expected {MOE["n_layers"]} flash launches a '
                 f'dispatch, {int8_want} int8 launches and '
                 f'{want_quantized if quantize else 0} quantized modules; '
                 f'got {per_dispatch}, {launches[key]}, '
                 f'{predict.quantized}')
        if health['platform'] != 'gpu':
            fail(f'/health disagrees: {health}')

        tokens = torch.from_numpy(requests[0]).cuda()
        served_row = torch.from_numpy(served[0][0]).cuda().long()
        model = predict.model
        with torch.inference_mode():
            kern = model(tokens)[0].float()
            if quantize:
                int8_modules = [m for m in model.modules()
                                if isinstance(m, Int8Dense)]
                for m in int8_modules:
                    m.impl = 'dense'
                ref = model(tokens)[0].float()
                for m in int8_modules:
                    m.impl = 'auto'
            else:
                dense = create_model(**{**MOE, 'attn_impl': 'dense'},
                                     device='cuda')
                dense.load_state_dict(model.state_dict())
                ref = dense(tokens)[0].float()
                del dense
        batch = torch.from_numpy(np.concatenate(requests[1:3])[
            :SERVE_BATCH]).cuda()
        with torch.inference_mode():
            forward_ms = time_ms(lambda: model(batch).argmax(dim=-1),
                                 iters=3)
        say('moe-serve', quantize=quantize or 'none',
            forward_ms=f'{forward_ms:.2f}', batch=SERVE_BATCH)
        _compare_rows('moe-serve', kern, ref, served_row,
                      quantize=quantize or 'none',
                      plain='int8 plain product' if quantize
                      else 'plain attention')
        del server, predict, model, kern, ref
        torch.cuda.empty_cache()
    return launches


def phase_vit_train(seed: int) -> dict:
    """``[vit-train]``: ``encoder_grid``'s ViT trained through the
    executor on the card for one epoch (16 steps of 256 images, 2 valid
    batches; the flash kernels' non-causal branch forward and backward)
    and its export served over HTTP, the served rows against the plain
    attention. Returns the kernels' launches in the epoch."""
    from mlcomp_tpu_torch import TOKEN
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.server.serve import ModelServer
    from mlcomp_tpu_torch.train.data import create_dataset

    work = tempfile.mkdtemp(prefix='mlcomp_smoke_vit_')
    try:
        ck_dir = os.path.join(work, 'checkpoints')
        spec = dict(VIT_SPEC, checkpoint_dir=ck_dir, seed=seed,
                    device='cuda')
        result, launches, seconds = _run_executor(spec, work)
        data = spec['dataset']
        steps = data['n_train'] // spec['batch_size']
        valid = -(-data['n_valid'] // spec['batch_size'])
        layers = 6
        say('vit-train', param_count=result['n_params'], steps=steps,
            seconds=f'{seconds:.1f}', valid_accuracy=result['best_score'],
            samples_per_s=f'{result["samples_per_sec"]:.1f}',
            launches=launches,
            fwd_per_step=launches['flash_attention_fwd'] / (steps + valid),
            bwd_per_step=launches['flash_attention_bwd_dq'] / steps)
        _check_launches('vit-train', launches, {
            'flash_attention_fwd': layers * (steps + valid),
            'flash_attention_bwd_dq': layers * steps,
            'flash_attention_bwd_dkv': layers * steps})
        if result['n_params'] != 3_564_864 \
                or not 0 <= result['best_score'] <= 1:
            fail(f'vit-train: {result}')

        ds = create_dataset(**data)
        model_spec = spec['model']
        export = os.path.join(work, 'models', spec['model_name'])
        server = ModelServer(export + '.msgpack', batch_size=64, port=0,
                             device='cuda')
        if not server.warmup():
            fail('the ViT export carries no input_shape to warm up with')
        server.bind()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        images = ds['x_valid'][:128]
        try:
            got, latencies = [], []
            for start, n in ((0, 1), (1, 64), (65, 63)):
                t1 = time.monotonic()
                out = _http(server.port, '/predict',
                            {'x': images[start:start + n].tolist()}, TOKEN)
                latencies.append((time.monotonic() - t1) * 1e3)
                got.append(np.asarray(out['y'], np.float32))
            health = _http(server.port, '/health')
            served = server.primary.predict.model
            dense = create_model(**{**model_spec, 'attn_impl': 'dense'},
                                 input_shape=images.shape[1:],
                                 device='cuda')
            dense.load_state_dict(served.state_dict())
            with torch.inference_mode():
                ref = dense(torch.from_numpy(images).cuda()).float()
        finally:
            server.shutdown()
            thread.join(timeout=30)
        got = torch.from_numpy(np.concatenate(got)).cuda()
        # the forward alone at the served batch: the requests' time is
        # mostly their JSON images on the host
        batch = torch.from_numpy(images[:64]).cuda()
        with torch.inference_mode():
            forward_ms = time_ms(lambda: served(batch), iters=10)
        say('vit-serve', requests=len(latencies), rows=len(got),
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            forward_ms=f'{forward_ms:.3f}', batch=64,
            platform=health['platform'])
        if got.shape != (128, 10) or health['platform'] != 'gpu':
            fail(f'vit-serve: /predict answered {tuple(got.shape)}; '
                 f'{health}')
        _compare_rows('vit-serve', got, ref, plain='plain attention')
        del server, served, dense
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


def vit_step(seed: int) -> tuple:
    """The ViT of VIT_SPEC with weights from ``seed`` on the card, the
    first batch of its dataset and its train step (the executor's AdamW):
    (run, parts), ``run()`` one step, ``parts`` the model, loss function
    and batch."""
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.train.data import create_dataset
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer
    ds = create_dataset(**VIT_SPEC['dataset'])
    n = VIT_SPEC['batch_size']
    x = torch.from_numpy(ds['x_train'][:n]).cuda()
    y = torch.from_numpy(ds['y_train'][:n]).cuda()
    model = create_model(**VIT_SPEC['model'], input_shape=x.shape[1:],
                         device='cuda',
                         generator=torch.Generator('cuda').manual_seed(seed))
    loss_fn = loss_for_task('softmax_ce')
    optimizer, _ = make_optimizer(VIT_SPEC['stages'][0]['optimizer'], 100)
    state = create_train_state(model, optimizer, seed=seed)
    step = make_train_step(model, optimizer, loss_fn)
    return (lambda: step(state, x, y)), {'model': model, 'loss_fn': loss_fn,
                                         'x': x, 'y': y, 'step': step,
                                         'state': state}


def phase_vit_step(seed: int) -> dict:
    """``[vit-train]``'s timed step: the ViT's train step at batch 256,
    VIT_STEP_WINDOWS windows of VIT_STEP_ITERS steps after 3 to warm
    (CUDA events; its profile comes after every step timing, in
    ``profile_vit``), the flash launches per step, and one step's
    gradients against the plain attention."""
    from mlcomp_tpu_torch.models import create_model
    run, parts = vit_step(seed)
    model, x, y = parts['model'], parts['x'], parts['y']
    dense = create_model(**{**VIT_SPEC['model'], 'attn_impl': 'dense'},
                         input_shape=x.shape[1:], device='cuda')
    dense.load_state_dict(model.state_dict())
    cosines = _grad_cosines(model, dense, lambda m: parts['loss_fn'](
        m(x, train=True), y)[0])
    del dense
    for _ in range(3):
        _, metrics = run()
    counters = _flash_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = [time_ms(run, iters=VIT_STEP_ITERS, warmup=0)
            for _ in range(VIT_STEP_WINDOWS)]
    steps = VIT_STEP_ITERS * VIT_STEP_WINDOWS
    per_step = {n: fn.launches / steps for n, fn in counters.items()}
    step_ms = sum(runs) / len(runs)
    batch = VIT_SPEC['batch_size']
    say('vit-train', timed_step=True, step_ms=f'{step_ms:.3f}',
        runs_ms=[f'{t:.3f}' for t in runs],
        images_per_s=f'{batch / (step_ms / 1e3):.1f}', batch=batch,
        loss=f'{float(metrics["loss"]):.4f}',
        flash_launches_per_step=per_step)
    _say_cosines('vit-train', cosines, MIN_GRAD_COSINE)
    want = dict.fromkeys(counters, float(len(model.layers)))
    if per_step != want:
        fail(f'vit-train: expected {want} flash launches a step, got '
             f'{per_step}')
    del run, parts, model
    torch.cuda.empty_cache()
    return {'step_ms': step_ms, 'runs_ms': runs}


def phase_moe_step(seed: int) -> dict:
    """``[moe-train]``'s timed step: the MoE LM's train step at B=1,
    T=8192 with AdamW as ``bench_lm`` times the flagship's: ms,
    tokens/s, MFU over the model FLOPs (``moe_flops``), the dispatch
    einsums' FLOPs apart, ``moe_aux``, the profiler's split (attention,
    the dispatch and combine einsums' share is not separable by kernel
    name: the longest kernels are printed), the flash launches per
    step, and one step's gradients against the plain attention."""
    from mlcomp_tpu_torch.models import create_model, param_count
    from mlcomp_tpu_torch.train.loop import (
        MOE_AUX_COEF, create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    t, vocab = MOE['max_seq_len'], MOE['vocab_size']
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (1, t)).astype(np.int32)).cuda()
    loss_fn = loss_for_task('lm_ce')
    model = create_model(**MOE, device='cuda',
                         generator=torch.Generator('cuda').manual_seed(seed))
    n_params = param_count(model)
    flops = moe_flops(MOE, n_params, t)

    def loss_of(m):
        logits, aux = m(tokens, train=True, return_aux=True)
        return loss_fn(logits, tokens)[0] + MOE_AUX_COEF * aux

    dense = create_model(**{**MOE, 'attn_impl': 'dense', 'remat': True},
                         device='cuda')
    dense.load_state_dict(model.state_dict())
    cosines = _grad_cosines(model, dense, loss_of)
    del dense
    torch.cuda.empty_cache()

    optimizer, _ = make_optimizer({'name': 'adamw', 'lr': 3e-4}, 1000)
    state = create_train_state(model, optimizer, seed=seed)
    step = make_train_step(model, optimizer, loss_fn, self_supervised=True)
    for _ in range(3):
        state, metrics = step(state, tokens, None)
    counters = _flash_counters()
    for fn in counters.values():
        fn.launches = 0
    step_ms = time_ms(lambda: step(state, tokens, None), iters=STEP_ITERS,
                      warmup=0)
    per_step = {n: fn.launches / STEP_ITERS for n, fn in counters.items()}
    _, metrics = step(state, tokens, None)
    loss, aux = float(metrics['loss']), float(metrics['moe_aux'])
    tok_s = t / (step_ms / 1e3)
    mfu = tok_s * flops['model_flops_per_token'] \
        / PEAK_OPS_PER_S[torch.bfloat16]
    fields = dict(param_count=n_params, step_ms=f'{step_ms:.2f}',
                  tokens_per_s=f'{tok_s:.1f}', mfu=f'{mfu:.4f}',
                  model_tflop_per_step=f'{flops["model_flops"] / 1e12:.3f}',
                  dispatch_tflop_per_step=
                  f'{flops["dispatch_flops"] / 1e12:.3f}',
                  active_params=flops['active_params'],
                  capacity=flops['capacity'], loss=f'{loss:.4f}',
                  moe_aux=f'{aux:.4f}', flash_launches_per_step=per_step)
    fields.update(profile_step('moe-step', lambda: step(state, tokens, None),
                               step_ms, _is_attention, 'attention')[0])
    say('moe-train', timed_step=True, **fields)
    _say_cosines('moe-train', cosines, MIN_GRAD_COSINE)
    if not (np.isfinite(loss) and np.isfinite(aux)):
        fail(f'MoE step loss {loss} or moe_aux {aux} is not finite')
    want = {'flash_attention_fwd': MOE['n_layers'],
            'flash_attention_bwd_dq': MOE['n_layers'],
            'flash_attention_bwd_dkv': MOE['n_layers']}
    if per_step != want:
        fail(f'moe-train: expected {want} flash launches a step, got '
             f'{per_step}')
    del state, model, step
    torch.cuda.empty_cache()
    return {'step_ms': step_ms, 'tokens_per_s': tok_s, 'mfu': mfu,
            'moe_aux': aux, **flops}


# ------------------------------------------------- export consumers (DAGs)
#: ``examples/cifar10/config.yml`` as the port runs it: ``type: train``
#: for ``jax_train`` and the model's ``norm: fused``. Cuts: the train's 5
#: epochs -> 1; ``report_imgs`` dropped (report images need the DB,
#: ROADMAP.md A0). ``cifar10`` is the synthetic stand-in at CIFAR's
#: 50000/10000 x 32x32x3 where no local npz exists.
CIFAR10_DAG = {
    'train': {
        'type': 'train',
        'model': {'name': 'resnet18', 'num_classes': 10,
                  'dtype': 'bfloat16', 'norm': 'fused'},
        'dataset': {'name': 'cifar10'}, 'loss': 'softmax_ce',
        'batch_size': 512, 'augment': [{'name': 'pad_crop', 'pad': 4},
                                       'hflip'],
        'mesh': {'dp': -1}, 'main_metric': 'accuracy',
        'model_name': 'cifar10_resnet18',
        'stages': [{'name': 'warm', 'epochs': 1, 'optimizer': {
            'name': 'sgd', 'lr': 0.1, 'momentum': 0.9,
            'schedule': {'name': 'warmup_cosine', 'warmup_steps': 200}}}]},
    'infer': {'type': 'infer_classify', 'model_name': 'cifar10_resnet18',
              'dataset': {'name': 'cifar10'}, 'depends': 'train'},
    'valid': {'type': 'valid_classify', 'dataset': {'name': 'cifar10'},
              'y': "load('cifar10_resnet18')", 'depends': 'infer'},
}
#: ``examples/ensemble/config.yml`` verbatim but ``type: train``
_ENS_DATA = {'name': 'synthetic_images', 'n_train': 4096, 'n_valid': 512,
             'image_size': 16, 'channels': 1}
_ENS_MLP = {'name': 'mlp', 'num_classes': 10, 'hidden': [256],
            'dtype': 'float32'}
ENSEMBLE_DAG = {
    'train_a': {'type': 'train', 'model': _ENS_MLP, 'dataset': _ENS_DATA,
                'batch_size': 128, 'model_name': 'a',
                'stages': [{'name': 's1', 'epochs': 3, 'optimizer': {
                    'name': 'adam', 'lr': 0.003}}]},
    'train_b': {'type': 'train', 'model': _ENS_MLP, 'dataset': _ENS_DATA,
                'batch_size': 128, 'seed': 1, 'model_name': 'b',
                'stages': [{'name': 's1', 'epochs': 3, 'optimizer': {
                    'name': 'adam', 'lr': 0.003}}]},
    'infer_a': {'type': 'infer_classify', 'model_name': 'a',
                'dataset': _ENS_DATA, 'depends': 'train_a'},
    'infer_b': {'type': 'infer_classify', 'model_name': 'b',
                'dataset': _ENS_DATA, 'depends': 'train_b'},
    'valid_ens': {'type': 'valid_classify', 'dataset': _ENS_DATA,
                  'y': "(load('a') + load('b')) / 2",
                  'depends': ['infer_a', 'infer_b']},
}
#: ``examples/encoder_grid/config.yml``'s six cells as six train
#: executors (the grid expanded by hand; cut: 2 epochs -> 1), the
#: ``resnet18`` cell with ``norm: fused`` added to the base spec (the
#: other families' factories drop it, as JAX's do), exported as
#: ``grid_<name>``, then inferred at the default batch 512 with hflip TTA
#: (the ViT through the int8 kernel, and again in bf16 to hold it
#: against) and ensembled over the six saved arrays
_GRID_DATA = {'name': 'synthetic_images', 'n_train': 4096, 'n_valid': 512,
              'image_size': 32, 'channels': 3, 'num_classes': 10}
_GRID_TRAIN = {'type': 'train', 'dataset': _GRID_DATA, 'batch_size': 256,
               'mesh': {'dp': -1}, 'main_metric': 'accuracy',
               'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
                   'name': 'adamw', 'lr': 0.001,
                   'schedule': {'name': 'warmup_cosine'}}}]}
_GRID_MODEL = {'name': 'resnet18', 'num_classes': 10, 'cifar_stem': True,
               'dtype': 'bfloat16', 'norm': 'fused'}
#: the grid's cells beyond ResNet-18 and the ViT
GRID_CELLS = ('seresnet18', 'vgg13', 'densenet121', 'efficientnet_lite0')
GRID_ARRAYS = ('grid_resnet18', 'grid_vit') + tuple(
    f'grid_{cell}' for cell in GRID_CELLS)
GRID_DAG = {
    'train_resnet18': dict(_GRID_TRAIN, model_name='grid_resnet18',
                           model=_GRID_MODEL),
    'train_vit': dict(_GRID_TRAIN, model_name='grid_vit', model={
        'name': 'vit', 'num_classes': 10, 'cifar_stem': True,
        'dtype': 'bfloat16'}),
    **{f'train_{cell}': dict(_GRID_TRAIN, model_name=f'grid_{cell}',
                             model=dict(_GRID_MODEL, name=cell))
       for cell in GRID_CELLS},
    'infer_resnet18': {'type': 'infer_classify',
                       'model_name': 'grid_resnet18', 'tta': ['hflip'],
                       'dataset': _GRID_DATA, 'depends': 'train_resnet18'},
    'infer_vit_int8': {'type': 'infer_classify', 'model_name': 'grid_vit',
                       'y': "infer(tta=['hflip'], quantize='int8')",
                       'dataset': _GRID_DATA, 'depends': 'train_vit'},
    'infer_vit_bf16': {'type': 'infer_classify', 'name': 'grid_vit_bf16',
                       'y': "infer('grid_vit', tta=['hflip'])",
                       'dataset': _GRID_DATA, 'depends': 'train_vit'},
    **{f'infer_{cell}': {'type': 'infer_classify',
                         'model_name': f'grid_{cell}', 'tta': ['hflip'],
                         'dataset': _GRID_DATA, 'depends': f'train_{cell}'}
       for cell in GRID_CELLS},
    'valid_grid': {'type': 'valid_classify', 'dataset': _GRID_DATA,
                   'y': '(' + ' + '.join(
                       f"load('{a}')" for a in GRID_ARRAYS) + ') / '
                        f'{len(GRID_ARRAYS)}',
                   'depends': ['infer_resnet18', 'infer_vit_int8'] + [
                       f'infer_{cell}' for cell in GRID_CELLS]},
}
#: ``examples/segmentation/config.yml`` as the port runs it: ``type:
#: train`` for ``jax_train``; ``report_imgs`` dropped (report images need
#: the DB, ROADMAP.md A0); then ``valid_segment`` over the saved
#: predictions by iou and by dice
_SEG_DATA = {'name': 'synthetic_segmentation', 'n_train': 512,
             'n_valid': 64, 'image_size': 64, 'num_classes': 2}
SEGMENTATION_DAG = {
    'train': {'type': 'train', 'model': {
                  'name': 'fpn', 'encoder': 'resnet18', 'num_classes': 2,
                  'dtype': 'bfloat16', 'cifar_stem': True},
              'dataset': _SEG_DATA, 'loss': 'bce_dice', 'batch_size': 32,
              'main_metric': 'dice', 'model_name': 'seg_fpn',
              'stages': [{'name': 's1', 'epochs': 4, 'optimizer': {
                  'name': 'adam', 'lr': 0.001}}]},
    'infer': {'type': 'infer_classify', 'model_name': 'seg_fpn',
              'dataset': _SEG_DATA, 'activation': 'argmax',
              'depends': 'train'},
    **{f'valid_{metric}': {'type': 'valid_segment', 'dataset': _SEG_DATA,
                           'y': "load('seg_fpn')", 'metric': metric,
                           'depends': 'infer'}
       for metric in ('iou', 'dice')},
}
#: the saved predictions' accuracy against the trainer's validation
#: accuracy: 0.2 points (the trainer's eval step and the predictor run
#: the same bf16 forward; they differ in batching alone)
DAG_ACCURACY_POINTS = 0.2


def _dag_order(executors: dict) -> list:
    """The executors' names with each after its ``depends``."""
    order, seen = [], set()

    def visit(name, path=()):
        if name in seen:
            return
        if name in path:
            fail(f'depends cycle through {name!r}')
        deps = executors[name].get('depends') or []
        for dep in [deps] if isinstance(deps, str) else deps:
            visit(dep, path + (name,))
        seen.add(name)
        order.append(name)

    for name in executors:
        visit(name)
    return order


def _kernel_counters() -> dict:
    """Every kernel wrapper a DAG of this slice can launch, by name."""
    from mlcomp_tpu_torch.ops.fused_norm import (
        norm_act_backward_kernel, norm_act_forward,
    )
    from mlcomp_tpu_torch.ops.int8_matmul import int8_matmul
    return {**_flash_counters(), 'fused_norm': norm_act_forward,
            'fused_norm_bwd': norm_act_backward_kernel,
            'int8_matmul': int8_matmul}


class _Lines(logging.Handler):
    """A logging handler that keeps the messages it is given."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _train_losses(messages) -> list:
    """The train loss of each epoch from the executor's log lines."""
    return [float(m.group(1)) for m in (
        re.search(r"\] epoch \d+: train \{[^}]*'loss': ([^,}]+)", line)
        for line in messages) if m]


def _walk_dag(phase: str, executors: dict, work: str, seed: int) -> dict:
    """Run the executors of a DAG config on the card in ``work``, each
    after its ``depends``, through
    ``Executor.from_config(name, config)`` and ``executor(logger=...)``;
    every kernel's count zeroed just before each executor and read just
    after. Returns {name: {'result', 'seconds', 'launches', 'executor',
    'log'}}."""
    import gc
    from mlcomp_tpu_torch.worker.executors import Executor
    config = {'executors': {
        name: dict(spec, device='cuda', **(
            {'seed': spec.get('seed', 0) + seed,
             'checkpoint_dir': os.path.join(work, 'ck', name)}
            if spec['type'] == 'train' else {}))
        for name, spec in executors.items()}}
    counters = _kernel_counters()
    log = _train_logger()
    out = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for name in _dag_order(executors):
            executor = Executor.from_config(name, config)
            lines = _Lines()
            log.addHandler(lines)
            try:
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.monotonic()
                result = executor(logger=log)
                torch.cuda.synchronize()
                seconds = time.monotonic() - t0
                launches = {k: fn.launches for k, fn in counters.items()
                            if fn.launches}
            finally:
                log.removeHandler(lines)
            out[name] = {'result': result, 'seconds': seconds,
                         'launches': launches, 'executor': executor,
                         'log': lines.messages}
            say(phase, executor=name, type=executors[name]['type'],
                seconds=f'{seconds:.2f}', launches=launches,
                result={k: v for k, v in result.items()
                        if k in ('best_score', 'score', 'count', 'name')})
        return out
    finally:
        os.chdir(cwd)
        gc.collect()
        torch.cuda.empty_cache()


def _say_infer_rate(phase: str, name: str, run: dict, smi: str, views=1):
    n = run['result']['count']
    say(phase, infer=name, wall_s=f'{run["seconds"]:.3f}', images=n,
        views=views, images_per_s=f'{n / run["seconds"]:.1f}', card=smi)


def _accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    return float((preds.argmax(-1) == labels).mean())


def _check_probabilities(phase: str, preds: np.ndarray, n: int, k: int):
    sums = preds.sum(-1)
    if preds.shape != (n, k) or not np.isfinite(preds).all() \
            or float(np.abs(sums - 1).max()) > 1e-3:
        fail(f'{phase}: predictions of shape {preds.shape} (want '
             f'{(n, k)}), finite {bool(np.isfinite(preds).all())}, rows '
             f'summing to 1 within {float(np.abs(sums - 1).max())}')


def _check_points(phase: str, what: str, got: float, want: float):
    if not abs(got - want) * 100 <= DAG_ACCURACY_POINTS:
        fail(f'{phase}: {what} {got} is more than {DAG_ACCURACY_POINTS} '
             f'points from {want}')


def phase_dag_cifar10(seed: int, smi: str) -> dict:
    """``[dag-cifar10]``: ``examples/cifar10``'s train -> infer -> valid
    on the card (CIFAR10_DAG), then a fine-tune from its export
    (``model.params_file``) with ``infer_valid``. Returns the norm
    kernels' launches of the two trains."""
    from mlcomp_tpu_torch.convert import state_dict_from_jax
    from mlcomp_tpu_torch.train import pretrained
    from mlcomp_tpu_torch.train.data import create_dataset
    from mlcomp_tpu_torch.train.export import load_export

    phase = 'dag-cifar10'
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_dag_cifar10_')
    try:
        runs = _walk_dag(phase, CIFAR10_DAG, work, seed)
        train = runs['train']
        data = create_dataset(**CIFAR10_DAG['train']['dataset'])
        labels = data['y_valid']
        steps = len(data['x_train']) // CIFAR10_DAG['train']['batch_size']
        del data
        preds = np.load(os.path.join(work, 'data', 'pred',
                                     'cifar10_resnet18.npy'))
        _check_probabilities(phase, preds, len(labels), 10)
        accuracy = _accuracy(preds, labels)
        score = runs['valid']['result']['score']
        _say_infer_rate(phase, 'infer', runs['infer'], smi)
        say(phase, valid_score=score, preds_accuracy=accuracy,
            train_valid_accuracy=train['result']['best_score'],
            max_points=DAG_ACCURACY_POINTS)
        if score != accuracy:
            fail(f'{phase}: valid scored {score}, the saved predictions '
                 f'{accuracy}')
        _check_points(phase, 'the saved predictions\' accuracy', accuracy,
                      train['result']['best_score'])

        # the fine-tune: the same train spec from the export, in a fresh
        # checkpoint directory (_walk_dag's ck/<name>), exported under its
        # own name so the file it starts from stays as it was
        export = os.path.join(work, 'models', 'cifar10_resnet18')
        ft_spec = dict(CIFAR10_DAG['train'], model_name='cifar10_ft',
                       infer_valid={'out_prefix': 'cifar10_ft'},
                       model=dict(CIFAR10_DAG['train']['model'],
                                  params_file='models/cifar10_resnet18'))
        seen = {}
        apply = pretrained.apply_pretrained

        def apply_and_keep(state, params_file):
            state, summary = apply(state, params_file)
            seen['summary'] = summary
            seen['state'] = {k: v.detach().cpu().clone()
                             for k, v in state.model.state_dict().items()}
            return state, summary

        pretrained.apply_pretrained = apply_and_keep
        try:
            ft = _walk_dag(phase, {'finetune': ft_spec}, work, seed)
        finally:
            pretrained.apply_pretrained = apply
        ft = ft['finetune']
        summary = seen.get('summary')
        if summary is None:
            fail(f'{phase}: the fine-tune applied no pretrained weights')
        want = state_dict_from_jax(load_export(export)[0], 'resnet18')
        equal = want.keys() == seen['state'].keys() and all(
            torch.equal(want[k], seen['state'][k]) for k in want)
        ft_preds = np.load(os.path.join(work, 'data', 'pred',
                                        'cifar10_ft.npy'))
        _check_probabilities(phase, ft_preds, len(labels), 10)
        ft_accuracy = _accuracy(ft_preds, labels)
        losses = (_train_losses(train['log']), _train_losses(ft['log']))
        say(phase, finetune=str(summary), starts_at_export=equal,
            leaves=len(want), infer_valid_accuracy=ft_accuracy,
            best_score=ft['result']['best_score'],
            first_epoch_loss_scratch=losses[0][:1],
            first_epoch_loss_finetune=losses[1][:1])
        if summary.reinit or summary.missing \
                or len(summary.loaded) != len(want):
            fail(f'{phase}: the fine-tune loaded {summary}, not every leaf')
        if not equal:
            fail(f'{phase}: the fine-tune\'s state before its first step '
                 f'is not the export')
        _check_points(phase, 'infer_valid\'s accuracy', ft_accuracy,
                      ft['result']['best_score'])
        launches = {'dag_cifar10_train': train['launches'],
                    'dag_cifar10_finetune': ft['launches']}
        for path, counts in launches.items():
            for name in ('fused_norm', 'fused_norm_bwd'):
                if counts.get(name) != 20 * steps:
                    fail(f'{phase}: {path} launched {counts.get(name)} '
                         f'{name}, expected {20 * steps} (20 norm sites '
                         f'per train step, none in eval)')
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_dag_ensemble(seed: int, smi: str) -> dict:
    """``[dag-ensemble]``: (a) ``examples/ensemble`` verbatim on the card,
    (b) ``encoder_grid``'s six cells trained, inferred (the ViT through
    the flash and int8 kernels) and ensembled. Returns each kernel's
    launches by path."""
    from mlcomp_tpu_torch.train.data import create_dataset
    from mlcomp_tpu_torch.train.export import load_export, quantized_modules

    phase = 'dag-ensemble'
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_dag_ensemble_')
    try:
        pred = os.path.join(work, 'data', 'pred')
        runs = _walk_dag(phase, ENSEMBLE_DAG, work, seed)
        labels = create_dataset(**_ENS_DATA)['y_valid']
        mean = (np.load(os.path.join(pred, 'a.npy'))
                + np.load(os.path.join(pred, 'b.npy'))) / 2
        score = runs['valid_ens']['result']['score']
        say(phase, part='a', valid_score=score,
            mean_accuracy=_accuracy(mean, labels))
        if score != _accuracy(mean, labels):
            fail(f'{phase}: valid_ens scored {score}, the mean of the saved '
                 f'predictions {_accuracy(mean, labels)}')

        runs = _walk_dag(phase, GRID_DAG, work, seed)
        labels = create_dataset(**_GRID_DATA)['y_valid']
        n = len(labels)
        int8_run = runs['infer_vit_int8']
        predict = next(iter(int8_run['executor']._predictors.values()))
        want_q = len(quantized_modules(load_export(
            os.path.join(work, 'models', 'grid_vit'))[0]['params']))
        layers, views = 6, 2
        batches = -(-n // 512)
        steps = _GRID_DATA['n_train'] // _GRID_TRAIN['batch_size']
        valid = -(-_GRID_DATA['n_valid'] // _GRID_TRAIN['batch_size'])
        for name in ('infer_resnet18', 'infer_vit_int8', 'infer_vit_bf16'):
            _say_infer_rate(phase, name, runs[name], smi, views=views)
        say(phase, part='b', quantized=predict.quantized,
            quantized_modules=want_q)
        if predict.quantized != want_q or want_q <= 0:
            fail(f'{phase}: the int8 predictor swapped {predict.quantized} '
                 f'modules, quantized_modules counts {want_q}')
        _check_launches(f'{phase} train_resnet18',
                        runs['train_resnet18']['launches'],
                        {'fused_norm': 20 * steps,
                         'fused_norm_bwd': 20 * steps})
        _check_launches(f'{phase} train_vit', runs['train_vit']['launches'],
                        {'flash_attention_fwd': layers * (steps + valid),
                         'flash_attention_bwd_dq': layers * steps,
                         'flash_attention_bwd_dkv': layers * steps})
        _check_launches(f'{phase} infer_vit_int8', int8_run['launches'],
                        {'flash_attention_fwd': layers * batches * views,
                         'int8_matmul': want_q * batches * views})
        _check_launches(f'{phase} infer_vit_bf16',
                        runs['infer_vit_bf16']['launches'],
                        {'flash_attention_fwd': layers * batches * views})
        for cell in GRID_CELLS:
            train = runs[f'train_{cell}']
            images = _GRID_DATA['n_train']      # one epoch
            say(phase, cell=cell, train_s=f'{train["seconds"]:.2f}',
                train_images_per_s=f'{images / train["seconds"]:.1f}',
                params=train['result']['n_params'],
                best_accuracy=train['result']['best_score'], card=smi)
            _say_infer_rate(phase, f'infer_{cell}', runs[f'infer_{cell}'],
                            smi, views=views)
            if runs[f'train_{cell}']['launches'] \
                    or runs[f'infer_{cell}']['launches']:
                fail(f'{phase}: the {cell} cell launched a kernel of the '
                     f'port\'s; its path has none')
        q8 = np.load(os.path.join(pred, 'grid_vit.npy'))
        bf16 = np.load(os.path.join(pred, 'grid_vit_bf16.npy'))
        arrays = [np.load(os.path.join(pred, f'{a}.npy'))
                  for a in GRID_ARRAYS]
        for arr in arrays + [bf16]:
            _check_probabilities(phase, arr, n, 10)
        _compare_rows(phase, torch.from_numpy(q8), torch.from_numpy(bf16),
                      int8='quantize=int8', plain='bf16 infer')
        # the equation's order: the sum left to right, then the division
        total = arrays[0]
        for arr in arrays[1:]:
            total = total + arr
        mean = total / len(arrays)
        score = runs['valid_grid']['result']['score']
        say(phase, part='b', valid_score=score, arrays=len(arrays),
            mean_accuracy=_accuracy(mean, labels),
            **{f'{a[len("grid_"):]}_accuracy': _accuracy(arr, labels)
               for a, arr in zip(GRID_ARRAYS, arrays)})
        if score != _accuracy(mean, labels):
            fail(f'{phase}: valid_grid scored {score}, the mean of the '
                 f'{len(arrays)} saved predictions {_accuracy(mean, labels)}')
        return {'dag_ensemble_train': {
                    **runs['train_resnet18']['launches'],
                    **runs['train_vit']['launches']},
                'dag_ensemble_infer_vit_int8': int8_run['launches'],
                'dag_ensemble_infer_vit': runs['infer_vit_bf16']['launches']}
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


def _valid_metric(messages, metric: str) -> list:
    """The validation ``metric`` of each epoch from the executor's log."""
    return [float(m.group(1)) for m in (
        re.search(r"\] epoch \d+: train \{[^}]*\} valid \{[^}]*'"
                  + metric + r"': ([^,}]+)", line) for line in messages) if m]


def phase_dag_segmentation(seed: int, smi: str):
    """``[dag-segmentation]``: ``examples/segmentation``'s train -> infer
    (argmax) on the card, then ``valid_segment`` by iou and by dice over
    the saved predictions."""
    from mlcomp_tpu_torch.contrib.metrics import dice_numpy, iou_numpy
    from mlcomp_tpu_torch.train.data import create_dataset

    phase = 'dag-segmentation'
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_dag_segmentation_')
    try:
        runs = _walk_dag(phase, SEGMENTATION_DAG, work, seed)
        masks = create_dataset(**_SEG_DATA)['y_valid']
        preds = np.load(os.path.join(work, 'data', 'pred', 'seg_fpn.npy'))
        want = (_SEG_DATA['n_valid'], _SEG_DATA['image_size'],
                _SEG_DATA['image_size'])
        if preds.shape != want or preds.dtype != np.int32:
            fail(f'{phase}: argmax predictions {preds.shape} '
                 f'{preds.dtype}, expected {want} int32')
        truth, picked = masks > 0, preds > 0
        scores = {'iou': iou_numpy(truth, picked),
                  'dice': dice_numpy(truth, picked)}
        train = runs['train']
        losses = _train_losses(train['log'])
        dice = _valid_metric(train['log'], 'dice')
        _say_infer_rate(phase, 'infer', runs['infer'], smi)
        images = len(losses) * _SEG_DATA['n_train']
        say(phase, train_s=f'{train["seconds"]:.2f}',
            train_images_per_s=f'{images / train["seconds"]:.1f}',
            params=train['result']['n_params'],
            epoch_train_loss=[f'{v:.4f}' for v in losses],
            final_valid_dice=dice[-1:],
            best_dice=train['result']['best_score'],
            **{f'valid_{m}': runs[f'valid_{m}']['result']['score']
               for m in scores},
            **{f'numpy_{m}': v for m, v in scores.items()}, card=smi)
        for metric, value in scores.items():
            got = runs[f'valid_{metric}']['result']['score']
            if got != value:
                fail(f'{phase}: valid_segment scored {metric} {got}, the '
                     f'saved predictions {value}')
        if len(losses) != 4 or not losses[-1] < losses[0]:
            fail(f'{phase}: the train loss by epoch {losses} did not fall')
        if any(run['launches'] for run in runs.values()):
            fail(f'{phase}: a kernel of the port\'s was launched; this '
                 f'path has none')
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


#: ``[cli]``'s configs, run as the repository holds them
CLI_CIFAR = os.path.join('examples', 'cifar_simple', 'config.yml')
CLI_GRID = os.path.join('examples', 'encoder_grid', 'config.yml')
#: both configs' epochs; ``cifar_simple``'s steps an epoch (8192 images,
#: batch 256), ``encoder_grid``'s (4096, batch 256) and valid batches
#: (512 images)
CLI_EPOCHS, CLI_CIFAR_STEPS = 2, 32
CLI_GRID_STEPS, CLI_GRID_VALID = 16, 2


def _cli_rows(db: str, dag_id: int) -> dict:
    """The DB rows of one dag the CLI left, read with stdlib sqlite3:
    {task name: {'task', 'steps', 'logs', 'series', 'spans'}}, plus the
    dag's stored files under ``None``."""
    import sqlite3
    conn = sqlite3.connect(db)
    conn.row_factory = sqlite3.Row
    try:
        out = {None: [dict(r) for r in conn.execute(
            'SELECT s.path, f.md5 FROM dag_storage s JOIN file f '
            'ON s.file = f.id WHERE s.dag=?', (dag_id,))]}
        for task in conn.execute('SELECT * FROM task WHERE dag=? '
                                 'ORDER BY id', (dag_id,)):
            tid = task['id']
            out[task['name']] = {
                'task': dict(task),
                'steps': [dict(r) for r in conn.execute(
                    'SELECT * FROM step WHERE task=? ORDER BY id', (tid,))],
                'logs': conn.execute('SELECT COUNT(*) FROM log WHERE '
                                     'task=?', (tid,)).fetchone()[0],
                'series': [dict(r) for r in conn.execute(
                    'SELECT name, part, stage, epoch, value FROM '
                    'report_series WHERE task=? ORDER BY id', (tid,))],
                'spans': conn.execute('SELECT COUNT(*) FROM telemetry_span '
                                      'WHERE task=?', (tid,)).fetchone()[0]}
        return out
    finally:
        conn.close()


def _dag_ids(db: str) -> list:
    """The ids of the dags in the sqlite DB at ``db``, in order."""
    import sqlite3
    conn = sqlite3.connect(db)
    try:
        return [r[0] for r in conn.execute('SELECT id FROM dag ORDER BY id')]
    finally:
        conn.close()


def _check_cli_task(phase: str, name: str, rows: dict):
    """A train task the CLI ran: Success, its step tree and logs, and a
    finite train and valid loss and an images/s series each epoch."""
    from mlcomp_tpu_torch.db.enums import TaskStatus
    task = rows['task']
    if task['status'] != int(TaskStatus.Success):
        fail(f'{phase}: task {name!r} ended in status {task["status"]} '
             f'({task["failure_reason"]})')
    levels = sorted({s['level'] for s in rows['steps']})
    if levels != [1, 2] or rows['logs'] <= 0 or rows['spans'] <= 0:
        fail(f'{phase}: task {name!r} left steps at levels {levels}, '
             f'{rows["logs"]} log rows, {rows["spans"]} spans')
    for part in ('train', 'valid'):
        losses = [r['value'] for r in rows['series']
                  if r['name'] == 'loss' and r['part'] == part]
        if len(losses) != CLI_EPOCHS or not all(np.isfinite(losses)):
            fail(f'{phase}: task {name!r} {part} losses {losses}, want '
                 f'{CLI_EPOCHS} finite')
    rates = [r['value'] for r in rows['series']
             if r['name'] == 'images_per_sec']
    if len(rates) != CLI_EPOCHS:
        fail(f'{phase}: task {name!r} images_per_sec series {rates}')


def phase_cli(smi: str) -> dict:
    """``[cli]``: the repository's YAML DAGs through the port's command
    line and its sqlite DB. (a) ``init`` and ``execute
    examples/cifar_simple/config.yml --params model/norm:fused`` as
    processes, the DB read back; (b) ``execute
    examples/encoder_grid/config.yml`` and the CIFAR one again through
    the CLI's ``main`` in this process, every kernel's count zeroed just
    before and read just after; (c) each task's wall seconds and
    images/s. Returns the kernels' launches by path."""
    from datetime import datetime
    from mlcomp_tpu_torch import DB_FOLDER, MODEL_FOLDER
    from mlcomp_tpu_torch.__main__ import main as cli_main
    from mlcomp_tpu_torch.db.core import Session

    phase = 'cli'
    db = os.path.join(DB_FOLDER, 'sqlite.db')
    cifar = ['execute', CLI_CIFAR, '--params', 'model/norm:fused']
    links = [os.path.join(HERE, os.path.dirname(cfg), name)
             for cfg in (CLI_CIFAR, CLI_GRID) for name in ('data', 'models')]
    known = set()

    def new_dag(what: str) -> int:
        """The one dag the last run created."""
        ids = [i for i in _dag_ids(db) if i not in known]
        if len(ids) != 1:
            fail(f'{phase}: {what} created dags {ids}, want one')
        known.update(ids)
        return ids[0]

    def run_cli(argv: list) -> str:
        """``python -m mlcomp_tpu_torch *argv`` as a process; its last
        line."""
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, '-m', 'mlcomp_tpu_torch', *argv], cwd=HERE,
            capture_output=True, text=True, timeout=900)
        seconds = time.monotonic() - t0
        last = (proc.stdout.strip().splitlines() or [''])[-1]
        say(phase, part='a', command=' '.join(argv), rc=proc.returncode,
            seconds=f'{seconds:.2f}', last_line=last)
        if proc.returncode != 0:
            fail(f'{phase}: {" ".join(argv)} exited {proc.returncode}:\n'
                 f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
        return last

    try:
        # (a) the entry point as a process
        run_cli(['init'])
        known.update(_dag_ids(db))
        last = run_cli(cifar)
        if json.loads(last) != {'train': 'Success'}:
            fail(f'{phase}: cifar_simple ended {last}')
        dag_ids = [new_dag('cifar_simple')]
        rows = _cli_rows(db, dag_ids[0])
        _check_cli_task(phase, 'train', rows['train'])
        export = os.path.join(MODEL_FOLDER, 'cifar_simple', 'cifar_resnet18')
        if not os.path.exists(export + '.msgpack') \
                or [f['path'] for f in rows[None]] != ['config.yml']:
            fail(f'{phase}: export {export} or the stored code '
                 f'{rows[None]} missing')
        say(phase, part='a', steps=len(rows['train']['steps']),
            logs=rows['train']['logs'], spans=rows['train']['spans'],
            series=len(rows['train']['series']), files=rows[None],
            export=export + '.msgpack')

        # (b) launches, counted in this process
        counters = _kernel_counters()
        launches, statuses = {}, {}
        for path, argv in (
                ('cli_cifar', ['execute', os.path.join(HERE, CLI_CIFAR),
                               *cifar[2:]]),
                ('cli_grid', ['execute', os.path.join(HERE, CLI_GRID)])):
            for fn in counters.values():
                fn.launches = 0
            t0 = time.monotonic()
            statuses[path] = cli_main(argv)
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            dag_ids.append(new_dag(path))
            launches[path] = {k: fn.launches for k, fn in counters.items()
                              if fn.launches}
            say(phase, part='b', path=path, seconds=f'{seconds:.2f}',
                launches=launches[path], statuses=statuses[path])
        Session.cleanup()
        if statuses['cli_cifar'] != {'train': 'Success'} or \
                len(statuses['cli_grid']) != 6 or any(
                    s != 'Success' for s in statuses['cli_grid'].values()):
            fail(f'{phase}: statuses {statuses}')
        norm = 20 * CLI_CIFAR_STEPS * CLI_EPOCHS
        _check_launches(f'{phase} cifar_simple', launches['cli_cifar'],
                        {'fused_norm': norm, 'fused_norm_bwd': norm})
        layers = 6
        steps = CLI_GRID_STEPS * CLI_EPOCHS
        _check_launches(f'{phase} encoder_grid', launches['cli_grid'], {
            'flash_attention_fwd':
                layers * (CLI_GRID_STEPS + CLI_GRID_VALID) * CLI_EPOCHS,
            'flash_attention_bwd_dq': layers * steps,
            'flash_attention_bwd_dkv': layers * steps})

        # (c) numbers: each task's wall seconds and images/s
        for dag_id in dag_ids:
            for name, rows in _cli_rows(db, dag_id).items():
                if name is None:
                    continue
                _check_cli_task(phase, name, rows)
                task = rows['task']
                wall = (datetime.fromisoformat(task['finished'])
                        - datetime.fromisoformat(task['started']))
                rates = [r['value'] for r in rows['series']
                         if r['name'] == 'images_per_sec']
                say(phase, part='c', dag=dag_id, task=name,
                    wall_s=f'{wall.total_seconds():.2f}',
                    images_per_s=' '.join(f'{r:.1f}' for r in rates),
                    best_accuracy=task['score'], card=smi)
        return {'cli': {**launches['cli_cifar'], **launches['cli_grid']}}
    finally:
        for link in links:
            if os.path.islink(link):
                os.remove(link)


# ------------------------------------------------------------ the scheduler
#: seconds ``[sched]`` waits for the daemons' task to reach Success
SCHED_TIMEOUT_S = 600
#: ``[sched]`` (b)'s ticks at most: each dispatches what is runnable,
#: then the in-process worker drains the queue
SCHED_TICKS = 10


def _seconds(later: str, earlier: str) -> float:
    from datetime import datetime
    return (datetime.fromisoformat(later)
            - datetime.fromisoformat(earlier)).total_seconds()


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors='replace') as fh:
        return fh.read()[-n:]


def phase_sched(smi: str) -> dict:
    """``[sched]``: a DAG submitted with ``dag`` runs to Success through
    the port's supervisor tick, its DB queue and a worker daemon, with
    no ``execute``. (a) As processes: ``init``, then ``worker-supervisor``
    and ``worker 0`` (a ``run-task`` process per task) as child
    processes, the supervisor loop (``register_supervisor(ha=False)``)
    in this process, and, once the host agent heartbeats, ``dag
    examples/cifar_simple/config.yml --params model/norm:fused`` as a
    process; the task's rows, its queue message
    (``done``, claimed by ``<host>:0``), the computer row and its
    heartbeat read back; the times from the dag row and from the
    command's return to Queued (the latter the dispatch), Queued to
    claim and to InProgress, the task's own wall and its
    process's. (b) In this process: ``dag`` of that config and of
    ``examples/encoder_grid/config.yml``, driven by supervisor ticks and
    ``_consume_one(..., in_process=True)``, every kernel's count zeroed
    just before and read just after; the CIFAR task asks for one card
    (``executors/train/cores:1``), so the tick places it on the card's
    slot (``cores_assigned`` ``[0]``) and the in-process worker, whose
    CUDA already runs, makes that card the current device; every task
    Success, the computer row's card usage written. Returns the kernels'
    launches by path."""
    import signal
    from mlcomp_tpu_torch import DB_FOLDER, DOCKER_IMG
    from mlcomp_tpu_torch.__main__ import main as cli_main
    from mlcomp_tpu_torch.db.core import Session
    from mlcomp_tpu_torch.db.enums import TaskStatus
    from mlcomp_tpu_torch.db.providers import DockerProvider, QueueProvider
    from mlcomp_tpu_torch.server.supervisor import (
        SupervisorBuilder, register_supervisor,
    )
    from mlcomp_tpu_torch.utils.logging import create_logger
    from mlcomp_tpu_torch.utils.misc import hostname, now as utc_now
    import mlcomp_tpu_torch.worker.__main__ as worker_main

    phase = 'sched'
    db = os.path.join(DB_FOLDER, 'sqlite.db')
    host = hostname()
    finished = {int(s) for s in TaskStatus.finished()}
    work = tempfile.mkdtemp(prefix='sched_')
    daemons, loop = {}, None

    def new_dags(known: set, want: int) -> list:
        ids = [i for i in _dag_ids(db) if i not in known]
        if len(ids) != want:
            fail(f'{phase}: the submit created dags {ids}, want {want}')
        return ids

    def check_daemons():
        for name, (proc, log) in daemons.items():
            if proc.poll() is not None:
                fail(f'{phase}: {name} exited {proc.returncode}:\n'
                     f'{_tail(log)}')

    def stop_daemons():
        # each daemon leads a process group of its own: a run-task
        # process left by a dead worker goes with it
        for proc, _ in daemons.values():
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        for proc, _ in daemons.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)

    try:
        # (a) the daemons as processes
        t0 = time.monotonic()
        init = subprocess.run(
            [sys.executable, '-m', 'mlcomp_tpu_torch', 'init'], cwd=HERE,
            capture_output=True, text=True, timeout=300)
        if init.returncode != 0:
            fail(f'{phase}: init exited {init.returncode}:\n'
                 f'{init.stdout[-2000:]}\n{init.stderr[-2000:]}')
        for name, argv in (('worker-supervisor', ['worker-supervisor']),
                           ('worker', ['worker', '0'])):
            log = os.path.join(work, f'{name}.log')
            with open(log, 'w') as out:
                proc = subprocess.Popen(
                    [sys.executable, '-m', 'mlcomp_tpu_torch.worker',
                     *argv], cwd=HERE, stdout=out,
                    stderr=subprocess.STDOUT, start_new_session=True)
            daemons[name] = (proc, log)
        session = Session.create_session(key='sched')
        _, (loop,) = register_supervisor(
            session=session, logger=create_logger(session), ha=False)
        # the host agent's first heartbeat makes the queue live: it
        # comes after the card count (a subprocess that starts CUDA).
        # Submitting before it would time the agent's start-up as
        # dispatch
        deadline = time.monotonic() + 120
        while session.query_one(
                'SELECT 1 FROM docker WHERE computer=? AND name=?',
                (host, DOCKER_IMG)) is None:
            check_daemons()
            if time.monotonic() > deadline:
                fail(f'{phase}: no heartbeat from worker-supervisor:\n'
                     f'{_tail(daemons["worker-supervisor"][1])}')
            time.sleep(0.1)
        agent_s = time.monotonic() - t0
        known = set(_dag_ids(db))
        submit = subprocess.run(
            [sys.executable, '-m', 'mlcomp_tpu_torch', 'dag', CLI_CIFAR,
             '--params', 'model/norm:fused'], cwd=HERE,
            capture_output=True, text=True, timeout=300)
        # the DB's clock (naive UTC): the dag command writes its task
        # rows last, just before it returns
        returned = str(utc_now())
        if submit.returncode != 0:
            fail(f'{phase}: dag exited {submit.returncode}:\n'
                 f'{submit.stdout[-2000:]}\n{submit.stderr[-2000:]}')
        (dag_id,) = new_dags(known, 1)
        (task_id,) = [r['id'] for r in session.query(
            'SELECT id FROM task WHERE dag=?', (dag_id,))]
        deadline = time.monotonic() + SCHED_TIMEOUT_S
        while True:
            check_daemons()
            task = session.query_one('SELECT * FROM task WHERE id=?',
                                     (task_id,))
            # the worker completes the message once run-task has exited,
            # after the process wrote Success
            success = task['status'] == int(TaskStatus.Success)
            if success and session.query_one(
                    'SELECT status FROM queue_message WHERE id=?',
                    (task['queue_id'],))[0] != 'claimed':
                break
            if (task['status'] in finished and not success) \
                    or time.monotonic() > deadline:
                fail(f'{phase}: task {task_id} in status {task["status"]} '
                     f'({task["failure_reason"]}) after '
                     f'{time.monotonic() - t0:.0f} s; worker log:\n'
                     f'{_tail(daemons["worker"][1])}')
            time.sleep(0.5)
        phase_a_s = time.monotonic() - t0
        # the host agent's first usage sample lands WORKER_USAGE_INTERVAL
        # (10 s) after its start
        deadline = time.monotonic() + 30
        while not session.query_one(
                'SELECT usage FROM computer WHERE name=?', (host,))[0] \
                and time.monotonic() < deadline:
            time.sleep(0.5)
        check_daemons()
        loop.stop()
        loop.join(timeout=30)
        stop_daemons()
        rows = _cli_rows(db, dag_id)
        _check_cli_task(phase, 'train', rows['train'])
        msg = session.query_one('SELECT * FROM queue_message WHERE id=?',
                                (task['queue_id'],))
        dag = session.query_one('SELECT * FROM dag WHERE id=?', (dag_id,))
        computer = session.query_one(
            'SELECT * FROM computer WHERE name=?', (host,))
        beat = session.query_one(
            'SELECT * FROM docker WHERE computer=? AND name=?',
            (host, DOCKER_IMG))
        exited = session.query_one(
            "SELECT message FROM log WHERE task=? AND message LIKE "
            "'%run-task process exited%'", (task_id,))
        if msg['status'] != 'done' or msg['claimed_by'] != f'{host}:0' \
                or task['computer_assigned'] != host:
            fail(f'{phase}: message {dict(msg)}, task on '
                 f'{task["computer_assigned"]}, want done by {host}:0')
        usage = json.loads(computer['usage'] or '{}')
        if not {'cpu', 'memory', 'disk'} <= set(usage) or beat is None \
                or exited is None:
            fail(f'{phase}: computer usage {usage}, heartbeat '
                 f'{beat and dict(beat)}, process log {exited}')
        process_s = float(re.search(r'after ([\d.]+) s',
                                    exited['message']).group(1))
        say(phase, part='a', dag=dag_id, task=task_id,
            computer=host, cores=computer['cores'],
            cores_assigned=task['cores_assigned'],
            message=msg['status'], claimed_by=msg['claimed_by'],
            steps=len(rows['train']['steps']),
            spans=rows['train']['spans'],
            series=len(rows['train']['series']),
            heartbeat=beat['last_activity'],
            submit_to_queued_s=(
                f'{_seconds(msg["created"], dag["created"]):.3f}'),
            dispatch_s=f'{_seconds(msg["created"], returned):.3f}',
            claim_s=f'{_seconds(msg["claimed_at"], msg["created"]):.3f}',
            queued_to_inprogress_s=(
                f'{_seconds(task["started"], msg["created"]):.3f}'),
            task_wall_s=f'{_seconds(task["finished"], task["started"]):.2f}',
            process_wall_s=f'{process_s:.2f}',
            agent_ready_s=f'{agent_s:.2f}', phase_s=f'{phase_a_s:.2f}',
            card=smi)

        # (b) in this process, the launches counted
        counters = _kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        known = set(_dag_ids(db))
        cli_main(['dag', os.path.join(HERE, CLI_CIFAR), '--params',
                  'model/norm:fused', '--params', 'executors/train/cores:1'])
        cli_main(['dag', os.path.join(HERE, CLI_GRID)])
        dag_ids = new_dags(known, 2)
        marks = ','.join('?' * len(dag_ids))
        builder = SupervisorBuilder(session=session)
        queue, logger = QueueProvider(session), create_logger(session)
        docker = DockerProvider(session)
        for tick in range(SCHED_TICKS):
            docker.heartbeat(host, DOCKER_IMG)  # the agent is stopped
            builder.build()
            while worker_main._consume_one(session, queue, logger, 0,
                                           in_process=True):
                docker.heartbeat(host, DOCKER_IMG)
            tasks = session.query(f'SELECT * FROM task WHERE dag IN '
                                  f'({marks}) ORDER BY id', tuple(dag_ids))
            if all(t['status'] in finished for t in tasks):
                break
        torch.cuda.synchronize()
        phase_b_s = time.monotonic() - t0
        launches = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        bad = [(t['name'], t['status'], t['failure_reason'])
               for t in tasks if t['status'] != int(TaskStatus.Success)]
        if len(tasks) != 7 or bad:
            fail(f'{phase}: {len(tasks)} tasks after {tick + 1} ticks, '
                 f'not Success: {bad}')
        placed = {t['dag']: t['cores_assigned'] for t in tasks}
        if json.loads(placed[dag_ids[0]] or '[]') != [0] \
                or torch.cuda.current_device() != 0:
            fail(f'{phase}: the one-card CIFAR task got cards '
                 f'{placed[dag_ids[0]]}, current device '
                 f'{torch.cuda.current_device()}; want [0] and 0')
        for t in tasks:
            say(phase, part='b', dag=t['dag'], task=t['name'],
                wall_s=f'{_seconds(t["finished"], t["started"]):.2f}',
                best_accuracy=t['score'], card=smi)
        card = json.loads(session.query_one(
            'SELECT usage FROM computer WHERE name=?',
            (host,))['usage']).get('tpu')
        if not card:
            fail(f'{phase}: the in-process worker wrote no card usage')
        norm = 20 * CLI_CIFAR_STEPS * CLI_EPOCHS
        layers, steps = 6, CLI_GRID_STEPS * CLI_EPOCHS
        _check_launches(phase, launches, {
            'fused_norm': norm, 'fused_norm_bwd': norm,
            'flash_attention_fwd':
                layers * (CLI_GRID_STEPS + CLI_GRID_VALID) * CLI_EPOCHS,
            'flash_attention_bwd_dq': layers * steps,
            'flash_attention_bwd_dkv': layers * steps})
        say(phase, part='b', ticks=tick + 1, tasks=len(tasks),
            cifar_cores_assigned=placed[dag_ids[0]],
            cuda_visible_devices=os.environ.get('CUDA_VISIBLE_DEVICES'),
            launches=launches, card_usage=card[0],
            phase_s=f'{phase_b_s:.2f}', card=smi)
        return {'sched': launches}
    finally:
        if loop is not None:
            loop.stop()
        stop_daemons()
        Session.cleanup()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ the site
#: ``[site]`` (a)'s epochs: ``cifar_simple``'s 2 raised, so that its task
#: can be stopped after the first epoch's checkpoint and before its last
#: epoch ends (``--params`` reaches no list item, so the stage's count is
#: raised in a copy of the config)
SITE_EPOCHS = 6
#: seconds ``[site]`` waits for any one of its steps
SITE_TIMEOUT_S = 300


def _api(port, path, data=None, method='POST', token=None):
    """(status, JSON or text) of one request to the site."""
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}',
        data=None if method == 'GET' else json.dumps(data or {}).encode(),
        headers={'Authorization': token} if token else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, raw = resp.status, resp.read()
            ctype = resp.headers.get('Content-Type', '')
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers.get(
            'Content-Type', '')
    return status, json.loads(raw) if 'json' in ctype else raw.decode()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _port_processes() -> dict:
    """pid → command line of every live process of the port's server and
    worker commands on this machine, this one aside."""
    from mlcomp_tpu_torch.utils import procfs
    out = {}
    for pid in procfs.process_pids():
        cmd = procfs.process_cmdline(pid)
        if pid != os.getpid() and procfs.pid_exists(pid) and (
                'mlcomp_tpu_torch.server' in cmd
                or 'mlcomp_tpu_torch.worker' in cmd):
            out[pid] = cmd
    return out


def _maps_libcuda(pid: int) -> bool:
    """Whether process ``pid`` has mapped the CUDA driver library, as
    every process that holds a CUDA context has."""
    try:
        with open(f'/proc/{pid}/maps') as fh:
            return 'libcuda.so' in fh.read()
    except OSError:
        return False


def _compute_apps() -> list:
    """The pids ``nvidia-smi`` lists as holding a context on a card."""
    out = subprocess.run(
        ['nvidia-smi', '--query-compute-apps=pid', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    return [int(p) for p in out.stdout.split() if p.strip().isdigit()]


def _wait_for(phase: str, what: str, probe, check=None,
              timeout: float = SITE_TIMEOUT_S, interval: float = 0.1):
    """Poll ``probe()`` until it returns something true, and return it;
    ``check()`` runs between polls (it fails the run itself)."""
    deadline = time.monotonic() + timeout
    while True:
        got = probe()
        if got:
            return got
        if check is not None:
            check()
        if time.monotonic() > deadline:
            fail(f'{phase}: no {what} after {timeout:.0f} s')
        time.sleep(interval)


def phase_site(smi: str) -> dict:
    """``[site]``: the port's site, started the documented way, trains a
    DAG, stops its task and resumes it through the JSON API.

    (a) Through processes: ``python -m mlcomp_tpu_torch.server start 1``
    on a free port (``start-site`` with the HA supervisor,
    ``worker-supervisor``, ``worker 0``); once ``/api/token`` answers
    and the host agent heartbeats, ``dag`` of ``cifar_simple`` (``--params
    model/norm:fused``, its epochs raised to ``SITE_EPOCHS``) as a
    process; ``/api/tasks`` polled until the first epoch's checkpoint is
    on disk, then ``/api/task/stop``: the task Stopped, its ``run-task``
    process gone, before its last epoch; ``/api/dag/start`` resets it
    with ``resume``, the site's supervisor re-dispatches it and the
    worker resumes it from that checkpoint (the "resumed from
    checkpoint" log row, the epoch series after the restart) through
    the epochs left to Success. Then ``/api/graph``, ``GET /``, ``GET
    /metrics`` (parsed; the task counts those of the rows),
    ``/api/auxiliary``; the lease held by the site at an epoch >= 1;
    no site process mapping the CUDA driver or listed by ``nvidia-smi
    --query-compute-apps``; SIGTERM to the site, whose lease is
    released, the group restarting it, the new site taking the lease
    at the next epoch; ``server stop`` leaving no process of the
    group. (b) In this process: ``start_server(background=True)`` with
    the HA supervisor, ``dag`` of ``cifar_simple`` as written and the
    worker's in-process consume: Success with 1280 launches of each norm
    kernel, the card's memory in ``/api/computers``; then the task
    marked Failed, ``/api/dag/start`` and the consume again: the resume
    finds every epoch done, ``samples_per_sec`` 0 and no launch. Returns
    (b)'s launches."""
    import signal
    from mlcomp_tpu_torch import DB_FOLDER, DOCKER_IMG, TASK_FOLDER, TOKEN
    from mlcomp_tpu_torch.__main__ import main as cli_main
    from mlcomp_tpu_torch.db.core import Session
    from mlcomp_tpu_torch.db.enums import TaskStatus
    from mlcomp_tpu_torch.db.providers import (
        DockerProvider, QueueProvider, TaskProvider,
    )
    from mlcomp_tpu_torch.server.api import start_server
    from mlcomp_tpu_torch.telemetry.export import parse_openmetrics
    from mlcomp_tpu_torch.utils import procfs
    from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
    from mlcomp_tpu_torch.utils.logging import create_logger
    from mlcomp_tpu_torch.utils.misc import (
        hostname, now as utc_now, to_snake,
    )
    import mlcomp_tpu_torch.worker.__main__ as worker_main

    phase = 'site'
    db = os.path.join(DB_FOLDER, 'sqlite.db')
    host = hostname()
    finished = {int(s) for s in TaskStatus.finished()}
    work = tempfile.mkdtemp(prefix='site_')
    group_log = os.path.join(work, 'group.log')
    group, server = None, None
    on_term = signal.getsignal(signal.SIGTERM)

    def seconds_since(t0: float) -> str:
        return f'{time.monotonic() - t0:.3f}'

    def group_alive():
        if group.poll() is not None:
            fail(f'{phase}: the group exited {group.returncode}:\n'
                 f'{_tail(group_log)}')

    def lease():
        return dict(session.query_one(
            'SELECT * FROM supervisor_lease WHERE id=1'))

    def holder_pid(row) -> int:
        return int(row['holder'].split(':')[1]) if row['holder'] else 0

    def stop_group():
        if group is not None and group.poll() is None:
            try:
                os.killpg(group.pid, signal.SIGTERM)
                group.wait(timeout=30)
            except (ProcessLookupError, subprocess.TimeoutExpired):
                os.killpg(group.pid, signal.SIGKILL)
                group.wait(timeout=30)

    try:
        session = Session.create_session(key='site')
        # (a) the site as processes
        config = yaml_load(file=os.path.join(HERE, CLI_CIFAR))
        config['executors']['train']['stages'][0]['epochs'] = SITE_EPOCHS
        folder = os.path.join(work, 'cifar_site')
        os.makedirs(folder)
        yaml_dump(config, file=os.path.join(folder, 'config.yml'))
        port = _free_port()
        spawned = str(utc_now())
        t0 = time.monotonic()
        with open(group_log, 'w') as out:
            group = subprocess.Popen(
                [sys.executable, '-m', 'mlcomp_tpu_torch.server', 'start',
                 '1'], cwd=HERE, env=dict(os.environ, WEB_PORT=str(port)),
                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)

        def token_answers():
            try:
                return _api(port, '/api/token', {'token': TOKEN}) == (
                    200, {'success': True})
            except (urllib.error.URLError, ConnectionError):
                return False

        _wait_for(phase, 'answer from /api/token', token_answers,
                  group_alive, interval=0.05)
        ready_s = seconds_since(t0)
        site_pid = _wait_for(
            phase, 'lease held by the site',
            lambda: holder_pid(lease()), group_alive)
        if 'start-site' not in procfs.process_cmdline(site_pid):
            fail(f'{phase}: the lease holder {lease()} is not the site')
        _wait_for(phase, 'heartbeat of worker-supervisor', lambda: (
            session.query_one(
                'SELECT 1 FROM docker WHERE computer=? AND name=? AND '
                'last_activity > ?', (host, DOCKER_IMG, spawned))),
            group_alive)
        agent_s = seconds_since(t0)
        known = set(_dag_ids(db))
        submit = subprocess.run(
            [sys.executable, '-m', 'mlcomp_tpu_torch', 'dag',
             os.path.join(folder, 'config.yml'), '--params',
             'model/norm:fused'], cwd=HERE, capture_output=True, text=True,
            timeout=300)
        returned = str(utc_now())
        if submit.returncode != 0:
            fail(f'{phase}: dag exited {submit.returncode}:\n'
                 f'{submit.stdout[-2000:]}\n{submit.stderr[-2000:]}')
        (dag_id,) = [i for i in _dag_ids(db) if i not in known]

        def task_row():
            status, body = _api(port, '/api/tasks', {'dag': dag_id},
                                token=TOKEN)
            if status != 200 or body['total'] != 1:
                fail(f'{phase}: /api/tasks answered {status} {body}')
            return body['data'][0]

        def status_is(want):
            def probe():
                task = task_row()
                if task['status'] == int(want):
                    return task
                if task['status'] in finished:
                    fail(f'{phase}: task {task["id"]} ended in status '
                         f'{task["status"]} ({task["failure_reason"]}), '
                         f'waiting for {want.name}:\n{_tail(group_log)}')
                return None
            return probe

        first = _wait_for(phase, 'InProgress task',
                          status_is(TaskStatus.InProgress), group_alive)
        task_id, task_pid = first['id'], first['pid']
        msg = session.query_one('SELECT * FROM queue_message WHERE id=?',
                                (first['queue_id'],))
        meta_path = os.path.join(TASK_FOLDER, str(task_id), 'checkpoints',
                                 'last.msgpack.meta.json')

        def checkpointed():
            if task_row()['status'] in finished:
                fail(f'{phase}: task {task_id} ended before the stop')
            return os.path.exists(meta_path)

        _wait_for(phase, 'first checkpoint', checkpointed, group_alive,
                  interval=0.05)
        apps_running = _compute_apps()
        # the positive control of the site's check below: the training
        # process, which holds a context, maps the driver library
        if not _maps_libcuda(task_pid):
            fail(f'{phase}: the run-task process {task_pid} maps no '
                 f'libcuda, so that check cannot see a context')
        t_stop = time.monotonic()
        status, body = _api(port, '/api/task/stop', {'id': task_id},
                            token=TOKEN)
        if (status, body) != (200, {'status': 'stopped'}):
            fail(f'{phase}: /api/task/stop answered {status} {body}')
        stopped = _wait_for(phase, 'Stopped task',
                            status_is(TaskStatus.Stopped), group_alive)
        stop_s = seconds_since(t_stop)
        _wait_for(phase, 'exit of the run-task process',
                  lambda: not procfs.pid_exists(task_pid), group_alive)
        gone_s = seconds_since(t_stop)
        with open(meta_path) as fh:
            ck_epoch = int(json.load(fh)['epoch'])
        if ck_epoch >= SITE_EPOCHS - 1:
            fail(f'{phase}: the task checkpointed epoch {ck_epoch} of '
                 f'{SITE_EPOCHS} before the stop')
        last_series = session.query_one(
            'SELECT COALESCE(MAX(id), 0) FROM report_series WHERE task=?',
            (task_id,))[0]
        t_start = time.monotonic()
        status, body = _api(port, '/api/dag/start', {'id': dag_id},
                            token=TOKEN)
        if (status, body) != (200, {'restarted': [task_id]}):
            fail(f'{phase}: /api/dag/start answered {status} {body}')
        resume = yaml_load(session.query_one(
            'SELECT additional_info FROM task WHERE id=?',
            (task_id,))[0])['resume']
        if resume['master_task_id'] != task_id or not resume['load_last']:
            fail(f'{phase}: resume info {resume}')
        _wait_for(phase, 'InProgress task after /api/dag/start',
                  status_is(TaskStatus.InProgress), group_alive)
        start_s = seconds_since(t_start)
        done = _wait_for(phase, 'Success of the resumed task',
                         status_is(TaskStatus.Success), group_alive)
        resumed_log = session.query_one(
            "SELECT message FROM log WHERE task=? AND message LIKE "
            "'%resumed from checkpoint%'", (task_id,))
        epochs = sorted({r[0] for r in session.query(
            "SELECT epoch FROM report_series WHERE task=? AND id>? AND "
            "name='loss' AND part='train'", (task_id, last_series))})
        if resumed_log is None or f'epoch={ck_epoch} ' not in \
                resumed_log[0] or epochs != list(range(ck_epoch + 1,
                                                       SITE_EPOCHS)):
            fail(f'{phase}: resumed log {resumed_log}, epochs after the '
                 f'restart {epochs}, want {ck_epoch + 1}..'
                 f'{SITE_EPOCHS - 1}')
        resumed_wall = _seconds(done['finished'], done['started'])

        # the site's other reads
        status, graph = _api(port, '/api/graph', {'id': dag_id},
                             token=TOKEN)
        status_page, page = _api(port, '/', method='GET')
        status_metrics, text = _api(port, '/metrics', method='GET')
        status_aux, aux = _api(port, '/api/auxiliary')
        if status != 200 or [n['status'] for n in graph['nodes']] != \
                ['Success'] or status_page != 200 or \
                '<title>mlcomp_tpu</title>' not in page or \
                status_metrics != 200 or status_aux != 200 or \
                'supervisor' not in aux:
            fail(f'{phase}: graph {status} {graph}, page {status_page}, '
                 f'metrics {status_metrics}, auxiliary {status_aux}')
        families = parse_openmetrics(text)
        rows = {TaskStatus(r[0]).name: r[1] for r in session.query(
            'SELECT status, COUNT(*) FROM task GROUP BY status')}
        exported = {s[1]['status']: s[2]
                    for s in families['mlcomp_tasks']['samples'] if s[2]}
        want = {to_snake(k): float(v) for k, v in rows.items()}
        row = lease()
        leader = families['mlcomp_supervisor_leader']['samples']
        epoch0 = families['mlcomp_supervisor_epoch']['samples'][0][2]
        if exported != want or len(leader) != 1 or \
                leader[0][1]['holder'] != row['holder'] or \
                holder_pid(row) != site_pid or epoch0 != row['epoch'] or \
                row['epoch'] < 1:
            fail(f'{phase}: /metrics tasks {exported}, rows {want}, '
                 f'leader {leader}, epoch {epoch0}, lease {row}, site '
                 f'{site_pid}')
        cuda_in_site = _maps_libcuda(site_pid) or site_pid in _compute_apps()

        # SIGTERM to the site: its lease is released, the group restarts
        # it, and the new site takes the lease at the next epoch
        t_term = time.monotonic()
        os.kill(site_pid, signal.SIGTERM)
        _wait_for(phase, 'lease released by the SIGTERMed site',
                  lambda: holder_pid(lease()) != site_pid, group_alive,
                  interval=0.02)
        released_s = seconds_since(t_term)
        new_pid = _wait_for(phase, 'lease taken by the restarted site',
                            lambda: holder_pid(lease()), group_alive,
                            interval=0.02)
        handover_s = seconds_since(t_term)
        row_after = lease()
        roster = {r['holder']: r['role'] for r in session.query(
            'SELECT holder, role FROM supervisor_instance')}
        if new_pid == site_pid or procfs.pid_exists(site_pid) or \
                row_after['epoch'] != row['epoch'] + 1 or \
                'start-site' not in procfs.process_cmdline(new_pid) or \
                roster.get(row['holder']) != 'released':
            fail(f'{phase}: lease {row} -> {row_after}, old site '
                 f'{site_pid} alive {procfs.pid_exists(site_pid)}, roster '
                 f'{roster}')
        _wait_for(phase, 'answer from the restarted site', token_answers,
                  group_alive)
        cuda_in_site = cuda_in_site or _maps_libcuda(new_pid) or \
            new_pid in _compute_apps()
        if cuda_in_site:
            fail(f'{phase}: a site process ({site_pid}, {new_pid}) holds a '
                 f'CUDA context')

        # server stop: no process of the group is left
        t_off = time.monotonic()
        off = subprocess.run(
            [sys.executable, '-m', 'mlcomp_tpu_torch.server', 'stop'],
            cwd=HERE, capture_output=True, text=True, timeout=120)
        if off.returncode != 0 or off.stdout.strip() != 'stopped':
            fail(f'{phase}: server stop exited {off.returncode}: '
                 f'{off.stdout} {off.stderr}')
        _wait_for(phase, 'end of every process of the group',
                  lambda: not _port_processes(), timeout=60)
        off_s = seconds_since(t_off)
        group.wait(timeout=30)
        if lease()['holder'] is not None:
            fail(f'{phase}: the stopped site left the lease {lease()}')
        phase_a_s = seconds_since(t0)
        say(phase, part='a', dag=dag_id, task=task_id,
            site_ready_s=ready_s, agent_ready_s=agent_s,
            dispatch_s=f'{_seconds(msg["created"], returned):.3f}',
            checkpoint_epoch=ck_epoch, stop_to_stopped_s=stop_s,
            stop_to_process_gone_s=gone_s,
            dag_start_to_inprogress_s=start_s,
            resumed_epochs=f'{epochs[0]}..{epochs[-1]}',
            resumed_wall_s=f'{resumed_wall:.2f}',
            best_accuracy=done['score'], lease_epoch=row['epoch'],
            sigterm_to_release_s=released_s,
            lease_handover_s=handover_s, server_stop_s=off_s,
            stopped_status=stopped['status'],
            task_in_compute_apps=task_pid in apps_running,
            site_cuda=cuda_in_site, group_rc=group.returncode,
            phase_s=phase_a_s, card=smi)

        # (b) in this process: the HA supervisor and the API, the
        # worker's in-process consume, the launches counted
        counters = _kernel_counters()
        logger = create_logger(session)
        t_b0 = time.monotonic()
        server = start_server(host='127.0.0.1', port=0, background=True,
                              logger=logger)
        _wait_for(phase, 'lease held by this process',
                  lambda: holder_pid(lease()) == os.getpid())
        promote_s = seconds_since(t_b0)
        queue, docker = QueueProvider(session), DockerProvider(session)
        provider = TaskProvider(session)

        def drive():
            """Consume until the task ends; its row."""
            deadline = time.monotonic() + SITE_TIMEOUT_S
            while True:
                docker.heartbeat(host, DOCKER_IMG)   # the agent is stopped
                consumed = worker_main._consume_one(session, queue, logger,
                                                    0, in_process=True)
                task = provider.by_id(task_b)
                if task.status in finished:
                    return task
                if time.monotonic() > deadline:
                    fail(f'{phase}: in-process task in status '
                         f'{task.status} after {SITE_TIMEOUT_S} s')
                if not consumed:
                    time.sleep(0.05)

        for fn in counters.values():
            fn.launches = 0
        known = set(_dag_ids(db))
        t_b = time.monotonic()
        cli_main(['dag', os.path.join(HERE, CLI_CIFAR), '--params',
                  'model/norm:fused'])
        (dag_b,) = [i for i in _dag_ids(db) if i not in known]
        (task_b,) = [r[0] for r in session.query(
            'SELECT id FROM task WHERE dag=?', (dag_b,))]
        task = drive()
        torch.cuda.synchronize()
        trained_s = seconds_since(t_b)
        launches = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        if task.status != int(TaskStatus.Success):
            fail(f'{phase}: in-process task {task.status} '
                 f'({task.failure_reason})')
        norm = 20 * CLI_CIFAR_STEPS * CLI_EPOCHS
        _check_launches(f'{phase} b', launches,
                        {'fused_norm': norm, 'fused_norm_bwd': norm})
        status, computers = _api(server.port, '/api/computers', {},
                                 token=TOKEN)
        (usage,) = [c['usage'] for c in computers['data']
                    if c['name'] == host]
        card = (usage.get('tpu') or [{}])[0]
        if status != 200 or not card.get('hbm_used') or \
                not card.get('hbm_limit'):
            fail(f'{phase}: /api/computers usage {usage}')
        provider.change_status(task, TaskStatus.Failed)
        for fn in counters.values():
            fn.launches = 0
        t_r = time.monotonic()
        status, body = _api(server.port, '/api/dag/start', {'id': dag_b},
                            token=TOKEN)
        if (status, body) != (200, {'restarted': [task_b]}):
            fail(f'{phase}: /api/dag/start answered {status} {body}')
        task = drive()
        torch.cuda.synchronize()
        again = {k: fn.launches for k, fn in counters.items()
                 if fn.launches}
        result = yaml_load(task.result)
        if task.status != int(TaskStatus.Success) or again or \
                result['samples_per_sec'] != 0:
            fail(f'{phase}: the resume of a finished task ran: status '
                 f'{task.status}, launches {again}, result {result}')
        server.shutdown()
        server = None
        if lease()['holder'] is not None:
            fail(f'{phase}: the in-process supervisor left the lease '
                 f'{lease()}')
        say(phase, part='b', dag=dag_b, task=task_b, promote_s=promote_s,
            trained_s=trained_s, launches=launches,
            resume_s=seconds_since(t_r), resume_launches=again,
            resume_samples_per_sec=result['samples_per_sec'],
            card_usage=card, phase_s=seconds_since(t_b0), card=smi)
        return {'site': launches}
    finally:
        if server is not None:
            server.shutdown()
        signal.signal(signal.SIGTERM, on_term)
        stop_group()
        for pid in _port_processes():
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        Session.cleanup()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# ------------------------------------------------------------ the model zoo
#: the JAX package's parameter count of each model of ``[zoo]``
#: (``jax.eval_shape`` of its init on the CPU; the smoke imports no JAX):
#: the classifiers at ``num_classes`` 10, the segmentation models at 2
# ------------------------------------------------------------- telemetry
#: a profiler window's extent in dispatches, and each model's cadence
TELEMETRY_PROFILE_STEPS = 3
TELEMETRY_EVERY = {'vit': 8, 'cifar': 8}
#: the CIFAR task's images: cifar_simple's, 16 steps of 256 an epoch;
#: its epochs: the first sampled, then the on-demand trace from the
#: first's end until the stop lands, with epochs to spare
TELEMETRY_CIFAR_TRAIN, TELEMETRY_CIFAR_EPOCHS = 4096, 4
#: the instrumented ViT step against the bare one, alternating step by
#: step, this many of each, each call timed by the host's clock (the
#: step is host-bound; host times on a shared machine drift by ~10%
#: between runs of a few hundred ms, so A/B runs in turns would measure
#: the drift); the overhead the run allows
OVERHEAD_STEPS = 150
MAX_TELEMETRY_OVERHEAD = 0.05
#: the kernel path's FLOPs against the dense path's on the ViT
MAX_FLOPS_REL = 1e-3
#: the MFU's peak: one H100 SXM, bf16 dense
PEAK_TFLOPS = 989.0
#: (f) cifar_simple through ``execute`` in a fresh process with windows
#: on, then off: its images (48 steps an epoch, its 2 epochs) and the
#: windows' cadence
ON_OFF_TRAIN, ON_OFF_EVERY = 12288, 16


def _windows_on_off(phase: str, smi: str) -> dict:
    """(f) The trainer's default (no windows) against windows every
    ``ON_OFF_EVERY`` steps, end to end: ``execute`` of cifar_simple in a
    process each, windows on first (a host that drifts slower would
    then count against the default). For each run its process and task
    wall, epoch times and the median step time of each epoch (the
    ``step_time_ms`` rows; epoch 1 holds the FLOP count's step, the
    window-opening and -closing steps are in the median's tails)."""
    from mlcomp_tpu_torch import DB_FOLDER
    db = os.path.join(DB_FOLDER, 'sqlite.db')
    steps = ON_OFF_TRAIN // 256
    # the data and models links ``execute`` leaves beside the config
    links = [os.path.join(HERE, os.path.dirname(CLI_CIFAR), name)
             for name in ('data', 'models')]
    try:
        return _run_on_off(phase, smi, db, steps)
    finally:
        for link in links:
            if os.path.islink(link):
                os.remove(link)


def _run_on_off(phase: str, smi: str, db: str, steps: int) -> dict:
    import sqlite3
    from datetime import datetime
    out = {}
    for label, every in (('on', ON_OFF_EVERY), ('off', 0)):
        known = set(_dag_ids(db)) if os.path.exists(db) else set()
        argv = [sys.executable, '-m', 'mlcomp_tpu_torch', 'execute',
                CLI_CIFAR, '--params', 'model/norm:fused',
                '--params', f'dataset/n_train:{ON_OFF_TRAIN}',
                '--params',
                f'executors/train/telemetry/profile_every:{every}']
        t0 = time.monotonic()
        proc = subprocess.run(argv, cwd=HERE, capture_output=True,
                              text=True, timeout=600)
        process_s = time.monotonic() - t0
        if proc.returncode != 0:
            fail(f'{phase}: windows {label}: execute exited '
                 f'{proc.returncode}:\n{proc.stdout[-2000:]}\n'
                 f'{proc.stderr[-2000:]}')
        dags = [i for i in _dag_ids(db) if i not in known]
        conn = sqlite3.connect(db)
        conn.row_factory = sqlite3.Row
        try:
            task = conn.execute('SELECT * FROM task WHERE dag=?',
                                (dags[-1],)).fetchone()
            step_ms = dict(conn.execute(
                "SELECT step, value FROM metric WHERE task=? AND "
                "name='step_time_ms'", (task['id'],)).fetchall())
            epoch_s = [r[0] for r in conn.execute(
                "SELECT value FROM metric WHERE task=? AND "
                "name='epoch_time_s' ORDER BY id", (task['id'],))]
            windows = conn.execute(
                "SELECT COUNT(*) FROM metric WHERE task=? AND "
                "name='devtime.summary'", (task['id'],)).fetchone()[0]
        finally:
            conn.close()
        wall = (datetime.fromisoformat(task['finished'])
                - datetime.fromisoformat(task['started'])).total_seconds()
        medians = [float(np.median([v for k, v in step_ms.items()
                                    if e * steps <= k < (e + 1) * steps]))
                   for e in range(CLI_EPOCHS)]
        out[label] = {'process_s': process_s, 'task_wall_s': wall,
                      'epoch_s': epoch_s, 'step_median_ms': medians,
                      'windows': windows}
        say(phase, part='f', windows=label, every=every,
            process_s=f'{process_s:.2f}', task_wall_s=f'{wall:.2f}',
            epoch_time_s=[f'{v:.3f}' for v in epoch_s],
            step_median_ms_by_epoch=[f'{v:.3f}' for v in medians],
            devtime_windows=windows, steps=len(step_ms), card=smi)
        # an interval a step after the first (the step-0 row is none)
        if len(step_ms) != steps * CLI_EPOCHS - 1 \
                or (windows > 0) != (every > 0):
            fail(f'{phase}: windows {label}: {len(step_ms)} step rows, '
                 f'{windows} windows')
    on, off = out['on'], out['off']
    say(phase, part='f', epoch2_step_on_vs_off=(
        f'{on["step_median_ms"][1] / off["step_median_ms"][1] - 1:.4f}'),
        task_wall_on_vs_off=(
            f'{on["task_wall_s"] / off["task_wall_s"] - 1:.4f}'),
        card=smi)
    return out


def _norm_counters() -> dict:
    from mlcomp_tpu_torch.ops.fused_norm import (
        norm_act_backward_kernel, norm_act_forward,
    )
    return {'fused_norm': norm_act_forward,
            'fused_norm_bwd': norm_act_backward_kernel}


def _telemetry_task(session, work: str, name: str, spec: dict) -> tuple:
    """A DAG of one ``train`` task running ``spec``: (task id, folder).
    Its checkpoints go under ``folder``: this DB's task ids restart at 1,
    and the root's task folders hold earlier phases' checkpoints, which
    the trainer would resume."""
    from mlcomp_tpu_torch.server.create_dags import dag_standard
    folder = os.path.join(work, name)
    os.makedirs(folder)
    spec = dict(spec, checkpoint_dir=os.path.join(folder, 'checkpoints'))
    config = {'info': {'name': f'telemetry_{name}',
                       'project': 'smoke_telemetry'},
              'executors': {'train': spec}}
    _, tasks = dag_standard(session, config, upload_folder=folder)
    return tasks['train'][0], folder


def _execute_counted(session, tid: int, folder: str) -> tuple:
    """``execute_by_id`` of the task, every kernel's count zeroed just
    before and read just after: (launches, seconds)."""
    from mlcomp_tpu_torch.worker.tasks import execute_by_id
    counters = {**_flash_counters(), **_norm_counters()}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    execute_by_id(tid, folder=folder, session=session)
    torch.cuda.synchronize()
    return ({name: fn.launches for name, fn in counters.items()},
            time.monotonic() - t0)


def _host_step_ms(fn, n: int) -> list:
    """The host's time of each of ``n`` calls of ``fn``, ms (no sync: a
    host-bound step's call returns after its launches)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _metric_values(session, tid: int, name: str) -> list:
    return [r['value'] for r in _metric_rows(session, tid, name)]


def _metric_rows(session, tid: int, name: str) -> list:
    return session.query(
        'SELECT step, value, tags FROM metric WHERE task=? AND name=? '
        'ORDER BY id', (tid, name))


def _telemetry_report(phase: str, model: str, session, tid: int,
                      smi: str, flops: float = None) -> dict:
    """Print the run's step phases (means over every step, medians over
    the clean steps: after the first, which counts FLOPs, and before the
    first profiler window), pipeline efficiency, MFU, card memory and
    each devtime window with the loop thread's cost of opening and
    closing it; fail on a profiler failure in the log or without a
    window that saw the card busy. Returns the numbers."""
    from mlcomp_tpu_torch.telemetry import PHASES
    windows = [(r['step'], r['value'], json.loads(r['tags']))
               for r in _metric_rows(session, tid, 'devtime.summary')]
    first = min((w[0] for w in windows if w[0] is not None),
                default=None)
    by_step = {p: {r['step']: r['value'] for r in _metric_rows(
        session, tid, f'step.phase.{p}_ms')} for p in PHASES}
    step_time = {r['step']: r['value']
                 for r in _metric_rows(session, tid, 'step_time_ms')}
    steps = len(by_step['compute'])
    clean = [k for k in by_step['compute']
             if 0 < k and (first is None or k < first)]
    clean_ms = {p: float(np.median([v[k] for k in clean]))
                for p, v in by_step.items()}
    clean_step_ms = float(np.median([step_time[k] for k in clean
                                     if k in step_time]))

    def last_gib(name: str) -> str:
        values = _metric_values(session, tid, name)
        if not values:
            fail(f'{phase}: {model}: no {name} series')
            return 'none'
        return f'{values[-1] / 2 ** 30:.3f}'

    # the steps after the last window closed: a window's lasting cost
    last = max((w[0] for w in windows if w[0] is not None), default=None)
    after = [v for k, v in step_time.items()
             if last is not None and k >= last + TELEMETRY_PROFILE_STEPS + 1]
    after_ms = float(np.median(after)) if after else None
    suspects = _metric_values(session, tid, 'host_sync.suspect_ms')
    probe = [r['message'] for r in session.query(
        "SELECT message FROM log WHERE task=? AND message LIKE "
        "'telemetry: the first step counted%'", (tid,))]
    numbers = {'clean_ms': clean_ms, 'clean_step_ms': clean_step_ms,
               'after_windows_step_ms': after_ms,
               'mean_ms': {p: float(np.mean(list(v.values())))
                           for p, v in by_step.items()}}
    say(phase, model=model, task=tid, steps=steps, clean_steps=len(clean),
        **{f'{p}_mean_ms': f'{m:.3f}'
           for p, m in numbers['mean_ms'].items()},
        **{f'{p}_clean_median_ms': f'{m:.3f}' for p, m in clean_ms.items()},
        step_time_clean_median_ms=f'{clean_step_ms:.3f}',
        step_time_after_windows_median_ms='none' if after_ms is None
        else f'{after_ms:.3f}', steps_after_windows=len(after),
        host_sync_suspects=len(suspects),
        host_sync_suspect_ms=[round(v, 3) for v in suspects[:8]],
        first_step_log=probe,
        step_times_ms=[round(step_time[k], 1) for k in sorted(step_time)],
        pipeline_efficiency=[f'{v:.4f}' for v in _metric_values(
            session, tid, 'step.pipeline_efficiency')],
        mfu_rows=[f'{v:.5f}' for v in _metric_values(session, tid, 'mfu')],
        mfu_clean='not measured' if not flops else
        f'{flops / (clean_step_ms / 1e3) / (PEAK_TFLOPS * 1e12):.5f}',
        hbm_used_gib=last_gib('device0.hbm_used'),
        hbm_peak_gib=last_gib('device0.hbm_peak'),
        hbm_limit_gib=last_gib('device0.hbm_limit'),
        card=smi)
    if steps == 0 or not clean or \
            any(len(v) != steps for v in by_step.values()):
        fail(f'{phase}: {model}: step phases '
             f'{ {p: len(v) for p, v in by_step.items()} } for {steps} '
             f'steps, {len(clean)} clean')
    for step, window_ms, tags in windows:
        opened = closed = None
        if step is not None:
            opened = by_step['telemetry'].get(step)
            closed = by_step['telemetry'].get(
                step + TELEMETRY_PROFILE_STEPS)
        say(phase, model=model, window_step=step, window_ms=window_ms,
            device_lines=tags['device_lines'],
            buckets=json.dumps(tags['buckets']),
            busy_frac=tags['busy_frac'],
            host_dispatch_gap_ms=tags['host']['dispatch_gap_ms'],
            dispatches=tags['host']['dispatch_count'],
            open_telemetry_ms=opened, close_telemetry_ms=closed,
            top_kernels=json.dumps([(o['op'][:48], o['ms'], o['count'])
                                    for o in tags['ops'][:4]]))
    if not any(t['buckets']['compute_ms'] > 0 and 0 < t['busy_frac'] <= 1
               for _, _, t in windows):
        fail(f'{phase}: {model}: no devtime window with compute > 0 and '
             f'0 < busy <= 1: {windows}')
    failures = [r['message'] for r in session.query(
        "SELECT message FROM log WHERE task=? AND message LIKE "
        "'deviceprof:%failed%'", (tid,))]
    if failures:
        fail(f'{phase}: {model}: profiler failures {failures}')
    numbers['windows'] = [{'step': w[0], 'window_ms': w[1], **w[2]}
                          for w in windows]
    return numbers


def phase_telemetry(seed: int, smi: str) -> dict:
    """``[telemetry]``: the device telemetry of the trainer on the card
    (the module docstring lists what it checks). Returns the kernels'
    launches by run."""
    from mlcomp_tpu_torch import TOKEN
    from mlcomp_tpu_torch.db.core import Session
    from mlcomp_tpu_torch.db.migration import migrate
    from mlcomp_tpu_torch.db.providers import TaskProvider
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.server import api as api_module
    from mlcomp_tpu_torch.telemetry import (
        CompileEventRecorder, FlopCounter, HostSyncTripwire, MemorySampler,
        MetricRecorder, StepAttribution, load_postmortem,
    )
    from mlcomp_tpu_torch.telemetry.export import parse_openmetrics
    from mlcomp_tpu_torch.telemetry.deviceprof import TorchTracer, step_marker
    from mlcomp_tpu_torch.telemetry.trace_parse import (
        find_trace_files, host_time_split, parse_trace_events,
        read_trace_events,
    )
    from mlcomp_tpu_torch.testing import faults
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, instrumented_step, loss_for_task,
        make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    phase = 'telemetry'
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_telemetry_')
    cs = f'sqlite:///{work}/telemetry.db'
    session = Session.create_session(key='smoke-telemetry',
                                     connection_string=cs)
    migrate(session)
    Session.cleanup(api_module._SESSION_KEY)
    server = api_module.start_server(host='127.0.0.1', port=0,
                                     background=True, with_supervisor=False,
                                     connection_string=cs)
    launches = {}
    vit_spec = {k: v for k, v in VIT_SPEC.items() if k != 'model_name'}
    run, parts = vit_step(seed)
    try:
        # the bare ViT step before this phase's profiler windows, as the
        # step after them is timed in (e)
        for _ in range(3):
            run()
        bare_before = _host_step_ms(run, 60)
        # (a) the ViT, one epoch, in this thread
        spec = dict(vit_spec, seed=seed, device='cuda', checkpoint_every=0,
                    telemetry={'profile_every': TELEMETRY_EVERY['vit'],
                               'profile_steps': TELEMETRY_PROFILE_STEPS})
        vit_tid, folder = _telemetry_task(session, work, 'vit', spec)
        launches['telemetry_vit'], seconds = _execute_counted(
            session, vit_tid, folder)
        data = spec['dataset']
        steps = data['n_train'] // spec['batch_size']
        valid = -(-data['n_valid'] // spec['batch_size'])
        say(phase, model='vit', seconds=f'{seconds:.1f}',
            launches=launches['telemetry_vit'])
        _check_launches(phase, launches['telemetry_vit'], {
            'flash_attention_fwd': 6 * (steps + valid),
            'flash_attention_bwd_dq': 6 * steps,
            'flash_attention_bwd_dkv': 6 * steps,
            'fused_norm': 0, 'fused_norm_bwd': 0})
        # the kernel path's first-step FLOPs (mfu x peak x epoch time /
        # steps, the trainer's own count) against the dense path's
        mfu = _metric_values(session, vit_tid, 'mfu')[0]
        epoch_s = _metric_values(session, vit_tid, 'epoch_time_s')[0]
        kernel_flops = mfu * PEAK_TFLOPS * 1e12 * epoch_s / steps
        vit = _telemetry_report(phase, 'vit', session, vit_tid, smi,
                                flops=kernel_flops)
        x, y = parts['x'], parts['y']
        dense = create_model(**{**VIT_SPEC['model'], 'attn_impl': 'dense'},
                             input_shape=x.shape[1:], device='cuda')
        optimizer, _ = make_optimizer(VIT_SPEC['stages'][0]['optimizer'],
                                      100)
        dense_step = make_train_step(dense, optimizer,
                                     loss_for_task('softmax_ce'))
        dense_state = create_train_state(dense, optimizer, seed=seed)
        dynamo_before = 'torch._dynamo' in sys.modules
        counted_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            with FlopCounter() as counter:
                dense_step(dense_state, x, y)
            counted_s.append(time.perf_counter() - t0)
        dense_flops = counter.total
        kernel_counted_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            with FlopCounter() as kernel_counter:
                run()
            kernel_counted_s.append(time.perf_counter() - t0)
        bare_s = _host_step_ms(run, 5)
        say(phase, model='vit', flop_count_dense_s=[
            f'{v:.3f}' for v in counted_s],
            flop_count_kernel_s=[f'{v:.3f}' for v in kernel_counted_s],
            bare_step_ms=[f'{v:.2f}' for v in bare_s],
            kernel_gflop=f'{kernel_counter.total / 1e9:.4f}',
            dynamo_imported_before=dynamo_before,
            dynamo_imported_after='torch._dynamo' in sys.modules, card=smi)
        n_params, tokens = 3_564_864, 64
        # 6 per parameter and token, and 12·L·T·d for the attention
        analytic = (6 * n_params + 12 * 6 * tokens * 192) \
            * VIT_SPEC['batch_size'] * tokens
        rel = abs(kernel_flops - dense_flops) / dense_flops
        say(phase, model='vit', kernel_path_gflop=f'{kernel_flops / 1e9:.4f}',
            dense_path_gflop=f'{dense_flops / 1e9:.4f}',
            rel_diff=f'{rel:.2e}', max_rel=MAX_FLOPS_REL,
            analytic_gflop=f'{analytic / 1e9:.4f}',
            mfu=f'{mfu:.5f}',
            analytic_mfu=f'{analytic * steps / epoch_s / (PEAK_TFLOPS * 1e12):.5f}',
            peak_tflops=PEAK_TFLOPS, card=smi)
        if not rel <= MAX_FLOPS_REL:
            fail(f'{phase}: the ViT kernel path counts {kernel_flops} '
                 f'FLOPs a step, the dense path {dense_flops}')
        del dense, dense_state, dense_step, counter, kernel_counter

        # (b) the CIFAR ResNet-18 on a thread beside the API: an
        # on-demand trace started, watched, stopped; /metrics mid-run
        spec = {k: v for k, v in cifar_train_spec().items()
                if k != 'model_name'}
        spec = dict(spec, seed=seed, device='cuda', checkpoint_every=0,
                    dataset=dict(spec['dataset'],
                                 n_train=TELEMETRY_CIFAR_TRAIN),
                    stages=[dict(spec['stages'][0],
                                 epochs=TELEMETRY_CIFAR_EPOCHS)],
                    telemetry={'profile_every': TELEMETRY_EVERY['cifar'],
                               'profile_steps': TELEMETRY_PROFILE_STEPS})
        cifar_tid, folder = _telemetry_task(session, work, 'cifar', spec)
        trace_dir = os.path.join(work, 'on_demand')
        calls = [('start', {'max_epochs': 99, 'dir': trace_dir})]
        status, row = _api(server.port, '/api/telemetry/profile',
                           {'task': cifar_tid, 'action': 'start',
                            'max_epochs': 99, 'dir': trace_dir}, token=TOKEN)
        if status != 200 or row.get('status') != 'requested':
            fail(f'{phase}: profile start answered {status} {row}')
        result = {}

        def train():
            try:
                result['launches'], result['seconds'] = _execute_counted(
                    session, cifar_tid, folder)
            except BaseException as e:      # noqa: reported below
                result['error'] = repr(e)

        thread = threading.Thread(target=train, daemon=True)
        thread.start()
        deadline = time.monotonic() + 600
        while True:
            status, row = _api(server.port, '/api/telemetry/profile',
                               {'task': cifar_tid, 'action': 'status'},
                               token=TOKEN)
            if row.get('status') == 'tracing':
                break
            if not thread.is_alive() or time.monotonic() > deadline:
                fail(f'{phase}: the on-demand trace never ran: {row} '
                     f'{result}')
            time.sleep(0.05)
        calls.append(('status', row['status']))
        status, text = _api(server.port, '/metrics', method='GET')
        families = parse_openmetrics(text)
        phase_samples = [s for s in families['mlcomp_step_phase_ms'][
            'samples'] if s[1].get('task') == str(cifar_tid)]
        eff_samples = [s for s in families['mlcomp_pipeline_efficiency'][
            'samples'] if s[1].get('task') == str(cifar_tid)]
        status, row = _api(server.port, '/api/telemetry/profile',
                           {'task': cifar_tid, 'action': 'stop'},
                           token=TOKEN)
        calls.append(('stop', row.get('status')))
        thread.join(timeout=600)
        if thread.is_alive() or 'error' in result:
            fail(f'{phase}: the CIFAR task: {result}')
        status, row = _api(server.port, '/api/telemetry/profile',
                           {'task': cifar_tid, 'action': 'status'},
                           token=TOKEN)
        files = find_trace_files(row.get('dir') or trace_dir)
        attribution = row.get('attribution') or {}
        cifar_split = [host_time_split(read_trace_events(f))
                       for f in files]
        say(phase, model='cifar', seconds=f'{result["seconds"]:.1f}',
            trace_host_split=json.dumps(cifar_split),
            launches=result['launches'], profile_calls=calls,
            profile_final=row.get('status'), trace_files=len(files),
            trace_mib=f'{sum(os.path.getsize(f) for f in files) / 2 ** 20:.1f}',
            trace_epochs=row.get('epochs'),
            trace_busy_frac=attribution.get('busy_frac'),
            trace_buckets=json.dumps(attribution.get('buckets')),
            trace_host=json.dumps(attribution.get('host')),
            metrics_step_phases=len(phase_samples),
            metrics_pipeline_efficiency=len(eff_samples))
        if row.get('status') != 'done' or not files \
                or not attribution.get('device_lines'):
            fail(f'{phase}: the on-demand trace ended {row}, files {files}')
        if calls[-1][1] != 'stop_requested' or len(phase_samples) != 4 \
                or len(eff_samples) != 1:
            fail(f'{phase}: stop answered {calls}; /metrics phases '
                 f'{phase_samples}, efficiency {eff_samples}')
        launches['telemetry_cifar'] = result['launches']
        cifar_steps = TELEMETRY_CIFAR_TRAIN // spec['batch_size'] \
            * TELEMETRY_CIFAR_EPOCHS
        _check_launches(phase, result['launches'], {
            'flash_attention_fwd': 0, 'flash_attention_bwd_dq': 0,
            'flash_attention_bwd_dkv': 0,
            'fused_norm': 20 * cifar_steps,
            'fused_norm_bwd': 20 * cifar_steps})
        mfu = _metric_values(session, cifar_tid, 'mfu')[0]
        epoch_s = _metric_values(session, cifar_tid, 'epoch_time_s')[0]
        cifar_flops = mfu * PEAK_TFLOPS * 1e12 * epoch_s \
            / (TELEMETRY_CIFAR_TRAIN // spec['batch_size'])
        cifar = _telemetry_report(phase, 'cifar', session, cifar_tid, smi,
                                  flops=cifar_flops)
        for tid in (vit_tid, cifar_tid):
            status, body = _api(server.port, f'/api/task/devtime?task={tid}',
                                method='GET')
            if status != 200 or body['windows'] < 1:
                fail(f'{phase}: /api/task/devtime of task {tid}: {status} '
                     f'{body}')

        # (c) a ViT run killed by an injected device OOM at train.epoch
        spec = dict(vit_spec, seed=seed, device='cuda', checkpoint_every=0,
                    dataset=dict(vit_spec['dataset'], n_train=512,
                                 n_valid=256),
                    stages=[dict(vit_spec['stages'][0], epochs=2)],
                    telemetry={'flush_every': 10})
        oom_tid, folder = _telemetry_task(session, work, 'oom', spec)
        faults.configure_faults({'train.epoch': {
            'action': 'raise', 'exc': 'resource', 'after': 1}})
        counters = _flash_counters()
        try:
            _execute_counted(session, oom_tid, folder)
            fail(f'{phase}: the injected fault did not end the run')
        except RuntimeError as e:
            if 'RESOURCE_EXHAUSTED' not in str(e):
                raise
        finally:
            faults.clear_faults()
        launches['telemetry_oom'] = {n: fn.launches
                                     for n, fn in counters.items()}
        task = TaskProvider(session).by_id(oom_tid)
        bundle = load_postmortem(session, oom_tid) or {}
        status, via_api = _api(server.port,
                               f'/api/task/postmortem?task={oom_tid}',
                               method='GET')
        hbm = sorted(n for n in bundle.get('series', {})
                     if n.startswith('device0.hbm_'))
        say(phase, model='vit', injected='train.epoch resource',
            status=task.status, failure_reason=task.failure_reason,
            postmortem_series=len(bundle.get('series', {})),
            hbm_series=hbm, api_status=status,
            launches=launches['telemetry_oom'])
        if task.failure_reason != 'oom' or bundle.get('reason') != 'oom' \
                or hbm != ['device0.hbm_limit', 'device0.hbm_peak',
                           'device0.hbm_used'] \
                or status != 200 or via_api.get('reason') != 'oom':
            fail(f'{phase}: the killed run: {task.failure_reason}, '
                 f'{bundle.get("reason")}, {hbm}, {status}')
        _check_launches(phase, launches['telemetry_oom'], {
            'flash_attention_fwd': 6 * 3, 'flash_attention_bwd_dq': 6 * 2,
            'flash_attention_bwd_dkv': 6 * 2})

        # (d) where the ViT step's host time goes: a window of marked
        # steps, split into aten ops and CUDA calls against the rest
        step, state = parts['step'], parts['state']
        tracer = TorchTracer(cuda=True)
        t0 = time.perf_counter()
        tracer.start(os.path.join(work, 'vit_window'))
        start_s = time.perf_counter() - t0
        for i in range(TELEMETRY_PROFILE_STEPS):
            with step_marker(i):
                run()
        t0 = time.perf_counter()
        path = tracer.stop()
        stop_s = time.perf_counter() - t0
        events = read_trace_events(path)
        vit_split = host_time_split(events)
        vit_window = parse_trace_events(events)
        say(phase, model='vit', host_split=json.dumps(vit_split),
            window_busy_frac=vit_window['busy_frac'],
            window_buckets=json.dumps(vit_window['buckets']),
            start_s=f'{start_s:.3f}', stop_and_write_s=f'{stop_s:.3f}',
            card=smi)
        if vit_split['steps'] != TELEMETRY_PROFILE_STEPS \
                or not 0 < vit_split['op_ms'] <= vit_split['step_ms']:
            fail(f'{phase}: the ViT window split {vit_split}')
        # what routing a flash launch through its library op (for the
        # FLOP count) costs the host: the op on meta tensors, whose
        # kernel does nothing, against a Python call of a no-op
        meta = [torch.empty(s, device='meta') for s in (
            (256, 64, 3, 64),) * 4 + ((256, 3, 64),)]
        q_, k_, v_, o_, lse_ = meta
        op = torch.ops.mlcomp_tpu.flash_attention_fwd

        def noop(*args):
            return None

        per_call_us = {}
        for name, fn in (('op', op), ('python_call', noop)):
            t0 = time.perf_counter()
            for _ in range(10000):
                fn(q_, k_, v_, o_, lse_, 0.125, False)
            per_call_us[name] = (time.perf_counter() - t0) / 10000 * 1e6
        # the ViT's 6 layers: a forward and two backward launches each
        extra_ms = 18 * (per_call_us['op'] - per_call_us['python_call']) \
            / 1e3
        say(phase, model='vit', op_dispatch_us=f'{per_call_us["op"]:.2f}',
            python_call_us=f'{per_call_us["python_call"]:.2f}',
            launches_a_step=18, op_cost_a_step_ms=f'{extra_ms:.3f}',
            card=smi)

        # (e) the wrapper's cost: the instrumented ViT step against the
        # bare one, windows off, in turns
        rec = MetricRecorder(session=session, task=vit_tid,
                             component='overhead', async_flush=True)
        events = CompileEventRecorder(recorder=rec)
        events.install()
        wrapped = instrumented_step(
            step, rec, batch_size=VIT_SPEC['batch_size'],
            attribution=StepAttribution(rec),
            tripwire=HostSyncTripwire(recorder=rec), compile_events=events,
            memory=MemorySampler(rec, device=x.device))
        calls_by_name = {'bare': lambda: step(state, x, y),
                         'instrumented': lambda: wrapped(state, x, y)}
        for fn in calls_by_name.values():
            time_ms(fn, iters=3)
        times = {name: [] for name in calls_by_name}
        for i in range(2 * OVERHEAD_STEPS):
            name = ('bare', 'instrumented')[i % 2]
            times[name].extend(_host_step_ms(calls_by_name[name], 1))
        torch.cuda.synchronize()
        events.uninstall()
        rec.close()
        medians = {name: float(np.median(v)) for name, v in times.items()}
        overhead = medians['instrumented'] / medians['bare'] - 1
        say(phase, model='vit', overhead=f'{overhead:.4f}',
            max_overhead=MAX_TELEMETRY_OVERHEAD,
            bare_median_ms=f'{medians["bare"]:.3f}',
            instrumented_median_ms=f'{medians["instrumented"]:.3f}',
            steps_each=OVERHEAD_STEPS,
            bare_before_windows_median_ms=f'{np.median(bare_before):.3f}',
            card=smi)
        if overhead > MAX_TELEMETRY_OVERHEAD:
            fail(f'{phase}: the telemetry wrapper costs {overhead:.1%} of '
                 f'the ViT step')
        del run, parts, step, state, wrapped, calls_by_name
        vit['host_split'], cifar['host_split'] = vit_split, cifar_split

        # (f) windows on and off, end to end, each in a fresh process
        on_off = _windows_on_off(phase, smi)
        launches['numbers'] = {'vit': vit, 'cifar': cifar,
                               'windows_on_off': on_off,
                               'overhead': overhead,
                               'vit_flops': kernel_flops,
                               'cifar_flops': cifar_flops}
        return launches
    finally:
        faults.clear_faults()
        server.shutdown()
        Session.cleanup(api_module._SESSION_KEY)
        Session.cleanup(session.key)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


ZOO_PARAMS = {
    'vgg13': 9_413_066, 'vgg16': 14_724_042, 'densenet121': 6_956_426,
    'densenet169': 12_493_450, 'seresnet18': 11_263_042,
    'seresnet34': 21_443_318, 'seresnet50': 26_051_834,
    'efficientnet_lite0': 2_962_058, 'mobilenetv2': 1_814_922,
    'drn26': 11_173_962, 'xception': 21_349_290, 'dpn68': 2_684_266,
    'inceptionresnetv2': 71_122_570,
    'fpn': 11_587_778, 'linknet': 11_301_634, 'pspnet': 13_792_322,
    'deeplabv3': 13_153_090, 'unet_resnet18': 14_313_474,
    'deeplabv3_drn26': 13_153_090, 'unet': 1_948_322,
}
ZOO_SEGMENTATION = ('fpn', 'linknet', 'pspnet', 'deeplabv3', 'unet_resnet18',
                    'deeplabv3_drn26', 'unet')
#: f32 on the card (TF32 off) against the CPU: the largest error of a
#: row (an example's output, a statistics vector) over the row's largest
#: magnitude. cuDNN and the CPU sum convolutions and statistics in other
#: orders, through up to ~160 norm sites
ZOO_ROW_TOL = 1e-4
#: a running-statistics row whose entries all lie below this share of
#: the model's largest statistic is zero in exact arithmetic (the batch
#: mean of a bias-free linear map of a batch-normalised input, as
#: EfficientNet's ``expand_norm``: ~1e-9 on either device, 1e-18 in f64
#: on the CPU) and holds rounding noise; such a row is judged against
#: this floor instead of its own magnitude
ZOO_STAT_FLOOR = 1e-3
#: the timed step's batch: encoder_grid's 256, examples/segmentation's 32
ZOO_BATCH = {'classify': 256, 'segment': 32}
ZOO_WARMUP, ZOO_ITERS = 3, 10


def _row_error(got, want, floor: float = 1e-30) -> float:
    """The largest error of a row over the row's largest magnitude (or
    ``floor``, where that is larger)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    rows = got.shape[0] if got.dim() > 1 else 1
    g, w = got.reshape(rows, -1), want.reshape(rows, -1)
    return float(((g - w).abs().amax(1)
                  / w.abs().amax(1).clamp_min(floor)).max())


def phase_zoo(seed: int, smi: str):
    """``[zoo]``: every architecture of this slice at full width on the
    card (ZOO_PARAMS' models): the parameter count, an f32 card-vs-CPU
    check, bf16 AdamW steps (finite, every parameter moved), the step
    timed."""
    import copy
    from mlcomp_tpu_torch.models import create_model, param_count
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    phase = 'zoo'
    rng = np.random.RandomState(seed)
    for name in ZOO_PARAMS:
        segment = name in ZOO_SEGMENTATION
        classes, hw = (2, 64) if segment else (10, 32)
        spec = {'name': name, 'num_classes': classes, 'cifar_stem': True}
        cpu = create_model(**spec, dtype='float32', device='cpu',
                           generator=torch.Generator().manual_seed(seed))
        n_params = param_count(cpu)
        if n_params != ZOO_PARAMS[name]:
            fail(f'{phase}: {name} has {n_params} parameters, the JAX '
                 f'package {ZOO_PARAMS[name]}')
        # f32 on the card (TF32 off, main() sets it) against the CPU
        card = copy.deepcopy(cpu).cuda()
        x = torch.from_numpy(rng.rand(2, hw, hw, 3).astype(np.float32))
        with torch.no_grad():
            errors = {'eval': _row_error(card(x.cuda()), cpu(x)),
                      'train': _row_error(card(x.cuda(), train=True),
                                          cpu(x, train=True))}
        card_sd = card.state_dict()
        stats = {k: v for k, v in cpu.state_dict().items()
                 if k.endswith(('.mean', '.var'))}
        floor = ZOO_STAT_FLOOR * max(float(v.abs().max())
                                     for v in stats.values())
        errors['stats'] = max(_row_error(card_sd[k], v, floor)
                              for k, v in stats.items())
        del card, cpu
        # the bf16 train step at the config's batch
        gen = torch.Generator('cuda').manual_seed(seed)
        model = create_model(**spec, dtype='bfloat16', device='cuda',
                             generator=gen)
        batch = ZOO_BATCH['segment' if segment else 'classify']
        xb = torch.rand(batch, hw, hw, 3, device='cuda', generator=gen)
        yb = torch.randint(0, classes, (batch, hw, hw) if segment
                           else (batch,), device='cuda', generator=gen)
        loss_fn = loss_for_task('bce_dice' if segment else 'softmax_ce')
        params = dict(model.named_parameters())
        loss = loss_fn(model(xb, train=True), yb)[0]
        grads = torch.autograd.grad(loss, list(params.values()))
        loss = float(loss)
        finite_grads = all(bool(torch.isfinite(g).all()) for g in grads)
        optimizer, _ = make_optimizer({'name': 'adamw', 'lr': 1e-3}, 100)
        state = create_train_state(model, optimizer, seed=seed)
        step = make_train_step(model, optimizer, loss_fn)
        before = {k: v.detach().clone() for k, v in params.items()}
        # two steps: a zero-init residual scale (the blocks' last norm)
        # gives its branch's zero-init biases no gradient in the first
        for _ in range(2):
            state, metrics = step(state, xb, yb)
        still = [k for k, v in params.items() if torch.equal(v, before[k])]
        step_loss = float(metrics['loss'])
        del before, grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: step(state, xb, yb), iters=ZOO_ITERS,
                          warmup=ZOO_WARMUP)
        peak = torch.cuda.max_memory_allocated()
        say(phase, model=name, params=n_params, input=f'{hw}x{hw}x3',
            f32_eval_row_err=f'{errors["eval"]:.2e}',
            f32_train_row_err=f'{errors["train"]:.2e}',
            f32_stats_row_err=f'{errors["stats"]:.2e}', tf32='off',
            max_row_err=ZOO_ROW_TOL, bf16_loss=f'{loss:.4f}',
            step_loss=f'{step_loss:.4f}', finite_grads=finite_grads,
            unmoved=len(still), batch=batch, step_ms=f'{step_ms:.3f}',
            images_per_s=f'{batch / step_ms * 1e3:.1f}',
            peak_mib=f'{peak / 2 ** 20:.0f}', card=smi)
        if not max(errors.values()) <= ZOO_ROW_TOL:
            fail(f'{phase}: {name} in f32 on the card is off the CPU by '
                 f'{errors} of a row')
        if not (np.isfinite(loss) and np.isfinite(step_loss)
                and finite_grads):
            fail(f'{phase}: {name}\'s bf16 step is not finite: loss '
                 f'{loss}, step loss {step_loss}, grads finite '
                 f'{finite_grads}')
        if still:
            fail(f'{phase}: {name}\'s step left {still[:5]} unmoved')
        del model, state, step, xb, yb, params
        torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false — this smoke run needs '
             'an NVIDIA card')
    # a fresh root (its models/ folder) for the export, set before the
    # package computes MODEL_FOLDER at import
    root = tempfile.mkdtemp(prefix='mlcomp_smoke_')
    os.environ['MLCOMP_TPU_ROOT'] = root
    try:
        try:
            import mlcomp_tpu_torch  # noqa: F401
        except ImportError as e:
            fail(f'the mlcomp_tpu_torch package is not beside this '
                 f'script: {e}')
        torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
        torch.backends.cudnn.allow_tf32 = False

        smi = phase_device()
        phase_build()
        fwd = phase_kernels(args.seed)
        backward, vit = phase_backward_kernels(args.seed)
        norm = phase_norm_kernel(args.seed)
        norm_bwd = phase_norm_bwd_kernel(args.seed)
        int8 = phase_int8_kernel(args.seed)
        stack = phase_stack_kernel(args.seed)
        ce = phase_ce_kernels(args.seed)
        phase_int8_train_matmul(args.seed)
        serve_launches = phase_serving(args.seed)
        int8_serve, int8_split = phase_serve_int8(args.seed)
        leg = phase_serving_int8(args.seed)
        train_launches = phase_train(args.seed)
        wide_launches = phase_train_wide_int8(args.seed)
        moe_launches = phase_moe_train(args.seed)
        moe_serve = phase_moe_serve(args.seed)
        vit_launches = phase_vit_train(args.seed)
        cifar_launches = phase_cifar_train(args.seed)
        dag_cifar10 = phase_dag_cifar10(args.seed, smi)
        dag_ensemble = phase_dag_ensemble(args.seed, smi)
        phase_dag_segmentation(args.seed, smi)
        phase_zoo(args.seed, smi)
        cli = phase_cli(smi)
        sched = phase_sched(smi)
        site = phase_site(smi)
        # a profiler window can leave CUDA tracing on, which slows later
        # launches from the host: the step phases, which profile, come
        # last, the ViT's (timed here, profiled at the end) and the
        # launch-bound ResNet step before the LM's
        vit_step = phase_vit_step(args.seed)
        step_norm_ms = phase_cifar_step(args.seed)
        phase_step(args.seed)
        moe_step = phase_moe_step(args.seed)
        step_wide = phase_step_wide(args.seed)
        # before the profiles below: Kineto runs one profiler at a time
        telemetry = phase_telemetry(args.seed, smi)
        norm_device = profile_norm_sites(args.seed)
        vit_device = profile_vit(args.seed, vit_step['step_ms'])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fwd['launches_by_path'] = {
        'serve': serve_launches,
        'train': train_launches['flash_attention_fwd'],
        'train_wide_int8': wide_launches['flash_attention_fwd'],
        'moe_train': moe_launches['flash_attention_fwd'],
        'moe_serve': moe_serve['bf16']['flash_attention_fwd'],
        'moe_serve_int8': moe_serve['int8']['flash_attention_fwd'],
        'vit_train': vit_launches['flash_attention_fwd'],
        **{path: counts['flash_attention_fwd']
           for path, counts in dag_ensemble.items()},
        'cli': cli['cli']['flash_attention_fwd'],
        'sched': sched['sched']['flash_attention_fwd'],
        **{path: telemetry[path]['flash_attention_fwd']
           for path in ('telemetry_vit', 'telemetry_oom')}}
    fwd['launches'] = sum(fwd['launches_by_path'].values())
    fwd['vit'] = {'shape': [256, 64, 3, 64], 'causal': False,
                  'with_lse_ms': vit['fwd_lse_ms'],
                  'bound_ms': vit['fwd_bound_ms'],
                  'plain_ms': vit['plain_fwd_ms'],
                  'library_ms': vit['sdpa_fwd_ms'],
                  'device_ms': vit_device['fwd'],
                  'library_device_ms': vit_device['sdpa']}
    for entry in backward:
        entry['launches_by_path'] = {
            'train': train_launches[entry['name']],
            'train_wide_int8': wide_launches[entry['name']],
            'moe_train': moe_launches[entry['name']],
            'vit_train': vit_launches[entry['name']],
            'dag_ensemble_train':
                dag_ensemble['dag_ensemble_train'][entry['name']],
            'cli': cli['cli'][entry['name']],
            'sched': sched['sched'][entry['name']],
            **{path: telemetry[path][entry['name']]
               for path in ('telemetry_vit', 'telemetry_oom')}}
        entry['launches'] = sum(entry['launches_by_path'].values())
        part = 'dq' if entry['name'].endswith('_dq') else 'dkv'
        entry['vit'].update(device_ms=vit_device[part],
                            sdpa_bwd_device_ms=vit_device['sdpa_bwd'])
    for entry in ce:
        entry['launches_by_path'] = {
            'train_wide_int8': wide_launches[entry['name']]}
        entry['launches'] = wide_launches[entry['name']]
    ce[0]['step_wide'] = step_wide
    for entry in (norm, norm_bwd):
        entry['launches_by_path'] = {
            'cifar_train': cifar_launches[entry['name']],
            **{path: counts[entry['name']]
               for path, counts in dag_cifar10.items()},
            'dag_ensemble_train':
                dag_ensemble['dag_ensemble_train'][entry['name']],
            'cli': cli['cli'][entry['name']],
            'sched': sched['sched'][entry['name']],
            'site': site['site'][entry['name']],
            'telemetry_cifar': telemetry['telemetry_cifar'][entry['name']]}
        entry['launches'] = sum(entry['launches_by_path'].values())
    norm['device_ms'] = {site: {k: v for k, v in ms.items() if k != 'bwd'}
                         for site, ms in norm_device.items()}
    norm_bwd['device_ms'] = {site: ms['bwd']
                             for site, ms in norm_device.items()}
    # the 20 norm sites of a batch-512 train step, forward and backward,
    # as the profiler reads them (absent if it read no device time)
    norm['step_device_ms'] = step_norm_ms.get('fused')
    int8['launches_by_path'] = {
        'serve_int8_per_layer': int8_serve['flagship_lm_layers'],
        'serve_int8_stacked': int8_serve['flagship_lm'],
        'serving_int8': leg['launches']['int8_matmul'],
        'moe_serve_int8': moe_serve['int8']['int8_matmul'],
        'dag_ensemble_infer_vit_int8':
            dag_ensemble['dag_ensemble_infer_vit_int8']['int8_matmul']}
    int8['launches'] = sum(int8['launches_by_path'].values())
    int8['dispatch_split'] = int8_split
    stack['launches_by_path'] = {
        'serving_int8': leg['launches']['serving_stack']}
    stack['launches'] = sum(stack['launches_by_path'].values())
    stack['serving_int8'] = leg['numbers']
    kernels = [fwd] + backward + [norm, norm_bwd, int8, stack] + ce
    for entry in kernels:
        if entry['launches'] <= 0:
            fail(f'the main path launched no {entry["name"]}')
    numbers = telemetry['numbers']
    say('telemetry', summary=True, overhead=f'{numbers["overhead"]:.4f}',
        vit_clean_phases_ms=json.dumps({k: round(v, 3) for k, v in
                                        numbers['vit']['clean_ms'].items()}),
        cifar_clean_phases_ms=json.dumps({
            k: round(v, 3) for k, v in numbers['cifar']['clean_ms'].items()}),
        vit_step_gflop=f'{numbers["vit_flops"] / 1e9:.4f}',
        cifar_step_gflop=f'{numbers["cifar_flops"] / 1e9:.4f}')
    say('moe-vit', moe_step_ms=f'{moe_step["step_ms"]:.2f}',
        moe_mfu=f'{moe_step["mfu"]:.4f}', moe_aux=moe_step['moe_aux'],
        vit_step_ms=f'{vit_step["step_ms"]:.3f}',
        vit_device_busy=vit_device['step'].get('device_busy'))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
