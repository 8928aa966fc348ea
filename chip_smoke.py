#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version, check the card against the CPU,
pretrain the `base` preset (stock, and with the fusion sites substituted),
the `moe` preset and the SSD family at `ssd_8b` widths for a few steps
through TrainStep, train the ERNIE text classifier at ERNIE-1.0-base
widths and the PP-OCR detector and recognizer at bench scale, train
ResNet-50 and ERNIE-base through the high-level API (`hapi.Model`), and
serve Llama-3-8B-shaped, MoE and SSD-8B requests through the port's Engine,
Llama-3-8B-shaped traces through the Router over two replicas, and an
exported generate program through a Predictor.

    python3 chip_smoke.py                  # every phase, full depth
    python3 chip_smoke.py --layers 8       # cut Llama serving depth (never width)
    python3 chip_smoke.py --phases card,build,kernels,train
    python3 chip_smoke.py --phases card,build,moe_train,moe_serve
    python3 chip_smoke.py --phases card,build,ernie_train,ocr_train
    python3 chip_smoke.py --phases card,build,eager_train
    python3 chip_smoke.py --phases card,build,hapi_train
    python3 chip_smoke.py --phases card,build,nn_tail
    python3 chip_smoke.py --phases card,build,static_graph
    python3 chip_smoke.py --phases card,build,serve,router_serve
    python3 chip_smoke.py --phases card,build,kernels,longctx_train
    python3 chip_smoke.py --phases card,build,kernels,kernel_gate,parity,fuse_train
    python3 chip_smoke.py --phases card,build,kernels,parity,ssd_train,ssd_serve
    python3 chip_smoke.py --phases card,build,kernels,kernel_gate

Phases:
  1 card     name and power limit (nvidia-smi), torch device name
  2 build    nvcc of kernels/csrc/*.cu for sm_90a, all in parallel, and
             g++ of core/csrc/*.cc (the host runtime's library) beside them
  3 kernels  each kernel against its plain version at its path's shapes
             (RMSNorm at a decode step, a serving prefill and a `base`
             step; decode attention dense and paged at the kernel table's
             lengths and at the `serve` phase's own, NaN in the trash block
             and stale tails, with each of its two launches' device time;
             flash attention forward and backward at `base` and at
             `longctx`, and fp32 non-causal at ERNIE-base's B 32, S 512,
             12 heads of 64 (the CUDA-core kernels, timed beside sdpa's
             fp32 forward and backward alone) and bf16 at the same shape
             (`eager_train` leg 2's O1 attention, the bf16 kernels, beside
             sdpa in bf16), AdamW as one launch over base's 75 leaves and over
             ssd_train's 43 (0 ulps, with torch._fused_adamw_ beside it; a
             ragged table: sizes 1, 3, 4097, views at offset 1, bf16
             gradients, bf16 params with masters, a table past one launch's
             capacity, and a planted fault, one entry's size off by 4), the
             SSD scan at `ssd_8b`, SSDConfig()'s default, bench.py's
             on-chip and tiny widths): max error, kernel / plain / library
             time, bound; flash also against sdpa's backward alone, with
             each kernel's registers and spill bytes, its gradients tile by
             tile, and planted faults in them must be rejected; the SSD
             scan's forward and backward kernels also by norm per
             recurrence (the backward in each of dx, db, dc, dla, against
             its plain closed form, whose own fp32 error against fp64 is
             logged), with zero rows bitwise no-ops (zero gradients in the
             backward), under a log-decay near -20 a token, and against
             three planted faults each (the backward's: the state gradient
             not carried, dla without its chunk-end terms, dM's mask off by
             one); each fusion site's forward and backward at
             `base` (bf16 rows, fp32 weights; also 1000 ragged rows, the
             tied head, fp32 at 520 rows) against the plain reference and
             its autograd, elementwise and per 64-row tile (the add +
             RMSNorm backward's dx and dh with one bf16 ulp of the rounded
             norm gradient more), with the seam's stock chain timed beside
             it, and four planted faults (gate and up swapped, the last K
             tile dropped, a row's RMS skipped, a row's norm gradient
             dropped);
             the RMSNorm backward (the add + RMSNorm backward kernel):
             norm-only, as the stock RMSNorm's backward, at `base`'s,
             `longctx`'s and `ssd_train`'s rows over fp32 weights, the
             site's mode (h, d_s) at `base`, fp32 rows at the parity
             widths, untimed a ragged row, one row and the wide kernel: dx
             and dw against the plain version, dw the same bits twice,
             kernel / plain / stock-chain / library ms, bound, registers and
             spill bytes; two planted faults (a row's projection dropped
             from dx, a CTA's rows left out of dw) must be rejected;
             each bf16 GEMM launch of the sites at `base` alone (ms,
             TFLOP/s, bound, registers and spill bytes, torch.matmul on
             the same operands as its yardstick) and the two preparation
             passes (an fp32 weight rounded, the head's rows normed: bit
             for bit their plain versions);
             the gate's two seeded-defect kernels, exact on the part their
             defect leaves defined
  3b kernel_gate  the kernel gate (kernels/registry.py, analysis/
             kernel_lint.py): its CLI on the card, clean (20 entries, each
             at every dtype it has an example of, both legs, no finding,
             every kernel's shared memory as the card reports it) and under
             each KERNEL_GATE_INJECT (write-race, parallel-carry, emit-race:
             each refused with its codes, the other entries clean), four
             processes together; `parity`'s narrow Llama through the
             Engine, generate, one TrainStep step and one fused step, then
             one stock and one fused step in bf16 over fp32 params, with
             FLAGS_kernel_admission off and on: each kernel on those paths
             admitted once at the dtype it ran, tokens and losses equal,
             launch counts equal; sabotaged ssd_scan and rms_norm refused
             before their first launch
  4 parity   card (kernels) against CPU (plain versions) in fp32 on a
             narrow Llama config and on the tiny pure and hybrid SSD
             stacks: Engine and generate tokens must be equal; three
             TrainStep steps must agree in losses, step-1 gradients,
             parameters and the optimizer's m and v slots; the Llama steps
             again with every fusion site verified and activated; the
             narrow Llama with 4 experts under the switch gate (TF32 off):
             every layer's routing the same, logits within 1e-4, step-1
             gradients, Engine and generate tokens equal; ERNIE-tiny
             (configs[0], dropout off) for 5 Adam steps, losses within
             ERNIE_PARITY_LOSS_RTOL, AdamW once a step and no flash launch
             (head dim 26); DBNet-tiny and CRNN-tiny with cuDNN's TF32
             off, step 1's loss within PARITY_LOSS_RTOL, gradients within
             PARITY_GRAD_TOL, BatchNorm statistics within 1e-5; a tiny
             Llama and a tiny ERNIE through the HF-transformers layout
             and back (models.hf_compat): the same logits bits
  4a incubate  incubate.nn.functional's fused_rms_norm,
             masked_multihead_attention and block_multihead_attention (over
             the JAX package's pool layout) at llama3_8b decode shapes
             against their plain versions: one RMSNorm and two dense decode
             launches
  5 train    the `base` preset (12 layers, batch 3, seq 2048, bf16 compute,
             fp32 params) for 5 steps on one batch with the
             launch counters zeroed just before and read just after: every
             step must launch flash forward and backward once a layer,
             RMSNorm and its backward twice a layer plus once, AdamW once
             (one launch over every leaf, inside the optimizer update) and no
             decode kernel; losses finite and
             falling; step 1's loss within a limit of the same batch run
             with fp32 activations.  Step time, tokens/s and MFU are printed
  5a longctx_train  the `longctx` preset (the `base` model at seq 16384,
             batch 1, every decoder layer recomputed in the backward) for 3
             steps on one batch, counters zeroed just before and read just
             after: every step must launch flash forward twice a layer (the
             recompute), flash backward once a layer, RMSNorm four times a
             layer plus once and its backward twice a layer plus once, AdamW
             once (inside the update); losses
             finite and falling; step time, tokens/s and MFU are printed
  5f eager_train  the eager Paddle API only (`import paddle_tpu_torch as
             paddle`, set_device("gpu"), seed, to_tensor, io.DataLoader over
             io.TensorDataset, optimizer.AdamW, loss.backward(); opt.step();
             opt.clear_grad()), two legs.  Leg 1: the `base` preset's
             LlamaForCausalLM at full width and depth with the `train`
             phase's config and AdamW, EAGER_STEPS steps on seeded batches
             of 3 x 2048, counters zeroed just before and read per step:
             every step must launch what a `train` step launches (flash
             forward and backward once a layer, RMSNorm and its backward
             twice a layer plus once, AdamW once); then TrainStep on the
             same weights, batches and optimizer: every step's loss must be
             the same bits (only where step 1 already differs, which can
             come only from a kernel giving other bits on a second run,
             every step within TRAIN_LOSS_TOL, the reason logged); steady
             step ms beside the `train` phase's.  Leg 2: ERNIE-base
             widths (build_ernie_step's config, fp32 params, 32 x 512, Adam)
             under amp.auto_cast(level="O1", dtype="bfloat16") with a
             GradScaler, EAGER_AMP_STEPS steps: finite losses, each step
             the bf16 flash kernels non-causal once a layer forward and
             backward and AdamW once; step 1 of a 2-layer cut (dropout off,
             2 x 512) against the same O1 program on the CPU: the loss
             within EAGER_AMP_LOSS_RTOL, and the cut run on the card
             without auto_cast (fp32) past that limit, so that the check
             can tell whether O1 ran
  5b fuse_train  `base` in three legs, stock -> fused -> stock, each a fresh
             build_pretrain_step("base", "cuda") with the same seed, 5
             steps, counters read per step (the first stock leg is the
             `train` phase's run when that phase ran); the fused leg runs inside
             emit.activate(emit.verified_activation("cuda")) and each of its
             steps must launch every site forward and backward once a layer
             (the head's once), RMSNorm and its backward once a layer, flash
             as before and AdamW once in the update; the stock legs
             no site.
             Losses finite and falling; the fused step-1 loss within a
             limit of the stock one; the stock legs equal
  5c moe_train  the `moe` preset (bench.py's configs[4] shape: 12 layers,
             hidden 1024, 8 experts of 1408, top-2 over the gshard gate,
             bf16, batch 4 x seq 2048; 518.6 M params) for 5 steps on one
             batch, counters read per step: flash forward and backward
             once a layer, RMSNorm and its backward twice a layer plus
             once, AdamW once (inside the update), no fusion site and no
             decode kernel; losses finite and falling; step 1's loss within
             MOE_TRAIN_LOSS_TOL of the fp32-activation loss (the same
             gshard draws); each layer's share of (token, slot) choices
             dropped by capacity; a sixth step
             run twice from one state (params, slots, step count, the
             gshard generator) gives the same loss and every tensor's bits
  5d ernie_train  ERNIE-1.0-base widths (presets.build_ernie_step: 12
             layers of 768, 12 heads of 64, intermediate 3072, vocab 18000;
             fp32, TF32 as torch leaves it: matmul off) for 5 Adam steps on
             a batch of 32 x 512 from --seed, no padding mask: every step
             must launch the flash kernels forward and backward once a
             layer (non-causal) and AdamW once inside the update; losses
             finite; step ms, examples/s, TFLOP/s, peak memory, the flash
             kernels' share of a profiled step; then one step with a
             padding mask (the plain attention: no flash launch); then
             step 1 of the model cut to 2 layers (batch 2 x 512, dropout
             off) on the card against the CPU in fp32 with TF32 off: loss
             within PARITY_LOSS_RTOL, gradients within PARITY_GRAD_TOL
  5e ocr_train  cuDNN's TF32 on (torch's default), printed: DBNet at
             bench.py's `ocr` preset (presets.build_ocr_step:
             ocr_det_base, 640 x 640, batch 32, Momentum(1e-3, 0.9)) and
             CRNN at ocr_rec_base (6625 classes, 32 x 320, batch 32, CTC
             over labels of 1-25 characters, Adam(3e-3)), 5 steps each:
             losses finite and falling, images/s, step ms, peak memory; no
             kernel of the port but CRNN's AdamW (once a step).  No "same
             bits twice" check: cuDNN may pick non-deterministic algorithms
  5g hapi_train  the high-level API on the card, two legs, under torch's
             TF32 defaults (matmul off, cuDNN on; printed).  Leg 1:
             vision.models.resnet50() (1000 classes) at PaddleClas's
             ImageNet/ResNet/ResNet50.yaml recipe: Momentum(0.1, 0.9) with
             L2Decay(1e-4), batch 64, RandomResizedCrop(224) + flip +
             normalise + CHW for training, Resize(256) + CenterCrop(224)
             for eval, over vision.datasets.FakeData (384 + 128 HWC float
             images of 256 x 256 x 3 from --seed), through
             hapi.Model(net).prepare(opt, nn.CrossEntropyLoss(),
             metric.Accuracy(topk=(1, 5))).fit(num_iters=6) over a
             DataLoader of 2 worker processes (io.shm_loader, a 39.6 MB
             shared-memory slot: one batch) after one forward and backward
             of a copy at these shapes (so that cuDNN's first calls stay
             out of fit's steps), the same fit again with the batches
             made on a thread (use_shared_memory=False), evaluate over 2
             batches (workers) and predict over 1.  Counters read per
             fit step (a hapi callback): no kernel of the port; losses
             finite; step 1's loss the same bits as a jit.TrainStep's over a
             copy of the starting weights, with the model's loss function,
             on the batch fit's step 1 ran; BatchNorm statistics moved;
             evaluate gives finite `loss` and `acc` in [0, 1] (top-1, the
             metric's one name; top-5 from its accumulate()); predict a
             [64, 1000] array.  Printed, for the workers' fit and the
             thread's: images/s with the loader, each step's wait for the
             loader and its own ms, the share spent waiting; the loader
             alone,
             train_batch's steady ms on a batch on the card beside the same
             TrainStep queued without the loss read (the sync a step costs),
             evaluate's images/s, peak memory, the card's name and power
             limit.  Leg 2: ERNIE-base (ernie_base_config, 2 classes, fp32,
             32 x 512, AdamW(5e-5)) through fit for 3 steps over an
             io.TensorDataset of build_ernie_step's kind of batch: each step
             the fp32 flash kernels non-causal 12 + 12 and AdamW once,
             nothing else; step 1's bits as leg 1's (the dropout generator's
             state put back first); the steady step beside ernie_train's;
             evaluate over one batch
  5h nn_tail  the rest of paddle.nn, ops.extras, fft and signal (the
             slice that ports them), two legs.  Leg 1, the entries that
             reach kernels, each with the counters zeroed just before it:
             nn.RMSNorm and F.rms_norm at `base`'s rows (3 x 2048 x 2048
             bf16, fp32 weight) forward and backward, one rms_norm and one
             rms_norm_bwd launch each, held to the plain versions within
             RMS_TOL (dw within RMS_DW_ATOL), and at width 2000 none;
             F.flash_attn_qkvpacked at `base`'s attention (qkv 3 x 2048 x 3 x
             16 x 128 bf16, causal) forward and the backward of a sum, one
             flash forward and one backward, held within FLASH_TOL and tile
             by tile (whether the q/k/v views were copied is logged, with the
             forward's ms from the views and from contiguous copies);
             F.flash_attn_unpadded over an ERNIE-base packed batch (32
             sequences of 64-512 tokens from --seed, 12 heads of 64, bf16),
             non-causal and causal: one forward and one backward launch a
             segment, held to the JAX function's masked attention over the
             packed length (segment mask, causal rows bottom-right), and
             flash_attn_varlen_qkvpacked the same bits; the call's host ms
             beside its device ms and bound.  Leg 2, every other name the
             slice added to nn.functional and nn, and ops.extras, fft and
             signal, once on the card (ERNIE-base activations 32 x 512 x
             768, ImageNet logits 256 x 1000, ResNet-50's stage-1 map 64 x
             256 x 56 x 56, 3-D 8 x 64 x 16 x 56 x 56, 32 clips of 10 s at
             16 kHz for stft / istft at n_fft 512, hop 160, FFTs over 64 x
             4096) against the same call on the CPU in fp32 with TF32 off,
             forward and the backward of a fixed weighted sum, within the
             limit of its group (NN_TAIL_TOL; where NN_TAIL_SAMPLES says so
             the CPU recomputes the batch's first samples only); random
             names held to their support; every added name must be in the
             table
  5i static_graph  the compiled-graph layer at `base` (the `train` phase's
             config, 12 layers, batch 3 x 2048), three legs.  Leg 1: the
             model, compute_loss and AdamW(3e-4, decay 0.1).minimize under
             static.program_guard over static.data("ids", [None, 2048],
             "int32"), STATIC_STEPS Executor(place="gpu").run calls on
             seeded batches, counters zeroed just before and read per run:
             every run must launch what a `train` step launches; then
             TrainStep on the same weights, batches and optimizer: step 1's
             loss the same bits, every step within TRAIN_LOSS_TOL; steady
             ms beside TrainStep's.  Leg 2: jit.to_static of the forward
             under no_grad (the recorded program replayed: the eager
             logits' bits, 12 flash forwards and 25 RMSNorm launches a
             call); jit.save with an InputSpec (ms, bytes) and a Predictor
             from inference.Config(prefix) reading only the artifact (load
             ms, run ms, the eager logits' bits, the same launches); a
             to_static function with a data-dependent branch: its
             fragments and break site, the same on a second call, another
             fragment on the other branch.  Leg 3: amp.debugging's
             operator stats over one more static step (rms_norm and
             scaled_dot_product_attention counted as the model's seams
             run), and check_numerics raising on a NaN in abort mode
  6 serve    llama3_8b_config, bf16, random weights from --seed, three
             paths each with the launch counters zeroed just before it and
             read just after it: 16 requests (two share a 256-token prefix)
             through the Engine, one chunked-prefill request through a
             second Engine, generate on two prompts.  Every decode step of
             each path must launch its decode kernel once a layer and
             RMSNorm twice a layer plus once; generate's and the Engine's
             first-token logits must agree within a bf16 limit
  6e router_serve  the serving front end and the measuring surface on
             `serve`'s model (built here when `serve` did not run), two legs.
             Leg 1: serving.loadgen traces of 16 requests at 50 requests/s
             (seed 0) replayed by serving.router.Router over fresh Engines
             (8 slots, blocks of 128, 256 blocks, buckets 128-1024, each
             warmed up): `shared_prefix` (a 1024-token prefix, 8-token
             tails, 32 new tokens) on one replica with the prefix cache on,
             then off, then on two replicas under profiler.Profiler with
             PADDLE_TPU_PROFILE_DIR set and a RecordEvent("router.step")
             around each round; `long_prompt` (1024- and 16-token prompts,
             32 and 128 new tokens) on one replica with prefill_chunk 128,
             then without, then on two replicas with chunking and
             FLAGS_ft_inject_serve_kill_round a third of the way through
             one replica's rounds, killing replica 0.  Each run's replicas
             are built and warmed up before its counters are set to 0, so
             a run's counts are its replay's: every decode forward RMSNorm
             twice a layer plus once and paged decode once a layer,
             nothing else.  Every run completes
             each request exactly once with its new tokens; on two replicas
             every request placed after the prefix's first prefill goes to
             a replica holding it, the hit rate is above 0 and the prefill
             tokens below the cache-off run's; the kill run shows one kill,
             re-routes and a flight dump naming replica 0 and the re-routed
             ids; the profiled run's host spans number its rounds and its
             device trace holds as many RMSNorm kernels as the counters
             and two decode kernels a paged decode launch.  Each run's
             tokens against the one-replica run of its trace: where a
             request differs, the logits both runs' Engines computed at the
             first differing position (kept on the card during the replay)
             must choose their run's token and lie within LOGIT_TOL x the
             bf16 error of generate's dense prefill of that context, from
             that prefill in bf16 and with fp32 activations.  Printed: goodput, latency and decode-gap
             percentiles, hit rate and prefill tokens of every run, the
             cache on/off goodput ratio and the chunk on/off decode-gap p99
             ratio, the device's busy share of the profiled replay, one
             replay timed by device.Event, and the peak of
             device.cuda.max_memory_allocated (torch.cuda's the same).
             Leg 2: llama3_8b_config() width at 4 layers (seed as above):
             export_generate(batch 2, prompt 128, 32 new tokens), a
             Predictor from inference.Config over the artifact alone: its
             ids generate's, token for token, and its run launching
             RMSNorm (2L + 1) x 32 and dense decode L x 31 times, as
             generate does; export, load and run times printed
  6a resume_train  `base` at full width, cut to 2 of its 12 layers (as
             in `launch_train`): 5 steps uninterrupted;
             a fresh build, 3 steps and CheckpointManager.save(3) into a
             temporary directory; a build from another seed, resume, steps
             4-5: the resumed losses and every param and slot after step 5
             bit-equal to the uninterrupted run's (save and load ms and the
             checkpoint's bytes logged, the directory removed)
  6d launch_train  the host runtime at `base` cut to 2 of its 12 layers
             (the `train` phase's preset at full width, a new batch of 3 x
             2048 token rows from --seed a step, an io.TensorDataset of
             CPU Tensors), 5 steps in three legs, each
             a fresh build, freed before the next: (1) DataLoader(
             num_workers=0); (2) 2 persistent worker processes (io.
             shm_loader) with a worker_init_fn: every batch leg 1's bytes,
             the losses leg 1's bits, `train`'s launches each step, each
             worker's get_worker_info() right, its pid not the trainer's
             and CUDA never initialised in it (a probe module written into
             the phase's directory records it); (3) python -m
             paddle_tpu_torch.distributed.launch --max_restarts 1 --rank
             -1 (the native TCPStore's rendezvous) on this script's hidden
             child mode under FLAGS_ft_inject_crash_step=4 and
             FLAGS_ft_inject_crash_signal=9: the child joins the store, runs
             an ElasticManager heartbeat, resumes from CheckpointManager,
             calls get_injector().crash_point(step) before each step and
             saves after step 3; the launcher must exit 0 after exactly
             one restart, and steps 1-3 of the killed incarnation and 4-5
             of the relaunched one give leg 1's losses (held to the
             spread resume_train measured when two runs are not
             bit-equal).  Logged: each leg's wait for the loader a step,
             the time to recover from the SIGKILL to the relaunched first
             step and its parts, and the workers and /dev/shm segments the
             killed trainer left (counted, then cleared)
  6b optimizers  each of the 14 optimizers through TrainStep for 3 steps on
             the tiny Llama in fp32, on the card and on the CPU from the same
             weights: losses and params within their limits (OPT_PARITY);
             Adam and AdamW launch the AdamW kernel once a step, the others
             no kernel of the optimizer
  6c moe_serve  the `moe` preset's model with random bf16 weights: 16
             greedy requests through an Engine of 8 slots, then generate on
             two prompts, counters per path (every decode step RMSNorm twice
             a layer plus once and the path's decode kernel once a layer,
             nothing else); generated tok/s, and the device's busy share
             over a profiled drain of 8 requests

  7 ssd_train  ssd_8b_config cut to 8 layers, fp32 params, bf16 compute,
             batch 2 x seq 4096, 5 steps on one batch, counters zeroed just
             before and read just after: every step must launch the SSD
             scan's forward and its backward once a layer, RMSNorm and its
             backward once a layer plus once, AdamW once (inside the update)
             and no attention
             kernel; losses finite and falling; step 1's loss within a
             limit of the fp32-activation loss
  8 ssd_serve  ssd_8b_config at 32 layers, bf16, random weights from
             --seed: 16 requests through the Engine's recurrent path and
             generate on two prompts, counters per path: every decode step
             and prefill must launch RMSNorm once a layer plus once and no
             other kernel; the Engine's first-token logits within a bf16
             limit of generate's
  9 profile  (a diagnostic: it prints and checks nothing) one
             decode-dominated Engine drain at 8B widths, one `base`
             training step (stock and fused) and one `ssd_train` step under
             torch.profiler:
             device time by kernel, and the device's busy share of the
             wall time

`python3 kernel_ab.py SET DIR [DIR ...]` times kernels of several checkouts
on the same inputs: `gemm` the sites' GEMMs, `serve` RMSNorm and decode
(outputs hashed), `rms_plan` each RMSNorm kernel at the serving path's row
counts, `tokens` the `serve` and `ssd_serve` greedy tokens (hashed), `ssd`
the SSD scan's forward and backward (errors against the plain versions),
`norm` the add + RMSNorm forward (hashed), the RMSNorm backward (errors
against fp64) and five `base` steps.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero before that
line; without CUDA, or outside a checkout of the repo, it exits non-zero at
once.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import random
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

_T_IMPORT = time.time()      # a launched child's time to recover counts from here
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory bandwidth (data sheet)
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
TF32_FLOPS_PER_S = 495e12    # H100 SXM dense TF32 tensor-core rate
RMS_TOL = (1e-3, 1.6e-2)     # (atol, rtol): two bf16 ulps of the plain value
# the RMSNorm backward (the add + RMSNorm backward kernel, norm-only or with
# h and d_s) against its plain version: dx within RMS_TOL (bf16; fp32 rows
# within RMS_TOL_FP32, the atol scaled by max(1, max |plain|)), the site's
# dx with one bf16 ulp of its rounded norm gradient more (fuse_add_norm_slack);
# an fp32 dw within RMS_DW_ATOL of its largest |value| (rtol 0): the kernel
# sums a column's rows in another order (a lane's rows, its CTA's teams, the
# CTAs) than torch's reduction, each order rounding at ~1e-7 of the running
# sum over up to 16384 rows, so the limit keeps a ~100x margin, and one
# CTA's rows left out (~47 of 6144) move dw ~1000x past it; and dw must be
# the same bits in two calls
RMS_TOL_FP32 = (1e-5, 1e-5)
RMS_DW_ATOL = 1e-5
# (atol, rtol) of bf16 flash attention: kernel and plain version compute in
# fp32 from the same bf16 inputs and round once, so two bf16 ulps; the atol
# is scaled by the output's largest |value| (gradients grow with the rows
# they sum), at least 1
FLASH_TOL = (1e-3, 1.6e-2)
# bf16 flash gradients are also held tile by tile: in every (batch, head,
# 64-row tile) block -- the kernels' tile at head_dim 128 -- |kernel - plain|
# / |plain| (Frobenius norms) at most one bf16 ulp, 2^-8.  Under the causal
# mask |dV| and |dK| fall along the keys (late keys are summed over fewer
# queries), so an atol scaled by the whole tensor's largest value is a
# sizeable share of a late tile; a norm per tile holds each tile to its own
# scale.  The planted faults below show the limit rejecting a wrong tile
FLASH_GRAD_TILE = 64
FLASH_GRAD_RTOL = 2.0 ** -8
LSE_TOL = (1e-5, 1e-5)       # fp32 log-sum-exp, sums in another order
# the AdamW kernel rounds each operation on its own, as the plain version's
# separate kernels do: at most this many fp32 ulps apart (FMA contraction
# would cost one), on every leaf of every table
ADAMW_ULPS = 0
# fp32 training parity, card against CPU, after three AdamW steps: the
# parameters at most this far apart, ten times the largest difference read
# on an H100 (5.0e-5).  It cannot see a missing last update (that moves an
# element by about lr = 3e-4), so the step-3 m and v slots are held too:
# within PARITY_SLOT_TOL, ten times the largest error read there (9.9e-5 of
# a slot's largest value, from step-2 and step-3 gradients of parameters
# already that far apart), where one update fewer moves m and v by a third.
# A near-zero gradient whose sign differed by rounding would move its
# element by 2 lr at step 1 and fail the parameter limit on a correct
# kernel; none does at this seed
PARITY_PARAM_ATOL = 5e-4
# rtol, and atol as a share of the tensor's max |value|: step-1 gradients
# (sums in another order) and the step-3 optimizer slots
PARITY_GRAD_TOL = 1e-4
PARITY_SLOT_TOL = 1e-3
TRAIN_STEPS = 5              # steps of the `base` training phase, on one batch
LONGCTX_STEPS = 3            # steps of the `longctx_train` phase
# step 1's loss at `base` in bf16 against the same weights and batch with
# fp32 activations: at most this far apart (prediction in PERF.md)
TRAIN_LOSS_TOL = 1e-2
# the same at `moe`, both forwards routing on the same gshard draws: ~10x
# the card's reading (2.6e-4 on an H100 at 700 W; the bf16 router inputs
# may still send a near-tied token elsewhere)
MOE_TRAIN_LOSS_TOL = 3e-3
# `fuse_train`: the fused leg's step-1 loss against the stock leg's.  Both
# are bf16 steps on the same weights and batch that differ only in where
# bf16 rounding lands (sums in another order), so they are held to the same
# TRAIN_LOSS_TOL that bounds bf16 against fp32 activations; the run prints
# stock's own bf16-vs-fp32 gap beside the reading.  The two stock legs run
# the same code on the same inputs: step 1's losses (a forward of
# deterministic kernels) must be equal to the bit, later ones within
# STOCK_LEGS_RTOL (room for any order-dependent sum in a backward); a table
# leaking out of the fused leg's scope moves step 1 already
STOCK_LEGS_RTOL = 1e-4
# (atol, rtol): the same bf16 rounding limit.  Decode outputs are O(sqrt(1/L))
# (0.04-0.05 at L = 1024-2048), so one dropped or double-counted key, or a
# misweighted split in the combine pass, moves them far past it
DECODE_TOL = (1e-3, 1.6e-2)
# first-token logits of generate (B=1, exact length) against the Engine's
# (bucket-padded batched prefill) at 8B widths in bf16: their max |difference|
# over the vocabulary may be at most this multiple of generate's own bf16
# error, its max |difference| from the same prefill with fp32 activations
LOGIT_TOL = 2.0
# the SSD scan kernels against their plain versions, both fp32 (split-TF32
# products, sums and the log-decay prefix sum in another order):
# elementwise |kernel - plain| at most SSD_ATOL x max |plain|, and in every
# g row (one recurrence) |kernel - plain| / |plain| (Frobenius norms of y
# and of the final state; of dx, db, dc and dla) at most SSD_NORM_RTOL.
# Read on an H100 (split-TF32 kernels): forward 1.52e-6 and 1.18e-6, backward
# up to 2.96e-6 and 2.56e-6 (fp32 rounding is 6e-8; the sums run over up to
# L + N = 256 terms), so each limit is 3-8x its reading; the planted faults
# read 0.06 and up
SSD_ATOL = 1e-5
SSD_NORM_RTOL = 1e-5
# the fusion sites' kernels against their plain versions (the site
# references and torch's autograd of them, over cuBLAS products) in bf16:
# both sum in fp32 and round once, but in another order, so an output lands
# on the other side of a bf16 rounding at times, and one flipped ulp of gate
# or up moves everything after it: (atol, rtol) = (1e-3 x max(1, max
# |plain|), two bf16 ulps), as for flash.  Every output is also held per
# 64-row tile by |kernel - plain| / |plain| (Frobenius norms) at most one
# bf16 ulp, 2^-8; the planted faults below show both checks at work
FUSE_TOL = (1e-3, 1.6e-2)
# ... but the add + RMSNorm backward's residual gradient d_s + g (dx, also
# dh) sums the norm's gradient g after kernel and plain have each rounded g
# to bf16 on its own: where the add cancels, one bf16 ulp of g (0.0156 at
# |g| in [2, 4)) is far above two ulps of the sum.  So those two outputs'
# elementwise limit also takes one bf16 ulp of the plain version's rounded
# g at each element (fuse_add_norm_slack)
FUSE_TILE = 64
FUSE_TILE_RTOL = 2.0 ** -8
# fp32 (CUDA cores, no TF32 on either side): sums of up to 32000 terms in
# another order, ~1e-6 of the scale; elementwise atol as a share of max
# |plain|, rtol, and the tile norm limit
FUSE_TOL_FP32 = (1e-5, 1e-5)
FUSE_TILE_RTOL_FP32 = 1e-5
# `base`'s site shapes: batch 3 x seq 2048 rows, hidden, intermediate, vocab
FUSE_M, FUSE_H, FUSE_I, FUSE_V = 3 * 2048, 2048, 5632, 32000
SSD_TRAIN_LAYERS = 8         # depth of `ssd_train` (32 would need 77 GB for params and AdamW)
GATE_ENTRIES = 20            # the JAX registry's 18, ssd_scan_bwd and rms_norm_bwd
SSD_TRAIN_BATCH, SSD_TRAIN_SEQ = 2, 4096
# `optimizers`: (constructor keywords, parameter limit, slot limit) of each
# optimizer on the tiny Llama, card against CPU after OPT_STEPS TrainStep
# steps in fp32.  The parameter limit is ~10x the largest difference the
# card and the CPU showed (NVIDIA H100, 700 W; this phase's own log, the
# same bits in every run: 0 Rprop, 3.7e-9 Adadelta and RAdam, up to 8.7e-5
# NAdam, where a near-zero gradient's rounding flips an adaptive step's
# sign) and stays below the smallest move one step makes on the CPU (checked
# in the run: 4.5e-6 Adadelta, 1.0e-4 RAdam, ~1e-3 the others), so an update
# skipped or mangled on the card shows.  The slot limit is the atol, as a
# share of the slot's largest |value|, beside rtol OPT_SLOT_RTOL, again ~10x
# the reading (up to 1.3e-4 NAdam's m: later gradients at the parameters
# that differ); 1e-6 where there is no slot or no difference.
OPT_STEPS = 3
OPT_PARITY = {
    "SGD": (dict(learning_rate=1e-2), 1e-6, 1e-6),
    "Momentum": (dict(learning_rate=1e-2, momentum=0.9, use_nesterov=True), 1e-7, 2e-6),
    "Adam": (dict(learning_rate=1e-3, weight_decay=0.01), 1e-4, 2e-4),
    "AdamW": (dict(learning_rate=1e-3, weight_decay=0.1), 5e-4, 6e-4),
    "Adagrad": (dict(learning_rate=1e-3), 3e-5, 5e-8),
    "RMSProp": (dict(learning_rate=1e-3, momentum=0.5, centered=True), 2e-6, 2e-5),
    "Adadelta": (dict(learning_rate=1e-3, weight_decay=0.01), 5e-8, 5e-7),
    "Adamax": (dict(learning_rate=1e-3), 5e-4, 7e-4),
    "Lamb": (dict(learning_rate=1e-3), 2e-6, 3e-6),
    "NAdam": (dict(learning_rate=1e-3), 8e-4, 1.3e-3),
    "RAdam": (dict(learning_rate=1e-3), 5e-8, 2e-6),
    "ASGD": (dict(learning_rate=1e-2), 1e-6, 1e-6),
    "Rprop": (dict(learning_rate=1e-3, learning_rate_range=(1e-5, 1e-3)), 1e-6, 2e-6),
    "LBFGS": (dict(learning_rate=1.0, max_iter=2), 5e-6, 1e-6),
}
OPT_SLOT_RTOL = 1e-4
# fp32 flash attention (the CUDA-core kernels, ERNIE-base's non-causal
# attention) against its plain version: sums in another order, (atol,
# rtol) with the atol scaled by max(1, max |plain|), as the registry's fp32
# entries and tests/test_torch_gpu.py hold them
FLASH_TOL_FP32 = (2e-5, 2e-5)
# step 1 on the card against the CPU in fp32, TF32 off (`parity`'s tiny
# recipes, `ernie_train`'s cut model): the loss within this share of itself
PARITY_LOSS_RTOL = 1e-5
ERNIE_STEPS = 5              # steps of `ernie_train` and of `parity`'s ERNIE-tiny
OCR_STEPS = 5                # steps of each `ocr_train` model
# ERNIE-tiny, ERNIE_STEPS Adam steps card vs CPU in fp32: the losses within
# this share of the CPU's, ~10x the card's reading (1.415e-6 on an H100 at
# 700 W: Adam normalises each step, so rounding in tiny gradients moves
# later losses more than one step's sums do)
ERNIE_PARITY_LOSS_RTOL = 1.5e-5
EAGER_STEPS = 5              # leg 1 of `eager_train`: base through the eager API
EAGER_AMP_STEPS = 3          # leg 2: ERNIE-base under auto_cast O1
# leg 2's step 1 of a 2-layer cut, card against CPU under the same O1
# program: the loss within this share of the CPU's.  On an NVIDIA H100 80GB
# HBM3 at 700.00 W the card's O1 read 1.093e-3 (bf16 products on both sides
# summed in other orders, the card's bf16 flash kernel against the CPU's
# plain attention in fp32 rounded to bf16 once) and the control, the same
# cut on the card without auto_cast, 7.213e-3; the limit sits between, and
# the control must land past it.  (The logits themselves come out of O1 in
# bf16, so one ulp of rounding, 2^-8, hides the difference there: the
# card's O1 logits read 6.6e-3 from the CPU's, the control's 4.5e-3.)
EAGER_AMP_LOSS_RTOL = 3e-3
STATIC_STEPS = 5             # runs of the `static_graph` Program (and TrainStep's steps)
ALL_PHASES = ("card", "build", "kernels", "kernel_gate", "parity", "incubate", "train",
              "eager_train", "static_graph", "longctx_train", "fuse_train", "moe_train",
              "ernie_train",
              "ocr_train", "hapi_train", "nn_tail",
              "ssd_train", "resume_train", "launch_train", "optimizers", "serve", "router_serve",
              "moe_serve",
              "ssd_serve",
              "profile")
REPO = Path(__file__).resolve().parent


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20, sleep_cycles: int = 1_000_000) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after a 64 MiB write that evicts the 50 MB L2 cache (the
    serving path finds its operands cold).  A device sleep of
    ``sleep_cycles`` (~0.5 ms by default) ahead of the start event keeps
    the host's launch cost out of the interval: the host enqueues ``fn``
    while the device sleeps.  A wrapper whose host side takes longer (the
    AdamW table's, a few tenths of a ms over 75 leaves) asks for more."""
    import torch

    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def within(a, b, tol, scaled=False, slack=None):
    """|a - b| <= atol + rtol |b| (+ ``slack``, a tensor of b's shape: a
    further limit at each element); with ``scaled`` the atol is multiplied
    by max(1, max |b|)."""
    atol, rtol = tol
    a, b = a.float(), b.float()
    if scaled:
        atol = atol * max(1.0, float(b.abs().max()))
    limit = atol + rtol * b.abs()
    if slack is not None:
        limit = limit + slack
    return bool(((a - b).abs() <= limit).all())


def max_ulps(a, b):
    """Largest distance in fp32 ulps between same-shaped fp32 tensors (as
    ordered integers: exact for values of one sign)."""
    import torch

    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def tile_rel_err(a, b, tile=FLASH_GRAD_TILE):
    """Largest |a - b| / |b| (Frobenius norms) over the (batch, row tile,
    head) blocks of [B, S, heads, D] tensors; a ragged last tile is padded
    with zero rows, which add to neither norm."""
    import torch.nn.functional as F

    B, S, H, D = b.shape
    pad = -S % tile
    a, b = (F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, -1, tile, H, D)
            for x in (a, b))
    num = (a - b).square().sum((2, 4)).sqrt()
    den = b.square().sum((2, 4)).sqrt()
    return float((num / den.clamp_min(1e-30)).max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {line}")
    log(f"torch device: {torch.cuda.get_device_name(0)}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return line


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.core import native
    from paddle_tpu_torch.kernels import _build

    def build_host():
        """The host runtime's library (g++; launch_train's), beside nvcc."""
        native.load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(build_host)
        libs = _build.load_all()
        log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
        log(f"build: {native.lib_path().name} in {host.result():.1f} s")


def _rms_case(rows, d, gen, w_dtype):
    """bf16 x against a ``w_dtype`` weight: bf16 on the serving path (bf16
    params), fp32 on the training path (fp32 params, bf16 compute)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference

    x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype)
    y = rms_norm(x, w, 1e-6)
    ref = rms_norm_reference(x, w, 1e-6)
    torch.cuda.synchronize()
    err = max_err(y, ref)
    check(within(y, ref, RMS_TOL), f"rms_norm [{rows},{d}] weight {w_dtype} disagrees: "
          f"max err {err}")
    b_ms, b_by = bound(2 * rows * d * x.element_size() + d * w.element_size(), 4 * rows * d)
    rec = {"shape": [rows, d], "dtype": "bfloat16", "weight_dtype": str(w_dtype)[6:],
           "max_abs_err": err,
           "tol": {"atol": RMS_TOL[0], "rtol": RMS_TOL[1]},
           "ms": time_ms(lambda: rms_norm(x, w, 1e-6)),
           "plain_ms": time_ms(lambda: rms_norm_reference(x, w, 1e-6)),
           "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"rms_norm {rows}x{d} bf16, weight {rec['weight_dtype']}: {json.dumps(rec)}")
    return rec


def _dw_rejects(got, ref):
    """The RMSNorm backward's dw check: True when ``got`` fails it against
    ``ref`` (fp32: RMS_DW_ATOL of max |ref|; a 2-byte dw: RMS_TOL)."""
    import torch

    if ref.dtype == torch.float32:
        return not within(got, ref, (RMS_DW_ATOL * float(ref.abs().max()), 0.0))
    return not within(got, ref, RMS_TOL)


def _norm_bwd_case(gen, rows, d, dtype, site=False, timed=True, label=""):
    """The RMSNorm backward kernel against its plain version on ``rows``
    rows of ``d`` (``dtype`` rows over an fp32 weight, as the training paths
    pass): norm-only through ``rms_norm_backward`` (the stock RMSNorm's
    backward; plain: ``rms_norm_backward_reference``, what ran on the card
    before), or with ``site`` through ``add_rms_norm_bwd`` with h and d_s
    (the fuse_add_rms_norm backward; plain: autograd of the plain
    reference).  Checks dx and dw (see RMS_DW_ATOL), dw's bits in two
    calls; ``timed``: kernel, plain, stock-chain and library times, bound,
    the kernels' registers and spill bytes."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import _build, add_rms_norm as arn, emit
    from paddle_tpu_torch.kernels import rms_norm as rn

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    x, dy = rnd(rows, d), rnd(rows, d)
    w = 1 + 0.1 * rnd(d, dt=torch.float32)
    eps = 1e-6
    if site:
        h, d_s = rnd(rows, d), rnd(rows, d)
        args = (x, h, w, d_s, dy, eps)

        def launch():
            dx, _, dw = arn.add_rms_norm_bwd(*args)
            return dx, dw

        def plain():
            dx, _, dw = arn.add_rms_norm_bwd_reference(*args)
            return dx, dw

        slack = fuse_add_norm_slack((x, h, w), (d_s, dy), {"epsilon": eps})
    else:
        def launch():
            return rn.rms_norm_backward(x, w, dy, eps)

        def plain():
            return rn.rms_norm_backward_reference(x, w, dy, eps)

        slack = None
    before = rn.rms_norm_backward.launches
    got, again, ref = launch(), launch(), plain()
    torch.cuda.synchronize()
    check(rn.rms_norm_backward.launches == before + (0 if site else 2),
          f"rms_norm backward [{rows},{d}]: the stock wrapper's count moved "
          f"{rn.rms_norm_backward.launches - before} for {0 if site else 2} launches")
    kind = "add + RMSNorm (h, d_s)" if site else "norm-only"
    shape = {"rows": rows, "d": d, "dtype": str(dtype)[6:], "weight_dtype": "float32",
             "mode": kind, "label": label}
    fp32 = dtype == torch.float32
    errs = {"dx": max_err(got[0], ref[0]), "dw": max_err(got[1], ref[1]),
            "dw_over_max_abs": max_err(got[1], ref[1]) / max(float(ref[1].abs().max()), 1e-30)}
    dx_ok = within(got[0], ref[0], RMS_TOL_FP32 if fp32 else RMS_TOL, scaled=fp32, slack=slack)
    check(dx_ok and not _dw_rejects(got[1], ref[1]),
          f"rms_norm backward {shape}: disagrees with its plain version: {errs}")
    check(torch.equal(got[1], again[1]) and torch.equal(got[0], again[0]),
          f"rms_norm backward {shape}: two calls differ (dw must be summed in a fixed order)")
    check(bool(torch.isfinite(got[0].float()).all() and torch.isfinite(got[1]).all()),
          f"rms_norm backward {shape}: non-finite output")
    plan = arn.bwd_plan(rows, d, dtype, with_h=site, with_ds=site,
                        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    rec = {"shape": shape, "dtype": shape["dtype"], "plan": plan._asdict(),
           "max_abs_err": errs["dx"], "max_abs_err_by_output": errs,
           "tol": {"dx": {"atol": (RMS_TOL_FP32 if fp32 else RMS_TOL)[0],
                          "rtol": (RMS_TOL_FP32 if fp32 else RMS_TOL)[1],
                          "atol_scaled_by_max_abs": fp32,
                          "slack": "one bf16 ulp of the rounded norm gradient" if site else None},
                   "dw": {"atol_over_max_abs": RMS_DW_ATOL, "rtol": 0.0, "bitwise_repeat": True}},
           "ms": None, "plain_ms": None, "stock_chain_ms": None, "library_ms": None,
           "bound_ms": None, "bound_by": None}
    if timed:
        act = rows * d * x.element_size()
        # site: x, h, d_s, d_normed read, ds written once; norm-only: x, dy
        # read, dx written; the weight read and dw written (fp32)
        nbytes = (5 if site else 3) * act + 2 * d * w.element_size()
        b_ms, b_by = bound(nbytes, (14 if site else 10) * rows * d)
        codes = (_build.dtype_code(dtype), _build.dtype_code(w.dtype))
        if plan.kind == "ring":
            main = _build.kernel_attributes("add_rms_norm", 3 if site else 4, *codes, d,
                                            plan.slots * 4 + (3 if site else 0))
        else:
            main = _build.kernel_attributes("add_rms_norm", 1 if site else 5, *codes, d)
        red = _build.kernel_attributes("add_rms_norm", 2 if site else 6, *codes)
        p = [t.detach().requires_grad_() for t in ((x, h, w) if site else (x, w))]
        with torch.enable_grad():
            if site:
                s_ = p[0] + p[1]
                stock_outs, cts = (s_, rn.rms_norm(s_, p[2], eps)), (d_s, dy)
            else:
                stock_outs, cts = (rn.rms_norm(p[0], p[1], eps),), (dy,)
            lib_out = None if site else F.rms_norm(p[0], (d,), p[1], eps)
        rec.update(
            ms=time_ms(launch), plain_ms=time_ms(plain),
            stock_chain_ms=time_ms(lambda: torch.autograd.grad(stock_outs, p, cts,
                                                               retain_graph=True)),
            library_ms=None if site else time_ms(lambda: torch.autograd.grad(
                lib_out, p, dy, retain_graph=True)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            registers=main["registers"], spill_bytes=main["local_bytes"],
            smem_bytes=main["static_smem"] + main["dynamic_smem"],
            dw_kernel_registers=red["registers"], dw_kernel_spill_bytes=red["local_bytes"])
        rec["of_bound"] = b_ms / rec["ms"]
        rec["library"] = ("none: no single PyTorch call computes the site's backward" if site
                          else "torch.autograd.grad through F.rms_norm's graph (PyTorch's own "
                               "RMSNorm backward)")
        rec["stock_chain_note"] = ("autograd backward of the stock forward's saved graph: "
                                   "the residual add's and rms_norm's, whose backward is "
                                   "rms_norm_backward")
        del stock_outs, lib_out, p
    log(f"rms_norm backward {json.dumps(rec)}")
    del x, dy, w, got, again, ref
    if site:
        del h, d_s
    torch.cuda.empty_cache()
    return rec


def _norm_bwd_planted_faults(gen, rows=3 * 2048, d=2048):
    """Faults planted in the norm-only backward's outputs at `base`, each of
    which its checks must reject: one row's mean(g x_hat) term dropped from
    dx, and one CTA's rows (as bwd_plan cuts them on this card) left out of
    dw.  Built from the plain version on the same inputs."""
    import torch
    from paddle_tpu_torch.kernels import add_rms_norm as arn
    from paddle_tpu_torch.kernels import rms_norm as rn

    x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    dx, dw = rn.rms_norm_backward_reference(x, w, dy, 1e-6)
    x32, g = x[5:6].float(), dy[5:6].float() * w
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
    bad_dx = dx.clone()
    bad_dx[5] = (r * g).to(dx.dtype)[0]                       # row 5 without its projection
    plan = arn.bwd_plan(rows, d, torch.bfloat16, with_h=False, with_ds=False,
                        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    c = 5
    r0, r1 = c * rows // plan.ctas, (c + 1) * rows // plan.ctas
    _, dw_cta = rn.rms_norm_backward_reference(x[r0:r1], w, dy[r0:r1], 1e-6)
    out = {"dx: row 5's mean(g x_hat) term dropped": {
               "max_abs_err": max_err(bad_dx, dx),
               "rejected": not within(bad_dx, dx, RMS_TOL)},
           f"dw: CTA {c}'s rows {r0}..{r1 - 1} left out": {
               "max_abs_err_over_max_abs": max_err(dw - dw_cta, dw) / float(dw.abs().max()),
               "rejected": _dw_rejects(dw - dw_cta, dw)}}
    for fault, rec in out.items():
        check(rec["rejected"], f"rms_norm backward: the checks pass the planted fault "
                               f"'{fault}': {rec}")
    log(f"rms_norm backward planted faults: {json.dumps(out)}")
    return out


def _decode_bound(lengths, hk, d, h, itemsize, B):
    live = int(sum(lengths))
    nbytes = live * hk * d * 2 * itemsize + 2 * B * h * d * itemsize
    return bound(nbytes, 4 * h * d * live)


def _sdpa_ms(q, k, v, lengths):
    """One library call on the gathered cache: q [B,1,H,D], k/v [B,C,Hk,D]."""
    import torch
    import torch.nn.functional as F

    C = k.shape[1]
    mask = (torch.arange(C, device="cuda")[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))


def _serve_lengths(seed=0, B=8):
    """The first ``B`` requests of the `serve` phase at their last decode
    step: prompt plus new tokens."""
    from paddle_tpu_torch.models import llama3_8b_config

    reqs = _serve_requests(llama3_8b_config().vocab_size, seed)[0]
    return [len(r.prompt_ids) + r.max_new_tokens for r in reqs[:B]]


def _decode_passes_ms(fn, iters=20):
    """Device ms of each kernel ``fn`` launches (pass 1 and the combine),
    read by torch.profiler over ``iters`` calls, each after the L2 flush of
    ``time_ms``; ``{}`` where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {("partial" if "partial" in ev.key else "combine"):
            ev.self_device_time_total / 1e3 / ev.count
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and "decode_" in ev.key and ev.count}


def _dense_case(gen, lengths, C=2048, label="table"):
    import torch
    from paddle_tpu_torch.kernels import decode_attention as da

    B, H, Hk, D = len(lengths), 32, 8, 128
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, C, Hk, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, C, Hk, D, generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sm = 1.0 / D ** 0.5
    out = da.masked_multihead_attention(q, k, v, lengths)
    ref = da._decode_reference(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(within(out, ref, DECODE_TOL), f"dense decode ({label}) disagrees: max err {err}")
    b_ms, b_by = _decode_bound(lengths.tolist(), Hk, D, H, 2, B)
    rec = {"shape": {"B": B, "C": C, "H": H, "Hk": Hk, "D": D,
                     "lengths": lengths.tolist()}, "dtype": "bfloat16", "lengths_from": label,
           "max_abs_err": err, "tol": {"atol": DECODE_TOL[0], "rtol": DECODE_TOL[1]},
           "ms": time_ms(lambda: da.masked_multihead_attention(q, k, v, lengths)),
           "passes_ms": _decode_passes_ms(lambda: da.masked_multihead_attention(q, k, v, lengths)),
           "plain_ms": time_ms(lambda: da._decode_reference(q, k, v, lengths, sm)),
           "library_ms": _sdpa_ms(q, k, v, lengths),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"decode dense ({label}): {json.dumps(rec)}")
    return rec


def _paged_case(gen, lengths, label="table"):
    """Paged decode over the Engine's pool (512 blocks of 128) and table
    width (8 blocks), NaN in the trash block and in every stale tail."""
    import torch
    from paddle_tpu_torch.kernels import decode_attention as da

    B, NB, H, Hk, bs, D, MAXB = len(lengths), 512, 32, 8, 128, 128, 8
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn(NB, Hk, bs, D, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(NB, Hk, bs, D, generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(1)) + 1
    table = torch.zeros(B, MAXB, dtype=torch.int32)
    nxt = 0
    nan = float("nan")
    kp[0] = nan                       # the trash block
    vp[0] = nan
    for b, L in enumerate(lengths):
        nblk = -(-L // bs)
        table[b, :nblk] = perm[nxt:nxt + nblk].to(torch.int32)
        nxt += nblk
        if L % bs:                    # stale tail of the last live block
            kp[table[b, nblk - 1], :, L % bs:] = nan
            vp[table[b, nblk - 1], :, L % bs:] = nan
    table = table.cuda()
    len_t = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sm = 1.0 / D ** 0.5
    out = da.paged_decode_attention(q, kp, vp, table, len_t)
    ref = da._paged_pool_reference(q, kp, vp, table, len_t, sm)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), f"paged decode ({label}): NaN trash leaked")
    for b, L in enumerate(lengths):
        if L == 0:
            check(bool((out[b] == 0).all()), f"paged decode ({label}): lengths==0 row is not zero")
    err = max_err(out, ref)
    check(within(out, ref, DECODE_TOL), f"paged decode ({label}) disagrees: max err {err}")
    b_ms, b_by = _decode_bound(lengths, Hk, D, H, 2, B)
    kg, vg = da._gather_pool(kp, table), da._gather_pool(vp, table)
    rec = {"shape": {"B": B, "pool": [NB, Hk, bs, D], "maxb": MAXB, "H": H,
                     "lengths": lengths}, "dtype": "bfloat16", "lengths_from": label,
           "max_abs_err": err, "tol": {"atol": DECODE_TOL[0], "rtol": DECODE_TOL[1]},
           "ms": time_ms(lambda: da.paged_decode_attention(q, kp, vp, table, len_t)),
           "passes_ms": _decode_passes_ms(
               lambda: da.paged_decode_attention(q, kp, vp, table, len_t)),
           "plain_ms": time_ms(lambda: da._paged_pool_reference(q, kp, vp, table, len_t, sm)),
           "library_ms": _sdpa_ms(q, kg, vg, len_t),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"decode paged ({label}): {json.dumps(rec)}")
    return rec


def _flash_bounds(B, S, H, Hk, D, itemsize=2, causal=True, flops_per_s=BF16_FLOPS_PER_S):
    """(fwd, bwd) bounds of flash attention (by default causal, at the bf16
    tensor-core rate): bytes each input read once and each output written
    once; operations 4 D (fwd: q.k, p.v) and 10 D (bwd: q.k again, do.v,
    p^T do, ds k, ds^T q) per visible (query, key) pair, every pair of the
    S^2 when not causal."""
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    q_bytes = B * S * H * D * itemsize
    kv_bytes = B * S * Hk * D * itemsize
    lse_bytes = B * H * S * 4
    fwd = bound(2 * q_bytes + 2 * kv_bytes + lse_bytes, 4 * D * pairs, flops_per_s)
    bwd = bound(4 * q_bytes + 4 * kv_bytes + lse_bytes, 10 * D * pairs, flops_per_s)
    return fwd, bwd


def _sdpa_train_ms(q, k, v, do, mode, iters, causal=True):
    """The library on the same inputs: GQA scaled_dot_product_attention
    (causal unless told), ``mode`` "fwd" (its forward), "bwd" (its backward
    alone: torch.autograd.grad over a kept forward) or "fwd+bwd"."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2) for x in (q, k, v))
    dot = do.transpose(1, 2)
    if mode == "fwd":
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
    qg, kg, vg = (x.requires_grad_() for x in (qt.clone(), kt.clone(), vt.clone()))
    if mode == "bwd":
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)
        return time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True),
                       iters)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    return time_ms(fwd_bwd, iters)


def _flash_noncausal_case(gen, B=32, S=512, H=12, D=64, iters=10):
    """ERNIE-base's attention (``ernie_train``: B 32, S 512, 12 heads of 64,
    fp32, non-causal, no mask): the CUDA-core flash kernels forward and
    backward against their plain versions on the same inputs
    (``FLASH_TOL_FP32``, the atol scaled by max |plain|), timed beside
    sdpa's forward and its backward alone; bound at the fp32 rate over all
    S^2 pairs.  The fp32 kernels' registers, spill bytes and shared memory
    at every head dim ride along; none may spill at D <= 128."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda") for _ in range(4))
    sm = D ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, False, sm)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, False, sm)
    shape = {"B": B, "S": S, "H": H, "Hk": H, "D": D, "causal": False}
    err_o, err_lse = max_err(o, o_ref), max_err(lse, lse_ref)
    check(within(o, o_ref, FLASH_TOL_FP32, scaled=True),
          f"flash fwd {shape} fp32: o disagrees, max err {err_o}")
    check(within(lse, lse_ref, LSE_TOL), f"flash fwd {shape} fp32: lse disagrees, {err_lse}")
    grads = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, False, sm)
    refs = fa._flash_bwd_reference(q, k, v, o_ref, lse_ref, do, False, sm)
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        errs[name] = max_err(g, r)
        check(within(g, r, FLASH_TOL_FP32, scaled=True), f"flash bwd {shape} fp32: {name} "
              f"disagrees, max err {errs[name]} (max |ref| {float(r.abs().max())})")
    del grads, refs
    attrs = {d: _flash_attributes(d, "float32") for d in (32, 64, 128, 256)}
    spills = {(d, n): a["local_bytes"] for d, at in attrs.items() for n, a in at.items()
              if d <= 128 and a["local_bytes"]}
    check(not spills, f"flash fp32 kernels spill: {spills} bytes")
    (f_ms, f_by), (b_ms, b_by) = _flash_bounds(B, S, H, H, D, itemsize=4, causal=False,
                                               flops_per_s=FP32_FLOPS_PER_S)
    tol = {"atol": FLASH_TOL_FP32[0], "rtol": FLASH_TOL_FP32[1], "atol_scaled_by_max_abs": True}
    fwd = {"shape": shape, "dtype": "float32", "max_abs_err": err_o, "max_abs_err_lse": err_lse,
           "tol": tol, "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, False, sm), iters),
           "plain_ms": time_ms(lambda: fa._flash_fwd_reference(q, k, v, False, sm), iters),
           "library_ms": _sdpa_train_ms(q, k, v, do, "fwd", iters, causal=False),
           "library": "scaled_dot_product_attention forward, fp32, non-causal",
           "bound_ms": f_ms, "bound_by": f_by,
           "attributes": {d: {"flash_fwd_kernel": at["flash_fwd_kernel"]}
                          for d, at in attrs.items()}}
    bwd = {"shape": shape, "dtype": "float32", "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs, "tol": tol,
           "ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, False, sm),
                         iters),
           "plain_ms": time_ms(lambda: fa._flash_bwd_reference(q, k, v, o_ref, lse_ref, do,
                                                               False, sm), iters),
           "library_ms": _sdpa_train_ms(q, k, v, do, "bwd", iters, causal=False),
           "library": "scaled_dot_product_attention's backward alone, fp32, non-causal",
           "library_fwd_bwd_ms": _sdpa_train_ms(q, k, v, do, "fwd+bwd", iters, causal=False),
           "bound_ms": b_ms, "bound_by": b_by,
           "attributes": {d: {n: at[n] for n in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")}
                          for d, at in attrs.items()}}
    log(f"flash fwd {shape} fp32: {json.dumps(fwd)}")
    log(f"flash bwd {shape} fp32: {json.dumps(bwd)}")
    return fwd, bwd


def _flash_attributes(D, dtype="bfloat16"):
    """Registers, spill (local) bytes and shared memory of the flash
    kernels at head dim ``D``, as the card reports them: the bf16
    tensor-core ones, or the fp32 CUDA-core ones (the dQ pass being the sum
    of the dK/dV pass's dQ shares)."""
    from paddle_tpu_torch.kernels import _build

    names = (("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")
             if dtype == "bfloat16" else
             ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"))
    code = _build.dtype_code(dtype)
    return {name: _build.kernel_attributes("flash_attention", k, code, D)
            for k, name in enumerate(names)}


def _planted_faults(q, k, v, o, lse, do, sm, grads, refs, causal=True):
    """Faults planted in the kernel's own gradients, each of which the
    gradient checks must reject: the diagonal tiles' (query, key) pairs left
    out of dK/dV, one query head left out of its kv-head's dK/dV sum, and
    the last 64 keys' dV 1% off.  The removed parts come from the plain
    backward (it is linear in ``do``, and the diagonal tiles alone are the
    backward, causal or not as the case is, of each tile's own rows over the
    whole rows' o and lse).  Returns, for each fault, each faulted
    gradient's tile error and whether the max-scaled elementwise check
    alone would have passed it."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    T, S = FLASH_GRAD_TILE, q.shape[1]
    dk, dv = (g.float() for g in grads[1:])
    diag_dk, diag_dv = torch.zeros_like(dk), torch.zeros_like(dv)
    for t in range(0, S, T):
        r = slice(t, t + T)
        _, gk, gv = fa._flash_bwd_reference(q[:, r], k[:, r], v[:, r], o[:, r], lse[:, :, r],
                                            do[:, r], causal, sm)
        diag_dk[:, r], diag_dv[:, r] = gk.float(), gv.float()
    do_one = torch.zeros_like(do)
    do_one[:, :, 1] = do[:, :, 1]            # query head 1 (under GQA, of kv-head 0's group)
    _, head_dk, head_dv = fa._flash_bwd_reference(q, k, v, o, lse, do_one, causal, sm)
    late_dv = dv.clone()
    late_dv[:, -T:] *= 1.01
    faulted = {"diagonal tiles dropped from dK/dV": {"dk": dk - diag_dk, "dv": dv - diag_dv},
               "query head 1 dropped from its kv-head's dK/dV sum":
                   {"dk": dk - head_dk.float(), "dv": dv - head_dv.float()},
               "last 64 keys' dV 1% off": {"dv": late_dv}}
    ref = dict(zip(("dq", "dk", "dv"), refs))
    out = {}
    for fault, bad in faulted.items():
        rec = {name: {"tile_norm_err": tile_rel_err(g, ref[name]),
                      "max_scaled_check_passes": within(g, ref[name], FLASH_TOL, scaled=True)}
               for name, g in bad.items()}
        out[fault] = rec
        check(any(r["tile_norm_err"] > FLASH_GRAD_RTOL for r in rec.values()),
              f"flash bwd: the gradient checks pass the planted fault '{fault}': {rec}")
    log(f"flash bwd planted faults: {json.dumps(out)}")
    return out


def _flash_case(gen, B, S, H, Hk, D, heads=None, causal=True):
    """Flash forward and backward kernels against their plain versions on
    the same bf16 inputs (causal unless told).  ``heads``: hold only the first that many
    query heads (and their kv-heads) against the plain version, which
    cannot run whole at `longctx`; plain times are then not taken.  The
    backward of both gets the plain forward's o and lse for those heads."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, Hk, D), rnd(B, S, Hk, D), rnd(B, S, H, D)
    sm = D ** -0.5
    hq = heads or H
    hk = hq * Hk // H
    sub = (q[:, :, :hq], k[:, :, :hk], v[:, :, :hk])
    o, lse = fa.flash_attention_fwd(q, k, v, causal, sm)
    o_ref, lse_ref = fa._flash_fwd_reference(*sub, causal, sm)
    torch.cuda.synchronize()
    shape = {"B": B, "S": S, "H": H, "Hk": Hk, "D": D, "causal": causal}
    if heads:
        shape["checked_heads"] = hq
    err_o = max_err(o[:, :, :hq], o_ref)
    err_lse = max_err(lse[:, :hq], lse_ref)
    check(within(o[:, :, :hq], o_ref, FLASH_TOL, scaled=True),
          f"flash fwd {shape}: o disagrees, max err {err_o}")
    check(within(lse[:, :hq], lse_ref, LSE_TOL), f"flash fwd {shape}: lse disagrees, "
          f"max err {err_lse}")
    o_in, lse_in = o.clone(), lse.clone()
    o_in[:, :, :hq] = o_ref
    lse_in[:, :hq] = lse_ref
    grads = fa.flash_attention_bwd(q, k, v, o_in, lse_in, do, causal, sm)
    refs = fa._flash_bwd_reference(*sub, o_ref, lse_ref, do[:, :, :hq], causal, sm)
    torch.cuda.synchronize()
    errs, tile_errs = {}, {}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        g = g[:, :, :r.shape[2]]
        errs[name] = max_err(g, r)
        tile_errs[name] = tile_rel_err(g, r)
        check(within(g, r, FLASH_TOL, scaled=True), f"flash bwd {shape}: {name} disagrees, "
              f"max err {errs[name]} (max |ref| {float(r.float().abs().max())})")
        check(tile_errs[name] <= FLASH_GRAD_RTOL, f"flash bwd {shape}: {name} disagrees in "
              f"a {FLASH_GRAD_TILE}-row tile by {tile_errs[name]} of its norm")
    faults = None if heads else _planted_faults(q, k, v, o_in, lse_in, do, sm, grads, refs,
                                                   causal)
    del o_ref, lse_ref, refs
    iters = 20 if heads is None else 3

    def plain_fwd():
        """The plain forward over every head: at once, or ``hq`` heads at a
        time where all of the scores would not fit (``heads``)."""
        if heads is None:
            return fa._flash_fwd_reference(q, k, v, causal, sm)
        for h in range(0, H, hq):
            kv = slice(h * Hk // H, h * Hk // H + hk)
            fa._flash_fwd_reference(q[:, :, h:h + hq], k[:, :, kv], v[:, :, kv], causal, sm)

    def plain_bwd():
        if heads is None:
            return fa._flash_bwd_reference(q, k, v, o_in, lse_in, do, causal, sm)
        for h in range(0, H, hq):
            kv = slice(h * Hk // H, h * Hk // H + hk)
            fa._flash_bwd_reference(q[:, :, h:h + hq], k[:, :, kv], v[:, :, kv],
                                    o_in[:, :, h:h + hq], lse_in[:, h:h + hq],
                                    do[:, :, h:h + hq], causal, sm)

    attrs = _flash_attributes(D)
    (f_ms, f_by), (b_ms, b_by) = _flash_bounds(B, S, H, Hk, D, causal=causal)
    tol = {"atol": FLASH_TOL[0], "rtol": FLASH_TOL[1], "atol_scaled_by_max_abs": True,
           "grad_tile_rows": FLASH_GRAD_TILE, "grad_tile_norm_rtol": FLASH_GRAD_RTOL}
    fwd = {"shape": shape, "dtype": "bfloat16", "max_abs_err": err_o,
           "max_abs_err_lse": err_lse, "tol": tol,
           "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal, sm), iters),
           "plain_ms": time_ms(plain_fwd, iters), "plain_heads_a_call": hq,
           "library_ms": _sdpa_train_ms(q, k, v, do, "fwd", iters, causal),
           "library": f"scaled_dot_product_attention(is_causal={causal}, enable_gqa) forward",
           "attributes": {"flash_fwd_tc_kernel": attrs["flash_fwd_tc_kernel"]},
           "bound_ms": f_ms, "bound_by": f_by}
    bwd = {"shape": shape, "dtype": "bfloat16", "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs, "tile_norm_err_by_grad": tile_errs,
           "planted_faults": faults, "tol": tol,
           "ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, o_in, lse_in, do, causal, sm),
                         iters),
           "plain_ms": time_ms(plain_bwd, iters), "plain_heads_a_call": hq,
           "library_ms": _sdpa_train_ms(q, k, v, do, "bwd", iters, causal),
           "library": "scaled_dot_product_attention's backward alone (torch.autograd.grad "
                      "over a kept forward)",
           "library_fwd_bwd_ms": _sdpa_train_ms(q, k, v, do, "fwd+bwd", iters, causal),
           "attributes": {n: attrs[n] for n in ("flash_bwd_dkdv_tc_kernel",
                                                "flash_bwd_dq_tc_kernel")},
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"flash fwd {shape}: {json.dumps(fwd)}")
    log(f"flash bwd {shape}: {json.dumps(bwd)}")
    return fwd, bwd


def _adamw_leaves(sizes, seed, g_dtypes=None):
    """fp32 p, g, m, v a leaf of ``sizes`` (1-D) at the size of `base`'s
    step 10 (g ~ 1e-3, m = 0.3 g, v = g^2), each leaf from a generator of
    its own (``seed`` + its index), so any leaf's inputs can be made
    again; g rounded to ``g_dtypes[i]`` where given."""
    import torch

    leaves = []
    for i, n in enumerate(sizes):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        g = 1e-3 * torch.randn(n, generator=gen, device="cuda")
        p = 0.02 * torch.randn(n, generator=gen, device="cuda")
        g_i = g if g_dtypes is None else g.to(g_dtypes[i])
        leaves.append((p, g_i, 0.3 * g, g * g))
    return leaves


ADAMW_HYPER = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.1)
# the device sleep ahead of each timed AdamW call (~2 ms): longer than its
# wrapper's host side over 75 leaves, so the interval holds device time only
ADAMW_SLEEP_CYCLES = 4_000_000


def _adamw_case(sizes, label, seed, g_dtypes=None):
    """The AdamW kernel, ONE launch over the table of leaves of ``sizes``
    (``adamw.TRAIN_TABLES``, ``adamw.MOE_TABLE``), on fp32 p, m, v and
    gradients at step 10 of `base`'s AdamW, in place; then each leaf against
    the plain version on its inputs made again (``_adamw_leaves``), which
    needs no copy of the table (`ssd_train`'s 2.0 B elements fill 32 GB).
    ``g_dtypes``: each leaf's gradient dtype (default fp32); a leaf with a
    bf16 gradient is a bf16 param over its fp32 master and also writes its
    bf16 copy, as in the `moe` step.  Timed: the kernel's one launch, the
    plain version a leaf, and torch._fused_adamw_ over the same leaves; a
    table that mixes gradient dtypes also times the two designs it replaces
    (the bf16 gradients widened to fp32 first, then one launch; one launch
    a dtype)."""
    import torch
    from paddle_tpu_torch.kernels.adamw import adamw_reference, adamw_update_leaves

    lr, step = 3e-4, 10
    bf = torch.bfloat16
    g_dtypes = g_dtypes or [torch.float32] * len(sizes)
    leaves = _adamw_leaves(sizes, seed, g_dtypes)
    p, g, m, v = (list(c) for c in zip(*leaves))
    outs = [torch.empty(n, dtype=bf, device="cuda") if dt == bf else None
            for n, dt in zip(sizes, g_dtypes)]
    before = adamw_update_leaves.launches
    table = adamw_update_leaves(p, g, m, v, outs, lr, step, **ADAMW_HYPER)
    launches = adamw_update_leaves.launches - before
    check(launches == 1, f"adamw {label}: {launches} launches for {len(p)} leaves, not one")
    ulps, err = 0, 0.0
    for i, n_i in enumerate(sizes):
        p0, g0, m0, v0 = _adamw_leaves([n_i], seed + i, [g_dtypes[i]])[0]
        ref = adamw_reference(p0, g0.float(), m0, v0, lr, step, **ADAMW_HYPER)
        ulps = max(ulps, *(max_ulps(a, b) for a, b in zip((p[i], m[i], v[i]), ref)))
        err = max(err, *(max_err(a, b) for a, b in zip((p[i], m[i], v[i]), ref)))
        if outs[i] is not None:
            ulps = max(ulps, int((outs[i] != ref[0].to(bf)).sum()))
        del p0, g0, m0, v0, ref
    n = sum(x.numel() for x in p)
    check(ulps <= ADAMW_ULPS, f"adamw {label}: {ulps} ulps from the plain version")
    # each input read once, each output written once: p, m, v both ways,
    # the gradient in its own dtype, the bf16 copies
    moved = sum(x.numel() * (24 + x.element_size()) for x in g) + sum(
        2 * o.numel() for o in outs if o is not None)
    b_ms, b_by = bound(moved, 12 * n)

    def kernel():
        adamw_update_leaves(p, g, m, v, outs, lr, step, table=table, **ADAMW_HYPER)

    def plain():
        for pi, gi, mi, vi, o in zip(p, g, m, v, outs):
            p_new = adamw_reference(pi, gi.float(), mi, vi, lr, step, **ADAMW_HYPER)[0]
            if o is not None:
                p_new.to(bf)

    steps = [torch.tensor(float(step), device="cuda") for _ in p]

    def library():
        torch._fused_adamw_(p, g, m, v, [], steps, lr=lr, beta1=0.9, beta2=0.999,
                            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)

    sleep = ADAMW_SLEEP_CYCLES
    try:
        lib_ms = time_ms(library, sleep_cycles=sleep)
    except (RuntimeError, TypeError) as e:   # a yardstick only, never a check
        log(f"adamw {label}: torch._fused_adamw_ not timed: {e}")
        lib_ms = None
    kinds = sorted({str(dt).replace("torch.", "") for dt in g_dtypes})
    rec = {"shape": {"leaves": len(sizes), "elements": n, "label": label},
           "dtype": "float32", "grad_dtypes": kinds,
           "copies": sum(o is not None for o in outs), "max_abs_err": err, "max_ulps": ulps,
           "tol": {"ulps": ADAMW_ULPS}, "launches_a_call": launches,
           "ms": time_ms(kernel, sleep_cycles=sleep), "plain_ms": time_ms(plain),
           "library_ms": lib_ms, "library": "torch._fused_adamw_ over the same leaves",
           "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": moved}
    if len(kinds) > 1:
        rec["replaced_designs_ms"] = _adamw_mixed_alternatives(p, g, m, v, outs, lr, step,
                                                               table, sleep)
    rec["ms_again"] = time_ms(kernel, sleep_cycles=sleep)
    log(f"adamw {label}: {json.dumps(rec)}")
    return rec


def _adamw_mixed_alternatives(p, g, m, v, outs, lr, step, table, sleep):
    """The two designs a table of mixed gradient dtypes could take instead
    of one launch that reads each gradient in its own dtype, timed on the
    same leaves: ``widened`` (every bf16 gradient copied to fp32, then one
    launch: the copies are in the interval) and ``one_launch_a_dtype``."""
    import torch
    from paddle_tpu_torch.kernels.adamw import adamw_update_leaves

    groups = {}
    for i, x in enumerate(g):
        groups.setdefault(x.dtype, []).append(i)
    tables = {}

    def widened():
        adamw_update_leaves(p, [x.float() for x in g], m, v, outs, lr, step, table=table,
                            **ADAMW_HYPER)

    def one_launch_a_dtype():
        for dt, idx in groups.items():
            tables[dt] = adamw_update_leaves(
                *([c[i] for i in idx] for c in (p, g, m, v, outs)), lr, step,
                table=tables.get(dt), **ADAMW_HYPER)

    one_launch_a_dtype()
    torch.cuda.synchronize()
    return {"widened": time_ms(widened, sleep_cycles=sleep),
            "one_launch_a_dtype": time_ms(one_launch_a_dtype, sleep_cycles=sleep)}


def _adamw_ragged(seed):
    """The table's edges, each held to the plain version at 0 ulps: sizes 1,
    3, 4097, an empty leaf, 2048 and three chunks and a tail; the same at
    views of offset 1 (no 16-byte phase: scalar leaves); bf16 gradients
    (both); bf16 and fp32 gradients leaf by leaf in one table (both); bf16
    params with fp32 masters (the param the bf16 copy) and a
    leaf undecayed; 1000 leaves, past one launch's capacity (its launches
    counted).  A planted fault, one entry's size 4 short, must be
    rejected."""
    import torch
    from paddle_tpu_torch.kernels import adamw

    lr, step = 3e-4, 10
    chunk = adamw.CHUNK
    sizes = [1, 3, 4097, 0, 2048, 3 * chunk + 5]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def table(sizes, offset=0, g_dtype=torch.float32):
        def leaf(n, scale):
            return scale * torch.randn(n + offset, generator=gen, device="cuda")[offset:]

        dts = ([torch.bfloat16, torch.float32] * len(sizes) if g_dtype == "mixed"
               else [g_dtype] * len(sizes))
        return [(leaf(n, 0.02), leaf(n, 1e-3).to(dt), leaf(n, 3e-4), leaf(n, 1e-3) ** 2)
                for n, dt in zip(sizes, dts)]

    def run(leaves, outs=None, apply=None):
        p, g, m, v = (list(c) for c in zip(*leaves))
        outs = outs or [None] * len(p)
        ref = [adamw.adamw_reference(pi, gi.float(), mi, vi, lr, step,
                                     apply_decay=True if apply is None else apply[i],
                                     **ADAMW_HYPER)
               for i, (pi, gi, mi, vi) in enumerate(leaves)]
        before = adamw.adamw_update_leaves.launches
        adamw.adamw_update_leaves(p, g, m, v, outs, lr, step, apply_decay=apply, **ADAMW_HYPER)
        launches = adamw.adamw_update_leaves.launches - before
        ulps = 0
        for got, want, o in zip(zip(p, m, v), ref, outs):
            ulps = max([ulps] + [max_ulps(a, b) for a, b in zip(got, want) if a.numel()])
            if o is not None:
                ulps = max(ulps, int((o != want[0].to(torch.bfloat16)).sum()))
        return ulps, launches

    rec = {}
    for label, leaves, kw in (
            ("ragged", table(sizes), {}),
            ("offset 1", table(sizes, 1), {}),
            ("bf16 gradients", table(sizes, 0, torch.bfloat16), {}),
            ("bf16 gradients, offset 1", table(sizes, 1, torch.bfloat16), {}),
            ("bf16 and fp32 gradients in one table", table(sizes, 0, "mixed"), {}),
            ("bf16 and fp32 gradients, offset 1", table(sizes, 1, "mixed"), {}),
            ("bf16 params over masters", table(sizes), dict(
                outs=[torch.empty(n, dtype=torch.bfloat16, device="cuda") for n in sizes],
                apply=[True, False, True, True, True, True])),
            ("1000 leaves", table([5] * 999 + [chunk + 3]), {})):
        ulps, launches = run(leaves, **kw)
        want = -(-sum(1 for p, *_ in leaves if p.numel()) // adamw.TABLE_CAP)
        rec[label] = {"ulps": ulps, "launches": launches}
        check(ulps <= ADAMW_ULPS, f"adamw table {label}: {ulps} ulps from the plain version")
        check(launches == want, f"adamw table {label}: {launches} launches, expected {want}")
    # the planted fault: the table's 2048-value entry 4 values short
    leaves = table(sizes)
    p, g, m, v = (list(c) for c in zip(*leaves))
    ref = [adamw.adamw_reference(*x, lr, step, **ADAMW_HYPER) for x in leaves]
    t = adamw.LeafTable(p, m, v, [None] * len(p), [True] * len(p), [False] * len(p))
    t.fill(g)
    t.groups[0][0][3].n -= 4
    t.launch(adamw.step_scalars(lr, step, 0.9, 0.999, 0.1), (0.9, 0.999, 1e-8, 0.1))
    ulps = max(max_ulps(a, b) for got, want in zip(zip(p, m, v), ref)
               for a, b in zip(got, want) if a.numel())
    check(ulps > ADAMW_ULPS, "adamw table: the planted fault (an entry 4 values short) passed")
    rec["planted fault: an entry 4 values short"] = {"ulps": ulps, "rejected": True}
    log(f"adamw table edges: {json.dumps(rec)}")
    return rec


def _ssd_inputs(gen, G, T, P, N, decay=None):
    """fp32 scan operands: standard normal x, B, C; log-decay -0.1 |n| (a
    per-token decay of ~0.92), or near ``decay`` a token."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x, b, c = rnd(G, T, P), rnd(G, T, N), rnd(G, T, N)
    la = -0.1 * rnd(G, T).abs() if decay is None else (decay + 0.1 * rnd(G, T)).clamp(max=0.0)
    return x, b, c, la


def _ssd_errors(y, s, y_ref, s_ref):
    """(largest |a - plain| / max |plain| of y and of s, largest per-g
    |a - plain| / |plain| in Frobenius norm of y and of s)."""
    def elem(a, r):
        return max_err(a, r) / max(float(r.abs().max()), 1e-30)

    def norm(a, r):
        d = (a.float() - r.float()).flatten(1).norm(dim=1)
        return float((d / r.float().flatten(1).norm(dim=1).clamp_min(1e-30)).max())

    return max(elem(y, y_ref), elem(s, s_ref)), max(norm(y, y_ref), norm(s, s_ref))


def _ssd_rejects(errs):
    return errs[0] > SSD_ATOL or errs[1] > SSD_NORM_RTOL


def _ssd_planted_faults(x, b, c, la, L, y, s, y_ref, s_ref):
    """Faults planted in the kernel's own outputs, each of which the checks
    must reject: the state not carried across chunks (S reset each chunk),
    the mask off by one (s < t: the diagonal term left out), and the
    inter-chunk term C.S dropped on the last chunk.  The removed parts come
    from the plain scan's states entering each chunk."""
    import torch
    from paddle_tpu_torch.kernels.ssd_scan import ssd_scan_states

    G, T, P = x.shape
    N, nc = b.shape[-1], T // L
    _, states = ssd_scan_states(x, b, c, la, L)
    s_in = torch.stack(states[:-1], dim=1)                                    # [G, nc, N, P]
    cum = la.reshape(G, nc, L).cumsum(-1)
    inter = torch.exp(cum)[..., None] * (c.reshape(G, nc, L, N) @ s_in)      # [G, nc, L, P]
    last = torch.zeros_like(inter)
    last[:, -1] = inter[:, -1]
    faulted = {
        "state not carried across chunks": (
            y - inter.reshape(G, T, P),
            s - torch.exp(cum[:, -1, -1])[:, None, None] * s_in[:, -1]),
        "mask off by one (s < t)": (y - (c * b).sum(-1, keepdim=True) * x, s),
        "C.S dropped on the last chunk": (y - last.reshape(G, T, P), s)}
    out = {}
    for fault, (yf, sf) in faulted.items():
        errs = _ssd_errors(yf, sf, y_ref, s_ref)
        out[fault] = {"max_abs_err_over_max": errs[0], "g_norm_err": errs[1]}
        check(_ssd_rejects(errs), f"ssd_scan: the checks pass the planted fault '{fault}': "
              f"{out[fault]}")
    log(f"ssd_scan planted faults: {json.dumps(out)}")
    return out


def _ssd_grad_errors(got, want):
    """_ssd_errors of each of dx, db, dc, dla: {name: (elementwise over max
    |plain|, largest per-g norm)}."""
    out = {}
    for name, a, r in zip(("dx", "db", "dc", "dla"), got, want):
        def norm(a, r):
            d = (a.float() - r.float()).flatten(1).norm(dim=1)
            return float((d / r.float().flatten(1).norm(dim=1).clamp_min(1e-30)).max())
        out[name] = (max_err(a, r) / max(float(r.abs().max()), 1e-30), norm(a, r))
    return out


def _ssd_grad_rejects(errs):
    return any(_ssd_rejects(e) for e in errs.values())


def _ssd_bwd_faulted(x, b, c, la, states, dy, ds, L, fault):
    """The scan's closed-form VJP (kernels/ssd_scan.py
    ssd_scan_bwd_reference, the same steps) with one planted fault: "carry"
    the state gradient not carried across chunks (each chunk's G' is the
    next chunk's own C^T (e dy) only), "end" dla without the state update's
    chunk-end terms, "mask" dM masked off by one (s < t: the diagonal
    dropped).  With ``fault`` None it is the reference bit for bit, which
    _ssd_bwd_planted_faults checks before it plants a fault."""
    import torch

    G, T, P = x.shape
    N, nc = b.shape[-1], T // L
    xr, dyr = x.reshape(G, nc, L, P), dy.reshape(G, nc, L, P)
    br, cr = b.reshape(G, nc, L, N), c.reshape(G, nc, L, N)
    cum = la.reshape(G, nc, L).double().cumsum(-1)
    tot = cum[..., -1:]
    e, w, a = (torch.exp(v.float()) for v in (cum, tot - cum, tot))
    idx = torch.arange(L, device=x.device)
    mask = idx[None, :] <= idx[:, None]
    decay = torch.where(mask, torch.exp(torch.where(
        mask, cum[..., :, None] - cum[..., None, :], 0.0).float()), 0.0)
    m = (cr @ br.transpose(-1, -2)) * decay
    s_in = states[:, :nc]
    q = (cr * e[..., None]).transpose(-1, -2) @ dyr
    if fault == "carry":          # each chunk's G' its successor's Q alone; the last ds
        g_out = torch.cat([q[:, 1:], ds[:, None]], dim=1)
    else:
        grads = [ds]
        for k in reversed(range(nc)):
            grads.append(a[:, k, :, None] * grads[-1] + q[:, k])
        g_out = torch.stack(grads[-2::-1], dim=1)
    dx = m.transpose(-1, -2) @ dyr + (br * w[..., None]) @ g_out
    dcb = (dyr @ xr.transpose(-1, -2)) * decay
    diag = dcb.diagonal(0, -2, -1)[..., None]
    if fault == "mask":
        diag = torch.zeros_like(diag)
    dcb = torch.where(idx[None, :] < idx[:, None], dcb, 0.0)
    dc_in, db_in = dcb @ br, dcb.transpose(-1, -2) @ cr
    dys = e[..., None] * (dyr @ s_in.transpose(-1, -2))
    xg = w[..., None] * (xr @ g_out.transpose(-1, -2))
    dc, db = dc_in + diag * br + dys, db_in + diag * cr + xg
    wterm = (br * xg).sum(-1)[..., :-1]
    dcum = (cr * (dc_in + dys)).sum(-1) - (br * db_in).sum(-1)
    end = wterm.sum(-1) + a[..., 0] * (g_out * s_in).sum((-1, -2))
    if fault == "end":
        end = torch.zeros_like(end)
    dcum = torch.cat([dcum[..., :-1] - wterm, dcum[..., -1:] + end[..., None]], dim=-1)
    dla = dcum.flip(-1).cumsum(-1).flip(-1)
    return dx.reshape(G, T, P), db.reshape(G, T, N), dc.reshape(G, T, N), dla.reshape(G, T)


def _ssd_bwd_planted_faults(x, b, c, la, dy, ds, L):
    """Faults planted in the backward's plain steps, each of which the
    backward's checks must reject: the state gradient not carried across
    chunks, dla missing its state-update (chunk-end) terms, dM masked off by
    one (the diagonal s = t dropped).  At a tenth of the cases' log-decay
    (-0.01 |n| a token): at -0.1 |n| a 128-token chunk keeps e^-10 of the
    state it is handed, so a carry dropped there moves the gradients by
    less than the limit; at -0.01 |n| it keeps e^-1.  The kernel is held to
    the plain version at that decay too."""
    import torch
    from paddle_tpu_torch.kernels import ssd_scan as ts

    la = la / 10
    _, _, states = ts._launch(x, b, c, la, L)
    ops = (x, b, c, la, states, dy, ds)
    want = ts.ssd_scan_bwd_reference(*ops, L)
    check(all(torch.equal(a, r) for a, r in zip(_ssd_bwd_faulted(*ops, L, None), want)),
          "ssd_scan_bwd: the planted faults' copy of the plain backward is not the plain "
          "backward")
    errs = _ssd_grad_errors(ts.ssd_scan_bwd(*ops, chunk=L), want)
    check(not _ssd_grad_rejects(errs), f"ssd_scan_bwd: at log-decay -0.01 |n| the kernel "
                                       f"disagrees: {errs}")
    out = {"kernel at this decay": errs}
    for fault, label in (("carry", "state gradient not carried across chunks"),
                         ("end", "dla missing its state-update term"),
                         ("mask", "dM masked off by one (s < t)")):
        errs = _ssd_grad_errors(_ssd_bwd_faulted(*ops, L, fault), want)
        out[label] = errs
        check(_ssd_grad_rejects(errs), f"ssd_scan_bwd: the checks pass the planted fault "
                                       f"'{label}': {errs}")
    log(f"ssd_scan_bwd planted faults: {json.dumps(out)}")
    return out


def _ssd_bwd_bound(G, T, P, N, L):
    """(bytes, flops) of the backward: x, b, c, la, dy, ds and the saved
    states entering each chunk (nc of the nc + 1: the final one is not read)
    read once, dx, db, dc, dla written once (three [G, T, P], four [G, T, N],
    two [G, T]); a chunk's 3 L (L + 1) N (C B^T, dCB B, dCB^T C over the
    causal entries) + 2 L (L + 1) P (M^T dy, dy x^T) + 8 L N P (C^T (e dy),
    (B w) G', dy S^T, x G'^T) flops."""
    nc = T // L
    nbytes = 4 * (3 * G * T * P + 4 * G * T * N + 2 * G * T + G * nc * N * P + G * N * P)
    flops = G * nc * (3 * L * (L + 1) * N + 2 * L * (L + 1) * P + 8 * L * N * P)
    return nbytes, flops


def _ssd_case(gen, G, T, P, N, L, full):
    """The SSD scan's forward and backward kernels against their plain
    versions (fp32) at one shape: errors within ``SSD_ATOL`` /
    ``SSD_NORM_RTOL`` (the backward: each of dx, db, dc, dla); zero rows
    (inside the last chunk and a whole extra chunk) bitwise no-ops, and in
    the backward zero gradients that leave every other one's bits; a
    log-decay near -20 a token finite and within the limits; with ``full``
    the planted faults.  The fp32 plain backward's own error against fp64 is
    logged beside.  Returns (forward record, backward record)."""
    import torch
    from paddle_tpu_torch.kernels import ssd_scan as ts

    x, b, c, la = _ssd_inputs(gen, G, T, P, N)
    y, s = ts.ssd_scan(x, b, c, la, chunk=L)
    y_ref, s_ref = ts.ssd_scan_reference(x, b, c, la, L)
    torch.cuda.synchronize()
    shape = {"G": G, "T": T, "P": P, "N": N, "L": L}
    errs = _ssd_errors(y, s, y_ref, s_ref)
    check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()), f"ssd_scan {shape}: not finite")
    check(not _ssd_rejects(errs), f"ssd_scan {shape}: disagrees with the plain scan: max err "
          f"{errs[0]} of max |plain| (limit {SSD_ATOL}), g-row norm err {errs[1]} "
          f"(limit {SSD_NORM_RTOL})")
    zeros = [t.clone() for t in (x, b, c, la)]
    for t in zeros:
        t[:, T - 5:] = 0
    y0, s0 = ts.ssd_scan(*zeros, chunk=L)
    y1, s1 = ts.ssd_scan(*[torch.cat([t, torch.zeros_like(t[:, :L])], dim=1) for t in zeros],
                         chunk=L)
    check(torch.equal(y0, y1[:, :T]) and torch.equal(s0, s1),
          f"ssd_scan {shape}: zero rows are not exact no-ops")
    x20, b20, c20, la20 = _ssd_inputs(gen, min(G, 16), T, P, N, decay=-20.0)
    y20, s20 = ts.ssd_scan(x20, b20, c20, la20, chunk=L)
    errs20 = _ssd_errors(y20, s20, *ts.ssd_scan_reference(x20, b20, c20, la20, L))
    check(bool(torch.isfinite(y20).all() and torch.isfinite(s20).all()),
          f"ssd_scan {shape}: log-decay near -20 gives non-finite values")
    check(not _ssd_rejects(errs20), f"ssd_scan {shape}: log-decay near -20 disagrees: {errs20}")
    faults = _ssd_planted_faults(x, b, c, la, L, y, s, y_ref, s_ref) if full else None

    # the backward: the kernels against the plain closed form on the same
    # inputs, the forward kernels' states and the same cotangents
    _, _, states = ts._launch(x, b, c, la, L)
    dy, ds = (torch.randn(t.shape, generator=gen, device="cuda") for t in (y, s))
    ops = (x, b, c, la, states, dy, ds)
    got = ts.ssd_scan_bwd(*ops, chunk=L)
    want = ts.ssd_scan_bwd_reference(*ops, L)
    torch.cuda.synchronize()
    berrs = _ssd_grad_errors(got, want)
    check(all(bool(torch.isfinite(g).all()) for g in got), f"ssd_scan_bwd {shape}: not finite")
    check(not _ssd_grad_rejects(berrs), f"ssd_scan_bwd {shape}: disagrees with the plain "
          f"backward: {berrs} (limits {SSD_ATOL}, {SSD_NORM_RTOL})")
    # zero rows (dy 0 there, ds 0): zero gradients, and an appended zero
    # chunk changes no bit of the others
    zs = [t.clone() for t in (x, b, c, la, dy)]
    for t in zs:
        t[:, T - 5:] = 0

    def zgrads(x, b, c, la, dy):
        _, s, st = ts._launch(x, b, c, la, L)
        return ts.ssd_scan_bwd(x, b, c, la, st, dy, torch.zeros_like(s), chunk=L)

    g0 = zgrads(*zs)
    g1 = zgrads(*[torch.cat([t, torch.zeros_like(t[:, :L])], dim=1) for t in zs])
    check(all(torch.equal(a, r[:, :T]) and bool((r[:, T - 5:] == 0).all())
              for a, r in zip(g0, g1)),
          f"ssd_scan_bwd {shape}: zero rows do not give exact zero gradients and no-ops")
    del g0, g1, zs
    _, _, st20 = ts._launch(x20, b20, c20, la20, L)
    ops20 = (x20, b20, c20, la20, st20, dy[:x20.shape[0]], ds[:x20.shape[0]])
    got20 = ts.ssd_scan_bwd(*ops20, chunk=L)
    berrs20 = _ssd_grad_errors(got20, ts.ssd_scan_bwd_reference(*ops20, L))
    check(all(bool(torch.isfinite(g).all()) for g in got20),
          f"ssd_scan_bwd {shape}: log-decay near -20 gives non-finite gradients")
    check(not _ssd_grad_rejects(berrs20),
          f"ssd_scan_bwd {shape}: log-decay near -20 disagrees: {berrs20}")
    # the fp32 plain backward's own error against fp64, at both decays
    fp64 = {}
    for label, o in (("decay_0.1", ops), ("decay_near_minus_20", ops20)):
        x_, b_, c_, la_, _, dy_, ds_ = o
        _, st32 = ts.ssd_scan_states(x_, b_, c_, la_, L)
        plain32 = ts.ssd_scan_bwd_reference(x_, b_, c_, la_, torch.stack(st32, 1), dy_, ds_, L)
        o64 = [t.double() for t in (x_, b_, c_, la_)]
        _, st64 = ts.ssd_scan_states(*o64, L)
        plain64 = ts.ssd_scan_bwd_reference(*o64, torch.stack(st64, 1), dy_.double(),
                                            ds_.double(), L)
        fp64[label] = _ssd_grad_errors(plain32, plain64)
        del plain32, plain64, st32, st64, o64
    bfaults = _ssd_bwd_planted_faults(x, b, c, la, dy, ds, L) if full else None

    plain_bwd_ms = time_ms(lambda: ts.ssd_scan_bwd_reference(*ops, L), 5)
    # the backward before the scan had a backward kernel: autograd through a
    # recompute of the plain scan (the forward record's plain_backward_ms)
    args = [t.detach().requires_grad_() for t in (x, b, c, la)]

    def recompute_backward():
        with torch.enable_grad():
            yy, ss = ts.ssd_scan_reference(*args, L)
        torch.autograd.grad((yy, ss), args, (dy, ds))
    nbytes = 4 * (2 * G * T * P + 2 * G * T * N + G * T + G * N * P)
    # a chunk: C.B^T and M.x over the L(L+1)/2 entries with s <= t (the
    # causal mask needs no others), C.S and the state update in full
    flops = G * (T // L) * (L * (L + 1) * (N + P) + 4 * L * N * P)
    b_ms, b_by = bound(nbytes, flops)
    tc_ms, tc_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    rec = {"shape": shape, "dtype": "float32", "max_abs_err": max_err(y, y_ref),
           "max_abs_err_state": max_err(s, s_ref), "max_err_over_max_abs": errs[0],
           "g_norm_err": errs[1], "zero_rows_bitwise": True,
           "decay_near_minus_20": {"max_err_over_max_abs": errs20[0], "g_norm_err": errs20[1]},
           "planted_faults": faults,
           "tol": {"atol_over_max_abs": SSD_ATOL, "g_norm_rtol": SSD_NORM_RTOL},
           "ms": time_ms(lambda: ts.ssd_scan(x, b, c, la, chunk=L)),
           "plain_ms": time_ms(lambda: ts.ssd_scan_reference(x, b, c, la, L)),
           "library_ms": None,
           "library": "none: no single PyTorch call computes the chunked scan",
           "plain_backward_ms": time_ms(recompute_backward, 5),
           "bound_ms": b_ms, "bound_by": b_by, "bound_tf32x3_ms": tc_ms, "bound_tf32x3_by": tc_by,
           "bytes": nbytes, "flops": flops}
    log(f"ssd_scan {shape}: {json.dumps(rec)}")
    nbytes, flops = _ssd_bwd_bound(G, T, P, N, L)
    b_ms, b_by = bound(nbytes, flops)
    tc_ms, tc_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    brec = {"shape": shape, "dtype": "float32",
            "max_abs_err": max(max_err(a, r) for a, r in zip(got, want)),
            "max_abs_err_by_output": {n: max_err(a, r) for n, a, r in
                                      zip(("dx", "db", "dc", "dla"), got, want)},
            "errors": berrs, "decay_near_minus_20": berrs20, "plain_fp32_vs_fp64": fp64,
            "zero_rows_bitwise": True, "planted_faults": bfaults,
            "tol": {"atol_over_max_abs": SSD_ATOL, "g_norm_rtol": SSD_NORM_RTOL},
            "ms": time_ms(lambda: ts.ssd_scan_bwd(*ops, chunk=L)),
            "plain_ms": plain_bwd_ms,
            "library_ms": None,
            "library": "none: no single PyTorch call computes the scan's VJP",
            "bound_ms": b_ms, "bound_by": b_by, "bound_tf32x3_ms": tc_ms,
            "bound_tf32x3_by": tc_by, "bytes": nbytes, "flops": flops}
    log(f"ssd_scan_bwd {shape}: {json.dumps(brec)}")
    return rec, brec


def rows_tile_err(a, b, tile=FUSE_TILE):
    """Largest |a - b| / |b| (Frobenius norms) over the ``tile``-row blocks
    of 2-D tensors (a vector is one row); a ragged last tile is padded with
    zero rows, which add to neither norm."""
    import torch.nn.functional as F

    a, b = (x.float().reshape(-1, x.shape[-1]) for x in (a, b))
    pad = -b.shape[0] % tile
    a, b = (F.pad(x, (0, 0, 0, pad)).reshape(-1, tile, x.shape[-1]) for x in (a, b))
    num = (a - b).square().sum((1, 2)).sqrt()
    return float((num / b.square().sum((1, 2)).sqrt().clamp_min(1e-30)).max())


def _fuse_rejects(got, ref, fp32, slack=None):
    """The fusion checks: True when ``got`` fails them against ``ref``
    (``slack``: a further elementwise limit, see FUSE_TOL)."""
    tol, tile = (FUSE_TOL_FP32, FUSE_TILE_RTOL_FP32) if fp32 else (FUSE_TOL, FUSE_TILE_RTOL)
    if fp32:
        tol = (tol[0] * max(float(ref.float().abs().max()), 1e-30), tol[1])
    return (not within(got, ref, tol, scaled=not fp32, slack=slack)
            or rows_tile_err(got, ref) > tile)


def fuse_add_norm_slack(args, cts, static):
    """One bf16 ulp, at each element, of the add + RMSNorm site's norm
    gradient g as the plain version rounds it before the residual add
    (``emit.add_norm_slack``, which the kernel gate's limit takes too): the
    further limit of that backward's dx and dh (FUSE_TOL).  None for fp32
    rows, which round nothing."""
    import torch
    from paddle_tpu_torch.kernels import emit

    if args[0].dtype == torch.float32:
        return None
    return emit.add_norm_slack(*args, *cts, epsilon=static["epsilon"])


def _site_args(gen, name, M, dtype, transpose=False, device="cuda"):
    """A site's operands at `base` widths, ``M`` rows of ``dtype``
    activations, fp32 weights at the model's init scale: hidden rows N(0, 1)
    (N(0, 4) before the final norm, whose inverse RMS is then ~0.5), norm
    weights 1 + N(0, 0.01), projections N(0, 0.02^2)."""
    import torch

    def rnd(*shape, std=1.0, dt=torch.float32):
        return (std * torch.randn(*shape, generator=gen, device=device)).to(dt)

    H, I, V = FUSE_H, FUSE_I, FUSE_V
    if name == "fuse_swiglu_mlp":
        return (rnd(M, H, dt=dtype), rnd(H, 2 * I, std=0.02), rnd(I, H, std=0.02)), \
            {"intermediate_size": I}
    if name == "fuse_add_rms_norm":
        return (rnd(M, H, dt=dtype), rnd(M, H, dt=dtype), 1 + rnd(H, std=0.1)), {"epsilon": 1e-6}
    w_head = rnd(V, H, std=0.02) if transpose else rnd(H, V, std=0.02)
    return (rnd(M, H, std=2.0, dt=dtype), 1 + rnd(H, std=0.1), w_head), \
        {"epsilon": 1e-6, "transpose": transpose}


def _stock_chain(name, args, static):
    """The seam's stock path, which the site replaces: cuBLAS products and
    torch elementwise ops, with the RMSNorm kernel where the model has it."""
    from paddle_tpu_torch.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.models.llama import mlp_fn

    if name == "fuse_swiglu_mlp":
        return mlp_fn(*args, static["intermediate_size"])
    if name == "fuse_add_rms_norm":
        s = args[0] + args[1]
        return s, rms_norm(s, args[2], static["epsilon"])
    hidden, w_norm, w_head = args
    normed = rms_norm(hidden, w_norm, static["epsilon"])
    wh = w_head.to(normed.dtype)
    return normed @ (wh.T if static["transpose"] else wh)


def _site_bounds(name, M, itemsize):
    """(forward, backward) bounds of a site at `base` widths: bytes with
    each input read once and each output written once (fp32 weights and
    weight gradients), operations at the bf16 tensor-core rate (fp32 rate
    for fp32 activations, and for the add + norm's few flops an element)."""
    H, I, V = FUSE_H, FUSE_I, FUSE_V
    rate = BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S
    act = M * H * itemsize
    if name == "fuse_swiglu_mlp":
        w = 3 * H * I * 4
        mm = 2 * M * H * I                     # one [M, H] x [H, I] product
        # forward: gate_up (2 mm) + down (1 mm); backward: gate_up again,
        # d_act, dW_down, d_hidden (2 mm), dW_gate_up (2 mm)
        return (bound(2 * act + w, 3 * mm, rate), bound(3 * act + 2 * w, 8 * mm, rate))
    if name == "fuse_add_rms_norm":
        # backward: x, h, d_s, d_normed read; ds written once (it is dx and dh)
        return (bound(4 * act + H * 4, 5 * M * H), bound(5 * act + 2 * H * 4, 14 * M * H))
    logits = M * V * itemsize
    mm = 2 * M * H * V
    return (bound(act + H * 4 + H * V * 4 + logits, mm, rate),
            bound(2 * act + 2 * H * 4 + 2 * H * V * 4 + logits, 2 * mm, rate))


def _fuse_planted_faults(gen, M=FUSE_M, device="cuda"):
    """Faults planted in the sites' outputs at `base` widths (``M`` rows),
    each of which the fusion checks must reject: the gate and up halves
    swapped, the down product's last K tile (32 of 5632) dropped, one row's
    RMS scale skipped in the head's prologue, and one row's norm gradient
    dropped from the add + RMSNorm backward's dx (held with that output's
    further limit, fuse_add_norm_slack).  Each is built from the plain
    pieces on the same inputs and held against the plain output."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import emit

    (x, w_gu, w_d), st = _site_args(gen, "fuse_swiglu_mlp", M, torch.bfloat16, device=device)
    I = st["intermediate_size"]
    ref = emit._swiglu_ref(x, w_gu, w_d, intermediate_size=I)
    gate, up = torch.split(x @ w_gu.to(x.dtype), [I, I], dim=-1)
    act = F.silu(gate) * up
    wd = w_d.to(x.dtype)
    faults = {"gate and up halves swapped": (F.silu(up) * gate) @ wd,
              "down product's last K tile dropped": act[:, :-32] @ wd[:-32]}
    refs = {k: ref for k in faults}
    slacks = {}
    (hid, w_n, w_h), st = _site_args(gen, "fuse_rms_norm_head", M, torch.bfloat16,
                                     device=device)
    logits = emit._rms_norm_head_ref(hid, w_n, w_h, **st)
    bad = logits.clone()
    unscaled = (hid[5].float() * w_n).to(hid.dtype)           # row 5 without its 1/RMS
    bad[5] = unscaled @ w_h.to(hid.dtype)
    faults["one row's RMS scale skipped"] = bad
    refs["one row's RMS scale skipped"] = logits
    args, st = _site_args(gen, "fuse_add_rms_norm", M, torch.bfloat16, device=device)
    site = emit.SITES["fuse_add_rms_norm"]
    cts = tuple(torch.randn(a.shape, generator=gen, device=device).to(a.dtype)
                for a in args[:2])
    dx = emit._vjp_reference(site, args, cts, st)[0]
    bad = dx.clone()
    bad[5] = cts[0][5]                                        # row 5 without its norm gradient
    fault = "one row's norm gradient dropped (add + RMSNorm dx)"
    faults[fault], refs[fault] = bad, dx
    slacks[fault] = fuse_add_norm_slack(args, cts, st)
    out = {}
    for fault, got in faults.items():
        r = refs[fault]
        out[fault] = {"tile_norm_err": rows_tile_err(got, r),
                      "elementwise_check_passes": within(got, r, FUSE_TOL, scaled=True,
                                                         slack=slacks.get(fault))}
        check(_fuse_rejects(got, r, False, slacks.get(fault)),
              f"fusion sites: the checks pass the planted fault '{fault}': {out[fault]}")
    log(f"fusion planted faults: {json.dumps(out)}")
    return out


def _site_case(gen, name, M, dtype, transpose=False, timed=False):
    """A site's forward and backward kernels (``emit._FORWARD`` /
    ``emit._BACKWARD``, the launches ``make_fused`` makes) against the plain
    reference and torch's autograd of it, on the same inputs and
    cotangents.  ``timed``: kernel, plain and stock-chain times, bounds."""
    import torch
    from paddle_tpu_torch.kernels import emit

    site = emit.SITES[name]
    args, st = _site_args(gen, name, M, dtype, transpose)
    fp32 = dtype == torch.float32
    outs = emit._as_tuple(emit._FORWARD[name](*args, **st))
    refs = emit._as_tuple(site.ref(*args, **st))
    cts = tuple(torch.randn(r.shape, generator=gen, device="cuda").to(r.dtype) for r in refs)
    grads = emit._BACKWARD[name](args, cts, **st)
    want = emit._vjp_reference(site, args, cts, st)
    torch.cuda.synchronize()
    shape = {"M": M, "H": FUSE_H, "dtype": str(dtype)[6:], "weights": "float32"}
    shape.update({"I": FUSE_I} if name == "fuse_swiglu_mlp" else
                 {"V": FUSE_V, "tied": transpose} if name == "fuse_rms_norm_head" else {})
    # the add + RMSNorm backward's dx and dh: one bf16 ulp of the rounded
    # norm gradient more (FUSE_TOL)
    slack = fuse_add_norm_slack(args, cts, st) if name == "fuse_add_rms_norm" else None
    recs = []
    for direction, got, ref in (("forward", outs, refs), ("backward", grads, want)):
        errs = [max_err(g, r) for g, r in zip(got, ref)]
        tiles = [rows_tile_err(g, r) for g, r in zip(got, ref)]
        for i, (g, r) in enumerate(zip(got, ref)):
            check(g.dtype == r.dtype and g.shape == r.shape,
                  f"{name} {direction} {shape}: output {i} is {g.dtype} {tuple(g.shape)}, plain "
                  f"{r.dtype} {tuple(r.shape)}")
            extra = slack if direction == "backward" and i < 2 else None
            check(not _fuse_rejects(g, r, fp32, extra),
                  f"{name} {direction} {shape}: output {i} disagrees: max err {errs[i]} (max "
                  f"|plain| {float(r.float().abs().max())}), {FUSE_TILE}-row tile norm err "
                  f"{tiles[i]}")
        recs.append({"shape": shape, "dtype": shape["dtype"], "max_abs_err": max(errs),
                     "max_abs_err_by_output": errs, "tile_norm_err_by_output": tiles,
                     "tol": {"atol": (FUSE_TOL_FP32 if fp32 else FUSE_TOL)[0],
                             "rtol": (FUSE_TOL_FP32 if fp32 else FUSE_TOL)[1],
                             "atol_scaled_by_max_abs": True, "tile_rows": FUSE_TILE,
                             "tile_norm_rtol": FUSE_TILE_RTOL_FP32 if fp32 else FUSE_TILE_RTOL},
                     "ms": None, "plain_ms": None, "stock_chain_ms": None,
                     "library_ms": None,
                     "library": "none: no single PyTorch call computes the site; stock_chain_ms "
                                "is the seam's stock path (cuBLAS products + elementwise ops), "
                                "not one call",
                     "bound_ms": None, "bound_by": None})
    if timed:
        (f_ms, f_by), (b_ms, b_by) = _site_bounds(name, M, 2 if dtype == torch.bfloat16 else 4)
        p = [a.detach().requires_grad_() for a in args]
        with torch.enable_grad():
            stock_outs = emit._as_tuple(_stock_chain(name, p, st))
        recs[0].update(
            ms=time_ms(lambda: emit._FORWARD[name](*args, **st)),
            plain_ms=time_ms(lambda: site.ref(*args, **st)),
            stock_chain_ms=time_ms(lambda: _stock_chain(name, args, st)),
            bound_ms=f_ms, bound_by=f_by)
        recs[1].update(
            ms=time_ms(lambda: emit._BACKWARD[name](args, cts, **st)),
            plain_ms=time_ms(lambda: emit._vjp_reference(site, args, cts, st)),
            stock_chain_ms=time_ms(lambda: torch.autograd.grad(stock_outs, p, cts,
                                                               retain_graph=True)),
            bound_ms=b_ms, bound_by=b_by)
        recs[1]["stock_chain_note"] = "autograd backward of the stock forward's saved graph"
        del stock_outs, p
    for direction, rec in zip(("forward", "backward"), recs):
        log(f"{name} {direction} {shape}: {json.dumps(rec)}")
    return recs


def _gemm_products(gen):
    """Each bf16 GEMM launch of the sites at `base` timed on its own, on
    operands already in bf16 (the weights rounded, the head's rows normed):
    ms, TFLOP/s, bound, the card's registers and spill bytes, and one
    torch.matmul on the same operands as the yardstick (``library_ms``; the
    port never calls it); each product also held to the fusion checks
    against its plain version.  Then the two preparation passes (the
    head's fp32 weight rounded, the head's rows normed), against their
    plain versions bit for bit, with the torch cast as their yardstick.
    Returns ``{site: [record, ...]}``."""
    import torch
    from paddle_tpu_torch.kernels import _build, emit
    from paddle_tpu_torch.kernels import fused_gemm as fg

    M, H, I, V = FUSE_M, FUSE_H, FUSE_I, FUSE_V
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, std=1.0, dt=bf):
        return (std * torch.randn(*shape, generator=gen, device="cuda")).to(dt)

    x, dy, act = rnd(M, H), rnd(M, H), rnd(M, I)
    d_gu, normed, d_logits = rnd(M, 2 * I), rnd(M, H), rnd(M, V)
    wgu, wd, wh = rnd(H, 2 * I, std=0.02), rnd(I, H, std=0.02), rnd(H, V, std=0.02)
    # (site, product, launch, plain, yardstick, layout (a_t, b_t, epilogue), M, N, K, bytes)
    S, SB = fg._EPI_SWIGLU, fg._EPI_SWIGLU_BWD
    products = [
        ("fuse_swiglu_mlp", "gate_up+swiglu", lambda: fg.swiglu_gate_up(x, wgu, I),
         lambda: fg.swiglu_gate_up_reference(x, wgu, I), lambda: torch.matmul(x, wgu),
         (0, 0, S), M, I, H, 2 * (M * H + H * 2 * I + M * I)),
        ("fuse_swiglu_mlp", "down", lambda: fg.matmul(act, wd),
         lambda: fg.matmul_reference(act, wd), lambda: torch.matmul(act, wd),
         (0, 0, 0), M, H, I, 2 * (M * I + I * H + M * H)),
        ("fuse_swiglu_mlp_bwd", "d_act", lambda: fg.matmul(dy, wd, b_t=True),
         lambda: fg.matmul_reference(dy, wd, b_t=True), lambda: torch.matmul(dy, wd.T),
         (0, 1, 0), M, I, H, 2 * (M * H + I * H + M * I)),
        ("fuse_swiglu_mlp_bwd", "gate_up+swiglu_bwd",
         lambda: fg.swiglu_gate_up_bwd(x, wgu, act, I),
         lambda: fg.swiglu_gate_up_bwd_reference(x, wgu, act, I), lambda: torch.matmul(x, wgu),
         (0, 0, SB), M, I, H, 2 * (M * H + H * 2 * I + 2 * M * I + M * 2 * I)),
        ("fuse_swiglu_mlp_bwd", "d_w_down", lambda: fg.matmul(act, dy, a_t=True, out_dtype=f32),
         lambda: fg.matmul_reference(act, dy, a_t=True, out_dtype=f32),
         lambda: torch.matmul(act.T, dy), (1, 0, 0), I, H, M, 2 * (M * I + M * H) + 4 * I * H),
        ("fuse_swiglu_mlp_bwd", "d_hidden", lambda: fg.matmul(d_gu, wgu, b_t=True),
         lambda: fg.matmul_reference(d_gu, wgu, b_t=True), lambda: torch.matmul(d_gu, wgu.T),
         (0, 1, 0), M, H, 2 * I, 2 * (M * 2 * I + H * 2 * I + M * H)),
        ("fuse_swiglu_mlp_bwd", "d_w_gate_up",
         lambda: fg.matmul(x, d_gu, a_t=True, out_dtype=f32),
         lambda: fg.matmul_reference(x, d_gu, a_t=True, out_dtype=f32),
         lambda: torch.matmul(x.T, d_gu), (1, 0, 0), H, 2 * I, M,
         2 * (M * H + M * 2 * I) + 4 * H * 2 * I),
        ("fuse_rms_norm_head", "head", lambda: fg.matmul(normed, wh),
         lambda: fg.matmul_reference(normed, wh), lambda: torch.matmul(normed, wh),
         (0, 0, 0), M, V, H, 2 * (M * H + H * V + M * V)),
        ("fuse_rms_norm_head_bwd", "d_normed", lambda: fg.matmul(d_logits, wh, b_t=True),
         lambda: fg.matmul_reference(d_logits, wh, b_t=True),
         lambda: torch.matmul(d_logits, wh.T), (0, 1, 0), M, H, V, 2 * (M * V + H * V + M * H)),
        ("fuse_rms_norm_head_bwd", "d_w_head",
         lambda: fg.matmul(normed, d_logits, a_t=True, out_dtype=f32),
         lambda: fg.matmul_reference(normed, d_logits, a_t=True, out_dtype=f32),
         lambda: torch.matmul(normed.T, d_logits), (1, 0, 0), H, V, M,
         2 * (M * H + M * V) + 4 * H * V),
    ]
    out = {}
    code = _build.dtype_code(bf)
    for site, name, launch, plain, yard, (a_t, b_t, epi), m, n, k, nbytes in products:
        got, ref = emit._as_tuple(launch()), emit._as_tuple(plain())
        for g, r in zip(got, ref):
            check(not _fuse_rejects(g, r, False),
                  f"{name} at base: max err {max_err(g, r)} (max |plain| "
                  f"{float(r.float().abs().max())}), tile norm err {rows_tile_err(g, r)}")
        flops = 2 * m * n * k * (2 if epi else 1)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        ms = time_ms(launch)
        at = _build.kernel_attributes("fused_gemm", 2, code, 0,
                                      a_t | (1 - b_t) << 1 | epi << 2)
        rec = {"product": name, "M": m, "N": n, "K": k,
               "layout": ("T" if a_t else "N") + ("T" if b_t else "N"),
               "epilogue": ("store", "swiglu", "swiglu_bwd")[epi], "gflop": flops / 1e9,
               "ms": ms, "tflops": flops / ms / 1e9, "bound_ms": b_ms, "bound_by": b_by,
               "of_bound": b_ms / ms, "library_ms": time_ms(yard),
               "library": "torch.matmul of the same bf16 operands (no epilogue)",
               "max_abs_err": max(max_err(g, r) for g, r in zip(got, ref)),
               "registers": at["registers"], "spill_bytes": at["local_bytes"],
               "smem_bytes": at["static_smem"] + at["dynamic_smem"]}
        log(f"fused GEMM {site} {name}: {json.dumps(rec)}")
        out.setdefault(site, []).append(rec)
    w32 = torch.randn(H, V, generator=gen, device="cuda")
    r = 0.5 + torch.rand(M, generator=gen, device="cuda")
    w_norm = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    passes = [("fuse_rms_norm_head", "round w_head (fp32 [2048, 32000])",
               lambda: fg.to_compute(w32, bf), lambda: w32.to(bf), H * V * 6, (0, 0)),
              ("fuse_rms_norm_head", "normed rows ([6144, 2048] bf16)",
               lambda: fg._prep(x, (r, w_norm, "a")),
               lambda: ((x.float() * r[:, None]) * w_norm).to(bf), M * H * 4 + M * 4 + H * 4,
               (code, 1))]
    for site, name, launch, plain, nbytes, (dt, scale) in passes:
        got, ref = launch(), plain()
        check(torch.equal(got, ref), f"the preparation pass {name} is not bitwise its plain version")
        b_ms, b_by = bound(nbytes, 0)
        at = _build.kernel_attributes("fused_gemm", 3, dt, scale)
        rec = {"product": f"prep_kernel: {name}", "ms": time_ms(launch), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": time_ms(plain),
               "library": "the torch ops of the plain version", "max_abs_err": 0.0,
               "registers": at["registers"], "spill_bytes": at["local_bytes"]}
        rec["of_bound"] = b_ms / rec["ms"]
        log(f"fused GEMM {site} {name}: {json.dumps(rec)}")
        out[site].append(rec)
    del x, dy, act, d_gu, normed, d_logits, wgu, wd, wh, w32
    torch.cuda.empty_cache()
    return out


def phase_fuse_kernels(gen):
    """Every fusion site's kernels at `base` (timed), at a ragged row count
    (1000 rows, not a multiple of the 128-row tile), the tied head, and in
    fp32 at 520 rows; then the planted faults."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    for name in ("fuse_swiglu_mlp", "fuse_add_rms_norm", "fuse_rms_norm_head"):
        runs = [_site_case(gen, name, FUSE_M, torch.bfloat16, timed=True),
                _site_case(gen, name, 1000, torch.bfloat16),
                _site_case(gen, name, 520, torch.float32)]
        if name == "fuse_rms_norm_head":
            runs.append(_site_case(gen, name, FUSE_M, torch.bfloat16, transpose=True))
        cases[name] = [r[0] for r in runs]
        cases[name + "_bwd"] = [r[1] for r in runs]
        torch.cuda.empty_cache()
    faults = _fuse_planted_faults(gen)
    for name in ("fuse_swiglu_mlp", "fuse_rms_norm_head"):
        cases[name][0]["planted_faults"] = faults
    torch.cuda.empty_cache()
    for site, recs in _gemm_products(gen).items():
        cases[site][0]["gemm_products"] = recs
    return cases


def phase_kernels():
    import torch
    from paddle_tpu_torch.kernels import adamw

    gen = torch.Generator(device="cuda").manual_seed(0)
    # RMSNorm: a decode step's rows, 4096 rows, a `base` training step's
    # rows over the fp32 weight, and the Engine's prefill forwards (n
    # same-bucket prompts, n in 4/2/1: 2048 and 512 rows among them), these
    # from a generator of their own, so the cases after them keep their
    # inputs
    rows_gen = torch.Generator(device="cuda").manual_seed(1)
    cases = {"rms_norm": [_rms_case(8, 4096, gen, torch.bfloat16),
                          _rms_case(8 * 512, 4096, gen, torch.bfloat16),
                          _rms_case(3 * 2048, 2048, gen, torch.float32),
                          _rms_case(4 * 512, 4096, rows_gen, torch.bfloat16),
                          _rms_case(512, 4096, rows_gen, torch.bfloat16)],
             "decode_attention_dense": [
                 _dense_case(gen, [1, 37, 128, 129, 500, 1024, 2047, 2048]),
                 _dense_case(gen, _serve_lengths(), C=1024, label="serve")],
             "decode_attention_paged": [
                 _paged_case(gen, [0, 1, 128, 129, 256, 300, 777, 1024]),
                 _paged_case(gen, _serve_lengths(), label="serve")]}
    base = _flash_case(gen, 3, 2048, 16, 8, 128)
    longctx = _flash_case(gen, 1, 16384, 16, 8, 128, heads=2)
    cases["flash_attention_fwd"] = [base[0], longctx[0]]
    cases["flash_attention_bwd"] = [base[1], longctx[1]]
    ernie = _flash_noncausal_case(gen)
    # the same under amp.auto_cast O1, where the white-listed linears hand
    # the attention bf16 q, k, v (`eager_train` leg 2)
    ernie_o1 = _flash_case(gen, 32, 512, 12, 12, 64, causal=False)
    cases["flash_attention_fwd_noncausal"] = [ernie[0], ernie_o1[0]]
    cases["flash_attention_bwd_noncausal"] = [ernie[1], ernie_o1[1]]
    torch.cuda.empty_cache()
    tables = adamw.TRAIN_TABLES
    cases["adamw"] = [_adamw_case(tables["base"], "base, all 75 leaves", 100)]
    cases["adamw"][0]["table_edges"] = _adamw_ragged(101)
    torch.cuda.empty_cache()
    cases["adamw"].append(_adamw_case(tables["ssd_train"], "ssd_train, all 43 leaves", 200))
    torch.cuda.empty_cache()
    cases["adamw"].append(_adamw_case(adamw.MOE_TABLE, "moe, all 87 leaves: bf16 gradients "
                                      "and copies, the fp32 routers'", 300,
                                      adamw.MOE_GRAD_DTYPES))
    torch.cuda.empty_cache()
    # `ssd_train`'s shape: G = batch 2 x 64 heads, T 4096, P 64, N 128, L 128;
    # SSDConfig()'s defaults (hidden 4096 over 32 heads: P 128, N 64, L 64;
    # G = batch 2 x 32 heads, T 4096), two column blocks a recurrence;
    # bench.py's on-chip case (G 8, T 512, P 128, N 128, L 128); and
    # ssd_tiny_config's widths
    ssd = [_ssd_case(gen, 128, 4096, 64, 128, 128, full=True),
           _ssd_case(gen, 64, 4096, 128, 64, 64, full=True),
           _ssd_case(gen, 8, 512, 128, 128, 128, full=True),
           _ssd_case(gen, 8, 256, 32, 16, 16, full=True)]
    cases["ssd_scan"] = [fwd for fwd, _ in ssd]
    cases["ssd_scan_bwd"] = [bwd for _, bwd in ssd]
    torch.cuda.empty_cache()
    cases.update(phase_fuse_kernels(gen))
    # the RMSNorm backward: norm-only (the stock backward) at `base`'s,
    # `longctx`'s and `ssd_train`'s rows over their fp32 weights, the
    # fuse_add_rms_norm site's mode (h and d_s) at `base`, fp32 rows at the
    # parity phase's narrow Llama (2 x 256 rows of 256); untimed, a ragged
    # row (33 vectors), one row, and a width past the ring (the wide kernel)
    bf = torch.bfloat16
    cases["rms_norm_bwd"] = [
        _norm_bwd_case(gen, 3 * 2048, 2048, bf, label="base (train)"),
        _norm_bwd_case(gen, 3 * 2048, 2048, bf, site=True, label="base, fuse_add_rms_norm"),
        _norm_bwd_case(gen, 16384, 2048, bf, label="longctx"),
        _norm_bwd_case(gen, SSD_TRAIN_BATCH * SSD_TRAIN_SEQ, 4096, bf, label="ssd_train"),
        _norm_bwd_case(gen, 2 * 256, 256, torch.float32, label="parity, fp32"),
        _norm_bwd_case(gen, 1037, 264, bf, timed=False, label="ragged"),
        _norm_bwd_case(gen, 1037, 264, bf, site=True, timed=False, label="ragged"),
        _norm_bwd_case(gen, 1, 2048, bf, timed=False, label="one row"),
        _norm_bwd_case(gen, 64, 16384, bf, timed=False, label="the wide kernel"),
        _norm_bwd_case(gen, 64, 16384, bf, site=True, timed=False, label="the wide kernel")]
    cases["rms_norm_bwd"][0]["planted_faults"] = _norm_bwd_planted_faults(gen)
    cases["injected_write_race"] = [_injected_case(gen, "write_race")]
    cases["injected_parallel_carry"] = [_injected_case(gen, "parallel_carry")]
    return cases


def _injected_case(gen, kind):
    """A seeded-defect kernel of the gate at the gate's shapes, against its
    plain version (what a correct kernel gives) on the part the defect
    leaves defined, which must be exact (tolerance 0: 2 x and x are exact
    in fp32): every element of write-race's tile 0 is one CTA's doubled
    value (the CTAs race element by element), and its other tiles must keep
    the NaN sentinel; parallel-carry's first tile of each row reads no
    carried state.  The rest is undefined by design."""
    import torch
    from paddle_tpu_torch.analysis.kernel_lint import sentinel_outputs
    from paddle_tpu_torch.kernels import injected

    if kind == "write_race":
        x = torch.randn(32, 128, generator=gen, device="cuda")
        fn, plain = injected.write_race, injected.write_race_reference
    else:
        x = torch.randn(2, 32, 128, generator=gen, device="cuda")
        fn, plain = injected.parallel_carry, injected.parallel_carry_reference
    with sentinel_outputs():
        y = fn(x)
    ref = plain(x)
    torch.cuda.synchronize()
    rec = {"shape": list(x.shape), "tolerance": 0.0}
    if kind == "write_race":
        # each element of tile 0 against the nearest of the four CTAs' values
        errs = (y[:8][None] - ref.reshape(4, 8, 128)).abs().amin(0)
        won = (y[:8][None] == ref.reshape(4, 8, 128)).float().argmax(0)
        rec.update(max_abs_err=float(errs.max()),
                   elements_stored_by_cta=[int((won == t).sum()) for t in range(4)],
                   unwritten_elements=int(torch.isnan(y).sum()),
                   defined="each element of tile 0 is one CTA's 2x; tiles 1-3 keep the "
                           "sentinel")
        check(rec["unwritten_elements"] == y[8:].numel() and not torch.isnan(y[:8]).any(),
              f"injected write_race: {rec['unwritten_elements']} unwritten elements, "
              f"expected {y[8:].numel()}")
    else:
        rec.update(max_abs_err=max_err(y[:, :8], ref[:, :8]),
                   elements_off_the_running_sum=int((y != ref).sum()),
                   defined="the first tile of each row (reads no carried state)")
    check(rec["max_abs_err"] == 0.0,
          f"injected {kind}: the defined part is {rec['max_abs_err']} from the plain version")
    rec["ms"] = time_ms(lambda: fn(x))
    rec["plain_ms"] = time_ms(lambda: plain(x))
    rec["bound_ms"], rec["bound_by"] = bound(2 * x.numel() * 4, x.numel())
    # the plain version is one PyTorch call (2 x; a cumsum over a view of
    # x), so it is also the library call: timed again here as such
    rec["library_ms"] = time_ms(lambda: plain(x))
    log(f"kernels: injected_{kind} {rec}")
    return rec


# ---------------------------------------------------------------------------
# the kernel gate
# ---------------------------------------------------------------------------

# what the card's gate must report for each seeded defect (more may be
# observed: the defective kernels also disagree with their plain versions)
GATE_INJECTIONS = {"write-race": {"krn-write-race", "krn-coverage-hole"},
                   "parallel-carry": {"krn-parallel-carry"},
                   "emit-race": {"krn-coverage-hole"}}


def _gate_runs():
    """The gate's CLI on the card, clean and under each KERNEL_GATE_INJECT,
    four processes started together: ``{inject: (rc, json, stderr)}``."""
    import os

    procs = {}
    for inject in ("", *GATE_INJECTIONS):
        env = dict(os.environ, KERNEL_GATE_INJECT=inject)
        env.pop("FLAGS_kernel_admission", None)
        procs[inject] = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.kernels.registry", "--device", "cuda"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for inject, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        lines = stdout.strip().splitlines()
        check(lines, f"kernel_gate: the CLI (KERNEL_GATE_INJECT={inject!r}) printed nothing; "
                     f"rc {proc.returncode}:\n{stderr[-3000:]}")
        out[inject] = (proc.returncode, json.loads(lines[-1]), stderr)
    return out


def _check_gate(runs):
    """The clean gate and the three seeded defects, as the CLI reported
    them; returns the kernel_gate path's launches of the seeded kernels."""
    from paddle_tpu_torch.kernels import registry

    registry.load_all()
    rc, clean, err = runs[""]
    check(rc == 0 and clean["kernel_count"] == GATE_ENTRIES and clean["total_findings"] == 0,
          f"kernel_gate: clean gate rc {rc}, {clean['kernel_count']} entries, "
          f"{clean['total_findings']} findings:\n{err[-3000:]}")
    for name, k in clean["kernels"].items():
        check(k["legs"] == ["static", "dynamic"], f"kernel_gate: {name} ran legs {k['legs']}")
        check(k["dtypes"] == list(registry.entries()[name].dtypes),
              f"kernel_gate: {name} checked at {k['dtypes']}")
        check(k["smem_bytes_by_kernel"] == k["smem_bytes_card_by_kernel"],
              f"kernel_gate: {name} declares {k['smem_bytes_by_kernel']} B of shared memory, "
              f"the card reports {k['smem_bytes_card_by_kernel']}")
    dyn = {n: round(k["dynamic_ms"], 3) for n, k in clean["kernels"].items()}
    pairs = sum(max(1, len(k["dtypes"])) for k in clean["kernels"].values())
    log(f"kernel_gate: clean, {GATE_ENTRIES} entries at {pairs} (entry, dtype) pairs, both legs; "
        f"dynamic leg ms by entry {dyn} (sum {sum(dyn.values()):.1f} ms)")
    log(f"kernel_gate: compiled attributes "
        f"{ {n: k['attributes_by_kernel'] for n, k in clean['kernels'].items()} }")
    launches = {}
    for inject, want in GATE_INJECTIONS.items():
        rc, rep, err = runs[inject]
        name = "injected_" + inject.replace("-", "_")
        k = rep["kernels"].get(name, {})
        codes = set(k.get("codes", {}))
        check(rc == 1 and want <= codes,
              f"kernel_gate: KERNEL_GATE_INJECT={inject} rc {rc}, codes {k.get('codes')}, "
              f"expected {sorted(want)}:\n{err[-3000:]}")
        others = {n: v["findings"] for n, v in rep["kernels"].items() if n != name}
        check(len(others) == GATE_ENTRIES and not any(others.values()),
              f"kernel_gate: KERNEL_GATE_INJECT={inject}: other entries {others}")
        log(f"kernel_gate: {inject} refused with {k['codes']} (static leg alone: "
            f"{'clean' if inject == 'emit-race' else 'refused'}); gate launches "
            f"{k.get('gate_launches')}")
        launches.update({n: c for n, c in k.get("gate_launches", {}).items()
                         if n.startswith("injected_")})
    return launches


def _admission_drive(cfg, cfg16, seed, device):
    """The narrow Llama of `parity` through the Engine, `generate`, one
    TrainStep step and one step with every fusion site verified and
    activated; then ``cfg16`` (the same widths, bf16 compute over fp32
    params, as `base` trains) through one TrainStep step and one fused
    step.  Each path's launches are counted from 0.  Returns the tokens,
    losses and counts."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import emit, launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(cfg, device=device, seed=seed)
    rng = np.random.default_rng(seed + 1)
    prefix = rng.integers(1, cfg.vocab_size, size=(128,)).astype(np.int32)
    reqs = _requests(rng, cfg.vocab_size, (17, 100, 130, -40), (24, 16, 20, 16), prefix)
    out = {"launches": {}}
    reset_launch_counts()
    _, outs = _serve(model, reqs, device, max_batch=4, num_blocks=32, block_size=128,
                     prefill_buckets=(128, 256), decode_chunk=8)
    out["launches"]["engine"] = launch_counts()
    out["engine"] = [o.output_ids for o in outs]
    reset_launch_counts()
    gen = model.generate(reqs[0].prompt_ids[None], max_new_tokens=16)
    out["launches"]["generate"] = launch_counts()
    out["generate"] = gen[0].cpu().tolist()
    ids = np.random.default_rng(seed + 3).integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    step = TrainStep(model, lambda m, x: m.compute_loss(m(x), x),
                     AdamW(learning_rate=3e-4, weight_decay=0.1, parameters=model.parameters()))
    reset_launch_counts()
    out["loss"] = float(step(ids))
    out["launches"]["train"] = launch_counts()
    table = emit.verified_activation(device)
    check(sorted(table) == sorted(emit.SITES), f"kernel_gate: sites verified {sorted(table)}")
    with emit.activate(table):
        reset_launch_counts()
        out["fused_loss"] = float(step(ids))
        out["launches"]["fused_train"] = launch_counts()
    model16 = LlamaForCausalLM(cfg16, device=device, seed=seed)
    step16 = TrainStep(model16, lambda m, x: m.compute_loss(m(x), x),
                       AdamW(learning_rate=3e-4, weight_decay=0.1,
                             parameters=model16.parameters()))
    reset_launch_counts()
    out["loss_bf16"] = float(step16(ids))
    out["launches"]["train_bf16"] = launch_counts()
    with emit.activate(table):
        reset_launch_counts()
        out["fused_loss_bf16"] = float(step16(ids))
        out["launches"]["fused_train_bf16"] = launch_counts()
    return out


# the (entry, dtype) pairs each admission path must admit (once each, on the
# card): the fp32 narrow Llama's, then the bf16 legs' tensor-core flash and
# bf16-rows RMSNorm; verified_activation admits every site at all its dtypes
_FLASH_ENTRIES = ("flash_fwd_resident", "flash_fwd_stream", "flash_bwd_stream")
_SITE_ENTRIES = ("fuse_swiglu_mlp", "fuse_swiglu_mlp_bwd", "fuse_add_rms_norm",
                 "fuse_add_rms_norm_bwd", "fuse_rms_norm_head", "fuse_rms_norm_head_bwd")
ADMITTED_BY_PATH = {
    "engine": {("rms_norm", "float32"), ("paged_decode", "float32"),
               ("paged_decode_fused", "float32")},
    "generate": {("decode_mmha", "float32"), ("decode_mmha_fused", "float32")},
    "train": {(n, "float32") for n in (*_FLASH_ENTRIES, "adamw_fused", "rms_norm_bwd")},
    "fused_train": {(n, dt) for n in _SITE_ENTRIES
                    for dt in ("float32", "bfloat16+float32", "bfloat16",
                               "bfloat16+float32@base")},
    "train_bf16": {(n, "bfloat16") for n in _FLASH_ENTRIES} | {
        ("rms_norm", "bfloat16+float32"), ("rms_norm_bwd", "bfloat16+float32")},
}


def _admission_paths(seed, device="cuda"):
    """`parity`'s narrow Llama driven with FLAGS_kernel_admission off and
    then on (fresh weights from one seed each time): every registered
    kernel on the paths admitted exactly once at the dtype it ran, the
    same tokens, the same losses to the bit, and the same launch counts
    (the dynamic leg's own launches land in no path).  With the flag off
    only verified_activation admits (the sites, as the JAX one does)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models import llama_tiny_config

    widths = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=512)
    cfg = llama_tiny_config(**widths)
    cfg16 = llama_tiny_config(**widths, dtype="bfloat16", param_dtype="float32")
    flags.set_flags({"kernel_admission": False})
    registry.reset_admission_cache()
    off = _admission_drive(cfg, cfg16, seed, device)
    sites = {(n, device, dt) for n, dt in ADMITTED_BY_PATH["fused_train"]}
    check(set(registry.admissions()) == sites,
          f"kernel_gate: with the flag off admitted {registry.admissions()}, expected the "
          f"sites verified_activation admits, {sorted(sites)}")
    registry.reset_admission_cache()
    t0 = time.perf_counter()
    flags.set_flags({"kernel_admission": True})
    try:
        on = _admission_drive(cfg, cfg16, seed, device)
    finally:
        flags.set_flags({"kernel_admission": False})
    secs = time.perf_counter() - t0
    admitted = registry.admissions()
    spent = registry.admission_seconds()
    want = {(n, device, dt) for path in ADMITTED_BY_PATH.values() for n, dt in path}
    check(set(admitted) == want and set(admitted.values()) == {1},
          f"kernel_gate: admitted {admitted}, expected each of {sorted(want)} once")
    for key in ("engine", "generate"):
        check(on[key] == off[key], f"kernel_gate: {key} tokens differ under admission")
    for key in ("loss", "fused_loss", "loss_bf16", "fused_loss_bf16"):
        check(on[key] == off[key], f"kernel_gate: {key} {on[key]} under admission, "
                                   f"{off[key]} without")
    check(on["launches"] == off["launches"],
          f"kernel_gate: launches under admission {on['launches']}, without {off['launches']}")
    nonzero = {p: {k: n for k, n in c.items() if n} for p, c in off["launches"].items()}
    log(f"kernel_gate: admission on the Engine, generate, TrainStep and fused-step paths "
        f"(fp32, then bf16 steps): {len(admitted)} (entry, dtype) pairs admitted once each; "
        f"tokens and losses ({off['loss']}, {off['fused_loss']}, {off['loss_bf16']}, "
        f"{off['fused_loss_bf16']}) equal to the admission-off run; launches per path "
        f"{nonzero}; admission-on drive {secs:.3f} s, of which admission (both legs) "
        f"{sum(spent.values()) * 1e3:.1f} ms: "
        f"{ {f'{n}@{dt}': round(s * 1e3, 1) for (n, _, dt), s in sorted(spent.items())} }")
    registry.reset_admission_cache()


def _refusal_before_launch():
    """``ssd_scan`` and ``rms_norm`` re-registered with the write-race
    builder: with admission on each wrapper raises KernelRejected naming
    krn-write-race, and its launch counter does not move."""
    import torch
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.kernels import registry, rms_norm, ssd_scan

    calls = {
        "ssd_scan": (ssd_scan.ssd_scan, lambda: ssd_scan.ssd_scan(
            *(torch.randn(2, 128, w, device="cuda") for w in (32, 16, 16)),
            -torch.ones(2, 128, device="cuda"), chunk=16)),
        "rms_norm": (rms_norm.rms_norm, lambda: rms_norm.rms_norm(
            torch.randn(64, 256, device="cuda"), torch.ones(256, device="cuda"))),
    }
    saved = registry.entries()
    flags.set_flags({"kernel_admission": True})
    registry.reset_admission_cache()
    try:
        for name, (wrapper, call) in calls.items():
            registry.register(name, registry._build_injected_write_race)
            before = wrapper.launches
            try:
                call()
                raise PhaseError(f"kernel_gate: sabotaged {name} was not refused")
            except registry.KernelRejected as e:
                check("krn-write-race" in str(e), f"kernel_gate: {name} refused without "
                                                  f"krn-write-race: {e}")
            check(wrapper.launches == before, f"kernel_gate: {name} launched before refusal")
    finally:
        for name in calls:
            e = saved[name]
            registry.register(name, e.build, presets=e.presets, description=e.description,
                              tol=e.tol, dtypes=e.dtypes)
        flags.set_flags({"kernel_admission": False})
        registry.reset_admission_cache()
    log("kernel_gate: sabotaged ssd_scan and rms_norm refused before their first launch")


def _emit_race_bound():
    """The emit-race variant's work at the gate's example: the
    fuse_swiglu_mlp forward (gate_up, SwiGLU, down) on emit.SITES' example
    shapes, fp32.  Its bound (bytes each operand read once and the output
    written once, operations over the fp32 rate) and the times of the
    variant's launch and of the site's plain version on the same inputs
    (no one PyTorch call computes the site: library none)."""
    from paddle_tpu_torch.kernels import emit, injected

    site = emit.SITES["fuse_swiglu_mlp"]
    (x, _), (wgu, _), (wd, _) = site.example_shapes
    (M, H), I = x, site.example_static["intermediate_size"]
    nbytes = 4 * (M * H + wgu[0] * wgu[1] + wd[0] * wd[1] + M * H)
    b_ms, b_by = bound(nbytes, 3 * 2 * M * H * I)
    _, fn, plain, make = injected.emit_race_entry("float32")
    args = make("cuda")
    return {"shape": {"M": M, "H": H, "I": I, "dtype": "float32"}, "bytes": nbytes,
            "flops": 6 * M * H * I, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: fn(*args)), "plain_ms": time_ms(lambda: plain(*args)),
            "library_ms": None}


def phase_kernel_gate(seed):
    t0 = time.perf_counter()
    emit_race = _emit_race_bound()
    log(f"kernel_gate: emit-race variant's work at the gate's example: {json.dumps(emit_race)}")
    launches = _check_gate(_gate_runs())
    t_cli = time.perf_counter() - t0
    _admission_paths(seed)
    _refusal_before_launch()
    log(f"kernel_gate: {time.perf_counter() - t0:.1f} s (the four CLI runs together "
        f"{t_cli:.1f} s)")
    return {"launches": launches, "emit_race_bound": emit_race}


def _requests(rng, vocab, lengths, new_tokens, prefix=None):
    """Greedy requests with random prompts; a length ``-n`` makes the prompt
    ``prefix`` followed by ``n`` random tokens (a prefix-cache hit)."""
    import numpy as np
    from paddle_tpu_torch.serving import GenRequest

    reqs = []
    for P, n in zip(lengths, new_tokens):
        ids = rng.integers(1, vocab, size=(abs(P),)).astype(np.int32)
        if P < 0:
            ids = np.concatenate([prefix, ids])
        reqs.append(GenRequest(prompt_ids=ids, max_new_tokens=int(n)))
    return reqs


def _serve(model, reqs, device, hook=None, **engine_kw):
    from paddle_tpu_torch.serving import Engine

    eng = Engine(model, device=device, **engine_kw)
    if hook is not None:
        hook(eng)
    for r in reqs:
        eng.add_request(r)
    outs = {o.request_id: o for o in eng.run_to_completion()}
    return eng, [outs[r.request_id] for r in reqs]


def phase_parity(seed):
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                         load_paddle_tpu_params, to_paddle_tpu_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_tiny_config(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, max_position_embeddings=512)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, size=(128,)).astype(np.int32)
    lens, news = (17, 100, 130, 250, -40, -90), (24, 16, 20, 12, 16, 8)
    kw = dict(max_batch=4, num_blocks=32, block_size=128, prefill_buckets=(128, 256),
              decode_chunk=8)
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        reqs = _requests(np.random.default_rng(seed + 1), cfg.vocab_size, lens, news, prefix)
        eng, outs = _serve(model, reqs, dev, **kw)
        gen = model.generate(reqs[0].prompt_ids[None], max_new_tokens=16)
        gen_tokens = gen[0, len(reqs[0].prompt_ids):].cpu().tolist()
        check(gen_tokens == outs[0].output_ids[:16],
              f"parity: {name} generate and Engine disagree")
        results[name] = ([o.output_ids for o in outs], gen_tokens, eng.stats)
    with torch.no_grad():
        ids = torch.from_numpy(prefix[None].astype(np.int64))
        lg_cpu = cpu(ids)
        lg_gpu = gpu(ids.cuda()).cpu()
    lerr = max_err(lg_gpu, lg_cpu)
    log(f"parity: logits max err card vs cpu {lerr:.3e}; prefix hits "
        f"{results['cuda'][2]['prefix_hit_blocks']}")
    check(lerr < 1e-4, f"parity: fp32 logits differ by {lerr}")
    check(results["cpu"][0] == results["cuda"][0], "parity: Engine tokens differ")
    check(results["cpu"][1] == results["cuda"][1], "parity: generate tokens differ")
    for key in ("prefills", "prefill_tokens", "prefix_hit_blocks"):
        check(results["cpu"][2][key] == results["cuda"][2][key], f"parity: stats {key}")
    _train_parity("llama", cfg, cpu, gpu, seed, {"flash_attention_fwd": cfg.num_hidden_layers})
    with _fusion_scope("parity") as table:
        L = cfg.num_hidden_layers
        check(sorted(table) == sorted(("fuse_swiglu_mlp", "fuse_add_rms_norm",
                                       "fuse_rms_norm_head")),
              f"parity: sites verified on the card: {sorted(table)}")
        _train_parity("llama fused", cfg, cpu, gpu, seed, {
            "flash_attention_fwd": L, "rms_norm": L, "fuse_swiglu_mlp": L,
            "fuse_swiglu_mlp_bwd": L, "fuse_add_rms_norm": L, "fuse_add_rms_norm_bwd": L,
            "fuse_rms_norm_head": 1, "fuse_rms_norm_head_bwd": 1})
    _ssd_parity(seed)
    _moe_parity(seed)
    _ernie_tiny_parity(seed)
    _ocr_tiny_parity(seed)
    _hf_roundtrip(seed)


def phase_incubate(seed):
    """The ``incubate.nn.functional`` ops that reach a kernel, on the card at
    ``llama3_8b_config`` decode shapes (8 rows, hidden 4096; 32 heads over 8
    KV heads of 128, a 2048-slot cache, the `serve` phase's lengths) against
    their plain versions, counters zeroed just before: ``fused_rms_norm``
    (one RMSNorm launch), ``masked_multihead_attention`` and
    ``block_multihead_attention`` over the JAX package's pool layout
    ``[NB, 128, Hk, D]`` (one dense decode launch each)."""
    import torch
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels.rms_norm import rms_norm_reference
    from paddle_tpu_torch.models import llama3_8b_config

    cfg = llama3_8b_config()
    B, H, Hk, D, C, bs = 8, cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim, 2048, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    x, w = randn(B, 1, cfg.hidden_size), randn(cfg.hidden_size)
    q, k, v = randn(B, 1, H, D), randn(B, C, Hk, D), randn(B, C, Hk, D)
    lengths = torch.tensor(_serve_lengths(seed, B), dtype=torch.int32, device="cuda")
    nb = C // bs
    k_pool, v_pool = randn(B * nb + 1, bs, Hk, D), randn(B * nb + 1, bs, Hk, D)
    table = (1 + torch.randperm(B * nb, generator=gen, device="cuda")).reshape(B, nb)
    table = table.to(torch.int32)
    torch.cuda.synchronize()
    reset_launch_counts()
    y = IF.fused_rms_norm(x, w, epsilon=cfg.rms_norm_eps)
    o = IF.masked_multihead_attention(q, k, v, lengths)
    ob = IF.block_multihead_attention(q, k_pool, v_pool, table, lengths)
    torch.cuda.synchronize()
    counts = launch_counts()
    sm = 1.0 / D ** 0.5
    gathered = [pool[table.long()].reshape(B, -1, Hk, D) for pool in (k_pool, v_pool)]
    refs = {"fused_rms_norm": (y, rms_norm_reference(x, w, cfg.rms_norm_eps), RMS_TOL),
            "masked_multihead_attention": (o, da._decode_reference(q, k, v, lengths, sm),
                                           DECODE_TOL),
            "block_multihead_attention": (ob, da._decode_reference(q, *gathered, lengths, sm),
                                          DECODE_TOL)}
    errs = {name: max_err(got, ref) for name, (got, ref, _) in refs.items()}
    log(f"incubate: max err against the plain versions {errs}; launches {counts}")
    for name, (got, ref, tol) in refs.items():
        check(within(got, ref, tol), f"incubate: {name} disagrees: max err {errs[name]}")
    want = dict.fromkeys(counts, 0)
    want.update(rms_norm=1, decode_attention_dense=2)
    check(counts == want, f"incubate: launches {counts}, expected {want}")
    return {"launches": counts, "max_abs_err": errs}


@contextlib.contextmanager
def _fusion_scope(label):
    """Every fusion site that passes ``emit.verify_site`` on the card,
    activated for the scope's CPU and card models alike (each device runs
    its own path: the kernels here, the plain reference on the CPU)."""
    from paddle_tpu_torch.kernels import emit

    verified = emit.verified_activation("cuda")
    log(f"{label}: sites verified on the card: {sorted(verified)}")
    with emit.activate({name: emit.make_fused(name) for name in verified}):
        yield verified


def _ssd_parity(seed):
    """The card against the CPU in fp32 on the tiny pure and hybrid SSD
    stacks: Engine (recurrent and hybrid paths) and generate tokens equal,
    logits within 1e-4, three TrainStep steps as ``_train_parity``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (SSDForCausalLM, load_paddle_tpu_params,
                                         ssd_tiny_config, ssd_tiny_hybrid_config,
                                         to_paddle_tpu_params)

    lens, news = (17, 40, 100, 70, 5, 128), (24, 16, 20, 12, 16, 8)
    kw = dict(max_batch=4, num_blocks=64, block_size=16, prefill_buckets=(64, 128),
              decode_chunk=8)
    for label, cfg in (("ssd", ssd_tiny_config()), ("hybrid", ssd_tiny_hybrid_config())):
        cpu = SSDForCausalLM(cfg, device="cpu", seed=seed)
        gpu = SSDForCausalLM(cfg, device="cuda", seed=seed)
        load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
        results = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
            reqs = _requests(np.random.default_rng(seed + 1), cfg.vocab_size, lens, news)
            eng, outs = _serve(model, reqs, dev, **kw)
            check(eng.backend.kind == ("recurrent" if label == "ssd" else "hybrid"),
                  f"parity {label}: backend {eng.backend.kind}")
            gen = model.generate(reqs[0].prompt_ids[None], max_new_tokens=16)
            gen_tokens = gen[0, len(reqs[0].prompt_ids):].cpu().tolist()
            check(gen_tokens == outs[0].output_ids[:16],
                  f"parity {label}: {name} generate and Engine disagree")
            results[name] = ([o.output_ids for o in outs], gen_tokens)
        with torch.no_grad():
            ids = torch.from_numpy(np.random.default_rng(seed + 2).integers(
                1, cfg.vocab_size, (2, 200)).astype(np.int64))
            lg_cpu = cpu(ids)
            lg_gpu = gpu(ids.cuda()).cpu()
        lerr = max_err(lg_gpu, lg_cpu)
        log(f"parity {label}: logits max err card vs cpu {lerr:.3e}")
        check(lerr < 1e-4, f"parity {label}: fp32 logits differ by {lerr}")
        check(results["cpu"] == results["cuda"], f"parity {label}: Engine or generate tokens "
              f"differ")
        kinds = cfg.types
        _train_parity(label, cfg, cpu, gpu, seed, {"ssd_scan": kinds.count("ssd"),
                                                   "ssd_scan_bwd": kinds.count("ssd"),
                                                   "flash_attention_fwd": kinds.count("attention")})


def _moe_parity(seed):
    """The card against the CPU in fp32 (TF32 off) on the parity widths with
    4 experts under the switch gate: every layer's routing (experts and
    kept slots) the same, logits within 1e-4, step-1 gradients within
    ``PARITY_GRAD_TOL``, Engine and generate tokens equal."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                         load_paddle_tpu_params, to_paddle_tpu_params)

    cfg = llama_tiny_config(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                            max_position_embeddings=512, moe_num_experts=4, moe_gate="switch")
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
    ids = torch.from_numpy(np.random.default_rng(seed + 4).integers(
        1, cfg.vocab_size, (2, 300)).astype(np.int64))
    with torch.no_grad():
        lg_cpu = cpu(ids)
        lg_gpu = gpu(ids.cuda()).cpu()
    agree, kept_same, dropped = [], True, 0
    for lc, lg in zip(cpu.llama.layers, gpu.llama.layers):
        rc, rg = lc.mlp.last_routing, lg.mlp.last_routing
        agree.append(float((rc.expert == rg.expert.cpu()).float().mean()))
        kept_same &= bool(torch.equal(rc.kept, rg.kept.cpu()))
        dropped += int((~rc.kept).sum())
    lerr = max_err(lg_gpu, lg_cpu)
    log(f"parity moe: routing agreement by layer {agree} ({dropped} choices dropped by "
        f"capacity on the CPU); logits max err card vs cpu {lerr:.3e}")
    check(all(a == 1.0 for a in agree) and kept_same,
          f"parity moe: the card routes otherwise: agreement {agree}, kept equal {kept_same}")
    check(lerr < 1e-4, f"parity moe: fp32 logits differ by {lerr}")
    grads = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = ids.to(model.device)
        loss = model.compute_loss(model(t), t)
        grads[name] = dict(zip([n for n, _ in model.named_parameters()],
                               torch.autograd.grad(loss, list(model.parameters()))))
    gerr = 0.0
    for n, g in grads["cuda"].items():
        ref = grads["cpu"][n]
        gerr = max(gerr, max_err(g.cpu(), ref))
        tol = (PARITY_GRAD_TOL * float(ref.abs().max()), PARITY_GRAD_TOL)
        check(within(g.cpu(), ref, tol),
              f"parity moe: gradient of {n} differs by {max_err(g.cpu(), ref)}")
    rng = np.random.default_rng(seed + 1)
    prefix = rng.integers(1, cfg.vocab_size, size=(128,)).astype(np.int32)
    lens, news = (17, 100, 130, 250, -40, -90), (24, 16, 20, 12, 16, 8)
    kw = dict(max_batch=4, num_blocks=32, block_size=128, prefill_buckets=(128, 256),
              decode_chunk=8)
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        reqs = _requests(np.random.default_rng(seed + 1), cfg.vocab_size, lens, news, prefix)
        _, outs = _serve(model, reqs, dev, **kw)
        gen = model.generate(reqs[0].prompt_ids[None], max_new_tokens=16)
        results[name] = ([o.output_ids for o in outs],
                         gen[0, len(reqs[0].prompt_ids):].cpu().tolist())
    log(f"parity moe: step-1 gradient max err {gerr:.3e}; Engine tokens equal "
        f"{results['cpu'][0] == results['cuda'][0]}, generate tokens equal "
        f"{results['cpu'][1] == results['cuda'][1]}")
    check(results["cpu"] == results["cuda"], "parity moe: Engine or generate tokens differ")


def _train_parity(label, cfg, cpu, gpu, seed, per_step, steps=3, lr=3e-4):
    """Training on the card (kernels) against the CPU (plain versions) in
    fp32 from the same weights: step-1 gradients within ``PARITY_GRAD_TOL``
    (sums in another order); after ``steps`` TrainStep steps the losses
    within rtol 1e-5, the m and v slots within ``PARITY_SLOT_TOL`` and the
    parameters within ``PARITY_PARAM_ATOL``.  The card's steps must launch
    each kernel of ``per_step`` that many times a step, and AdamW once (one
    launch over every leaf)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import (load_paddle_tpu_params, to_paddle_tpu_opt_state,
                                         to_paddle_tpu_params)
    from paddle_tpu_torch.optimizer import AdamW

    def rel_tol(ref, tol):
        return (tol * float(ref.abs().max()), tol)

    load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
    ids = np.random.default_rng(seed + 3).integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    grads = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = torch.from_numpy(ids).to(model.device)
        loss = model.compute_loss(model(t), t)
        grads[name] = dict(zip([n for n, _ in model.named_parameters()],
                               torch.autograd.grad(loss, list(model.parameters()))))
    gerr = 0.0
    for n, g in grads["cuda"].items():
        ref = grads["cpu"][n]
        gerr = max(gerr, max_err(g.cpu(), ref))
        check(within(g.cpu(), ref, rel_tol(ref, PARITY_GRAD_TOL)),
              f"parity {label}: step-1 gradient of {n} differs by {max_err(g.cpu(), ref)}")

    def loss_fn(m, x):
        return m.compute_loss(m(x), x)

    losses, slots = {}, {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        opt = AdamW(learning_rate=lr, weight_decay=0.1, parameters=model.parameters())
        step = TrainStep(model, loss_fn, opt)
        reset_launch_counts()
        losses[name] = [float(step(ids)) for _ in range(steps)]
        slots[name] = to_paddle_tpu_opt_state(step)["slots"]
    counts = launch_counts()
    perr = max(max_err(p.detach().cpu(), q.detach())
               for p, q in zip(gpu.parameters(), cpu.parameters()))
    serr = {"m": 0.0, "v": 0.0}          # largest error as a share of the slot's max |value|
    for n, ref_slots in slots["cpu"].items():
        for s in serr:
            a, b = torch.from_numpy(slots["cuda"][n][s]), torch.from_numpy(ref_slots[s])
            serr[s] = max(serr[s], max_err(a, b) / max(float(b.abs().max()), 1e-30))
            check(within(a, b, rel_tol(b, PARITY_SLOT_TOL)),
                  f"parity {label}: slot {s} of {n} differs by {max_err(a, b)} after {steps} "
                  f"steps")
    log(f"parity {label}: training {steps} steps, losses cpu {losses['cpu']} card {losses['cuda']}; "
        f"step-1 gradient max err {gerr:.3e}; parameter max err {perr:.3e} (limit "
        f"{PARITY_PARAM_ATOL:.1e}); step-{steps} slot max err / max |slot| m {serr['m']:.3e} "
        f"v {serr['v']:.3e}; card launches {counts}")
    for a, b in zip(losses["cuda"], losses["cpu"]):
        check(abs(a - b) <= 1e-5 * abs(b), f"parity {label}: training losses differ: {losses}")
    check(perr <= PARITY_PARAM_ATOL,
          f"parity {label}: parameters differ by {perr} after {steps} steps")
    want = dict(per_step, adamw=1)
    check(all(counts[k] == steps * n for k, n in want.items()),
          f"parity {label}: the card's training steps launched {counts}, expected {want} a step")
    check(counts["rms_norm"] > 0 and counts["rms_norm_bwd"] == counts["rms_norm"],
          f"parity {label}: {counts['rms_norm_bwd']} RMSNorm backward launches for "
          f"{counts['rms_norm']} forwards (one each, nothing recomputed)")


# ---------------------------------------------------------------------------
# the stock nn library's recipes: ERNIE text classification, PP-OCR det + rec
# ---------------------------------------------------------------------------

def _backend_flags():
    """The TF32 switches a phase ran under (torch's defaults: matmul off,
    cuDNN on)."""
    import torch

    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


@contextlib.contextmanager
def _tf32(matmul, cudnn):
    """Set both TF32 switches inside, and put back what was there."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _grads_of(model, loss_fn, *args):
    import torch

    loss = loss_fn(model, *args)
    names = [n for n, p in model.named_parameters()]
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def _step1_parity(label, cpu, gpu, loss_fn, args, vanishing=()):
    """Step 1 on the card against the CPU from the same weights and batch:
    the loss within ``PARITY_LOSS_RTOL``, every gradient within
    ``PARITY_GRAD_TOL`` (rtol, and atol as a share of its max |value|), and
    every persistent buffer (BatchNorm's running statistics) after the
    forward within 1e-5.  A gradient that is zero in exact arithmetic (its
    name ending in one of ``vanishing``: a key bias, whose shift the
    softmax removes; a bias a training-mode BatchNorm subtracts again) is
    rounding on both sides, so it is held to zero instead: within
    ``PARITY_GRAD_TOL`` of the model's largest gradient.  Returns the
    card's launch counts and the errors."""
    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import load_paddle_tpu_params, to_paddle_tpu_params

    load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
    l_cpu, g_cpu = _grads_of(cpu, loss_fn, *args)
    torch.cuda.synchronize()
    reset_launch_counts()
    l_gpu, g_gpu = _grads_of(gpu, loss_fn, *(a.cuda() for a in args))
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    lerr = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    gerr, zero = 0.0, 0.0
    for n, g in g_gpu.items():
        ref, g = g_cpu[n], g.cpu()
        if n.endswith(tuple(vanishing)):
            zero = max(zero, float(g.abs().max()), float(ref.abs().max()))
            check(zero <= PARITY_GRAD_TOL * scale, f"parity {label}: the gradient of {n}, "
                  f"zero in exact arithmetic, reads {zero} (largest gradient {scale})")
            continue
        gerr = max(gerr, max_err(g, ref) / max(float(ref.abs().max()), 1e-30))
        check(within(g, ref, (PARITY_GRAD_TOL * float(ref.abs().max()), PARITY_GRAD_TOL)),
              f"parity {label}: step-1 gradient of {n} differs by {max_err(g, ref)}")
    berr = max([max_err(b.cpu(), c) for (_, b), (_, c) in
                zip(gpu.named_buffers(), cpu.named_buffers())], default=0.0)
    log(f"parity {label}: step-1 loss cpu {float(l_cpu)!r} card {float(l_gpu)!r} (rel "
        f"{lerr:.3e}, limit {PARITY_LOSS_RTOL:.0e}); gradient max err / max |grad| "
        f"{gerr:.3e}; vanishing gradients {zero:.3e} of a largest {scale:.3e}; buffers max err "
        f"{berr:.3e}; card launches {counts}; {_backend_flags()}")
    check(lerr <= PARITY_LOSS_RTOL, f"parity {label}: step-1 losses differ by {lerr} of the "
          "loss")
    check(berr <= 1e-5, f"parity {label}: running statistics differ by {berr}")
    return counts, {"loss_rel": lerr, "grad_share": gerr, "vanishing": zero, "buffers": berr}


def _ernie_batch(rng, vocab, batch, seq, classes=2):
    """Token ids with the class's marker at position 1 (the recipe's task)."""
    import torch

    ids = rng.integers(10, vocab, size=(batch, seq)).astype("int64")
    labels = rng.integers(0, classes, size=(batch,)).astype("int64")
    ids[:, 1] = labels + 1
    return torch.from_numpy(ids), torch.from_numpy(labels)


def _ernie_loss(m, ids, labels):
    return m.compute_loss(m(ids), labels)


def _ernie_tiny_parity(seed):
    """The ERNIE-tiny recipe (configs[0], head dim 26: the plain attention),
    dropout off, ``ERNIE_STEPS`` Adam steps through TrainStep on the card
    and on the CPU from the same weights (fp32, TF32 off): losses within
    ``ERNIE_PARITY_LOSS_RTOL``; the card's steps launch AdamW once each and
    no flash kernel."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import (ErnieForSequenceClassification, ernie_tiny_config,
                                         load_paddle_tpu_params, to_paddle_tpu_params)
    from paddle_tpu_torch.optimizer import Adam

    cfg = ernie_tiny_config(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cpu = ErnieForSequenceClassification(cfg, device="cpu", seed=seed)
    gpu = ErnieForSequenceClassification(cfg, device="cuda", seed=seed)
    load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
    ids, labels = _ernie_batch(np.random.default_rng(seed + 5), cfg.vocab_size, 8, 128)
    losses = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        step = TrainStep(model, _ernie_loss, Adam(learning_rate=2e-3,
                                                  parameters=model.parameters()))
        args = (ids.to(model.device), labels.to(model.device))
        reset_launch_counts()
        losses[name] = [float(step(*args)) for _ in range(ERNIE_STEPS)]
    counts = launch_counts()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"parity ernie-tiny: {ERNIE_STEPS} Adam steps, losses cpu {losses['cpu']} card "
        f"{losses['cuda']} (max rel {rel:.3e}, limit {ERNIE_PARITY_LOSS_RTOL:.0e}); card "
        f"launches {({k: v for k, v in counts.items() if v})}")
    check(rel <= ERNIE_PARITY_LOSS_RTOL, f"parity ernie-tiny: losses differ: {losses}")
    check(counts["adamw"] == ERNIE_STEPS and counts["flash_attention_fwd"] == 0
          and counts["flash_attention_fwd_noncausal"] == 0,
          f"parity ernie-tiny: the card's steps launched {counts}; expected AdamW once a step "
          f"and no flash kernel (head dim {cfg.hidden_size // cfg.num_attention_heads})")


def _ocr_batches(rng, batch, size, rec_w, classes, max_len):
    """A detection batch (images N(0, 1), a ground-truth map 20% ones) and
    a recognition batch (images, labels in 1..classes-1 of 1..max_len
    characters)."""
    import torch

    img = torch.from_numpy(rng.normal(size=(batch, 3, size, size)).astype("float32"))
    gt = torch.from_numpy((rng.random(size=(batch, 1, size, size)) < 0.2).astype("float32"))
    rec = torch.from_numpy(rng.normal(size=(batch, 3, 32, rec_w)).astype("float32"))
    lab_len = torch.from_numpy(rng.integers(1, max_len + 1, size=(batch,)).astype("int64"))
    labels = torch.from_numpy(rng.integers(1, classes, size=(batch, max_len)).astype("int64"))
    return (img, gt), (rec, labels, lab_len)


def _db_step_loss(m, img, gt):
    from paddle_tpu_torch.models.ocr import db_loss

    return db_loss(m(img), gt)


def _ctc_step_loss(m, img, labels, lab_len):
    return m.compute_loss(m(img), labels, lab_len)


def _ocr_tiny_parity(seed):
    """DBNet-tiny and CRNN-tiny, step 1 on the card (cuDNN) against the CPU
    from the same weights, fp32 with cuDNN's and cuBLAS's TF32 off:
    ``_step1_parity`` (loss, gradients, BatchNorm statistics)."""
    import numpy as np
    from paddle_tpu_torch.models.ocr import ocr_det_tiny, ocr_rec_tiny

    det, rec = _ocr_batches(np.random.default_rng(seed + 6), 2, 64, 64, 64, 6)
    with _tf32(False, False):
        _step1_parity("dbnet-tiny", ocr_det_tiny(device="cpu", seed=seed),
                      ocr_det_tiny(device="cuda", seed=seed), _db_step_loss, det,
                      vanishing=("head.up1.bias",))
        _step1_parity("crnn-tiny", ocr_rec_tiny(device="cpu", seed=seed),
                      ocr_rec_tiny(device="cuda", seed=seed), _ctc_step_loss, rec)


def _hf_roundtrip(seed):
    """A tiny Llama and a tiny ERNIE classifier on the card through the
    HF-transformers layout and back (``models.hf_compat``, no
    ``transformers`` needed): the rebuilt model's logits are the same bits."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (ErnieForSequenceClassification, LlamaForCausalLM,
                                         ernie_from_transformers, ernie_tiny_config,
                                         ernie_to_transformers_state_dict, llama_from_transformers,
                                         llama_tiny_config, llama_to_transformers_state_dict)

    rng = np.random.default_rng(seed + 7)
    llama = LlamaForCausalLM(llama_tiny_config(), device="cuda", seed=seed)
    back = llama_from_transformers(llama_to_transformers_state_dict(llama), config=llama.config,
                                   device="cuda", seed=seed + 1)
    cfg = ernie_tiny_config(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ernie = ErnieForSequenceClassification(cfg, num_classes=3, device="cuda", seed=seed).eval()
    ernie_back = ernie_from_transformers(ernie_to_transformers_state_dict(ernie), config=cfg,
                                         layer_norm_eps=1e-5, device="cuda",
                                         seed=seed + 1).eval()
    ids = torch.from_numpy(rng.integers(0, 512, size=(2, 64))).cuda()
    with torch.no_grad():
        same = {"llama": torch.equal(llama(ids), back(ids)),
                "ernie": torch.equal(ernie(ids), ernie_back(ids))}
    log(f"parity hf_compat: logits after a round trip through the HF layout, the same bits "
        f"{same}")
    check(all(same.values()), f"parity hf_compat: a round trip changed the logits: {same}")


def _ernie_step1_parity(seed):
    """``ernie_train``'s step 1 at ERNIE-base widths cut to 2 layers, batch
    2 x 512, dropout off: the card (the flash kernels, head dim 64) against
    the CPU (plain) in fp32 with TF32 off, through ``_step1_parity``; the
    card must launch flash forward and backward once a layer."""
    import numpy as np
    from paddle_tpu_torch.models import ErnieForSequenceClassification
    from paddle_tpu_torch.models.presets import ernie_base_config

    cfg = ernie_base_config(num_hidden_layers=2, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    batch = _ernie_batch(np.random.default_rng(seed + 8), cfg.vocab_size, 2, 512)
    with _tf32(False, False):
        counts, errs = _step1_parity(
            "ernie-base, 2 layers, 2 x 512", ErnieForSequenceClassification(cfg, device="cpu",
                                                                            seed=seed),
            ErnieForSequenceClassification(cfg, device="cuda", seed=seed), _ernie_loss, batch,
            vanishing=("k_proj.bias",))
    want = {"flash_attention_fwd_noncausal": 2, "flash_attention_bwd_noncausal": 2}
    check(counts == want, f"ernie_train: the cut model's card step launched {counts}, "
          f"expected {want}")
    return errs


def phase_ernie_train(seed, profile):
    """ERNIE-1.0-base widths (``presets.build_ernie_step``: 12 layers of 768,
    12 heads of 64, fp32, batch 32 x 512, Adam) through TrainStep,
    ``ERNIE_STEPS`` steps with the counters read per step, then one step
    with a padding mask (the plain attention), then step 1 of a 2-layer cut
    against the CPU; see the module docstring."""
    import math

    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models.presets import build_ernie_step, ernie_flops_per_example
    from paddle_tpu_torch.optimizer import Adam

    t0 = time.perf_counter()
    step_fn, batch, model, cfg = build_ernie_step("cuda", seed=seed)
    B, S = batch[0].shape
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    log(f"ernie_train: ERNIE-1.0-base widths, {L} layers of {cfg.hidden_size} "
        f"({cfg.num_attention_heads} heads of {cfg.hidden_size // cfg.num_attention_heads}), "
        f"{sum(p.numel() for p in model.parameters())} params fp32, batch {B} x seq {S}, "
        f"dropout {cfg.hidden_dropout_prob}, built in {time.perf_counter() - t0:.1f} s; "
        f"{_backend_flags()}")
    want = dict.fromkeys(launch_counts(), 0)
    want.update(flash_attention_fwd_noncausal=L, flash_attention_bwd_noncausal=L, adamw=1)
    torch.cuda.reset_peak_memory_stats()
    losses, walls, rec = _drive_train(step_fn, batch, ERNIE_STEPS)
    step_ms = [w * 1e3 for w in walls]
    steady = sum(step_ms[1:]) / (ERNIE_STEPS - 1)
    flops = ernie_flops_per_example(cfg, S) * B
    rec.update(losses=losses, step_ms=step_ms, steady_step_ms=steady,
               examples_per_s=B / steady * 1e3, tflops_per_s=flops / steady / 1e9,
               peak_bytes=torch.cuda.max_memory_allocated(), flags=_backend_flags())
    log(f"ernie_train: losses {losses}; step ms {step_ms}; steady {steady:.3f} ms = "
        f"{rec['examples_per_s']:.2f} examples/s, {rec['tflops_per_s']:.2f} TFLOP/s "
        f"({flops / 1e12:.3f} TFLOP a step); peak memory {rec['peak_bytes'] / 2**30:.2f} GiB")
    log(f"ernie_train: launches {json.dumps(rec)}")
    check(all(math.isfinite(x) for x in losses), f"ernie_train: non-finite loss {losses}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"ernie_train: step {i + 1} launched {got}, expected {want}")
    check(rec["launches_in_update"]["adamw"] == ERNIE_STEPS,
          f"ernie_train: AdamW launches inside the update {rec['launches_in_update']}")
    if profile:
        _, rows = _profile(lambda: step_fn(*batch), "ernie_train: one step")
        flash_ms = sum(ms for ms, _, key in rows if "flash_" in key)
        rec["flash_device_ms"] = flash_ms
        log(f"ernie_train: flash kernels {flash_ms:.3f} ms of the profiled step's device time")

    ids, labels = batch
    mask = torch.ones(B, S, device=ids.device)
    mask[::2, S // 2:] = 0.0                       # every other row padded after S / 2
    masked = TrainStep(model, lambda m, i, y, am: m.compute_loss(m(i, attention_mask=am), y),
                       Adam(learning_rate=2e-3, parameters=model.parameters()))
    m_losses, m_walls, m_rec = _drive_train(masked, (ids, labels, mask), 1)
    m_want = dict.fromkeys(launch_counts(), 0)
    m_want["adamw"] = 1
    log(f"ernie_train: a step with a padding mask (the plain attention): loss {m_losses[0]}, "
        f"{m_walls[0] * 1e3:.3f} ms, launches {m_rec['launches_per_step'][0]}")
    check(math.isfinite(m_losses[0]), f"ernie_train: the masked step's loss {m_losses[0]}")
    check(m_rec["launches_per_step"][0] == m_want,
          f"ernie_train: the masked step launched {m_rec['launches_per_step'][0]}, expected "
          f"{m_want}")
    rec["masked_step"] = {"loss": m_losses[0], "ms": m_walls[0] * 1e3}
    del step_fn, masked, model
    torch.cuda.empty_cache()
    rec["step1_parity"] = _ernie_step1_parity(seed)
    return rec


def _ocr_leg(label, step_fn, args, steps, batch, profile):
    """``steps`` TrainStep steps through ``_drive_train``: losses finite
    and falling, step ms, images/s, peak memory; the path launches no
    kernel of the port but AdamW where the optimizer is Adam."""
    import math

    import torch
    from paddle_tpu_torch.kernels import launch_counts

    want = dict.fromkeys(launch_counts(), 0)
    want["adamw"] = int(type(step_fn.optimizer).__name__ in ("Adam", "AdamW"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, rec = _drive_train(step_fn, args, steps)
    step_ms = [w * 1e3 for w in walls]
    steady = sum(step_ms[1:]) / (steps - 1)
    rec.update(losses=losses, step_ms=step_ms, steady_step_ms=steady,
               images_per_s=batch / steady * 1e3, peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{label}: losses {losses}; step ms {step_ms}; steady {steady:.3f} ms = "
        f"{rec['images_per_s']:.2f} images/s; peak memory {rec['peak_bytes'] / 2**30:.2f} GiB; "
        f"launches a step {rec['launches_per_step'][0]}; {_backend_flags()}")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"{label}: step {i + 1} launched {got}, expected {want}")
    if profile:
        _profile(lambda: step_fn(*args), f"{label}: one step")
    return rec


def phase_ocr_train(seed, profile):
    """PP-OCR detection and recognition at bench scale through TrainStep
    (cuDNN's TF32 on, torch's default): DBNet at ``bench.py``'s ``ocr``
    preset (``presets.build_ocr_step``: ``ocr_det_base``, 640 x 640, batch
    32, Momentum) and CRNN at ``ocr_rec_base`` (6625 classes, 32 x 320,
    batch 32, CTC, Adam as ``tests/test_ocr.py``), ``OCR_STEPS`` steps each;
    see the module docstring."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.ocr import ocr_rec_base
    from paddle_tpu_torch.models.presets import build_ocr_step
    from paddle_tpu_torch.optimizer import Adam

    out = {}
    with _tf32(False, True):
        t0 = time.perf_counter()
        step_fn, det, model, (B, size) = build_ocr_step("cuda", seed=seed)
        log(f"ocr_train: DBNet ocr_det_base, {sum(p.numel() for p in model.parameters())} "
            f"params, batch {B} x {size} x {size}, Momentum(1e-3, 0.9), built in "
            f"{time.perf_counter() - t0:.1f} s")
        out["dbnet"] = _ocr_leg("ocr_train dbnet", step_fn, det, OCR_STEPS, B, profile)
        del step_fn, det, model
        torch.cuda.empty_cache()
        model = ocr_rec_base(device="cuda", seed=seed)
        _, rec = _ocr_batches(np.random.default_rng(seed + 9), 32, 64, 320, 6625, 25)
        step_fn = TrainStep(model, _ctc_step_loss, Adam(learning_rate=3e-3,
                                                        parameters=model.parameters()))
        log(f"ocr_train: CRNN ocr_rec_base, {sum(p.numel() for p in model.parameters())} params, "
            f"6625 classes, batch 32 x 32 x 320 (80 CTC steps), labels of 1-25 characters")
        out["crnn"] = _ocr_leg("ocr_train crnn", step_fn, tuple(t.cuda() for t in rec),
                               OCR_STEPS, 32, profile)
    del step_fn, model
    torch.cuda.empty_cache()
    merged = {k: out["dbnet"][k] for k in ("launches", "launches_in_update")}
    merged["launches_per_step"] = out["crnn"]["launches_per_step"]
    for k in merged["launches"]:
        merged["launches"][k] += out["crnn"]["launches"][k]
        merged["launches_in_update"][k] += out["crnn"]["launches_in_update"][k]
    merged.update(out)
    return merged


def _drive_train(step_fn, args, steps, train_step=None):
    """Set every launch count to 0, run ``steps`` training steps on
    ``args`` (the tuple of the step's arguments), and read the counts just
    after.  Launches inside the optimizer's update are tallied apart from
    the rest of each step (the update of ``train_step``, the TrainStep that
    ``step_fn`` runs, ``step_fn`` itself by default).  Returns the losses,
    the wall time of each step (host clock, ending in a synchronise) and
    the record of counts."""
    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    owner = step_fn if train_step is None else train_step
    update = owner._update_fn
    in_update = dict.fromkeys(launch_counts(), 0)

    def counted_update(*a, **kw):
        before = launch_counts()
        out = update(*a, **kw)
        for name, n in launch_counts().items():
            in_update[name] += n - before[name]
        return out

    owner._update_fn = counted_update
    losses, walls, per_step = [], [], []
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        for _ in range(steps):
            before = launch_counts()
            t0 = time.perf_counter()
            losses.append(float(step_fn(*args)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_step.append({n: c - before[n] for n, c in launch_counts().items()})
        counts = launch_counts()
    finally:
        owner._update_fn = update
    return losses, walls, {"launches": counts, "launches_in_update": in_update,
                           "launches_per_step": per_step}


def _train_leg(label, fused, fp32_loss=False, preset="base", steps=TRAIN_STEPS):
    """One fresh pretrain step of ``preset`` (seed 0: the same weights and
    batch every time), ``steps`` steps through ``_drive_train``; with
    ``fused`` inside ``emit.activate(emit.verified_activation("cuda"))``,
    where every seam reads the table at each call.  Checks every step's
    launches (inside and outside the optimizer update; a recomputed layer
    runs its forward's kernels twice) and that losses are finite and
    falling.  With ``fp32_loss`` the record also holds step 1's loss with
    fp32 activations (stock, before any update).  Returns the record and
    ``(step_fn, ids)``."""
    import math

    import torch
    from paddle_tpu_torch.kernels import emit, launch_counts
    from paddle_tpu_torch.models.presets import (build_moe_step, build_pretrain_step,
                                                 model_flops_per_token)

    t0 = time.perf_counter()
    if preset == "moe":
        step_fn, ids, model, cfg, (B, S, _) = build_moe_step("cuda")
    else:
        step_fn, ids, model, cfg, (B, S, _) = build_pretrain_step(preset, "cuda")
    torch.cuda.synchronize()
    log(f"{label}: {preset} preset, {cfg.num_hidden_layers} layers, "
        f"{sum(p.numel() for p in model.parameters())} params (dtype {cfg.dtype}, params "
        f"{cfg.pdtype}), batch {B} x seq {S}, built in {time.perf_counter() - t0:.1f} s")
    L = cfg.num_hidden_layers
    want = _stock_launches(cfg)
    scope = contextlib.nullcontext({})
    if fused:
        table = emit.verified_activation("cuda")
        check(sorted(table) == sorted(emit.SITES),
              f"{label}: sites verified on the card: {sorted(table)}")
        scope = emit.activate(table)
        want.update(rms_norm=L, rms_norm_bwd=L, fuse_swiglu_mlp=L, fuse_swiglu_mlp_bwd=L,
                    fuse_add_rms_norm=L, fuse_add_rms_norm_bwd=L, fuse_rms_norm_head=1,
                    fuse_rms_norm_head_bwd=1)
    want_update = dict.fromkeys(launch_counts(), 0)
    want_update["adamw"] = steps         # one launch over every leaf a step
    loss32 = None
    if fp32_loss:
        # fp32 activations over the stored params (bf16 ones are cast at use);
        # the model's generator is put back after, so that step 1 draws the
        # gshard gate's uniforms this forward drew: both route alike
        torch.backends.cuda.matmul.allow_tf32 = False
        gen_state = model.generator.get_state()
        with torch.no_grad():
            saved = cfg.dtype, cfg.param_dtype
            cfg.param_dtype, cfg.dtype = cfg.pdtype, "float32"
            try:
                loss32 = float(model.compute_loss(model(ids), ids))
            finally:
                cfg.dtype, cfg.param_dtype = saved
                model.generator.set_state(gen_state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with scope:
        losses, walls, rec = _drive_train(step_fn, (ids,), steps)
    check(all(emit.active(n) is None for n in emit.SITES), f"{label}: the scope leaked")
    step_ms = [w * 1e3 for w in walls]
    steady = sum(step_ms[1:]) / (steps - 1)      # step 1 includes the warm-up
    flops = model_flops_per_token(cfg, S) * B * S
    rec.update(losses=losses, step_ms=step_ms, steady_step_ms=steady, loss_fp32=loss32,
               tokens_per_s=B * S / steady * 1e3,
               mfu=flops / (steady / 1e3) / BF16_FLOPS_PER_S,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{label}: losses {losses}; step ms {step_ms}; steady {steady:.3f} ms = "
        f"{rec['tokens_per_s']:.1f} tokens/s, MFU {rec['mfu']:.4f} ({flops / 1e12:.2f} TFLOP a "
        f"step at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s); peak memory "
        f"{rec['peak_bytes'] / 2**30:.2f} GiB")
    log(f"{label}: launches {json.dumps(rec)}")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"{label}: step {i + 1} launched {got}, expected {want}")
    check(rec["launches_in_update"] == want_update,
          f"{label}: launches inside the optimizer update {rec['launches_in_update']}, "
          f"expected {want_update}")
    return rec, (step_fn, ids, model)


def phase_train(profile):
    """`base` pretraining at full width and depth through the port's
    entry points, ``TRAIN_STEPS`` steps (the stock leg); see the module
    docstring."""
    import torch

    rec, (step_fn, ids, _) = _train_leg("train", False, fp32_loss=True)
    losses, loss32 = rec["losses"], rec["loss_fp32"]
    log(f"train: fp32-activation loss at step 1's weights {loss32} "
        f"(|bf16 - fp32| {abs(losses[0] - loss32):.6g}, limit {TRAIN_LOSS_TOL})")
    check(abs(losses[0] - loss32) <= TRAIN_LOSS_TOL,
          f"train: step 1's bf16 loss {losses[0]} is {abs(losses[0] - loss32)} from the "
          f"fp32-activation loss {loss32}, past {TRAIN_LOSS_TOL}")
    if profile:
        _profile(lambda: step_fn(ids), "train: one base step")
    del step_fn
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# hapi_train: the high-level API (hapi.Model) with paddle.vision
# ---------------------------------------------------------------------------

HAPI_BATCH = 64              # PaddleClas ResNet50.yaml: batch 64 a card
HAPI_TRAIN_SAMPLES = 384     # FakeData 256 x 256 x 3 float32: 302 MB on the host
HAPI_FIT_STEPS = 6           # fit's num_iters: one pass over the samples
HAPI_DRIVE_STEPS = 5         # train_batch on one batch already on the card
HAPI_EVAL_SAMPLES = 128      # evaluate: 2 batches; predict: 1
HAPI_ERNIE_STEPS = 3
# a worker's shared-memory slot: one batch of 224 x 224 x 3 fp32 images and
# its labels, with room for the frame's pickle
HAPI_SLOT_BYTES = HAPI_BATCH * (3 * 224 * 224 * 4 + 8) + (1 << 20)
IMAGENET_MEAN, IMAGENET_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _fit_probe():
    """A hapi callback that records each fit step: the host time from the
    previous step's end (or the epoch's start) to this step's start (the
    wait for the loader's batch), the step's own time (``train_batch``,
    which ends by reading the loss: a synchronise), its loss and its
    launch counts."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.kernels import launch_counts

    class FitProbe(hapi.Callback):
        def __init__(self):
            super().__init__()
            self.steps = []

        def on_epoch_begin(self, epoch, logs=None):
            self._mark = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            now = time.perf_counter()
            self._wait, self._begin, self._before = now - self._mark, now, launch_counts()

        def on_train_batch_end(self, step, logs=None):
            now = time.perf_counter()
            self.steps.append({"wait_ms": self._wait * 1e3, "step_ms": (now - self._begin) * 1e3,
                               "loss": logs["loss"],
                               "launches": {n: c - self._before[n]
                                            for n, c in launch_counts().items()}})
            self._mark = now

    return FitProbe()


def _first_batch_recorder(model):
    """Wrap ``model.train_batch`` so that the first batch fit hands it is
    kept (cloned onto the model's device); returns the dict it lands in."""
    first = {}
    inner = model.train_batch

    def recording(inputs, labels=None):
        if not first:
            dev = model._device()
            first["args"] = tuple(getattr(t, "_data", t).to(dev).clone()
                                  for t in (*inputs, *labels))
        return inner(inputs, labels)

    model.train_batch = recording
    return first


def _hapi_fit(label, model, data, steps, probe, **fit_kw):
    """``model.fit`` for ``steps`` steps with the launch counts zeroed just
    before and read just after; every step's counts are the probe's."""
    import math

    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    hist = model.fit(data, epochs=1, num_iters=steps, verbose=0, callbacks=[probe], **fit_kw)
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    losses = [s["loss"] for s in probe.steps]
    check(len(losses) == steps, f"{label}: fit ran {len(losses)} steps, not {steps}")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite fit loss {losses}")
    check(len(hist["loss"]) == 1 and math.isfinite(hist["loss"][0]),
          f"{label}: fit's history {hist}")
    return {"fit_s": fit_s, "losses": losses, "launches": counts,
            "launches_per_step": [s["launches"] for s in probe.steps],
            "wait_ms": [s["wait_ms"] for s in probe.steps],
            "step_ms": [s["step_ms"] for s in probe.steps]}


def _step1_same_bits(label, model, ref_net, ref_opt, args, fit_loss, before=None):
    """Step 1 of fit against a ``jit.TrainStep`` over ``ref_net`` (a copy of
    the weights fit started from), the model's own loss function, on the
    batch fit's step 1 ran: the losses must be the same bits.  ``before``
    runs first (it puts back the dropout generator's state)."""
    from paddle_tpu_torch.jit import TrainStep

    ref_net.train()
    ref = TrainStep(ref_net, lambda m, *a: model._loss(m(*a[:-1]), a[-1]), ref_opt)
    if before is not None:
        before()
    ref_loss = float(ref(*args))
    log(f"{label}: step 1 loss {fit_loss!r} through fit, {ref_loss!r} through TrainStep")
    check(ref_loss == fit_loss,
          f"{label}: step 1's loss {fit_loss!r} through fit is not {ref_loss!r}, a "
          f"TrainStep's on the same weights and batch")
    return ref_loss


def _sync_cost(label, model, args, steps):
    """``train_batch`` on a batch already on the card, ``steps`` steps
    through ``_drive_train`` (the loss read each step: train_batch's host
    sync), then as many ``TrainStep`` calls queued with one synchronise at
    the end; the difference of the two steady means is what the sync a
    step costs."""
    import torch

    def train_batch(*a):
        return model.train_batch(a[:-1], a[-1:])

    losses, walls, rec = _drive_train(train_batch, args, steps, model._train_step)
    synced = sum(walls[1:]) / (steps - 1) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model._train_step(*args)
    torch.cuda.synchronize()
    queued = (time.perf_counter() - t0) / steps * 1e3
    log(f"{label}: train_batch on a batch on the card {synced:.3f} ms a step (steady over "
        f"steps 2-{steps}); TrainStep queued {queued:.3f} ms; the loss read a step costs "
        f"{synced - queued:.3f} ms")
    return {"train_batch_ms": synced, "queued_step_ms": queued, "drive_losses": losses,
            "drive_launches_per_step": rec["launches_per_step"],
            "drive_launches_in_update": rec["launches_in_update"]}


def _hapi_resnet_leg(seed, card):
    """Leg 1: ResNet-50 at PaddleClas's ImageNet recipe width through
    ``Model.fit`` / ``evaluate`` / ``predict``; see the module docstring."""
    import math
    import random

    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io, metric, nn, vision
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.nn.layers import deepcopy_sharing_generators
    from paddle_tpu_torch.optimizer import L2Decay, Momentum

    T = vision.transforms
    paddle.seed(seed)
    random.seed(seed)
    np.random.seed(seed)
    t0 = time.perf_counter()
    train_tf = T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                          T.Normalize(IMAGENET_MEAN, IMAGENET_STD, data_format="HWC"),
                          T.Transpose()])
    eval_tf = T.Compose([T.Resize(256), T.CenterCrop(224),
                         T.Normalize(IMAGENET_MEAN, IMAGENET_STD, data_format="HWC"),
                         T.Transpose()])
    train_ds = vision.datasets.FakeData(HAPI_TRAIN_SAMPLES, (256, 256, 3), 1000, train_tf,
                                        seed=seed)
    eval_ds = vision.datasets.FakeData(HAPI_EVAL_SAMPLES, (256, 256, 3), 1000, eval_tf,
                                       seed=seed + 1)
    data_s = time.perf_counter() - t0
    net = vision.models.resnet50()
    ref_net = deepcopy_sharing_generators(net)

    def momentum(params):
        return Momentum(learning_rate=0.1, momentum=0.9, parameters=params,
                        weight_decay=L2Decay(1e-4))

    model = paddle.Model(net)
    model.prepare(momentum(net.parameters()), nn.CrossEntropyLoss(),
                  metric.Accuracy(topk=(1, 5)))
    torch.cuda.synchronize()
    log(f"hapi_train: ResNet-50, {sum(p.numel() for p in net.parameters())} params fp32, "
        f"1000 classes, batch {HAPI_BATCH} at 224 x 224, Momentum(0.1, 0.9) + L2Decay(1e-4); "
        f"FakeData {HAPI_TRAIN_SAMPLES} + {HAPI_EVAL_SAMPLES} images 256 x 256 x 3 made in "
        f"{data_s:.1f} s, built in {time.perf_counter() - t0:.1f} s; {_backend_flags()}")
    # cuDNN's and cuBLAS's first calls at these shapes (algorithm choice,
    # handles) on the copy, so that fit's steps show the loader, not them;
    # the copy's BatchNorm statistics move, which step 1's loss (batch
    # statistics) does not read
    t0 = time.perf_counter()
    x0 = torch.zeros(HAPI_BATCH, 3, 224, 224, device=net.bn1._mean.device)
    y0 = torch.zeros(HAPI_BATCH, dtype=torch.int64, device=x0.device)
    ref_net.train()
    torch.autograd.grad(model._loss(ref_net(x0), y0), list(ref_net.parameters()))
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    bn = net.bn1._mean.clone()
    first = _first_batch_recorder(model)
    probe = _fit_probe()
    torch.cuda.reset_peak_memory_stats()
    # the workers ship a batch through one shared-memory slot: 38.5 MB of
    # images, past the 8 MiB default
    rec = _hapi_fit("hapi_train resnet50", model, io.DataLoader(
        train_ds, batch_size=HAPI_BATCH, shuffle=True, num_workers=2,
        shm_slot_bytes=HAPI_SLOT_BYTES), HAPI_FIT_STEPS, probe)
    rec["fit_peak_bytes"] = torch.cuda.max_memory_allocated()
    del model.train_batch                                  # the recorder
    none = dict.fromkeys(launch_counts(), 0)
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == none, f"hapi_train resnet50: fit step {i + 1} launched {got}")
    check(not torch.equal(net.bn1._mean, bn), "hapi_train resnet50: BatchNorm statistics "
          "did not move")
    # the same fit with the batches made on a thread of this process
    thread = _hapi_fit("hapi_train resnet50 thread", model, io.DataLoader(
        train_ds, batch_size=HAPI_BATCH, shuffle=True, num_workers=2,
        use_shared_memory=False), HAPI_FIT_STEPS, _fit_probe())
    for i, got in enumerate(thread["launches_per_step"]):
        check(got == none, f"hapi_train resnet50 thread: fit step {i + 1} launched {got}")
    loader = io.DataLoader(train_ds, batch_size=HAPI_BATCH, shuffle=True)
    t0 = time.perf_counter()
    for i, _ in enumerate(loader):
        if i == 2:
            break
    torch.cuda.synchronize()
    rec["loader_ms_per_batch"] = (time.perf_counter() - t0) / 3 * 1e3
    n = HAPI_FIT_STEPS
    rec["warm_up_ms"] = warm_ms
    log(f"hapi_train resnet50: a forward and backward at these shapes first (the copy's): "
        f"{warm_ms:.1f} ms")
    for label, r in (("2 worker processes", rec), ("a thread", thread)):
        wait, step = r["wait_ms"], r["step_ms"]
        r.update(images_per_s=n * HAPI_BATCH / r["fit_s"],
                 steady_images_per_s=(n - 1) * HAPI_BATCH / (sum(wait[1:]) + sum(step[1:]))
                 * 1e3, loader_share=sum(wait[1:]) / (sum(wait[1:]) + sum(step[1:])))
        log(f"hapi_train resnet50: fit, batches from {label}: losses {r['losses']}; wait ms "
            f"{wait}; step ms {step}; {r['images_per_s']:.2f} images/s over the fit "
            f"({r['fit_s']:.2f} s, loader included), {r['steady_images_per_s']:.2f} images/s "
            f"over steps 2-{n}, of which {r['loader_share']:.3f} waited on the loader; {card}")
    rec["thread"] = {k: thread[k] for k in ("losses", "wait_ms", "step_ms", "fit_s",
                                            "images_per_s", "steady_images_per_s",
                                            "loader_share")}
    log(f"hapi_train resnet50: the loader alone, in this thread, "
        f"{rec['loader_ms_per_batch']:.3f} ms a batch; peak memory "
        f"{rec['fit_peak_bytes'] / 2**30:.2f} GiB; {card}")
    rec["step1_fit_loss"] = rec["losses"][0]
    _step1_same_bits("hapi_train resnet50", model, ref_net, momentum(ref_net.parameters()),
                     first["args"], rec["losses"][0])
    del ref_net
    rec.update(_sync_cost("hapi_train resnet50", model, first["args"], HAPI_DRIVE_STEPS))
    for i, got in enumerate(rec["drive_launches_per_step"]):
        check(got == none, f"hapi_train resnet50: train_batch {i + 1} launched {got}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logs = model.evaluate(io.DataLoader(eval_ds, batch_size=HAPI_BATCH, num_workers=2,
                                        shm_slot_bytes=HAPI_SLOT_BYTES), verbose=0)
    eval_s = time.perf_counter() - t0
    top1, top5 = model._metrics[0].accumulate()
    rec.update(eval_logs=logs, eval_top5=top5, eval_images_per_s=HAPI_EVAL_SAMPLES / eval_s,
               eval_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"hapi_train resnet50: evaluate {logs} (top-5 {top5}) over {HAPI_EVAL_SAMPLES} images "
        f"in {eval_s:.3f} s = {rec['eval_images_per_s']:.2f} images/s, peak memory "
        f"{rec['eval_peak_bytes'] / 2**30:.2f} GiB; {card}")
    check(sorted(logs) == ["acc", "loss"], f"hapi_train resnet50: evaluate's logs {logs}")
    check(math.isfinite(logs["loss"]) and 0.0 <= logs["acc"] <= 1.0 and logs["acc"] == top1
          and 0.0 <= top5 <= 1.0, f"hapi_train resnet50: evaluate's values {logs}, top-5 {top5}")
    pred = model.predict(io.Subset(eval_ds, range(HAPI_BATCH)), batch_size=HAPI_BATCH)
    check(len(pred) == 1 and len(pred[0]) == 1 and pred[0][0].shape == (HAPI_BATCH, 1000)
          and bool(np.isfinite(pred[0][0]).all()),
          f"hapi_train resnet50: predict gave {[[a.shape for a in o] for o in pred]}")
    log(f"hapi_train resnet50: predict {pred[0][0].shape} {pred[0][0].dtype}")
    del model, net
    torch.cuda.empty_cache()
    return rec


def _hapi_ernie_leg(seed, ernie_rec):
    """Leg 2: ERNIE-base text classification through ``Model.fit``; see the
    module docstring."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io, metric, nn
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification
    from paddle_tpu_torch.models.presets import ERNIE_BATCH, ERNIE_SEQ, ernie_base_config
    from paddle_tpu_torch.nn.layers import deepcopy_sharing_generators
    from paddle_tpu_torch.optimizer import AdamW

    cfg = ernie_base_config()
    L = cfg.num_hidden_layers
    net = ErnieForSequenceClassification(cfg, num_classes=2, seed=seed)
    ref_net = deepcopy_sharing_generators(net)
    ids, labels = _ernie_batch(np.random.default_rng(seed), cfg.vocab_size,
                               ERNIE_BATCH * HAPI_ERNIE_STEPS, ERNIE_SEQ)
    data = io.TensorDataset([paddle.to_tensor(ids), paddle.to_tensor(labels)])

    def adamw(params):
        return AdamW(learning_rate=5e-5, parameters=params, weight_decay=0.01)

    model = paddle.Model(net)
    model.prepare(adamw(net.parameters()), nn.CrossEntropyLoss(), metric.Accuracy())
    gen = net._generator                    # weights and dropout masks, shared with ref_net
    state = gen.get_state()
    first = _first_batch_recorder(model)
    probe = _fit_probe()
    rec = _hapi_fit("hapi_train ernie", model, data, HAPI_ERNIE_STEPS, probe,
                    batch_size=ERNIE_BATCH)
    del model.train_batch
    want = dict.fromkeys(launch_counts(), 0)
    want.update(flash_attention_fwd_noncausal=L, flash_attention_bwd_noncausal=L, adamw=1)
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"hapi_train ernie: fit step {i + 1} launched {got}, expected {want}")
    steady = sum(rec["step_ms"][1:]) / (HAPI_ERNIE_STEPS - 1)
    ernie_ms = ernie_rec["steady_step_ms"] if ernie_rec else None
    rec["steady_step_ms"] = steady
    log(f"hapi_train ernie: ERNIE-1.0-base widths, batch {ERNIE_BATCH} x {ERNIE_SEQ}, AdamW(5e-5), "
        f"fit losses {rec['losses']}; wait ms {rec['wait_ms']}; step ms {rec['step_ms']}; "
        f"steady {steady:.3f} ms a step through fit, "
        + (f"{ernie_ms:.3f} ms through ernie_train's TrainStep (Adam)" if ernie_ms
           else "ernie_train not run"))
    _step1_same_bits("hapi_train ernie", model, ref_net, adamw(ref_net.parameters()),
                     first["args"], rec["losses"][0], before=lambda: gen.set_state(state))
    del ref_net
    rec.update(_sync_cost("hapi_train ernie", model, first["args"], HAPI_ERNIE_STEPS))
    for i, got in enumerate(rec["drive_launches_per_step"]):
        check(got == want, f"hapi_train ernie: train_batch {i + 1} launched {got}")
    logs = model.evaluate(io.Subset(data, range(ERNIE_BATCH)), batch_size=ERNIE_BATCH,
                          verbose=0)
    log(f"hapi_train ernie: evaluate over one batch {logs}")
    check(sorted(logs) == ["acc", "loss"] and np.isfinite(logs["loss"])
          and 0.0 <= logs["acc"] <= 1.0, f"hapi_train ernie: evaluate's logs {logs}")
    rec["eval_logs"] = logs
    del model, net
    torch.cuda.empty_cache()
    return rec


def phase_hapi_train(seed, card, ernie_rec=None):
    """The high-level API on the card: ResNet-50 and ERNIE-base through
    ``hapi.Model``; see the module docstring.  Returns the record whose
    launches the kernel table reads (both fits' counts; the ERNIE fit's
    per step).  Both legs run under torch's TF32 defaults (matmul off,
    cuDNN on), whatever an earlier phase left set, as ``ocr_train``."""
    with _tf32(False, True):
        resnet = _hapi_resnet_leg(seed, card)
        ernie = _hapi_ernie_leg(seed, ernie_rec)
    launches = {n: c + ernie["launches"][n] for n, c in resnet["launches"].items()}
    return {"launches": launches, "launches_per_step": ernie["launches_per_step"],
            "resnet50": resnet, "ernie": ernie}


def _eager_steps(step, batches, steps):
    """``steps`` calls of ``step(*batch)`` (one training step that returns
    its loss) over the batches ``batches`` yields, the launch counts set to
    0 just before the first and read after each; a step's wall time holds
    the batch's fetch and ends in a synchronise.  Returns the losses, the
    ms of each step and the record of counts."""
    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    losses, walls, per_step = [], [], []
    it = iter(batches)
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(steps):
        before = launch_counts()
        t0 = time.perf_counter()
        losses.append(float(step(*next(it))))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: c - before[n] for n, c in launch_counts().items()})
    return losses, walls, {"launches": launch_counts(), "launches_per_step": per_step}


def _base_tokens(seed, steps):
    """The `base` preset's config and ``steps`` seeded batches of 3 x 2048
    (the `train` phase's config and batch shape), as one int32 array."""
    import numpy as np
    from paddle_tpu_torch.models.presets import DEFAULTS, build_config

    cfg = build_config("base", "bfloat16")
    B, S, _ = DEFAULTS["base"]
    tokens = np.random.default_rng(seed + 20).integers(
        0, cfg.vocab_size, size=(steps * B, S)).astype(np.int32)
    return cfg, B, S, tokens


def _base_trainstep_leg(cfg, seed, tokens, B):
    """`base` from ``seed`` through TrainStep with AdamW(3e-4, decay 0.1),
    a step a batch of ``tokens`` (``_eager_steps``): the yardstick of the
    legs that run the same model, batches and optimizer another way."""
    import paddle_tpu_torch as paddle
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    opt = paddle.optimizer.AdamW(learning_rate=3e-4, weight_decay=0.1,
                                 parameters=model.parameters())
    step_fn = paddle.jit.TrainStep(model, lambda m, ids: m.compute_loss(m(ids), ids), opt)
    steps = len(tokens) // B
    batches = [(torch.from_numpy(tokens[i * B:(i + 1) * B]).cuda(),) for i in range(steps)]
    out = _eager_steps(step_fn, batches, steps)
    del model, opt, step_fn, batches
    torch.cuda.empty_cache()
    return out


def _eager_base_leg(seed, train):
    """Leg 1 of `eager_train`: the `base` LlamaForCausalLM through the eager
    API, then TrainStep on the same weights, batches and AdamW; see the
    module docstring."""
    import math

    import paddle_tpu_torch as paddle
    import torch
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM

    paddle.set_device("gpu")
    paddle.seed(seed)
    cfg, B, S, tokens = _base_tokens(seed, EAGER_STEPS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=seed)
    opt = paddle.optimizer.AdamW(learning_rate=3e-4, weight_decay=0.1,
                                 parameters=model.parameters())
    loader = paddle.io.DataLoader(paddle.io.TensorDataset([paddle.to_tensor(tokens)]),
                                  batch_size=B)

    def step(ids):
        loss = model.compute_loss(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.synchronize()
    log(f"eager_train leg 1: base preset through the eager API, {cfg.num_hidden_layers} layers, "
        f"{sum(p.numel() for p in model.parameters())} params (params {cfg.pdtype}, compute "
        f"{cfg.dtype}), {EAGER_STEPS} batches of {B} x {S} from a DataLoader, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    losses, walls, rec = _eager_steps(step, loader, EAGER_STEPS)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    want = dict.fromkeys(launch_counts(), 0)
    want.update(flash_attention_fwd=L, flash_attention_bwd=L, rms_norm=2 * L + 1,
                rms_norm_bwd=2 * L + 1, adamw=1)
    if train is not None:
        check(train["launches_per_step"][0] == want,
              f"eager_train: the `train` phase's step launched {train['launches_per_step'][0]}, "
              f"expected {want}")
    del model, opt, loader, step
    torch.cuda.empty_cache()

    # the same weights, batches and AdamW through TrainStep
    ts_losses, ts_walls, ts_rec = _base_trainstep_leg(cfg, seed, tokens, B)

    steady = sum(walls[1:]) / (EAGER_STEPS - 1)
    ts_steady = sum(ts_walls[1:]) / (EAGER_STEPS - 1)
    train_steady = None if train is None else train["steady_step_ms"]
    same_bits = losses == ts_losses
    d = max(abs(a - b) for a, b in zip(losses, ts_losses))
    rec.update(losses=losses, step_ms=walls, steady_step_ms=steady, peak_bytes=peak,
               train_step=dict(losses=ts_losses, step_ms=ts_walls, steady_step_ms=ts_steady,
                               launches_per_step=ts_rec["launches_per_step"]),
               train_phase_steady_step_ms=train_steady, same_bits=same_bits)
    log(f"eager_train leg 1: losses {losses}; TrainStep {ts_losses}; "
        f"{'the same bits' if same_bits else f'differ by up to {d!r}'}; step ms {walls} (TrainStep "
        f"{ts_walls}); steady {steady:.3f} ms, fastest {min(walls[1:]):.3f} (TrainStep in this "
        f"phase {ts_steady:.3f}, fastest {min(ts_walls[1:]):.3f}; the `train` phase "
        f"{train_steady}); peak memory {peak / 2**30:.2f} GiB")
    log(f"eager_train leg 1: launches {json.dumps(rec['launches_per_step'])}")
    check(all(math.isfinite(x) for x in losses), f"eager_train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"eager_train: loss did not fall: {losses}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"eager_train: eager step {i + 1} launched {got}, expected {want}")
    for i, got in enumerate(ts_rec["launches_per_step"]):
        check(got == want, f"eager_train: TrainStep step {i + 1} launched {got}, expected {want}")
    if not same_bits:
        # the same weights and batch give step 1 the same autograd graph and
        # the same update: a later step may differ only where step 1 did
        check(losses[0] != ts_losses[0], f"eager_train: step 1's losses are the same bits but "
              f"a later step's are not ({losses} against TrainStep's {ts_losses}): the eager "
              f"update differs from TrainStep's")
        log("eager_train: step 1's losses are not the same bits: the eager and TrainStep "
            "forwards ran on the same weights and batch, so a kernel gave other bits on a "
            "second run; every step held within TRAIN_LOSS_TOL")
        check(d <= TRAIN_LOSS_TOL, f"eager_train: the eager losses {losses} are up to {d} "
              f"from TrainStep's {ts_losses}, past {TRAIN_LOSS_TOL}")
    return rec


def _ernie_o1_step(paddle, model, ids, labels, opt, scaler, amp=True):
    """One dygraph step of ERNIE under ``auto_cast`` O1 bf16 (without it
    where ``amp`` is False) with loss scaling (the `eager_train` leg 2
    program).  Returns the loss and the logits."""
    with paddle.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        logits = model(ids)
        loss = model.compute_loss(logits, labels)
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    return loss, logits


def _eager_amp_leg(seed):
    """Leg 2 of `eager_train`: ERNIE-base widths under ``auto_cast`` O1 with
    a GradScaler, then step 1 of a 2-layer cut against the CPU; see the
    module docstring."""
    import math

    import numpy as np
    import paddle_tpu_torch as paddle
    import torch
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         load_paddle_tpu_params, to_paddle_tpu_params)
    from paddle_tpu_torch.models.presets import ERNIE_BATCH, ERNIE_SEQ, ernie_base_config

    paddle.set_device("gpu")
    cfg = ernie_base_config()
    ids, labels = _ernie_batch(np.random.default_rng(seed), cfg.vocab_size, ERNIE_BATCH,
                               ERNIE_SEQ)
    model = ErnieForSequenceClassification(cfg, seed=seed)
    opt = paddle.optimizer.Adam(learning_rate=2e-3, parameters=model.parameters())
    scaler = paddle.amp.GradScaler()
    seen = {}

    def note_dtype(mod, args):
        seen.setdefault("attention_output", str(args[0].dtype))

    hook = model.ernie.encoder.layers[0].self_attn.out_proj.register_forward_pre_hook(
        note_dtype)
    batch = (paddle.to_tensor(ids.numpy()), paddle.to_tensor(labels.numpy()))
    L = cfg.num_hidden_layers
    losses, walls, rec = _eager_steps(
        lambda i, y: _ernie_o1_step(paddle, model, i, y, opt, scaler)[0],
        [batch] * EAGER_AMP_STEPS, EAGER_AMP_STEPS)
    hook.remove()
    want = dict.fromkeys(launch_counts(), 0)
    want.update(flash_attention_fwd_noncausal=L, flash_attention_bwd_noncausal=L, adamw=1)
    steady = sum(walls[1:]) / (EAGER_AMP_STEPS - 1)
    rec.update(losses=losses, step_ms=walls, steady_step_ms=steady,
               loss_scale=float(scaler.get_loss_scaling()), **seen)
    log(f"eager_train leg 2: ERNIE-base widths, {L} layers, fp32 params, batch {ERNIE_BATCH} "
        f"x {ERNIE_SEQ}, auto_cast O1 bf16, GradScaler: losses {losses}; step ms {walls}; "
        f"steady {steady:.3f} ms; attention output (the flash kernels' dtype) "
        f"{seen.get('attention_output')}; loss scale {rec['loss_scale']}; launches "
        f"{json.dumps(rec['launches_per_step'])}")
    del model, opt, scaler, batch
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f"eager_train leg 2: non-finite loss {losses}")
    check(seen.get("attention_output") == "torch.bfloat16",
          f"eager_train leg 2: attention ran in {seen.get('attention_output')}, not bf16")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"eager_train leg 2: step {i + 1} launched {got}, expected {want}")

    # step 1 of a 2-layer cut, card against CPU, under the same O1 program;
    # the control runs the card without auto_cast
    cut = ernie_base_config(num_hidden_layers=2, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    ids2, labels2 = _ernie_batch(np.random.default_rng(seed + 8), cut.vocab_size, 2, 512)
    cpu = ErnieForSequenceClassification(cut, device="cpu", seed=seed)
    start = {k: v.copy() for k, v in to_paddle_tpu_params(cpu).items()}   # CPU steps in place
    step1 = {}
    for run, dev, amp in (("cpu", "cpu", True), ("card", "gpu", True),
                          ("card_fp32", "gpu", False)):
        paddle.set_device(dev)
        m = cpu if dev == "cpu" else ErnieForSequenceClassification(cut, device="cuda",
                                                                    seed=seed)
        if m is not cpu:
            load_paddle_tpu_params(m, start)
        loss, logits = _ernie_o1_step(
            paddle, m, paddle.to_tensor(ids2.numpy()), paddle.to_tensor(labels2.numpy()),
            paddle.optimizer.Adam(learning_rate=2e-3, parameters=m.parameters()),
            paddle.amp.GradScaler(), amp=amp)
        step1[run] = {"loss": float(loss), "logits": logits.numpy().astype(np.float64),
                      "logits_dtype": str(logits.dtype)}
        del m
    paddle.set_device("gpu")
    ref = step1["cpu"]

    def gap(run):
        return abs(step1[run]["loss"] - ref["loss"]) / abs(ref["loss"])

    rel, ctl = gap("card"), gap("card_fp32")
    rec["step1_cut"] = {run: {"loss": r["loss"], "logits": r["logits"].tolist(),
                              "logits_dtype": r["logits_dtype"]} for run, r in step1.items()}
    rec["step1_cut"].update(rel=rel, control_rel=ctl, limit=EAGER_AMP_LOSS_RTOL)
    log(f"eager_train leg 2: 2-layer cut, step 1's loss under O1, card against CPU: rel "
        f"{rel:.3e}; the control, the card without auto_cast: rel {ctl:.3e}; limit "
        f"{EAGER_AMP_LOSS_RTOL:.3e}; {json.dumps(rec['step1_cut'])}")
    check(rel <= EAGER_AMP_LOSS_RTOL, f"eager_train leg 2: the cut's step-1 loss on the card "
          f"{step1['card']['loss']} is {rel} of the CPU's {ref['loss']} away, past "
          f"{EAGER_AMP_LOSS_RTOL}")
    check(ctl > EAGER_AMP_LOSS_RTOL, f"eager_train leg 2: the cut run on the card without "
          f"auto_cast is only {ctl} of the CPU's O1 loss away, within the limit "
          f"{EAGER_AMP_LOSS_RTOL}: the check cannot tell whether O1 ran")
    return rec


def phase_eager_train(seed, train=None):
    """The eager Paddle API on the card (`base` dygraph, then ERNIE-base
    under O1); ``train``, the record of the `train` phase run just before,
    when it ran.  See the module docstring."""
    import paddle_tpu_torch as paddle

    try:
        base = _eager_base_leg(seed, train)
        amp = _eager_amp_leg(seed)
    finally:
        paddle.set_device(None)
    merged = {"launches": dict(base["launches"]), "launches_per_step": base["launches_per_step"],
              "base": base, "amp": amp}
    for k, n in amp["launches"].items():
        merged["launches"][k] += n
    return merged


def _static_base_leg(seed, card):
    """Leg 1 of `static_graph`: `base` as a static Program (static.data,
    the model, compute_loss and AdamW.minimize under program_guard), run
    by an Executor on the card, against TrainStep on the same weights,
    batches and optimizer.  Returns the record and the trained model, the
    Program, its Executor and its loss variable."""
    import math

    import paddle_tpu_torch as paddle
    import torch
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg, B, S, tokens = _base_tokens(seed, STATIC_STEPS)
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paddle.enable_static()
    try:
        main, startup = paddle.static.Program(), paddle.static.Program()
        with paddle.static.program_guard(main, startup):
            ids = paddle.static.data("ids", [None, S], "int32")
            loss = model.compute_loss(model(ids), ids)
            paddle.optimizer.AdamW(learning_rate=3e-4, weight_decay=0.1).minimize(loss)
    finally:
        paddle.disable_static()
    record_s = time.perf_counter() - t0
    exe = paddle.static.Executor(place="gpu")
    exe.run(startup)
    batches = [(tokens[i * B:(i + 1) * B],) for i in range(STATIC_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    losses, walls, rec = _eager_steps(
        lambda b: exe.run(main, feed={"ids": b}, fetch_list=[loss])[0], batches, STATIC_STEPS)
    peak = torch.cuda.max_memory_allocated()
    ts_losses, ts_walls, ts_rec = _base_trainstep_leg(cfg, seed, tokens, B)
    L = cfg.num_hidden_layers
    want = dict.fromkeys(launch_counts(), 0)
    want.update(flash_attention_fwd=L, flash_attention_bwd=L, rms_norm=2 * L + 1,
                rms_norm_bwd=2 * L + 1, adamw=1)
    steady = sum(walls[1:]) / (STATIC_STEPS - 1)
    ts_steady = sum(ts_walls[1:]) / (STATIC_STEPS - 1)
    d = max(abs(a - b) for a, b in zip(losses, ts_losses))
    rec.update(losses=losses, step_ms=walls, steady_step_ms=steady, peak_bytes=peak,
               record_s=record_s, recorded_ops=len(main.ops),
               train_step=dict(losses=ts_losses, step_ms=ts_walls, steady_step_ms=ts_steady))
    log(f"static_graph leg 1 ({card}): base as a static Program, {len(main.ops)} recorded "
        f"ops, recorded in {record_s * 1e3:.1f} ms; losses {losses}; TrainStep {ts_losses} "
        f"(largest difference {d!r}); step ms {walls} (TrainStep {ts_walls}); steady "
        f"{steady:.3f} ms against TrainStep's {ts_steady:.3f}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"static_graph leg 1: launches {json.dumps(rec['launches_per_step'])}")
    check(all(math.isfinite(x) for x in losses), f"static_graph: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"static_graph: loss did not fall: {losses}")
    check(losses[0] == ts_losses[0], f"static_graph: step 1's loss {losses[0]!r} is not "
          f"TrainStep's {ts_losses[0]!r}")
    check(d <= TRAIN_LOSS_TOL, f"static_graph: the Program's losses {losses} are up to {d} "
          f"from TrainStep's {ts_losses}, past {TRAIN_LOSS_TOL}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"static_graph: run {i + 1} launched {got}, expected {want}")
    for i, got in enumerate(ts_rec["launches_per_step"]):
        check(got == want, f"static_graph: TrainStep step {i + 1} launched {got}, "
              f"expected {want}")
    return rec, (model, main, exe, loss, tokens[:B])


def _branchy(x):
    """A function with a data-dependent branch (the fragment fallback)."""
    y = x * 2
    if float(y.sum()) > 0:
        return y + 1
    return y - 1


def _static_export_leg(model, ids, card, tmpdir):
    """Leg 2 of `static_graph`: to_static of the forward, jit.save with an
    InputSpec, a Predictor reading only the artifact; each output against
    the eager forward's bits, the Predictor's launches counted; then a
    to_static function whose branch reads a value (fragments, break site)."""
    import paddle_tpu_torch as paddle
    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    B, S = ids.shape
    t = torch.from_numpy(ids).cuda()
    with torch.no_grad():
        eager = model(t)
        static = paddle.jit.to_static(model)
        first = static(t)._data
        torch.cuda.synchronize()
        reset_launch_counts()
        again = static(t)._data
        torch.cuda.synchronize()
        replay_launches = launch_counts()
    same = torch.equal(first, eager) and torch.equal(again, eager)
    prefix = str(Path(tmpdir) / "base_fwd")
    t0 = time.perf_counter()
    nbytes = paddle.jit.save(model, prefix,
                             input_spec=[paddle.static.InputSpec([B, S], "int32")])
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pred = paddle.inference.create_predictor(paddle.inference.Config(prefix))
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    handle = pred.get_input_handle(pred.get_input_names()[0])
    handle.copy_from_cpu(ids)
    pred.run()                                   # the first run: allocations
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    pred.run()
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    pred_launches = launch_counts()
    out = pred.get_output_handle(pred.get_output_names()[0])._value
    pred_same = torch.equal(out, eager)
    L = model.config.num_hidden_layers
    want = dict.fromkeys(launch_counts(), 0)
    want.update(flash_attention_fwd=L, rms_norm=2 * L + 1)
    log(f"static_graph leg 2 ({card}): to_static logits {'the same bits as' if same else 'NOT'} "
        f"eager's (launches a replay {json.dumps(replay_launches)}); jit.save {save_ms:.1f} ms, "
        f"{nbytes} bytes; Predictor load {load_ms:.1f} ms, run {run_ms:.3f} ms, output "
        f"{'the same bits as' if pred_same else 'NOT'} eager's (max |diff| "
        f"{float((out.float() - eager.float()).abs().max())!r}); launches "
        f"{json.dumps(pred_launches)}")
    check(same, "static_graph: to_static's logits are not eager's bits")
    check(replay_launches == want, f"static_graph: a to_static replay launched "
          f"{replay_launches}, expected {want}")
    check(pred_same, "static_graph: the Predictor's logits are not eager's bits")
    check(pred_launches == want, f"static_graph: the Predictor launched {pred_launches}, "
          f"expected {want}")
    del pred, static
    # fragments: the same report on two calls (the repeat records every
    # call from the shape cache: no miss), another fragment for the other
    # branch
    fn = paddle.jit.to_static(_branchy)
    reports = []
    for sign in (1.0, 1.0, -1.0):
        x = paddle.to_tensor(torch.full((4, 8), sign, device="cuda"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = fn(x)
        rec = fn._last_capture
        check(torch.equal(out._data, _branchy(x)._data), "static_graph: fragment output")
        reports.append(dict(fragments=len(rec.fragments), breaks=len(rec.breaks),
                            site=rec.breaks[0]["site"], eager_ops=rec.eager_ops,
                            cache_hits=rec.cache_hits, cache_misses=rec.cache_misses))
    log(f"static_graph leg 2: to_static(_branchy) by call (positive, positive, negative): "
        f"{json.dumps(reports)}")
    check(reports[0]["site"] == reports[1]["site"] == reports[2]["site"]
          and "chip_smoke.py" in reports[0]["site"], f"static_graph: break sites {reports}")
    check(reports[1]["cache_misses"] == 0, f"static_graph: a repeated call missed: {reports}")
    return {"same_bits": same, "predictor_same_bits": pred_same, "save_ms": save_ms,
            "save_bytes": nbytes, "load_ms": load_ms, "predictor_run_ms": run_ms,
            "launches_replay": replay_launches, "launches": pred_launches,
            "fragments": reports}


def phase_static_graph(seed, card):
    """The compiled-graph layer at `base`: a static Program trained by an
    Executor (leg 1), to_static, jit.save and a Predictor (leg 2), and
    amp.debugging over a static step (leg 3).  See the module docstring."""
    import tempfile

    import paddle_tpu_torch as paddle
    import torch

    paddle.set_device("gpu")
    try:
        train, (model, main, exe, loss, ids) = _static_base_leg(seed, card)
        with tempfile.TemporaryDirectory() as tmp:
            export = _static_export_leg(model, ids, card, tmp)
        # leg 3: operator statistics over one more static step; numerics
        with paddle.amp.debugging.collect_operator_stats(print_table=False):
            exe.run(main, feed={"ids": ids}, fetch_list=[loss])
            stats = paddle.amp.debugging.operator_stats()
        log(f"static_graph leg 3: operator stats of one static base step "
            f"{json.dumps({f'{k[0]}/{k[1]}': n for k, n in sorted(stats.items())})}")
        L = model.config.num_hidden_layers
        check(stats.get(("scaled_dot_product_attention", "bfloat16")) == L
              and stats.get(("rms_norm", "bfloat16")) == 2 * L + 1,
              f"static_graph: operator stats {stats}")
        bad = paddle.to_tensor(torch.tensor([1.0, float("nan"), 2.0], device="cuda"))
        try:
            paddle.amp.debugging.check_numerics(bad, "static_graph", "probe")
            raised = False
        except FloatingPointError:
            raised = True
        check(raised, "static_graph: check_numerics did not raise on a NaN in abort mode")
        del model, main, exe
        torch.cuda.empty_cache()
    finally:
        paddle.set_device(None)
    return {"launches": dict(train["launches"]), "launches_per_step": train["launches_per_step"],
            "train": train, "export": export, "op_stats": {f"{k[0]}/{k[1]}": n
                                                           for k, n in stats.items()}}


def phase_longctx_train(profile):
    """`longctx` pretraining (the `base` model at seq 16384, batch 1, every
    layer recomputed) through the port's entry points, ``LONGCTX_STEPS``
    steps; see the module docstring."""
    import torch

    rec, (step_fn, ids, _) = _train_leg("longctx_train", False, preset="longctx",
                                        steps=LONGCTX_STEPS)
    if profile:
        _profile(lambda: step_fn(ids), "longctx_train: one longctx step")
    del step_fn
    torch.cuda.empty_cache()
    return rec


def phase_fuse_train(profile, stock=None):
    """`base` through TrainStep in three legs, stock -> fused -> stock (the
    port's counterpart of bench.py's ``_bench_fuse``); ``stock``, the record
    of the `train` phase run just before, is the first stock leg when
    given.  See the module docstring."""
    import torch
    from paddle_tpu_torch.kernels import emit

    legs = {} if stock is None else {"stock": stock}
    for label, fused in (("stock", False), ("fused", True), ("stock again", False)):
        if label in legs:
            continue
        legs[label], (step_fn, ids, _) = _train_leg(f"fuse_train {label} leg", fused,
                                                    fp32_loss=label == "stock")
        if fused and profile:
            with emit.activate(emit.verified_activation("cuda")):
                _profile(lambda: step_fn(ids), "fuse_train: one fused base step")
        del step_fn
        torch.cuda.empty_cache()
    stock, fused, again = (legs[k]["losses"] for k in ("stock", "fused", "stock again"))
    loss32 = legs["stock"]["loss_fp32"]
    d_fused, d_fp32 = abs(fused[0] - stock[0]), abs(stock[0] - loss32)
    log(f"fuse_train: step-1 loss fused {fused[0]} stock {stock[0]}: |fused - stock| "
        f"{d_fused:.6g} (limit {TRAIN_LOSS_TOL}); stock's own |bf16 - fp32 activations| "
        f"{d_fp32:.6g} (fp32 loss {loss32}); stock legs' losses {stock} and {again}")
    check(d_fused <= TRAIN_LOSS_TOL,
          f"fuse_train: step 1's fused loss {fused[0]} is {d_fused} from the stock {stock[0]}, "
          f"past {TRAIN_LOSS_TOL}")
    check(again[0] == stock[0] and all(abs(a - b) <= STOCK_LEGS_RTOL * abs(b)
                                       for a, b in zip(again, stock)),
          f"fuse_train: the stock legs disagree: {stock} and {again}")
    rec = dict(legs["fused"])
    rec.update(stock=legs["stock"], stock_again=legs["stock again"], loss_fp32=loss32,
               step1_fused_minus_stock=fused[0] - stock[0])
    return rec


def phase_moe_train(profile):
    """The `moe` preset (bench.py's configs[4] shape) at full width and depth
    through the port's entry points, ``TRAIN_STEPS`` steps through
    ``_train_leg``; then each layer's capacity drops, and a step run twice
    from one state; see the module docstring."""
    import torch

    rec, (step_fn, ids, model) = _train_leg("moe_train", False, fp32_loss=True, preset="moe")
    losses, loss32 = rec["losses"], rec["loss_fp32"]
    log(f"moe_train: fp32-activation loss at step 1's weights {loss32} "
        f"(|bf16 - fp32| {abs(losses[0] - loss32):.6g}, limit {MOE_TRAIN_LOSS_TOL})")
    check(abs(losses[0] - loss32) <= MOE_TRAIN_LOSS_TOL,
          f"moe_train: step 1's bf16 loss {losses[0]} is {abs(losses[0] - loss32)} from the "
          f"fp32-activation loss {loss32}, past {MOE_TRAIN_LOSS_TOL}")
    drops = []
    for layer in model.llama.layers:         # the last step's routing, layer by layer
        r = layer.mlp.last_routing
        chosen = int((r.weight > 0).sum())   # gshard's second expert may be drawn away
        drops.append((chosen - int(r.kept.sum())) / chosen)
    rec["capacity_drop_share"] = drops
    log(f"moe_train: capacity {model.llama.layers[0].mlp.last_routing.capacity} a expert; "
        f"share of (token, slot) choices dropped by capacity, layer by layer {drops}")
    rec["same_bits"] = _same_bits_twice("moe_train", step_fn, ids, model)
    if profile:
        _profile(lambda: step_fn(ids), "moe_train: one moe step")
    del step_fn, model
    torch.cuda.empty_cache()
    return rec


def _same_bits_twice(label, step_fn, ids, model):
    """One step run twice from the same state (params, optimizer slots, step
    count, the gshard gate's generator): the losses and every param and
    slot must be the same bits."""
    import torch

    start = {k: v.clone() for k, v in step_fn.state_dict().items()}
    gen = model.generator.get_state()
    runs = []
    for _ in range(2):
        step_fn.set_state_dict(start)
        model.generator.set_state(gen)
        loss = step_fn(ids)
        runs.append((loss.clone(), {k: v.clone() for k, v in step_fn.state_dict().items()}))
    (l1, s1), (l2, s2) = runs
    differ = sorted(k for k in s1 if not torch.equal(s1[k], s2[k]))
    log(f"{label}: a step run twice from one state: losses {float(l1)!r} and {float(l2)!r}; "
        f"{len(s1) - len(differ)} of {len(s1)} tensors the same bits")
    check(torch.equal(l1, l2) and not differ,
          f"{label}: a step repeated from the same state differs: losses {float(l1)!r} "
          f"{float(l2)!r}, tensors {differ[:8]}")
    return {"losses": [float(l1), float(l2)], "tensors": len(s1)}


def _profile(fn, label, ranges=()):
    """torch.profiler over one call of ``fn``: device kernel time by name,
    the device's busy share of the wall time, and the device time of the
    kernels launched inside each ``record_function`` range named in
    ``ranges`` (prints, checks nothing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a record_function range also shows as a device row spanning its
    # kernels: it is read apart below, never summed with them
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and ev.key not in ranges]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"profile: {label}: wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall)")
    # first match wins: the fusion sites' kernels before cuBLAS and RMSNorm,
    # the stock RMSNorm's backward (rms_norm_bwd_*) before its forward
    groups = {"fusion sites": ("gemm_kernel<", "gemm_tc_kernel<", "prep_kernel<",
                               "row_rms_kernel", "add_rms_norm_", "dw_reduce_kernel"),
              "rms_norm_bwd": ("rms_norm_bwd_",),
              "flash": ("flash_",), "gemm (cuBLAS)": ("nvjet", "gemm", "cutlass"),
              "adamw": ("adamw_",), "rms_norm": ("rms_norm_",), "decode": ("decode_",),
              "ssd_scan": ("chunk_state_kernel<true>", "state_pass_kernel<false>",
                           "chunk_apply_kernel<false>"),
              "ssd_scan_bwd": ("chunk_state_kernel<false>", "state_pass_kernel<true>",
                               "chunk_apply_kernel<true>", "ssd_dcb_kernel")}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for ms, _, key in rows:
        name = next((g for g, marks in groups.items() if any(m in key for m in marks)), "other")
        by_group[name] += ms
    log(f"profile: {label}: device ms by group {json.dumps(by_group)}")
    if ranges:
        span = {ev.key: ev.self_device_time_total / 1e3
                for ev in prof.key_averages() if ev.key in ranges}
        log(f"profile: {label}: device span of each range (first kernel to last, gaps "
            f"included) ms {json.dumps(span)}")
    for ms, count, key in rows[:15]:
        log(f"profile:   {ms:10.3f} ms {count:7d}x  {key[:100]}")
    return wall_ms, rows


def _drive_path(model, drive):
    """Set every launch count to 0, run ``drive()``, and read the counts just
    after it.  Each forward of ``model.decoder`` is also tallied by its role:
    one token a row is a decode step, more is a prefill.  Returns
    ``(drive's result, record)``; the record holds the path's counts, its
    decode steps and prefill forwards, and the launches each of them made."""
    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    roles = {r: {"forwards": 0, "launches": dict.fromkeys(launch_counts(), 0)}
             for r in ("decode", "prefill")}
    fwd = model.decoder.forward

    def counted(input_ids, *a, **kw):
        before = launch_counts()
        out = fwd(input_ids, *a, **kw)
        role = roles["decode" if input_ids.shape[1] == 1 else "prefill"]
        role["forwards"] += 1
        for name, n in launch_counts().items():
            role["launches"][name] += n - before[name]
        return out

    model.decoder.forward = counted
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        result = drive()
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        del model.decoder.forward
    rec = {"launches": counts}
    for r, v in roles.items():
        rec[f"{r}_forwards"] = v["forwards"]
        rec[f"launches_per_{r}_forward"] = {
            name: n / v["forwards"] if v["forwards"] else None
            for name, n in v["launches"].items()}
    outside = {name: counts[name] - sum(v["launches"][name] for v in roles.values())
               for name in counts}
    check(not any(outside.values()), f"serve: launches outside the model: {outside}")
    return result, rec


def _check_path(name, rec, norms, decode_kernel=None, n_decode=0):
    """Every decode step of the path launches RMSNorm ``norms`` times and
    ``decode_kernel`` ``n_decode`` times, and no other kernel; every prefill
    forward launches RMSNorm alike and no other kernel."""
    from paddle_tpu_torch.kernels import launch_counts

    check(rec["decode_forwards"] > 0, f"serve: {name} ran no decode step")
    want = dict.fromkeys(launch_counts(), 0)
    want["rms_norm"] = norms
    if decode_kernel is not None:
        want[decode_kernel] = n_decode
    got = rec["launches_per_decode_forward"]
    check(got == want, f"serve: {name} launches a decode step {got}, expected {want}")
    if rec["prefill_forwards"]:
        if decode_kernel is not None:
            want[decode_kernel] = 0
        got = rec["launches_per_prefill_forward"]
        check(got == want, f"serve: {name} launches a prefill forward {got}, expected {want}")


def _serve_requests(vocab, seed):
    """`serve`'s requests: 14 with 128-512-token prompts and two that share
    a 256-token prefix, 32-128 new tokens each; and the chunked-prefill
    request."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=(256,)).astype(np.int32)
    lens = [int(x) for x in rng.integers(128, 513, size=14)] + [-100, -150]
    news = [int(x) for x in rng.integers(32, 129, size=16)]
    reqs = _requests(rng, vocab, lens, news, prefix)
    return reqs, _requests(rng, vocab, [400], [48])


def phase_serve(seed, layers):
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config

    cfg = llama3_8b_config(num_hidden_layers=layers)
    if layers != 32:
        log(f"serve: depth cut to {layers} of 32 layers (widths unchanged)")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"serve: random bf16 weights ({sum(p.numel() for p in model.parameters()) / 1e9:.2f} "
        f"B params) in {time.perf_counter() - t0:.1f} s")
    watch = _HeadWatch(model)
    reqs, chunk_req = _serve_requests(cfg.vocab_size, seed)
    gen_reqs = reqs[:2]
    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512))
    from paddle_tpu_torch.serving import Engine

    Engine(model, device="cuda", num_blocks=16, **kw).warmup()

    eng_first = {}
    paths = {}
    t0 = time.perf_counter()
    (eng, outs), paths["engine"] = _drive_path(model, lambda: _serve(
        model, reqs, "cuda", hook=_keep_first_logits(watch, gen_reqs, eng_first),
        num_blocks=512, **kw))
    wall = time.perf_counter() - t0
    (ceng, couts), paths["engine_chunked"] = _drive_path(model, lambda: _serve(
        model, chunk_req, "cuda", num_blocks=64, prefill_chunk=128, **kw))
    gens, paths["generate"] = _drive_path(model, lambda: [
        model.generate(r.prompt_ids[None], max_new_tokens=16) for r in gen_reqs])
    gen_tokens = sum(len(o.output_ids) for o in outs)
    log(f"serve: {len(outs)} requests, {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.1f} generated tok/s (prefill included)")
    log(f"serve: stats {json.dumps(eng.stats)}")
    log(f"serve: chunked-prefill engine stats {json.dumps(ceng.stats)}")
    for name, rec in paths.items():
        log(f"serve: path {name}: {json.dumps(rec)}")
    for r, o in zip(reqs + chunk_req, outs + couts):
        check(len(o.output_ids) == r.max_new_tokens,
              f"serve: {o.request_id} gave {len(o.output_ids)} of {r.max_new_tokens} tokens")
    check(eng.stats["prefix_hit_blocks"] > 0, "serve: the shared prefix never hit")
    check(ceng.stats["chunk_prefills"] > 1, "serve: chunked prefill did not chunk")
    check(paths["engine"]["decode_forwards"] == eng.stats["decode_steps"],
          "serve: Engine decode steps and decode forwards differ")
    for r, g in zip(gen_reqs, gens):
        check(tuple(g.shape) == (1, len(r.prompt_ids) + 16), "serve: generate shape")
    check(not bool(watch.nan), "serve: NaN logits")
    norms = 2 * layers + 1
    _check_path("engine", paths["engine"], norms, "decode_attention_paged", layers)
    _check_path("engine_chunked", paths["engine_chunked"], norms, "decode_attention_paged", layers)
    _check_path("generate", paths["generate"], norms, "decode_attention_dense", layers)
    _first_token_check("serve", model, watch.head, gen_reqs, gens, outs, eng_first)
    watch.restore()
    return paths, model


# ---------------------------------------------------------------------------
# router_serve: the serving front end and the measuring surface at 8B width
# ---------------------------------------------------------------------------

ROUTER_REQUESTS = 16         # requests of each loadgen trace
ROUTER_BLOCKS = 256          # pool blocks of each replica (4.3 GB of KV at 8B width)
# serve's buckets and the 1024 one: a 1024-token prompt plus its new tokens
# must fit a slot (twice the largest bucket)
ROUTER_BUCKETS = (128, 256, 512, 1024)
EXPORT_LAYERS = 4            # depth of leg 2's exported generate program (width unchanged)
EXPORT_BATCH, EXPORT_PROMPT, EXPORT_NEW = 2, 128, 32


class _Watch:
    """Wraps a router's ``step`` and ``_route``: a ``RecordEvent(
    "router.step")`` around each round and every output it returns kept in
    order (a request emitted twice would show); for each placement the
    replica chosen, the prefix blocks each replica held then, and the
    rounds run so far."""

    def __init__(self, router):
        from paddle_tpu_torch.profiler import RecordEvent

        self.emitted, self.placed = [], {}
        step, route = router.step, router._route

        def stepped():
            with RecordEvent("router.step"):
                outs = step()
            self.emitted += [o.request_id for o in outs]
            return outs

        def routed(t):
            hold = {i: router._affinity(e, t.prompt_ids) for i, e in router._replicas.items()}
            rid = route(t)
            self.placed.setdefault(t.rid, []).append((rid, hold, router.rounds))
            return rid

        router.step, router._route = stepped, routed


class _LogitsKeeper:
    """Stands in for ``model.head`` over a phase: while a router run
    replays, every vocab projection an Engine samples from is kept on the
    card (no sync), and each row is filed in ``rows`` under the request and
    output position whose token it chose.  A request rerouted or requeued
    files its positions again; the last filing is the one its output came
    from."""

    def __init__(self, model):
        self.model, self.head = model, model.head
        self.sink, self.rows = None, {}
        model.head = self

    def __call__(self, hidden):
        out = self.head(hidden)
        if self.sink is not None:
            self.sink.append(out)
        return out

    def restore(self):
        del self.model.head

    def _collect(self, fn, *a):
        self.sink = []
        try:
            return fn(*a), self.sink
        finally:
            self.sink = None

    def _file(self, req, pos, lg, row):
        self.rows[(req.request_id, len(req.prior_output) + pos)] = (lg, row)

    def watch(self, eng):
        """File the rows of ``eng``'s prefills (the first token) and decode
        sub-steps (slot row; position = tokens the slot had + sub-step)."""
        run_prefill, run_chunk, run_decode = (eng._run_prefill, eng._run_chunk_prefill,
                                              eng._run_decode)

        def prefill(group, Pb, fidx0):
            _, (lg,) = self._collect(run_prefill, group, Pb, fidx0)
            for j, e in enumerate(group):
                self._file(e[1], 0, lg, j)

        def chunk(sidx, ids_row, tbl_row, ctx, n_valid, req, fidx0):
            _, sink = self._collect(run_chunk, sidx, ids_row, tbl_row, ctx, n_valid, req, fidx0)
            if fidx0 is not None:
                self._file(req, 0, sink[0], 0)

        def decode(k, *a):
            live = [(s.idx, s.req, s.out_count) for s in eng._slots
                    if s.req is not None and s.prefill_left is None]
            lengths, sink = self._collect(run_decode, k, *a)
            for i, lg in enumerate(sink):
                for idx, req, n in live:
                    if n + i < req.max_new_tokens:
                        self._file(req, n + i, lg, idx)
            return lengths

        eng._run_prefill, eng._run_chunk_prefill, eng._run_decode = prefill, chunk, decode

    def take(self):
        """This run's filed rows (and their bytes held on the card); the
        keeper starts empty for the next run."""
        rows, self.rows = self.rows, {}
        held = {id(lg): lg.nbytes for lg, _ in rows.values()}
        return rows, sum(held.values())


def _router(model, replicas, engine_kw, keeper):
    """A Router over ``replicas`` fresh Engines, each warmed up and watched
    by ``keeper``; built outside any counted window."""
    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.serving.router import Router

    router = Router()
    for _ in range(replicas):
        eng = Engine(model, device="cuda", num_blocks=ROUTER_BLOCKS, max_batch=8,
                     block_size=128, prefill_buckets=ROUTER_BUCKETS, **engine_kw)
        eng.warmup()
        keeper.watch(eng)
        router.add_replica(eng)
    return router


def _replay(router, trace, around):
    """``run_trace`` of ``trace`` through ``router`` inside ``around()``:
    returns ``(metrics, wall ms of the replay)``."""
    import torch
    from paddle_tpu_torch.serving.loadgen import run_trace

    with around():
        t0 = time.perf_counter()
        m = run_trace(router, trace)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return m, wall_ms


def _check_replay(label, trace, m, watch):
    """Every request of ``trace`` completed and was emitted exactly once,
    each with its ``max_new_tokens``."""
    want = {f"rtr-{i + 1}": r.max_new_tokens for i, r in enumerate(
        sorted(trace, key=lambda r: r.arrival_s))}
    check(m["completed"] == m["submitted"] == len(trace),
          f"router_serve: {label}: {m['completed']} of {len(trace)} requests completed")
    check(sorted(watch.emitted) == sorted(want),
          f"router_serve: {label}: requests not emitted exactly once: {watch.emitted}")
    for rid, n in want.items():
        check(len(m["outputs"][rid]) == n,
              f"router_serve: {label}: {rid} gave {len(m['outputs'][rid])} of {n} tokens")


def _logits_at(model, ids, dtype):
    """Next-token logits after ``ids`` from one dense prefill (generate's),
    in ``dtype`` activations (the config's own mode: bf16 params)."""
    import torch

    cfg = model.config
    saved = cfg.param_dtype, cfg.dtype
    if dtype == "float32":
        cfg.param_dtype, cfg.dtype = cfg.pdtype, "float32"
    try:
        x = torch.from_numpy(ids[None]).to(model.device, torch.int32)
        cache = model.init_cache(1, len(ids) + 16, dtype=dtype)
        hidden, _ = model.decoder(x, cache=cache)
        return model.head(hidden[:, -1]).float()[0]
    finally:
        cfg.param_dtype, cfg.dtype = saved


def _same_tokens(label, model, trace, got, ref):
    """``got``'s greedy tokens against the one-replica run ``ref`` of the
    same trace, request by request; each is ``(outputs, rows filed by
    _LogitsKeeper)``.  Where a request differs, the logits each run's
    Engine computed at the first differing position are held as
    ``_first_token_check`` holds the Engine's first token: generate's dense
    prefill of the common context is rebuilt in bf16 and with fp32
    activations, and each Engine row must lie within LOGIT_TOL x that
    prefill's own bf16 error of both (and choose the token its run gave)."""
    import numpy as np
    import torch

    prompts = {f"rtr-{i + 1}": r.prompt_ids
               for i, r in enumerate(sorted(trace, key=lambda r: r.arrival_s))}
    (got_out, got_rows), (ref_out, ref_rows) = got, ref
    differ = sorted(rid for rid in ref_out if got_out[rid] != ref_out[rid])
    log(f"router_serve: {label}: {len(ref_out) - len(differ)} of {len(ref_out)} requests give "
        f"the one-replica run's tokens in full")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        for rid in differ:
            a, b = ref_out[rid], got_out[rid]
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            ctx = np.concatenate([prompts[rid], np.asarray(a[:j], np.int32)])
            dense = _logits_at(model, ctx, "bfloat16")
            exact = _logits_at(model, ctx, "float32")
            err = float((dense - exact).abs().max())
            for run, rows, tok in (("reference", ref_rows, a[j]), ("compared", got_rows, b[j])):
                check((rid, j) in rows, f"router_serve: {label}: {rid}'s logits at token {j} "
                                        f"in the {run} run were not kept")
                lg_rows, row = rows[(rid, j)]
                lg = lg_rows[row].float()
                diff = float((lg - dense).abs().max())
                err_eng = float((lg - exact).abs().max())
                log(f"router_serve: {label}: {rid} first differs at token {j} ({a[j]} against "
                    f"{b[j]}); the {run} run's Engine logits there: max |Engine - generate| "
                    f"{diff:.6g}, max |Engine - fp32| {err_eng:.6g}; generate's bf16 error "
                    f"{err:.6g} (limit {LOGIT_TOL} x it); the two tokens' logits "
                    f"{abs(float(dense[a[j]] - dense[b[j]])):.6g} apart in generate's")
                check(int(lg.argmax()) == tok,
                      f"router_serve: {label}: {rid}: the {run} run's kept logits at token {j} "
                      f"choose {int(lg.argmax())}, its output {tok}")
                check(diff <= LOGIT_TOL * err and err_eng <= LOGIT_TOL * err,
                      f"router_serve: {label}: {rid} at token {j}: the {run} run's Engine "
                      f"logits are {diff} from generate's and {err_eng} from fp32, past "
                      f"{LOGIT_TOL} x generate's own bf16 error {err}")
    return len(ref_out) - len(differ)


def _device_trace_counts(path):
    """Kernel events of a torch.profiler chrome trace: RMSNorm forwards,
    decode kernels (a decode launch is a partial and a combine kernel), and
    the kernels' summed device ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"rms_norm": sum(1 for e in kernels if "rms_norm" in e["name"]
                            and "bwd" not in e["name"]),
            "decode": sum(1 for e in kernels if "decode_partial_kernel" in e["name"]
                          or "decode_combine_kernel" in e["name"]),
            "kernels": len(kernels),
            "kernel_ms": sum(e.get("dur", 0.0) for e in kernels) / 1e3}


def phase_router_serve(seed, layers, model=None):
    """Two legs at `llama3_8b_config()` width; see the module docstring."""
    import os
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch import device as pdevice
    from paddle_tpu_torch import obs, profiler
    from paddle_tpu_torch.distributed.fault_tolerance.injection import (FaultInjector,
                                                                        set_injector)
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    from paddle_tpu_torch.serving.loadgen import make_trace

    if model is None:
        model = LlamaForCausalLM(llama3_8b_config(num_hidden_layers=layers), device="cuda",
                                 seed=seed)
    cfg = model.config
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    traces = {
        "shared_prefix": make_trace("shared_prefix", cfg.vocab_size, seed=0,
                                    n_requests=ROUTER_REQUESTS, rate_rps=50.0, shared_len=1024,
                                    tail_len=8, max_new_tokens=32),
        "long_prompt": make_trace("long_prompt", cfg.vocab_size, seed=0,
                                  n_requests=ROUTER_REQUESTS, rate_rps=50.0, long_len=1024,
                                  short_len=16, max_new_tokens=32)}
    work = Path(tempfile.mkdtemp(prefix="router_serve_"))
    paths, runs, out = {}, {}, {}
    # the first run of each trace: its outputs and kept Engine logits, which
    # the trace's later runs are held against
    refs = {}
    compare_s = 0.0
    keeper = _LogitsKeeper(model)

    def drive(name, trace, replicas, engine_kw, around=contextlib.nullcontext):
        """Build and warm the replicas, then count only the replay."""
        nonlocal compare_s
        t0 = time.perf_counter()
        router = _router(model, replicas, engine_kw, keeper)
        watch = _Watch(router)
        (m, wall_ms), rec = _drive_path(model, lambda: _replay(router, traces[trace], around))
        _check_replay(name, traces[trace], m, watch)
        _check_path(name, rec, 2 * L + 1, "decode_attention_paged", L)
        rows, held = keeper.take()
        runs[name] = (m, router, watch, wall_ms, rec)
        paths[f"router_{name}"] = rec
        out[name] = {k: m[k] for k in (
            "goodput_tps", "p50_ms", "p99_ms", "decode_gap_p50_ms", "decode_gap_p99_ms",
            "hit_rate", "prefill_tokens", "wall_s")}
        out[name].update(rounds=router.rounds, stats=dict(router.stats),
                         run_s=time.perf_counter() - t0, logits_kept_bytes=held)
        log(f"router_serve: {name}: {json.dumps(out[name])}")
        if trace not in refs:
            refs[trace] = name, (m["outputs"], rows)
        else:
            t1 = time.perf_counter()
            ref_name, ref = refs[trace]
            out[name]["same_tokens"] = _same_tokens(
                f"{name} against {ref_name}", model, traces[trace], (m["outputs"], rows), ref)
            compare_s += time.perf_counter() - t1
        return runs[name]

    try:
        # -- leg 1: the router under loadgen traces --------------------------
        start, end = pdevice.Event(), pdevice.Event()

        @contextlib.contextmanager
        def timed():
            start.record()
            yield
            end.record()
            end.synchronize()

        wall_ms = drive("shared_prefix_1_cache", "shared_prefix", 1, {}, timed)[3]
        out["event_ms"], out["event_wall_ms"] = start.elapsed_time(end), wall_ms
        log(f"router_serve: shared_prefix_1_cache's replay timed by device.Event: "
            f"{out['event_ms']:.3f} ms on the card's clock, {wall_ms:.3f} ms on the host's")
        drive("shared_prefix_1_nocache", "shared_prefix", 1, {"prefix_cache": False})

        os.environ["PADDLE_TPU_PROFILE_DIR"] = str(work / "device")
        prof = profiler.Profiler(on_trace_ready=profiler.export_chrome_tracing(
            str(work / "host"), "router"))
        try:
            m2, r2, watch2, prof_wall_ms, rec2 = drive(
                "shared_prefix_2_cache", "shared_prefix", 2, {}, lambda: prof)
        finally:
            del os.environ["PADDLE_TPU_PROFILE_DIR"]
        launches = rec2["launches"]
        (host_file,) = (work / "host").iterdir()
        with open(host_file) as f:
            spans = [e for e in json.load(f)["traceEvents"] if e["name"] == "router.step"]
        t0 = time.perf_counter()
        dev = _device_trace_counts(prof.device_trace_path)
        log(f"router_serve: profiled replay: {len(spans)} router.step host spans over "
            f"{r2.rounds} rounds; device trace {json.dumps(dev)} (read in "
            f"{time.perf_counter() - t0:.1f} s); the path's launch counters rms_norm "
            f"{launches['rms_norm']}, decode_attention_paged "
            f"{launches['decode_attention_paged']}")
        check(len(spans) == r2.rounds,
              f"router_serve: {len(spans)} router.step spans, {r2.rounds} rounds")
        check(dev["rms_norm"] == launches["rms_norm"],
              f"router_serve: the device trace holds {dev['rms_norm']} RMSNorm kernels, the "
              f"counters {launches['rms_norm']}")
        check(dev["decode"] == 2 * launches["decode_attention_paged"],
              f"router_serve: the device trace holds {dev['decode']} decode kernels, the "
              f"counters {launches['decode_attention_paged']} launches of two")
        out["profiled"] = dict(dev, host_spans=len(spans), wall_ms=prof_wall_ms,
                               busy_share=dev["kernel_ms"] / prof_wall_ms)
        log(f"router_serve: device busy share of the profiled replay "
            f"{out['profiled']['busy_share']:.4f} (kernels {dev['kernel_ms']:.3f} ms of "
            f"{prof_wall_ms:.3f} ms wall, the profiler's cost inside)")

        # affinity: a request placed before any replica held the prefix was
        # placed before round 1 (whose prefill registers it); every other
        # went to a replica holding the most of it
        cold = []
        for rid, placements in watch2.placed.items():
            for replica, hold, rounds_before in placements:
                if max(hold.values()) == 0:
                    cold.append(rid)
                    check(rounds_before == 0, f"router_serve: {rid} placed cold after round "
                                              f"{rounds_before}")
                else:
                    check(hold[replica] == max(hold.values()),
                          f"router_serve: {rid} went to replica {replica} holding "
                          f"{hold[replica]} prefix blocks while another held "
                          f"{max(hold.values())}")
        log(f"router_serve: shared_prefix_2_cache: {len(cold)} request(s) placed before any "
            f"replica held the prefix ({cold}), the other {len(watch2.placed) - len(cold)} "
            f"to a replica holding it; hit blocks by replica "
            f"{json.dumps({i: e.stats['prefix_hit_blocks'] for i, e in r2._replicas.items()})}")
        check(m2["hit_rate"] > 0, "router_serve: the shared prefix never hit")
        check(m2["prefill_tokens"] < runs["shared_prefix_1_nocache"][0]["prefill_tokens"],
              "router_serve: the prefix cache saved no prefill tokens")
        del refs["shared_prefix"]

        drive("long_prompt_1_chunk", "long_prompt", 1, {"prefill_chunk": 128})
        drive("long_prompt_1_mono", "long_prompt", 1, {})
        # two replicas take about half the rounds of one: a third of one's
        # is mid-drain
        kill_round = max(2, runs["long_prompt_1_chunk"][1].rounds // 3)
        os.environ["PADDLE_FLIGHT_DIR"] = str(work / "flight")
        saved = flags.get_flags(["ft_inject_serve_kill_round", "ft_inject_serve_kill_replica"])
        flags.set_flags({"ft_inject_serve_kill_round": kill_round,
                         "ft_inject_serve_kill_replica": 0})
        obs.flight().clear()
        try:
            set_injector(FaultInjector.from_flags())
            _, rk, *_ = drive("long_prompt_2_kill", "long_prompt", 2, {"prefill_chunk": 128})
        finally:
            flags.set_flags(saved)
            set_injector(None)
            del os.environ["PADDLE_FLIGHT_DIR"]
        dump = obs.last_flight_dump()
        check(dump is not None and dump.startswith(str(work)),
              f"router_serve: the kill left no flight dump ({dump})")
        with open(dump) as f:
            doc = json.load(f)
        log(f"router_serve: kill at round {kill_round}: stats {json.dumps(rk.stats)}; flight "
            f"dump {doc['reason']!r} victim {doc['victim']!r} rerouted {doc['rerouted']}")
        check(rk.stats["kills"] == 1 and rk.stats["rerouted"] >= 1,
              f"router_serve: the kill run's stats {rk.stats}")
        check(doc["victim"] == "replica 0" and doc["rerouted"]
              and len(doc["rerouted"]) == rk.stats["rerouted"],
              f"router_serve: the flight dump names {doc['victim']!r}, rerouted "
              f"{doc['rerouted']}")
        check(rk.replica_ids == [1], f"router_serve: replicas left {rk.replica_ids}")

        refs.clear()
        log(f"router_serve: token comparisons in {compare_s:.1f} s")
        ratios = {
            "goodput_ratio_cache_on_off": out["shared_prefix_1_cache"]["goodput_tps"]
            / out["shared_prefix_1_nocache"]["goodput_tps"],
            "decode_gap_p99_ratio_chunk_on_off": out["long_prompt_1_chunk"]["decode_gap_p99_ms"]
            / out["long_prompt_1_mono"]["decode_gap_p99_ms"]}
        out.update(ratios)
        log(f"router_serve: {json.dumps(ratios)}")
        peak = pdevice.cuda.max_memory_allocated()
        check(peak == torch.cuda.max_memory_allocated(),
              "router_serve: device.cuda.max_memory_allocated is not torch.cuda's")
        out["peak_gib"] = peak / 2 ** 30
        log(f"router_serve: peak device memory {peak} B ({peak / 2 ** 30:.3f} GiB; "
            f"device.cuda.max_memory_allocated, torch.cuda's the same; the Engine logits "
            f"kept for the token checks inside, at most "
            f"{max(out[n]['logits_kept_bytes'] for n in runs)} B a run)")
        runs.clear()
        del r2, rk, watch2, prof
        torch.cuda.empty_cache()

        # -- leg 2: the exported greedy-generate program ----------------------
        paths.update(_export_leg(seed, work, out))
    finally:
        keeper.restore()
        shutil.rmtree(work, ignore_errors=True)
    log(f"router_serve: {json.dumps(out)}")
    return paths


def _export_leg(seed, work, out):
    """``llama3_8b_config()`` at EXPORT_LAYERS layers: ``export_generate``,
    a Predictor from the artifact alone, its ids against ``generate``'s and
    its launches counted."""
    import gc

    import numpy as np
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config

    L = EXPORT_LAYERS
    log(f"router_serve: leg 2: llama3_8b_config() width, depth cut to {L} of 32 layers")
    m4 = LlamaForCausalLM(llama3_8b_config(num_hidden_layers=L), device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(1, m4.config.vocab_size,
                       size=(EXPORT_BATCH, EXPORT_PROMPT)).astype(np.int32)

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return res, {k: n for k, n in launch_counts().items() if n}, ms

    m4.generate(ids, max_new_tokens=EXPORT_NEW)      # first calls out of the timed run
    want, gen_n, gen_ms = counted(lambda: m4.generate(ids, max_new_tokens=EXPORT_NEW))
    prefix = str(work / "generate")
    t0 = time.perf_counter()
    nbytes = m4.export_generate(prefix, EXPORT_BATCH, EXPORT_PROMPT, EXPORT_NEW)
    export_s = time.perf_counter() - t0
    del m4
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(prefix))
    load_s = time.perf_counter() - t0
    pred.get_input_handle("input_0").copy_from_cpu(ids)
    pred.run()                                       # first calls out of the timed run
    _, got_n, run_ms = counted(pred.run)
    got = pred.get_output_handle("output_0").copy_to_cpu()
    expect = {"rms_norm": (2 * L + 1) * EXPORT_NEW, "decode_attention_dense": L * (EXPORT_NEW - 1)}
    rec = dict(export_s=export_s, artifact_bytes=nbytes, load_s=load_s, run_ms=run_ms,
               generate_ms=gen_ms, launches=got_n, generate_launches=gen_n)
    log(f"router_serve: export_generate {json.dumps(rec)}")
    check(tuple(got.shape) == (EXPORT_BATCH, EXPORT_PROMPT + EXPORT_NEW) and got.dtype == np.int32,
          f"router_serve: the Predictor gave {got.shape} {got.dtype}")
    check(np.array_equal(got, want.cpu().numpy()),
          "router_serve: the exported program's ids are not generate's")
    check(gen_n == expect and got_n == expect,
          f"router_serve: launches: exported {got_n}, generate {gen_n}, expected {expect}")
    out["export"] = rec
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    counts = dict.fromkeys(launch_counts(), 0)
    counts.update(got_n)
    return {"export_generate": {"launches": counts}}


def phase_moe_serve(seed):
    """The `moe` preset's model, random bf16 weights from ``seed``: 16 greedy
    requests through an Engine of 8 slots, then generate on two prompts,
    counters per path; then one profiled Engine drain for the device's busy
    share.  See the module docstring."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.presets import moe_config
    from paddle_tpu_torch.serving import Engine

    cfg = moe_config(True)
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    log(f"moe_serve: {L} layers, {cfg.moe_num_experts} experts, top-{cfg.moe_top_k} "
        f"{cfg.moe_gate}, {sum(p.numel() for p in model.parameters())} params, bf16")
    watch = _HeadWatch(model)
    reqs, _ = _serve_requests(cfg.vocab_size, seed)
    gen_reqs = reqs[:2]
    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512))
    Engine(model, device="cuda", num_blocks=16, **kw).warmup()
    paths = {}
    t0 = time.perf_counter()
    (eng, outs), paths["moe_engine"] = _drive_path(model, lambda: _serve(
        model, reqs, "cuda", num_blocks=512, **kw))
    wall = time.perf_counter() - t0
    gens, paths["moe_generate"] = _drive_path(model, lambda: [
        model.generate(r.prompt_ids[None], max_new_tokens=16) for r in gen_reqs])
    gen_tokens = sum(len(o.output_ids) for o in outs)
    log(f"moe_serve: {len(outs)} requests, {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.1f} generated tok/s (prefill included)")
    log(f"moe_serve: stats {json.dumps(eng.stats)}")
    for name, rec in paths.items():
        log(f"moe_serve: path {name}: {json.dumps(rec)}")
    for r, o in zip(reqs, outs):
        check(len(o.output_ids) == r.max_new_tokens,
              f"moe_serve: {o.request_id} gave {len(o.output_ids)} of {r.max_new_tokens} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o.output_ids), "moe_serve: token out of range")
    for r, g in zip(gen_reqs, gens):
        check(tuple(g.shape) == (1, len(r.prompt_ids) + 16), "moe_serve: generate shape")
    check(not bool(watch.nan), "moe_serve: NaN logits")
    check(paths["moe_engine"]["decode_forwards"] == eng.stats["decode_steps"],
          "moe_serve: Engine decode steps and decode forwards differ")
    _check_path("moe_engine", paths["moe_engine"], 2 * L + 1, "decode_attention_paged", L)
    _check_path("moe_generate", paths["moe_generate"], 2 * L + 1, "decode_attention_dense", L)
    watch.restore()
    rng = np.random.default_rng(seed + 2)
    drain = _requests(rng, cfg.vocab_size, [128] * 8, [32] * 8)
    wall_ms, rows = _profile(lambda: _serve(model, drain, "cuda", num_blocks=64, **kw),
                             "moe_serve: one Engine drain (8 requests, 32 new tokens each)")
    busy = sum(r[0] for r in rows) / wall_ms
    paths["moe_engine"].update(tokens_per_s=gen_tokens / wall, busy_share=busy)
    log(f"moe_serve: device busy share {busy:.4f} of the profiled drain's wall time")
    del model
    torch.cuda.empty_cache()
    return paths


class _HeadWatch:
    """Stands in for ``model.head``: a device-side NaN flag over every vocab
    projection (no sync) and, while ``sink`` is a list, each projection kept
    there."""

    def __init__(self, model):
        import torch

        self.model, self.head = model, model.head
        self.nan = torch.zeros((), dtype=torch.bool, device="cuda")
        self.sink = None
        model.head = self

    def __call__(self, hidden):
        import torch

        out = self.head(hidden)
        self.nan.logical_or_(torch.isnan(out).any())
        if self.sink is not None:
            self.sink.append(out)
        return out

    def restore(self):
        del self.model.head


def _keep_first_logits(watch, gen_reqs, eng_first):
    """An Engine hook that keeps the first-token logits of ``gen_reqs`` from
    the Engine's prefill (one projected row per request of the group, in
    group order) in ``eng_first``."""
    def hook(eng):
        name = "_run_ssd_prefill" if eng._recurrent else "_run_prefill"
        run = getattr(eng, name)

        def run_prefill(group, Pb, fidx0):
            watch.sink = []
            run(group, Pb, fidx0)
            (lg,), watch.sink = watch.sink, None
            for j, e in enumerate(group):
                for i, r in enumerate(gen_reqs):
                    if e[1] is r:
                        eng_first[i] = lg[j].float()

        setattr(eng, name, run_prefill)

    return hook


def _first_token_check(label, model, head, gen_reqs, gens, outs, eng_first):
    """generate against the Engine on the first token: generate's prefill
    (B=1, exact length) rebuilt as it runs, in bf16 and with fp32
    activations (the config's own mixed-precision mode: bf16 params, fp32
    compute), against the Engine's captured row (bucket-padded prefill).
    Both must lie within ``LOGIT_TOL`` x generate's own bf16 error."""
    import torch

    cfg = model.config
    check(sorted(eng_first) == list(range(len(gen_reqs))),
          f"{label}: Engine first-token logits not captured")
    torch.backends.cuda.matmul.allow_tf32 = False

    def first_logits(prompt, dtype):
        ids = torch.from_numpy(prompt[None]).to("cuda", torch.int32)
        cache = model.init_cache(1, len(prompt) + 16, dtype=dtype)
        hidden, _ = model.decoder(ids, cache=cache)
        return head(hidden[:, -1]).float()[0]

    diverge = []
    with torch.no_grad():
        for i, (r, g, o) in enumerate(zip(gen_reqs, gens, outs)):
            P = len(r.prompt_ids)
            ref = first_logits(r.prompt_ids, "bfloat16")
            saved = cfg.param_dtype, cfg.dtype
            cfg.param_dtype, cfg.dtype = cfg.pdtype, "float32"
            try:
                exact = first_logits(r.prompt_ids, "float32")
            finally:
                cfg.param_dtype, cfg.dtype = saved
            lg = eng_first[i]
            diff = float((lg - ref).abs().max())
            err_gen = float((ref - exact).abs().max())
            err_eng = float((lg - exact).abs().max())
            gap = ref.topk(2).values
            log(f"{label}: prompt {i} (P={P}) first-token logits: max |generate - Engine| "
                f"{diff:.6g}; max |bf16 - fp32 activations| generate {err_gen:.6g}, "
                f"Engine {err_eng:.6g} (limit {LOGIT_TOL} x generate's); max |logit| "
                f"{float(ref.abs().max()):.6g}; generate's top-1 - top-2 gap "
                f"{float(gap[0] - gap[1]):.6g}; first token generate {int(ref.argmax())} "
                f"Engine {int(lg.argmax())} fp32 {int(exact.argmax())}")
            check(int(ref.argmax()) == int(g[0, P]), f"{label}: prompt {i}: rebuilt "
                  "prefill disagrees with generate's first token")
            check(int(lg.argmax()) == o.output_ids[0], f"{label}: prompt {i}: captured "
                  "logits disagree with the Engine's first token")
            check(diff <= LOGIT_TOL * err_gen and err_eng <= LOGIT_TOL * err_gen,
                  f"{label}: prompt {i}: the Engine's first-token logits are {diff} from "
                  f"generate's and {err_eng} from fp32, past {LOGIT_TOL} x generate's "
                  f"own bf16 error {err_gen}")
            toks = g[0, P:].tolist()
            diverge.append(next((j for j, (a, b) in enumerate(zip(toks, o.output_ids))
                                 if a != b), None))
    log(f"{label}: first position where generate's and the Engine's 16 tokens differ, "
        f"per prompt: {diverge} (None = all equal)")


def _ssd_serve_requests(vocab, seed):
    """`ssd_serve`'s 16 requests (128-512-token prompts, 32-128 new tokens)
    and the generator that drew them, for the profile's requests after."""
    import numpy as np

    rng = np.random.default_rng(seed + 5)
    lens = [int(x) for x in rng.integers(128, 513, size=16)]
    news = [int(x) for x in rng.integers(32, 129, size=16)]
    return _requests(rng, vocab, lens, news), rng


def phase_ssd_serve(seed, profile):
    """ssd_8b_config at full depth through the Engine's recurrent path and
    generate; see the module docstring."""
    import torch
    from paddle_tpu_torch.models import SSDForCausalLM, ssd_8b_config
    from paddle_tpu_torch.serving import Engine, RecurrentState

    cfg = ssd_8b_config()
    t0 = time.perf_counter()
    model = SSDForCausalLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"ssd_serve: {cfg.num_hidden_layers} layers, random bf16 weights "
        f"({sum(p.numel() for p in model.parameters())} params) in "
        f"{time.perf_counter() - t0:.1f} s")
    watch = _HeadWatch(model)
    reqs, rng = _ssd_serve_requests(cfg.vocab_size, seed)
    gen_reqs = reqs[:2]
    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512))
    Engine(model, device="cuda", num_blocks=16, **kw).warmup()
    eng_first = {}
    paths = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (eng, outs), paths["ssd_engine"] = _drive_path(model, lambda: _serve(
        model, reqs, "cuda", hook=_keep_first_logits(watch, gen_reqs, eng_first),
        num_blocks=16, **kw))
    wall = time.perf_counter() - t0
    gens, paths["ssd_generate"] = _drive_path(model, lambda: [
        model.generate(r.prompt_ids[None], max_new_tokens=16) for r in gen_reqs])
    gen_tokens = sum(len(o.output_ids) for o in outs)
    plan = eng.memory_plan()
    log(f"ssd_serve: {len(outs)} requests, {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.1f} generated tok/s (prefill included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; slot state "
        f"{plan['state_bytes'] / 1e9:.3f} GB for {eng.max_batch} slots")
    log(f"ssd_serve: stats {json.dumps(eng.stats)}")
    for name, rec in paths.items():
        log(f"ssd_serve: path {name}: {json.dumps(rec)}")
    check(isinstance(eng.backend, RecurrentState) and not eng.prefix_cache,
          f"ssd_serve: backend {eng.backend.kind}, prefix cache {eng.prefix_cache}")
    check(eng._rstate._live == {} and eng._pages._ref == {}, "ssd_serve: ledgers not clean")
    for r, o in zip(reqs, outs):
        check(len(o.output_ids) == r.max_new_tokens,
              f"ssd_serve: {o.request_id} gave {len(o.output_ids)} of {r.max_new_tokens} tokens")
    check(paths["ssd_engine"]["decode_forwards"] == eng.stats["decode_steps"],
          "ssd_serve: Engine decode steps and decode forwards differ")
    for r, g in zip(gen_reqs, gens):
        check(tuple(g.shape) == (1, len(r.prompt_ids) + 16), "ssd_serve: generate shape")
    check(not bool(watch.nan), "ssd_serve: NaN logits")
    norms = cfg.num_hidden_layers + 1
    _check_path("ssd_engine", paths["ssd_engine"], norms)
    _check_path("ssd_generate", paths["ssd_generate"], norms)
    _first_token_check("ssd_serve", model, watch.head, gen_reqs, gens, outs, eng_first)
    watch.restore()
    if profile:
        small = _requests(rng, cfg.vocab_size, [128] * 8, [16] * 8)
        engines = []
        wall_ms, _ = _profile(lambda: engines.append(_serve(model, small, "cuda",
                                                            num_blocks=16, **kw)[0]),
                              "ssd_serve: one Engine drain")
        log(f"profile: ssd_serve: {engines[0].stats['decode_steps']} decode steps, "
            f"{wall_ms / engines[0].stats['decode_steps']:.3f} ms wall a step incl. prefill")
    del model, eng
    torch.cuda.empty_cache()
    return paths


def ssd_flops_per_token(cfg, seq_len):
    """Training FLOPs a token of an SSD stack: 6 x matmul params (in_proj,
    out_proj, lm_head) plus the chunked scan, 3 x its forward (a chunk of L
    tokens costs 2 L^2 N + 2 L^2 P + 4 L N P a head)."""
    nh, P, N, L = cfg.num_heads, cfg.head_dim, cfg.state_size, cfg.chunk_size
    H, V, n = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers
    per_layer = H * (2 * nh * P + 2 * nh * N + nh) + nh * P * H
    scan = nh * (2 * L * N + 2 * L * P + 4 * N * P)
    return 6.0 * (n * per_layer + H * V) + 3.0 * n * scan


def phase_ssd_train(profile):
    """ssd_8b widths at SSD_TRAIN_LAYERS layers through the port's
    TrainStep, ``TRAIN_STEPS`` steps; see the module docstring."""
    import math

    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import SSDForCausalLM, ssd_8b_config
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    cfg = ssd_8b_config(num_hidden_layers=SSD_TRAIN_LAYERS, param_dtype="float32")
    B, S = SSD_TRAIN_BATCH, SSD_TRAIN_SEQ
    model = SSDForCausalLM(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=3e-4, weight_decay=0.1, parameters=model.parameters())
    step_fn = TrainStep(model, lambda m, ids: m.compute_loss(m(ids), ids), opt)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"ssd_train: ssd_8b widths, {cfg.num_hidden_layers} of 32 layers, {n_params} params "
        f"(dtype {cfg.dtype}, params {cfg.pdtype}), batch {B} x seq {S}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        cfg.dtype = "float32"
        try:
            loss32 = float(model.compute_loss(model(ids), ids))
        finally:
            cfg.dtype = "bfloat16"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, rec = _drive_train(step_fn, (ids,), TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    want = dict.fromkeys(launch_counts(), 0)
    want.update(rms_norm=L + 1, rms_norm_bwd=L + 1, ssd_scan=L, ssd_scan_bwd=L,
                adamw=1)
    want_update = dict.fromkeys(launch_counts(), 0)
    want_update["adamw"] = TRAIN_STEPS     # one launch over every leaf a step
    step_ms = [w * 1e3 for w in walls]
    steady = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    flops = ssd_flops_per_token(cfg, S) * B * S
    log(f"ssd_train: losses {losses}; fp32-activation loss at step 1's weights {loss32} "
        f"(|bf16 - fp32| {abs(losses[0] - loss32):.6g}, limit {TRAIN_LOSS_TOL})")
    log(f"ssd_train: step ms {step_ms}; steady {steady:.3f} ms = {B * S / steady * 1e3:.1f} "
        f"tokens/s, MFU {flops / (steady / 1e3) / BF16_FLOPS_PER_S:.4f} "
        f"({flops / 1e12:.2f} TFLOP a step at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s); "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"ssd_train: launches {json.dumps(rec)}")
    check(all(math.isfinite(x) for x in losses), f"ssd_train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"ssd_train: loss did not fall: {losses}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"ssd_train: step {i + 1} launched {got}, expected {want}")
    check(rec["launches_in_update"] == want_update,
          f"ssd_train: launches inside the optimizer update {rec['launches_in_update']}, "
          f"expected {want_update}")
    check(abs(losses[0] - loss32) <= TRAIN_LOSS_TOL,
          f"ssd_train: step 1's bf16 loss {losses[0]} is {abs(losses[0] - loss32)} from the "
          f"fp32-activation loss {loss32}, past {TRAIN_LOSS_TOL}")
    rec.update(losses=losses, step_ms=step_ms, steady_step_ms=steady, loss_fp32=loss32,
               peak_bytes=peak)
    if profile:
        _profile_ssd_step(model, lambda: step_fn(ids))
    del step_fn, model, opt
    torch.cuda.empty_cache()
    return rec


# the depth of `base` in the two checkpoint phases, `resume_train` and
# `launch_train` (of its 12 layers; widths unchanged), which save and load
# its whole training state
CHECKPOINT_LAYERS = 2


def phase_resume_train():
    """`base` cut to CHECKPOINT_LAYERS layers through a checkpoint: 5 steps
    uninterrupted (run A); a fresh
    build (the same seed), 3 steps and ``CheckpointManager.save(3)`` (run
    B); a build from another seed, ``resume`` and steps 4-5 (run C).  C's
    losses and its every param and slot after step 5 must be A's bits.  A's
    steps 1-3 against B's show whether two runs of the same steps are
    bit-equal at all; if they are not, C is held to the spread they show
    (a finding).  A's end state is kept as host copies, and each model is
    freed before the next is built."""
    import gc
    import os
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.distributed.fleet import CheckpointManager
    from paddle_tpu_torch.models.presets import build_pretrain_step

    def leg(seed, steps, save=None, resume=None):
        """A fresh `base` build from ``seed``: resumed from ``resume`` (a
        manager) first, ``steps`` steps, saved into ``save`` (a manager)
        after; returns the losses, the end state as host tensors and the
        timings.  Nothing of the build outlives the call."""
        step_fn, ids = build_pretrain_step("base", "cuda", seed=seed,
                                           layers=CHECKPOINT_LAYERS)[:2]
        info = {}
        if resume is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info["resumed_at"] = resume.resume(step_fn)
            torch.cuda.synchronize()
            info["load_ms"] = (time.perf_counter() - t0) * 1e3
            info["step_counter"] = step_fn._step
        losses = [float(step_fn(ids)) for _ in range(steps)]
        if save is not None:
            t0 = time.perf_counter()
            save.save(step_fn._step, step_fn)
            info["save_ms"] = (time.perf_counter() - t0) * 1e3
        end = {k: t.detach().cpu() for k, t in step_fn.state_dict().items()}
        return losses, end, info

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    log(f"resume_train: `base` depth cut to {CHECKPOINT_LAYERS} of 12 layers (widths unchanged)")
    losses_a, end_a, _ = leg(0, 5)
    free()
    root = tempfile.mkdtemp(prefix="resume_train_")
    try:
        mgr = CheckpointManager(root, keep=1)
        losses_b, _, saved = leg(0, 3, save=mgr)
        free()
        ckpt = os.path.join(root, "step_00000003")
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        losses_c, end_c, loaded = leg(1, 2, resume=mgr)
        free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    save_ms, load_ms = saved["save_ms"], loaded["load_ms"]
    check(loaded["resumed_at"] == 3 and loaded["step_counter"] == 3,
          f"resume_train: resumed at {loaded}, not at step 3")
    check(sorted(end_c) == sorted(end_a), "resume_train: the state's keys differ")
    differ = sorted(k for k in end_a if not torch.equal(end_a[k], end_c[k]))
    repeatable = losses_b == losses_a[:3]
    spread = max(abs(a - b) for a, b in zip(losses_a, losses_b))
    rec = {"losses_uninterrupted": losses_a, "losses_first_three_again": losses_b,
           "losses_resumed_4_5": losses_c, "save_ms": save_ms, "load_ms": load_ms,
           "checkpoint_bytes": nbytes, "tensors": len(end_a), "tensors_differing": differ[:8],
           "two_runs_bit_equal": repeatable}
    log(f"resume_train: {json.dumps(rec)}")
    if repeatable:
        check(losses_c == losses_a[3:], f"resume_train: resumed losses {losses_c} are not the "
                                        f"uninterrupted run's {losses_a[3:]}")
        check(not differ, f"resume_train: {len(differ)} tensors differ after step 5 from the "
                          f"uninterrupted run's, e.g. {differ[:4]}")
    else:
        log(f"resume_train: FINDING: two runs of the same steps are not bit-equal (steps 1-3 "
            f"{losses_a[:3]} against {losses_b}); the resumed losses are held to that spread, "
            f"{spread:.3g}")
        check(all(abs(a - c) <= spread for a, c in zip(losses_a[3:], losses_c)),
              f"resume_train: resumed losses {losses_c} outside the spread {spread} of the "
              f"uninterrupted run's {losses_a[3:]}")
    return rec


# ---------------------------------------------------------------------------
# launch_train: the host runtime (DataLoader workers, TCPStore, launcher)
# ---------------------------------------------------------------------------

LAUNCH_STEPS = 5             # steps of each `launch_train` leg, a new batch each
LAUNCH_SAVE_STEP = 3         # the launched child saves its checkpoint after this step
LAUNCH_CRASH_STEP = 4        # FLAGS_ft_inject_crash_step: the child is SIGKILLed before it
LAUNCH_TIMEOUT = 900         # seconds the launcher may take for both incarnations
LAUNCH_HEARTBEAT = 0.5       # the child's ElasticManager interval (s)

# Written into the phase's directory as `launch_probe.py`: spawned workers
# import it, and so never this script's `__main__`, whose objects the
# DataLoader keeps on its thread.
_PROBE_SOURCE = '''"""DataLoader probes of chip_smoke.py's launch_train phase: what a
spawned worker sees, one JSON file a worker process in OUT."""
import json
import os
import time

OUT = {out!r}


def exec_time():
    """When this process started (epoch seconds, from /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")


class Probed:
    """``ds`` as it is, recording its reader's worker info after each read."""

    def __init__(self, ds, tag):
        self.ds, self.tag = ds, tag

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        out = self.ds[i]
        record(self.tag, read=True)
        return out


def init(worker_id):
    """The DataLoader's worker_init_fn."""
    record(None, init=worker_id)


def record(tag, read=False, init=None):
    import torch
    from paddle_tpu_torch.io import get_worker_info

    info = get_worker_info()
    if info is None:
        return                                  # the trainer's own reads
    path = os.path.join(OUT, f"worker_{{os.getpid()}}.json")
    rec = {{}}
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
    rec.update(pid=os.getpid(), ppid=os.getppid(), id=info.id,
               num_workers=info.num_workers, seed=info.seed,
               reads=rec.get("reads", 0) + int(read),
               cuda_initialized=bool(torch.cuda.is_initialized()))
    if tag is not None:
        rec["tag"] = tag
    if init is not None:
        rec.update(init_worker_id=init, t_init=time.time(), t_exec=exec_time())
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)
'''


def _launch_probe(workdir):
    """Write the probe module into ``workdir``, put ``workdir`` on the path
    (spawned workers inherit it) and import it."""
    import importlib

    Path(workdir, "launch_probe.py").write_text(_PROBE_SOURCE.format(out=str(workdir)))
    if str(workdir) not in sys.path:
        sys.path.insert(0, str(workdir))
    importlib.invalidate_caches()
    return importlib.import_module("launch_probe")


def _launch_tokens(seed, vocab, batch, seq):
    """``LAUNCH_STEPS`` batches of token rows from ``seed``, as an
    io.TensorDataset over CPU Tensors (rows of int32)."""
    import numpy as np
    from paddle_tpu_torch import io
    from paddle_tpu_torch.framework.tensor import Tensor

    rows = np.random.default_rng(seed).integers(
        0, vocab, size=(LAUNCH_STEPS * batch, seq)).astype(np.int32)
    return io.TensorDataset([Tensor(rows, place="cpu")])


def _stock_launches(cfg):
    """A stock `base`-family TrainStep's launches a step (a recomputed layer
    runs its forward's kernels twice, its norms forward twice and backward
    once)."""
    from paddle_tpu_torch.kernels import launch_counts

    L = cfg.num_hidden_layers
    passes = 2 if cfg.recompute else 1
    want = dict.fromkeys(launch_counts(), 0)
    want.update(flash_attention_fwd=passes * L, flash_attention_bwd=L, adamw=1,
                rms_norm=2 * passes * L + 1, rms_norm_bwd=2 * L + 1)
    return want


def _launch_steps(step_fn, loader, start=0, before_step=None, after_step=None):
    """Steps ``start + 1 ..`` over ``loader``'s batches (the first ``start``
    skipped): each step's loss, its batch's sha256 prefix, the wait for the
    batch and the step's own time (ms, host clock, ending in the loss's
    read) and its launches.  ``before_step(step)`` runs before a step,
    ``after_step(record)`` after, with the step's record."""
    import hashlib

    import torch
    from paddle_tpu_torch.kernels import launch_counts

    out = []
    mark = time.perf_counter()
    for step, batch in enumerate(loader, 1):
        got = time.perf_counter()
        if step <= start:
            mark = got
            continue
        ids = batch[0]._data
        sha = hashlib.sha256(ids.cpu().numpy().tobytes()).hexdigest()[:16]
        if before_step is not None:
            before_step(step)
        before = launch_counts()
        t0 = time.perf_counter()
        loss = float(step_fn(ids.to("cuda")))
        torch.cuda.synchronize()
        done = time.perf_counter()
        out.append({"step": step, "loss": loss, "sha": sha, "dtype": str(ids.dtype),
                    "device": ids.device.type, "wait_ms": (got - mark) * 1e3,
                    "step_ms": (done - t0) * 1e3, "t_end": time.time(),
                    "t_wait": time.time() - (time.perf_counter() - mark),
                    "launches": {n: c - before[n] for n, c in launch_counts().items()}})
        if after_step is not None:
            after_step(out[-1])
        mark = time.perf_counter()
    return out


def _launch_leg(label, seed, workdir, workers):
    """One fresh `base` build from ``seed``, ``LAUNCH_STEPS`` steps fed by a
    DataLoader over the phase's token rows: on this thread (``workers``
    False) or from 2 persistent worker processes with the probe's
    ``worker_init_fn``.  Returns the steps' records and the launches a step
    must make.  Nothing of the build outlives the call."""
    import gc

    import torch
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models.presets import build_pretrain_step

    probe = _launch_probe(workdir)
    step_fn, _, model, cfg, (B, S, _) = build_pretrain_step("base", "cuda", seed=seed,
                                                            layers=CHECKPOINT_LAYERS)
    ds = probe.Probed(_launch_tokens(seed, cfg.vocab_size, B, S), label)
    kw = dict(num_workers=2, persistent_workers=True, worker_init_fn=probe.init) \
        if workers else dict(num_workers=0)
    loader = io.DataLoader(ds, batch_size=B, **kw)
    try:
        steps = _launch_steps(step_fn, loader)
    finally:
        if loader._shm_pool is not None:
            loader._shm_pool.shutdown()
    want = _stock_launches(cfg)
    for s in steps:
        check(s["launches"] == want,
              f"launch_train {label}: step {s['step']} launched {s['launches']}, expected {want}")
    log(f"launch_train {label}: losses {[s['loss'] for s in steps]}; batches "
        f"{[s['sha'] for s in steps]} ({steps[0]['dtype']} on {steps[0]['device']}); wait ms "
        f"{[round(s['wait_ms'], 3) for s in steps]}; step ms "
        f"{[round(s['step_ms'], 3) for s in steps]}")
    del step_fn, model
    gc.collect()
    torch.cuda.empty_cache()
    return steps, want


def _worker_records(workdir, tag):
    out = []
    for p in sorted(Path(workdir).glob("worker_*.json")):
        rec = json.loads(p.read_text())
        if rec.get("tag") == tag:
            out.append(rec)
    return out


def _spawn_split(recs, first):
    """Each worker's start, from the trainer's first wait (``first``, a step
    record) to its batch: until its process exists, its interpreter,
    imports and unpickled dataset (to ``worker_init_fn``), then making and
    shipping the first batches (ms)."""
    got = first["t_wait"] + first["wait_ms"] / 1e3
    out = {}
    for r in recs:
        if r.get("t_exec") is None:
            continue
        out[r["id"]] = {"process": round((r["t_exec"] - first["t_wait"]) * 1e3, 1),
                        "imports_and_spec": round((r["t_init"] - r["t_exec"]) * 1e3, 1),
                        "to_the_first_batch": round((got - r["t_init"]) * 1e3, 1)}
    return out


def _check_workers(label, recs, trainer_pid):
    """Two workers, each with its id, one seed less its id (the loader's),
    its init hook run, reads done, a pid not the trainer's and CUDA never
    initialised."""
    ids = sorted(r["id"] for r in recs)
    check(ids == [0, 1], f"{label}: worker records {recs}")
    check(len({r["seed"] - r["id"] for r in recs}) == 1, f"{label}: worker seeds {recs}")
    for r in recs:
        check(r["num_workers"] == 2 and r.get("init_worker_id") == r["id"] and r["reads"] > 0,
              f"{label}: worker info {r}")
        check(r["pid"] != trainer_pid, f"{label}: a worker is the trainer ({r})")
        check(not r["cuda_initialized"], f"{label}: CUDA initialised in worker {r}")


def _same_losses(label, got, want, spread):
    """``got`` the bits of ``want``, or, where two runs of the same steps
    are not bit-equal (``spread`` not None, from resume_train), within
    that spread."""
    if spread is None:
        check(got == want, f"{label}: losses {got} are not {want}")
    else:
        check(all(abs(a - b) <= spread for a, b in zip(got, want)),
              f"{label}: losses {got} outside the spread {spread} of {want}")


def _watch_exit(events, proc, out):
    """While the launcher ``proc`` runs: find the first incarnation's pid
    (its start event in ``events``), then set ``out["t"]`` to the time its
    process stops running (a zombie waiting for the launcher, or gone)."""
    pid = None
    while proc.poll() is None:
        if pid is None:
            with contextlib.suppress(OSError, ValueError):
                for line in events.read_text().splitlines():
                    e = json.loads(line)
                    if e["inc"] == 0 and e["ev"] == "start":
                        pid = e["pid"]
            time.sleep(0.05)
            continue
        try:
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
        except OSError:
            state = "gone"
        if state in ("Z", "X", "gone"):
            out.update(t=time.time(), state=state)
            return
        time.sleep(0.01)


def _orphans(pids, trainer_pid):
    """Of ``pids`` (workers), those alive; and the shared-memory segments
    named after ``trainer_pid`` (the rings of its pools)."""
    alive = []
    for pid in pids:
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:
            continue
        if b"multiprocessing" in cmd:
            alive.append(pid)
    segs = sorted(str(p) for p in Path("/dev/shm").glob(f"pt_dl*_{trainer_pid}_*"))
    return alive, segs


def _launch_checks(rc, err, by, pids, workdir, leg1, leg2, want, spread, exited):
    """Leg 3's checks (see ``phase_launch_train``) over the launcher's exit
    code and stderr and the incarnations' events ``by``; returns the
    record, with the time to recover and its parts."""
    check(rc == 0, f"launch_train: the launcher exited {rc}")
    restarts = [ln for ln in err.splitlines() if "restart " in ln and "exited rc=" in ln]
    check(len(restarts) == 1 and "rc=-9; restart 1/1" in restarts[0],
          f"launch_train: restarts {restarts}, expected one after a SIGKILL")
    steps0 = [e for e in by[0] if e["ev"] == "step"]
    steps1 = [e for e in by[1] if e["ev"] == "step"]
    check([e["step"] for e in steps0] == [1, 2, 3] and [e["step"] for e in steps1] == [4, 5],
          f"launch_train: incarnation steps {[e['step'] for e in steps0]}, "
          f"{[e['step'] for e in steps1]}")
    resumed = [e for e in by[1] if e["ev"] == "resumed"]
    check(resumed and resumed[0]["at"] == LAUNCH_SAVE_STEP,
          f"launch_train: the relaunch resumed at {resumed}")
    launched = [e["loss"] for e in steps0 + steps1]
    check([e["sha"] for e in steps0 + steps1] == [s["sha"] for s in leg1],
          "launch_train: the launched child's batches are not leg 1's bytes")
    losses = [s["loss"] for s in leg1]
    _same_losses("launch_train launched", launched, losses, spread)
    for e in steps0 + steps1:
        check(e["launches"] == want, f"launch_train launched: step {e['step']} launched "
                                     f"{e['launches']}, expected {want}")
    for k in (0, 1):
        _check_workers(f"launch_train incarnation {k}",
                       _worker_records(workdir, f"launch{k}"), pids[k])
    # the time to recover, from the SIGKILL to the relaunched first step
    kill = next(e["t"] for e in by[0] if e["ev"] == "crash_point" and
                e["step"] == LAUNCH_CRASH_STEP)
    t = next(e for e in by[1] if e["ev"] == "timeline")
    marks = [("the killed trainer's exit (its CUDA context freed)", exited.get("t")),
             ("the launcher's notice and a new process", t["t_exec"]),
             ("interpreter and this script's imports", t["t_import"]),
             ("torch, the port and a CUDA context", t["t_cuda"]),
             ("store client and heartbeat", t["t_control"]),
             ("kernel-library load", t["t_kernels"]),
             ("model build", t["t_build"]),
             ("checkpoint load", t["t_resume"]),
             ("loader's first batch (worker spawn)", t["t_batch"]),
             ("first step", steps1[0]["t_end"])]
    parts, prev = {}, kill
    for name, at in marks:
        if at is not None:
            parts[name] = round((at - prev) * 1e3, 1)
            prev = at
    return {"losses": losses, "losses_workers": [s["loss"] for s in leg2],
            "losses_launched": launched, "restarts": 1,
            "wait_ms_no_workers": [s["wait_ms"] for s in leg1],
            "wait_ms_workers": [s["wait_ms"] for s in leg2],
            "wait_ms_launched": [e["wait_ms"] for e in steps0 + steps1],
            "step_ms_no_workers": [s["step_ms"] for s in leg1],
            "step_ms_workers": [s["step_ms"] for s in leg2],
            "recover_ms": (steps1[0]["t_end"] - kill) * 1e3, "recover_parts_ms": parts,
            "worker_start_relaunched_ms": _spawn_split(_worker_records(workdir, "launch1"),
                                                       steps1[0]),
            "save_ms": next(e["ms"] for e in by[0] if e["ev"] == "saved")}


def phase_launch_train(seed, card, resume=None):
    """`base` (cut to CHECKPOINT_LAYERS layers) training through the host
    runtime in three legs: no workers;
    2 worker processes; under ``python -m paddle_tpu_torch.distributed.
    launch`` with a crash and one restart.  See the module docstring."""
    import os
    import shutil
    import signal
    import socket
    import tempfile

    spread = None
    if resume is not None and not resume["two_runs_bit_equal"]:
        spread = max(abs(a - b) for a, b in zip(resume["losses_uninterrupted"],
                                                resume["losses_first_three_again"]))
    log(f"launch_train: `base` depth cut to {CHECKPOINT_LAYERS} of 12 layers (widths unchanged)")
    workdir = Path(tempfile.mkdtemp(prefix="launch_train_"))
    try:
        leg1, want = _launch_leg("no workers", seed, workdir, False)
        leg2, _ = _launch_leg("workers", seed, workdir, True)
        losses = [s["loss"] for s in leg1]
        check(all(s["device"] == "cpu" for s in leg1)
              and all(s["device"] == "cuda" for s in leg2),
              "launch_train: leg 1's batches must come on the host, leg 2's on the card")
        check([s["sha"] for s in leg2] == [s["sha"] for s in leg1],
              "launch_train: the workers' batches are not leg 1's bytes")
        _same_losses("launch_train workers", [s["loss"] for s in leg2], losses, spread)
        _check_workers("launch_train workers", _worker_records(workdir, "workers"), os.getpid())
        spawn = _spawn_split(_worker_records(workdir, "workers"), leg2[0])
        log(f"launch_train workers: each worker's start, ms from the first wait: "
            f"{json.dumps(spawn)}")

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        logs = workdir / "logs"
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--max_restarts", "1", "--log_dir", str(logs), "--job_id", "launch_train",
               "--rank", "-1", "--nnodes", "1", "--master", f"127.0.0.1:{port}",
               str(REPO / "chip_smoke.py"), "--launch_child", str(workdir),
               "--launch_store", f"127.0.0.1:{port}", "--seed", str(seed)]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               "FLAGS_ft_inject_crash_step": str(LAUNCH_CRASH_STEP),
               "FLAGS_ft_inject_crash_signal": str(int(signal.SIGKILL))}
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, start_new_session=True)
        exited = {}
        watcher = threading.Thread(target=_watch_exit, daemon=True,
                                   args=(workdir / "events.jsonl", proc, exited))
        watcher.start()
        try:
            err = proc.communicate(timeout=LAUNCH_TIMEOUT)[1]
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)         # the launcher, its child, the workers
            proc.communicate()
            raise PhaseError(f"launch_train: the launcher ran past {LAUNCH_TIMEOUT} s")
        watcher.join(timeout=5)
        launch_s = time.perf_counter() - t0
        child_log = next(iter(logs.glob("launch_train.*.log")), None)
        tail = child_log.read_text().splitlines()[-25:] if child_log else []
        log(f"launch_train launcher: rc {proc.returncode} in {launch_s:.1f} s; its stderr:\n"
            + err.strip() + "\nlaunch_train child log (tail):\n" + "\n".join(tail))
        events = [json.loads(ln) for ln in (workdir / "events.jsonl").read_text().splitlines()]
        by = {k: [e for e in events if e["inc"] == k] for k in (0, 1)}
        pids = {k: next((e["pid"] for e in by[k] if e["ev"] == "start"), None) for k in (0, 1)}
        # what each incarnation left (its workers and rings), counted now and
        # cleared whatever the checks below find
        left = {k: _orphans([r["pid"] for r in _worker_records(workdir, f"launch{k}")], pids[k])
                for k in (0, 1)}
        try:
            rec = _launch_checks(proc.returncode, err, by, pids, workdir, leg1, leg2, want,
                                 spread, exited)
        finally:
            with contextlib.suppress(OSError):
                os.killpg(proc.pid, signal.SIGKILL)     # the launcher's group: the orphans
            for k in (0, 1):
                for pid in left[k][0]:
                    with contextlib.suppress(OSError):
                        os.kill(pid, signal.SIGKILL)
                for seg in left[k][1]:
                    with contextlib.suppress(OSError):
                        os.unlink(seg)
        (orphans, segs), (left1, segs1) = left[0], left[1]
        rec.update(launch_s=launch_s, spread=spread, worker_start_ms=spawn,
                   orphan_workers=len(orphans), orphan_segments=len(segs),
                   left_by_clean_exit=len(left1) + len(segs1))
        log(f"launch_train: {json.dumps(rec)}; {card}")
        log(f"launch_train: time to recover {rec['recover_ms']:.1f} ms from the SIGKILL to the "
            f"relaunched first step: {json.dumps(rec['recover_parts_ms'])}")
        if orphans or segs:
            log(f"launch_train: FINDING: the SIGKILLed trainer left {len(orphans)} worker "
                f"processes and {len(segs)} shared-memory segments (workers do not watch for "
                f"their trainer's death); cleared")
        check(not left1 and not segs1, f"launch_train: the relaunched incarnation's clean exit "
                                       f"left workers {left1} and segments {segs1}")
        return rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def launch_child(workdir, store, seed):
    """The training program that `launch_train` hands the launcher: its rank
    from the launcher's rendezvous, an ElasticManager heartbeat on the
    launcher's store, leg 2's loop (2 persistent workers) resumed from the
    newest checkpoint, ``crash_point`` before each step and a save after
    step ``LAUNCH_SAVE_STEP``.  Every event goes to ``events.jsonl``."""
    import os

    t = {"t_exec": _launch_probe(workdir).exec_time(), "t_import": _T_IMPORT}
    import torch
    torch.zeros(1, device="cuda")
    t["t_cuda"] = time.time()
    from paddle_tpu_torch import io
    from paddle_tpu_torch.distributed.fault_tolerance import get_injector
    from paddle_tpu_torch.distributed.fleet import CheckpointManager, ElasticManager
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.kernels import _build, reset_launch_counts
    from paddle_tpu_torch.models.presets import build_pretrain_step

    inc = int(os.environ["PADDLE_RESTART_COUNT"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    events = open(Path(workdir, "events.jsonl"), "a")

    def emit(ev, **kw):
        events.write(json.dumps({"inc": inc, "ev": ev, **kw}) + "\n")
        events.flush()

    emit("start", pid=os.getpid(), rank=rank)
    host, port = store.rsplit(":", 1)
    kv = TCPStore(host, int(port), world_size=1, timeout=60.0)
    check(kv.native, "launch_train child: the store client is not the native one")
    kv.add("launch_train/incarnations", 1)
    elastic = ElasticManager(kv, rank, 1, job_id="launch_train",
                             interval=LAUNCH_HEARTBEAT).start()
    t["t_control"] = time.time()
    _build.load_all()
    t["t_kernels"] = time.time()
    step_fn, _, _, cfg, (B, S, _) = build_pretrain_step("base", "cuda", seed=seed,
                                                        layers=CHECKPOINT_LAYERS)
    torch.cuda.synchronize()
    t["t_build"] = time.time()
    ckpt = CheckpointManager(str(Path(workdir, "ckpt")), keep=1)
    start = ckpt.resume(step_fn)
    torch.cuda.synchronize()
    t["t_resume"] = time.time()
    emit("resumed", at=start)
    probe = _launch_probe(workdir)
    loader = io.DataLoader(probe.Probed(_launch_tokens(seed, cfg.vocab_size, B, S),
                                        f"launch{inc}"),
                           batch_size=B, num_workers=2, persistent_workers=True,
                           worker_init_fn=probe.init)
    injector = get_injector()
    check(injector is not None and injector.crash_step == LAUNCH_CRASH_STEP,
          f"launch_train child: the injector from the flags is {injector}")

    def before(step):
        t.setdefault("t_batch", time.time())
        emit("crash_point", step=step, t=time.time())
        injector.crash_point(step, rank=rank)

    def after(rec):
        emit("step", **rec)
        if rec["step"] == LAUNCH_SAVE_STEP:
            t0 = time.perf_counter()
            ckpt.save(rec["step"], step_fn)
            emit("saved", step=rec["step"], ms=(time.perf_counter() - t0) * 1e3)

    reset_launch_counts()
    try:
        _launch_steps(step_fn, loader, start, before, after)
    finally:
        if loader._shm_pool is not None:
            loader._shm_pool.shutdown()
    beats = elastic.counters()
    elastic.stop()
    kv.close()
    check(beats.get(rank, 0) > 0, f"launch_train child: heartbeat counters {beats}")
    emit("timeline", **t)
    events.close()
    return 0


def phase_optimizers(seed):
    """Each optimizer of OPT_PARITY through TrainStep for OPT_STEPS steps on
    the tiny Llama in fp32, on the card and on the CPU from the same
    weights: step-1 losses within rtol 1e-5 (fp32 forwards of equal
    weights), later ones within 1e-4, params within the optimizer's limit,
    which must lie below the smallest move a CPU step made, every slot
    within OPT_SLOT_RTOL and its slot limit, the step counts equal; on the card
    Adam and AdamW launch the AdamW kernel once a step (inside the update),
    the others never.  LBFGS steps through its closure (params only).
    Every optimizer is run and logged before the phase fails."""
    import numpy as np
    import torch
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import adamw
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                         load_paddle_tpu_params, to_paddle_tpu_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama_tiny_config()
    ids = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    base = to_paddle_tpu_params(LlamaForCausalLM(cfg, device="cpu", seed=seed))
    recs, failed = {}, []
    for name, (kw, atol, slot_atol) in OPT_PARITY.items():
        losses, state, kernel, moves = {}, {}, {}, []
        for dev in ("cpu", "cuda"):
            model = LlamaForCausalLM(cfg, device=dev, seed=seed)
            load_paddle_tpu_params(model, base)
            opt = getattr(topt, name)(parameters=model.parameters(), **kw)
            x = torch.from_numpy(ids).to(dev)
            before = adamw.adamw_update_leaves.launches
            if name == "LBFGS":
                def closure(model=model, opt=opt, x=x):
                    opt.clear_grad()
                    loss = model.compute_loss(model(x), x)
                    loss.backward()
                    return loss

                run = lambda: opt.step(closure)                          # noqa: E731
                flat = lambda: {f"param.{n}": p.detach()                 # noqa: E731
                                for n, p in model.named_parameters()}
            else:
                step = TrainStep(model, lambda m, t: m.compute_loss(m(t), t), opt)
                run, flat = (lambda: float(step(x))), step.state_dict
            losses[dev] = []
            for _ in range(OPT_STEPS):
                prev = {k: v.clone() for k, v in flat().items() if k.startswith("param.")}
                losses[dev].append(float(run()))
                if dev == "cpu":
                    moves.append(max(max_err(flat()[k], v) for k, v in prev.items()))
            kernel[dev] = adamw.adamw_update_leaves.launches - before
            state[dev] = {k: v.detach().cpu() for k, v in flat().items()}
        cpu, card = state["cpu"], state["cuda"]
        err = max(max_err(card[k], cpu[k]) for k in cpu if k.startswith("param."))
        # each slot's atol needed beside OPT_SLOT_RTOL, as a share of its
        # largest |value|
        slots = {k: float(((card[k] - cpu[k]).abs() - OPT_SLOT_RTOL * cpu[k].abs()).max()
                          / max(float(cpu[k].abs().max()), 1e-30))
                 for k in cpu if k.startswith("opt") and k in card}
        worst = max(slots, key=slots.get, default=None)
        recs[name] = {"losses_cpu": losses["cpu"], "losses_card": losses["cuda"],
                      "param_max_err": err, "limit": atol, "cpu_step_moves": moves,
                      "slot_atol_needed": slots.get(worst, 0.0), "slot_worst": worst,
                      "slot_limit": slot_atol,
                      "adamw_launches": kernel["cuda"]}
        log(f"optimizers {name}: {json.dumps(recs[name])}")
        try:
            _optimizer_checks(name, (atol, slot_atol), losses, moves, err, slots, cpu, card,
                              kernel)
        except PhaseError as e:
            failed.append(str(e))
    log(f"optimizers: {json.dumps(recs)}")
    check(not failed, "; ".join(failed))
    return recs


def _optimizer_checks(name, limits, losses, moves, err, slots, cpu, card, kernel):
    """``phase_optimizers``' checks of one optimizer."""
    import torch

    atol, slot_atol = limits
    check(sorted(cpu) == sorted(card), f"optimizers {name}: state keys differ")
    # LBFGS reports the loss after each step's line search, not before
    check(name == "LBFGS" or abs(losses["cuda"][0] - losses["cpu"][0])
          <= 1e-5 * abs(losses["cpu"][0]), f"optimizers {name}: step-1 losses {losses}")
    check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(losses["cuda"], losses["cpu"])),
          f"optimizers {name}: losses {losses}")
    check(atol < min(moves), f"optimizers {name}: limit {atol} not below the smallest "
                             f"step move {min(moves)}")
    check(err <= atol, f"optimizers {name}: params {err} apart after {OPT_STEPS} steps, "
                       f"past {atol}")
    bad = {k: v for k, v in slots.items() if v > slot_atol}
    check(not bad, f"optimizers {name}: slots past rtol {OPT_SLOT_RTOL} + {slot_atol} of "
                   f"their largest value (the atol each needs): {bad}")
    check(all(torch.equal(card[k], cpu[k]) for k in cpu
              if not k.startswith(("param.", "opt"))), f"optimizers {name}: step counts")
    want = OPT_STEPS if name in ("Adam", "AdamW") else 0
    check(kernel["cuda"] == want and kernel["cpu"] == 0,
          f"optimizers {name}: {kernel} AdamW kernel launches, expected {want} on the card")


def _profile_ssd_step(model, step):
    """One ssd_train step under torch.profiler, with the device time of two
    ranges read apart: the scan's backward kernels and the 128256-wide
    cross-entropy's forward (prints, checks nothing)."""
    import torch
    from paddle_tpu_torch.kernels import ssd_scan as ts

    backward = ts._SSDScan.backward
    loss = model.compute_loss

    def timed_backward(ctx, dy, ds):
        with torch.profiler.record_function("ssd_scan backward (kernels)"):
            return backward(ctx, dy, ds)

    def timed_loss(*a, **kw):
        with torch.profiler.record_function("compute_loss forward"):
            return loss(*a, **kw)

    ts._SSDScan.backward = staticmethod(timed_backward)
    model.compute_loss = timed_loss
    try:
        _profile(step, "ssd_train: one step",
                 ranges=("ssd_scan backward (kernels)", "compute_loss forward"))
    finally:
        ts._SSDScan.backward = staticmethod(backward)
        del model.compute_loss


def phase_profile(model, seed):
    """torch.profiler over one decode-dominated Engine drain at 8B widths
    (8 requests of 128 prompt tokens, 32 new tokens each): device kernel
    time by kernel name, and the device's busy share of the wall time."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512), num_blocks=64)
    _serve(model, _requests(rng, model.config.vocab_size, [128] * 8, [32] * 8), "cuda", **kw)
    reqs = _requests(rng, model.config.vocab_size, [128] * 8, [32] * 8)
    engines = []
    wall_ms, _ = _profile(lambda: engines.append(_serve(model, reqs, "cuda", **kw)[0]),
                          "serve: one Engine drain")
    eng = engines[0]
    steps = eng.stats["decode_steps"]
    log(f"profile: {eng.stats['prefills']} prefills, {steps} decode steps "
        f"({wall_ms / steps:.3f} ms wall a step incl. prefill)")


# ---------------------------------------------------------------------------
# nn_tail: the rest of paddle.nn, ops.extras, fft and signal on the card
# ---------------------------------------------------------------------------

# leg 2: each group's limit on the card against the CPU, fp32 with TF32 off:
# (atol as a share of max(1, max |CPU|), rtol), values and gradients alike
NN_TAIL_TOL = {
    # CUDA's and the CPU's libm differ by an ulp or two in exp/log/tanh/erf
    "elementwise": ((1e-5, 1e-5), "fp32 transcendental functions, a few ulps apart"),
    # sums over a row, a window, a batch or a channel taken in another order
    "reduction": ((1e-4, 1e-4), "sums in another order (norms, pools, losses, softmax)"),
    # cuDNN's and oneDNN's convolution algorithms (implicit GEMM, Winograd,
    # FFT) round differently; the resampling and attention matmuls too
    "matmul": ((1e-3, 1e-3), "cuDNN / cuBLAS against the CPU's fp32 algorithms"),
    # cuFFT against pocketfft: errors grow with log2(n) and the norm
    "fft": ((1e-4, 1e-4), "cuFFT against pocketfft, error ~ log2(n) eps |x|"),
    "exact": ((0.0, 0.0), "integer, boolean and data-movement results: the same bits"),
}
NN_TAIL_SAMPLES = {"map": 2, "map3d": 1, "clip": 2}   # samples the CPU recomputes


def _nn_tail_kernels(seed):
    """Leg 1: the slice's entries that reach kernels, at full width, each
    with the counters zeroed just before it; every result held against its
    plain version."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.kernels.rms_norm import rms_norm_backward_reference, rms_norm_reference
    from paddle_tpu_torch.nn import functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out, total, labels = {}, {}, []

    def counted(label, fn, want):
        labels.append(label)
        torch.cuda.synchronize()
        reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        check(counts == want, f"nn_tail {label}: launches {counts}, expected {want}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return res

    # RMSNorm at `base`'s rows: bf16 x, fp32 weight, forward and backward
    x = torch.randn(3, 2048, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(2048, generator=gen, device="cuda")
    dy = torch.randn(3, 2048, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    layer = nn.RMSNorm(2048, device="cuda")
    with torch.no_grad():
        layer.weight.copy_(w)
    y_ref = rms_norm_reference(x, w)
    dx_ref, dw_ref = rms_norm_backward_reference(x, w, dy)
    for label, call, weight in (("nn.RMSNorm", lambda xx: layer(xx), layer.weight),
                                ("F.rms_norm", None, None)):
        if call is None:
            weight = w.clone().requires_grad_()
            call = lambda xx, ww=weight: F.rms_norm(xx, ww)   # noqa: E731
        xg = x.clone().requires_grad_()

        def run(xg=xg, call=call, weight=weight):
            y = call(xg)
            dx, dw = torch.autograd.grad(y, (xg, weight), dy)
            return y, dx, dw

        y, dx, dw = counted(label, run, {"rms_norm": 1, "rms_norm_bwd": 1})
        errs = {"y": max_err(y, y_ref), "dx": max_err(dx, dx_ref), "dw": max_err(dw, dw_ref)}
        check(within(y, y_ref, RMS_TOL) and within(dx, dx_ref, RMS_TOL),
              f"nn_tail {label} disagrees with the plain RMSNorm: {errs}")
        check(errs["dw"] <= RMS_DW_ATOL * float(dw_ref.abs().max()),
              f"nn_tail {label}: dw disagrees: {errs}")
        out[label] = {"shape": [3, 2048, 2048], "max_abs_err": errs}
        log(f"nn_tail {label}: {json.dumps(out[label])}")
    z = torch.randn(3, 2048, 2000, generator=gen, device="cuda").to(torch.bfloat16)
    counted("F.rms_norm at width 2000", lambda: F.rms_norm(z, w[:2000]), {})
    del x, dy, y_ref, dx_ref, y, dx

    # flash_attn_qkvpacked at `base`'s attention: the q, k, v views of qkv
    B, S, H, D = 3, 2048, 16, 128
    qkv = torch.randn(B, S, 3, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    views = [qkv[:, :, i] for i in range(3)]
    copied = [fa._aligned_rows(t).data_ptr() != t.data_ptr() for t in views]
    qkv_g = qkv.clone().requires_grad_()
    sm = D ** -0.5

    def packed():
        o = F.flash_attn_qkvpacked(qkv_g, causal=True)[0]
        return o, torch.autograd.grad(o.float().sum(), qkv_g)[0]

    o, dqkv = counted("flash_attn_qkvpacked", packed,
                      {"flash_attention_fwd": 1, "flash_attention_bwd": 1})
    o = o.detach()
    o_ref, lse_ref = fa._flash_fwd_reference(*views, True, sm)
    refs = fa._flash_bwd_reference(*views, o_ref, lse_ref, torch.ones_like(o_ref), True, sm)
    errs = {"o": max_err(o, o_ref)}
    check(within(o, o_ref, FLASH_TOL, scaled=True), f"nn_tail qkvpacked: o disagrees {errs}")
    for i, (name, r) in enumerate(zip(("dq", "dk", "dv"), refs)):
        g = dqkv[:, :, i]
        errs[name] = max_err(g, r)
        check(within(g, r, FLASH_TOL, scaled=True) and tile_rel_err(g, r) <= FLASH_GRAD_RTOL,
              f"nn_tail qkvpacked: {name} disagrees {errs}")
    contiguous = [t.contiguous() for t in views]
    packed_ms = time_ms(lambda: F.flash_attn_qkvpacked(qkv, causal=True), 10)
    dense_ms = time_ms(lambda: fa.flash_attention_fwd(*contiguous, True, sm), 10)
    out["flash_attn_qkvpacked"] = {
        "shape": [B, S, 3, H, D], "dtype": "bfloat16", "max_abs_err": errs,
        "views_copied": dict(zip("qkv", copied)), "fwd_ms_from_views": packed_ms,
        "fwd_ms_contiguous": dense_ms}
    log(f"nn_tail flash_attn_qkvpacked: {json.dumps(out['flash_attn_qkvpacked'])}")
    del qkv, qkv_g, views, contiguous, o, dqkv, o_ref, lse_ref, refs

    # flash_attn_unpadded over an ERNIE-base packed batch: 32 sequences of
    # 64-512 tokens from the seed, 12 heads of 64, bf16, non-causal and
    # causal; then causal with the query boundaries apart from the keys'
    # (each sequence's query count drawn on its own, one sequence without
    # keys): segments with more queries than keys, whose first rows see no key
    rng = random.Random(seed)
    lengths = [rng.randint(64, 512) for _ in range(32)]
    q_lengths = [rng.randint(64, 512) for _ in range(32)]
    k_lengths = list(lengths)
    k_lengths[rng.randrange(32)] = 0
    H, D, sc = 12, 64, 64 ** -0.5

    def bounds(lens):
        return torch.tensor([0] + list(itertools.accumulate(lens)), dtype=torch.int32,
                            device="cuda")

    def rows(n):
        return torch.randn(n, H, D, generator=gen, device="cuda").to(torch.bfloat16)

    cu = bounds(lengths)
    Tn = sum(lengths)
    q, k, v = rows(Tn), rows(Tn), rows(Tn)
    modes = [("noncausal", False, q, k, v, lengths, lengths),
             ("causal", True, q, k, v, lengths, lengths),
             ("causal, query boundaries apart", True, rows(sum(q_lengths)),
              rows(sum(k_lengths)), rows(sum(k_lengths)), q_lengths, k_lengths)]
    for mode, causal, q, k, v, lq, lk in modes:
        cq, ck = bounds(lq), bounds(lk)
        Tq = q.shape[0]
        ct = (torch.cos(torch.arange(Tq * H * D, device="cuda", dtype=torch.float32) * 0.7)
              + 0.5).reshape(Tq, H, D)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        def varlen(qg=qg, kg=kg, vg=vg, cq=cq, ck=ck, causal=causal, ct=ct):
            o = F.flash_attn_unpadded(qg, kg, vg, cq, ck, 512, 512, sc, causal=causal)[0]
            return o, torch.autograd.grad((o.float() * ct).sum(), (qg, kg, vg))

        # a launch each way for every sequence with keys
        n_seg = sum(1 for n in lk if n)
        kind = "" if causal else "_noncausal"
        want = {f"flash_attention_fwd{kind}": n_seg, f"flash_attention_bwd{kind}": n_seg}
        o, grads = counted(f"flash_attn_unpadded {mode}", varlen, want)
        o = o.detach()
        # the forward against the JAX function's masked attention over the
        # packed length (fp32 from the bf16 inputs)
        o_ref = F._varlen_reference(q.float(), k.float(), v.float(), cq.tolist(), ck.tolist(),
                                    causal, sc)
        errs = {"o": max_err(o, o_ref)}
        check(within(o, o_ref.to(torch.bfloat16), FLASH_TOL, scaled=True),
              f"nn_tail varlen {mode}: o disagrees {errs}")
        del o_ref
        tiles = {}
        g_ref = _varlen_grads_reference(q, k, v, ct.to(torch.bfloat16), cq.tolist(),
                                        ck.tolist(), causal, sc)
        for name, g, r in zip(("dq", "dk", "dv"), grads, g_ref):
            errs[name], tiles[name] = max_err(g, r), tile_rel_err(g[None], r[None])
            check(within(g, r, FLASH_TOL, scaled=True) and tiles[name] <= FLASH_GRAD_RTOL,
                  f"nn_tail varlen {mode}: {name} disagrees {errs}, tile errors {tiles} "
                  f"(max |plain| {float(r.float().abs().max())})")
        del g_ref, grads
        rec = {"sequences": 32, "query_tokens": Tq, "key_tokens": k.shape[0], "heads": H,
               "head_dim": D, "dtype": "bfloat16", "max_abs_err": errs,
               "grad_tile_norm_err": tiles}
        if lq == lk:
            qkv = torch.stack([q, k, v], dim=1)
            o_packed = counted(f"flash_attn_varlen_qkvpacked {mode}",
                               lambda: F.flash_attn_varlen_qkvpacked(
                                   qkv, cu, cu, 512, 512, sc, causal=causal)[0],
                               {name: cnt for name, cnt in want.items() if "fwd" in name})
            check(torch.equal(o_packed, o),
                  f"nn_tail varlen {mode}: the packed form differs from flash_attn_unpadded")
            del qkv, o_packed
            rec.update(_varlen_times(q, k, v, cu, lengths, causal, sc, o))
        out[f"flash_attn_unpadded {mode}"] = rec
        log(f"nn_tail flash_attn_unpadded {mode}: {json.dumps(rec)}")
    return out, total, labels


def _varlen_grads_reference(q, k, v, ct16, cu_q, cu_k, causal, scale):
    """The gradients ``F.flash_attn_unpadded`` should give: each segment's
    rows that see a key by the plain flash backward (from the plain
    forward's o and lse and the bf16 cotangent, as ``kernels`` holds the
    kernel's backward), and the rows that see none (their output the mean
    of every packed value row, as in the JAX function) spreading their
    cotangent over every row of v; fp32."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    dq, dk, dv = (torch.zeros(t.shape, device=t.device) for t in (q, k, v))
    blind = torch.zeros(v.shape[1:], device=v.device)
    for (q0, q1), (k0, k1) in zip(zip(cu_q, cu_q[1:]), zip(cu_k, cu_k[1:])):
        nb = q1 - q0 if k1 == k0 else (max(0, (q1 - q0) - (k1 - k0)) if causal else 0)
        blind += ct16[q0:q0 + nb].float().sum(0)
        if q1 - q0 > nb:
            seg = [q[q0 + nb:q1][None], k[k0:k1][None], v[k0:k1][None]]
            o_s, lse_s = fa._flash_fwd_reference(*seg, causal, scale)
            gq, gk, gv = fa._flash_bwd_reference(*seg, o_s, lse_s, ct16[q0 + nb:q1][None],
                                                 causal, scale)
            dq[q0 + nb:q1] = gq[0].float()
            dk[k0:k1] += gk[0].float()
            dv[k0:k1] += gv[0].float()
    dv += blind / max(v.shape[0], 1)
    return dq, dk, dv


def _varlen_times(q, k, v, cu, lengths, causal, scale, o):
    """A ``flash_attn_unpadded`` forward's host time (its python, the
    ``cu_seqlens`` read, the launches enqueued, with the device idle;
    ``cu_seqlens`` on the card and on the host), its device time, its
    bound, the plain version's device time, and the device time of
    torch's one-call varlen flash attention (``aten::_flash_attention_forward``
    with ``cu_seqlens``) on the same inputs, with its largest difference
    from ``o``."""
    import torch
    from paddle_tpu_torch.nn import functional as F

    cu_host = cu.cpu()
    host_ms = {}
    for where, c in (("cu_on_card", cu), ("cu_on_host", cu_host)):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            F.flash_attn_unpadded(q, k, v, c, c, 512, 512, scale, causal=causal)
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host_ms[where] = sum(times[1:]) / len(times[1:])
    dev_ms = time_ms(lambda: F.flash_attn_unpadded(q, k, v, cu_host, cu_host, 512, 512, scale,
                                                   causal=causal), 10,
                     sleep_cycles=20_000_000)
    # the plain version (the port's CPU path): one masked attention over the
    # packed length
    cu_list = cu_host.tolist()
    plain_ms = time_ms(lambda: F._varlen_reference(q, k, v, cu_list, cu_list, causal, scale),
                       3, sleep_cycles=20_000_000)
    T, H, D = q.shape
    pairs = sum(n * (n + 1) // 2 if causal else n * n for n in lengths) * H
    bnd, by = bound(4 * T * H * D * 2 + T * H * 4, 4 * D * pairs, BF16_FLOPS_PER_S)

    def library():
        return torch.ops.aten._flash_attention_forward(
            q, k, v, cu, cu, max(lengths), max(lengths), 0.0, causal, False, scale=scale)[0]

    try:
        lib_err = max_err(library(), o)
        lib_ms = time_ms(library, 10)
    except (RuntimeError, TypeError) as e:       # an aten build without it
        lib_err, lib_ms = None, None
        log(f"nn_tail varlen: no library varlen attention: {e}")
    return {"fwd_device_ms": dev_ms, "fwd_host_ms": host_ms, "fwd_bound_ms": bnd,
            "bound_by": by, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "aten::_flash_attention_forward with cu_seqlens",
            "library_max_abs_diff": lib_err}


# leg 2's sizes on the card, and the tiny ones of a CPU rehearsal
NN_TAIL_SIZES = {
    "card": dict(E=(32, 512, 768), NB=256, NC=1000, D=768, M=(64, 256, 56, 56),
                 M3=(8, 64, 16, 56, 56), SEQ=3136, CLIP=(32, 160000), NFFT=512, HOP=160,
                 SIG=(64, 4096), CUBE=64, MAT=512, BIL=256, RNNT=(8, 100, 21, 64)),
    "tiny": dict(E=(2, 8, 16), NB=8, NC=12, D=16, M=(3, 8, 8, 8), M3=(2, 4, 4, 8, 8), SEQ=64,
                 CLIP=(2, 2000), NFFT=64, HOP=16, SIG=(4, 64), CUBE=8, MAT=16, BIL=8,
                 RNNT=(2, 5, 4, 6)),
}


def _nn_tail_cases(gen, dev="cuda", size="card"):
    """Leg 2's table: (name, group, inputs on ``dev``, fn, samples) where
    ``samples`` is the key of NN_TAIL_SAMPLES when the CPU recomputes only
    the first samples of the batch (the op treats samples apart), else
    None (the whole call).  A layer's fn is ("layer", ctor, call): built on
    the CPU, copied to the card."""
    import torch
    import paddle_tpu_torch as ex
    from paddle_tpu_torch import fft, nn, signal
    from paddle_tpu_torch.nn import functional as F

    z = NN_TAIL_SIZES[size]
    E, NB, NC, D, M, M3 = z["E"], z["NB"], z["NC"], z["D"], z["M"], z["M3"]
    N, C, HW = M[0], M[1], M[2]
    N3, C3, DP = M3[0], M3[1], M3[2]
    HALF = NC // 2

    def R(*shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(*shape, generator=gen, device=dev)
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    def I(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    act = R(*E)
    logits, labels = R(NB, NC), I(0, NC, NB)
    probs = torch.softmax(R(NB, NC), -1)
    pos = R(NB, NC, lo=0.2, hi=2.0)
    bits = I(0, 2, NB, NC).float()
    pm = bits * 2 - 1
    signs = I(0, 2, NB).float() * 2 - 1
    vec, vec2, vec3 = R(NB, D), R(NB, D), R(NB, D)
    fmap, fmap3 = R(*M), R(*M3)
    fmap_c = R(N, C, HW // 2, HW // 2)
    seq1 = R(N, C, z["SEQ"])
    half3 = fmap3[:, :, :DP // 2, :HW // 2, :HW // 2]
    b_c = R(C)
    log_p = torch.log_softmax(logits, -1)
    rt_b, rt_t, rt_u1, rt_v = z["RNNT"]
    rnnt_in = [R(rt_b, rt_t, rt_u1, rt_v), I(1, rt_v, rt_b, rt_u1 - 1),
               torch.full((rt_b,), rt_t, device=dev), torch.full((rt_b,), rt_u1 - 1, device=dev)]
    cases = []

    def add(name, group, inputs, fn, samples=None):
        cases.append((name, group, inputs, fn, samples))

    # nn.functional
    for n in ("relu", "relu6", "gelu", "tanh", "sigmoid", "swish", "hardswish", "hardsigmoid"):
        add(n, "elementwise", [act], getattr(F, n))
    for n in ("softmax", "log_softmax"):
        add(n, "reduction", [act], getattr(F, n))
    add("linear", "matmul", [act, R(D, D // 2) * 0.05, R(D // 2)], F.linear)
    add("embedding", "reduction", [I(0, NC, NB, 16), R(NC, D)], F.embedding)
    add("conv2d", "matmul", [fmap, R(C, C, 3, 3) * 0.02, b_c],
        lambda x, w, b: F.conv2d(x, w, b, padding=1), "map")
    add("adaptive_avg_pool2d", "reduction", [fmap], lambda x: F.adaptive_avg_pool2d(x, 7), "map")
    add("batch_norm", "reduction", [fmap, b_c, b_c.abs() + 0.5, b_c, b_c],
        lambda x, m, v, w, b: F.batch_norm(x, m.detach(), v.detach(), w, b), "map")
    add("layer_norm", "reduction", [act, R(D), R(D)], lambda x, w, b: F.layer_norm(x, D, w, b))
    add("channel_shuffle", "exact", [fmap], lambda x: F.channel_shuffle(x, 4), "map")
    add("upsample", "exact", [fmap], lambda x: F.upsample(x, scale_factor=2), "map")
    add("cross_entropy", "reduction", [logits, labels], F.cross_entropy)
    add("binary_cross_entropy", "reduction", [torch.sigmoid(logits), bits],
        F.binary_cross_entropy)
    add("mse_loss", "reduction", [act, act.flip(0)], F.mse_loss)
    ctc_b = max(NB // 8, 2)
    ctc_in = [R(50, ctc_b, 30), I(1, 30, ctc_b, 10), torch.full((ctc_b,), 50, device=dev),
              torch.full((ctc_b,), 10, device=dev)]
    add("ctc_loss", "reduction", ctc_in, F.ctc_loss)
    for n in ("silu", "leaky_relu", "elu", "selu", "celu", "mish", "softplus", "softsign",
              "tanhshrink", "softshrink", "hardshrink", "log_sigmoid", "thresholded_relu",
              "hardtanh", "glu"):
        add(n, "elementwise", [act], getattr(F, n))
    add("prelu", "elementwise", [fmap, R(C)], F.prelu, "map")
    add("rrelu(eval)", "elementwise", [act], lambda x: F.rrelu(x, training=False))
    add("gumbel_softmax", "random", [logits], lambda x: F.gumbel_softmax(x, 0.5))
    add("rrelu", "random", [act], F.rrelu)
    add("conv1d", "matmul", [seq1, R(C // 2, C, 5) * 0.05, R(C // 2)],
        lambda x, w, b: F.conv1d(x, w, b, padding="SAME"), "map")
    add("conv3d", "matmul", [fmap3, R(C3, C3, 3, 3, 3) * 0.02, R(C3)],
        lambda x, w, b: F.conv3d(x, w, b, padding=1), "map3d")
    add("conv1d_transpose", "matmul", [seq1, R(C, C // 4, 4) * 0.05],
        lambda x, w: F.conv1d_transpose(x, w, stride=2, padding=1), "map")
    add("conv2d_transpose(asymmetric)", "matmul", [fmap_c, R(C, C // 2, 3, 3) * 0.02,
                                                   R(C // 2)],
        lambda x, w, b: F.conv2d_transpose(x, w, b, stride=2, padding=[1, 0, 0, 1],
                                           output_padding=1), "map")
    add("conv3d_transpose", "matmul", [half3, R(C3, C3 // 2, 3, 3, 3) * 0.02],
        lambda x, w: F.conv3d_transpose(x, w, stride=2, padding=1), "map3d")
    add("avg_pool1d", "reduction", [seq1], lambda x: F.avg_pool1d(x, 3, 2, 1), "map")
    add("avg_pool2d(SAME)", "reduction", [fmap], lambda x: F.avg_pool2d(x, 3, 2, "SAME"), "map")
    add("avg_pool3d", "reduction", [fmap3], lambda x: F.avg_pool3d(x, 2, 2), "map3d")
    add("max_pool1d", "exact", [seq1], lambda x: F.max_pool1d(x, 3, 2, 1), "map")
    add("max_pool2d(mask)", "exact", [fmap],
        lambda x: F.max_pool2d(x, 3, 2, [0, 1, 1, 0], return_mask=True), "map")
    add("max_pool3d", "exact", [fmap3], lambda x: F.max_pool3d(x, 2), "map3d")
    add("adaptive_avg_pool1d", "reduction", [seq1], lambda x: F.adaptive_avg_pool1d(x, 10),
        "map")
    add("adaptive_avg_pool3d", "reduction", [fmap3],
        lambda x: F.adaptive_avg_pool3d(x, [DP // 4, HW // 8, HW // 8]), "map3d")
    add("adaptive_max_pool1d", "exact", [seq1], lambda x: F.adaptive_max_pool1d(x, 10), "map")
    add("adaptive_max_pool2d", "exact", [fmap], lambda x: F.adaptive_max_pool2d(x, 5), "map")
    add("group_norm", "reduction", [fmap, b_c, b_c], lambda x, w, b: F.group_norm(x, 4, w, b),
        "map")
    add("instance_norm", "reduction", [fmap, b_c, b_c],
        lambda x, w, b: F.instance_norm(x, weight=w, bias=b), "map")
    add("rms_norm(width D)", "reduction", [act, R(D)], F.rms_norm)
    add("local_response_norm", "reduction", [fmap], lambda x: F.local_response_norm(x, 5),
        "map")
    add("normalize", "reduction", [act], lambda x: F.normalize(x, axis=-1))
    add("dropout(axis)", "random", [fmap], lambda x: F.dropout(x, 0.5, axis=[0, 1]))
    add("dropout2d", "random", [fmap], F.dropout2d)
    add("dropout3d", "random", [fmap3], F.dropout3d)
    add("alpha_dropout", "random", [fmap], F.alpha_dropout)
    add("one_hot", "exact", [labels], lambda y: F.one_hot(y, NC))
    add("softmax_with_cross_entropy", "reduction", [logits, labels[:, None]],
        lambda x, y: F.softmax_with_cross_entropy(x, y, return_softmax=True))
    add("binary_cross_entropy_with_logits", "reduction", [logits, bits, pos[0]],
        lambda x, y, pw: F.binary_cross_entropy_with_logits(x, y, pos_weight=pw))
    for n in ("l1_loss", "smooth_l1_loss", "square_error_cost"):
        add(n, "reduction", [act, act.flip(0)], getattr(F, n))
    add("nll_loss", "reduction", [log_p, labels], F.nll_loss)
    add("kl_div", "reduction", [log_p, probs], lambda a, b: F.kl_div(a, b, "batchmean"))
    add("margin_ranking_loss", "reduction", [vec[:, 0], vec2[:, 0], signs],
        F.margin_ranking_loss)
    add("sigmoid_focal_loss", "reduction", [logits, bits], F.sigmoid_focal_loss)
    add("cosine_embedding_loss", "reduction", [vec, vec2, signs], F.cosine_embedding_loss)
    add("triplet_margin_loss", "reduction", [vec, vec2, vec3], F.triplet_margin_loss)
    add("hinge_embedding_loss", "reduction", [logits, pm], F.hinge_embedding_loss)
    add("poisson_nll_loss", "reduction", [logits, bits * 3], F.poisson_nll_loss)
    add("gaussian_nll_loss", "reduction", [logits, probs, pos], F.gaussian_nll_loss)
    add("multi_label_soft_margin_loss", "reduction", [logits, bits],
        F.multi_label_soft_margin_loss)
    add("soft_margin_loss", "reduction", [logits, pm], F.soft_margin_loss)
    add("npair_loss", "reduction", [vec, vec2, I(0, NB // 4, NB)], F.npair_loss)
    add("interpolate(bicubic)", "matmul", [fmap],
        lambda x: F.interpolate(x, size=[2 * HW, 2 * HW], mode="bicubic"), "map")
    add("interpolate(area)", "matmul", [fmap],
        lambda x: F.interpolate(x, size=[HW // 2, HW // 2], mode="area"), "map")
    add("interpolate(trilinear)", "matmul", [fmap3],
        lambda x: F.interpolate(x, size=[DP // 2, HW // 2, HW // 2], mode="trilinear"), "map3d")
    add("pixel_shuffle", "exact", [fmap], lambda x: F.pixel_shuffle(x, 2), "map")
    add("pixel_unshuffle", "exact", [fmap], lambda x: F.pixel_unshuffle(x, 2), "map")
    add("cosine_similarity", "reduction", [act, act.flip(0)], F.cosine_similarity)
    add("pad(reflect)", "exact", [fmap], lambda x: F.pad(x, [1, 2, 3, 0], "reflect"), "map")
    add("zeropad2d", "exact", [fmap], lambda x: F.zeropad2d(x, [1, 2, 3, 0]), "map")
    add("pairwise_distance", "reduction", [vec, vec2], F.pairwise_distance)
    add("label_smooth", "elementwise", [F.one_hot(labels, NC)], F.label_smooth)
    add("sequence_mask", "exact", [I(1, E[1], E[0])], lambda n: F.sequence_mask(n, E[1]))
    add("unfold", "exact", [fmap], lambda x: F.unfold(x, 3, 2, [1, 0, 0, 1]), "map")
    add("temporal_shift", "exact", [fmap], lambda x: F.temporal_shift(x, N))
    add("affine_grid", "matmul", [R(N, 2, 3)], lambda t: F.affine_grid(t, [N, C, HW, HW]))
    add("grid_sample", "matmul", [fmap, R(N, HW, HW, 2, lo=-1.05, hi=1.05)], F.grid_sample,
        "map")
    cols = R(N, 4 * C, (HW // 2 + 1) ** 2)
    add("fold", "reduction", [cols], lambda x: F.fold(x, [HW, HW], 2, 2, 1), "map")
    pooled, idx = F.max_pool2d(fmap, 2, return_mask=True)
    add("max_unpool2d", "exact", [pooled, idx], lambda x, i: F.max_unpool2d(x, i, 2), "map")
    p1, i1 = (t[..., 0] for t in F.max_pool2d(seq1[..., None], [2, 1], return_mask=True))
    add("max_unpool1d", "exact", [p1, i1], lambda x, i: F.max_unpool1d(x, i, 2), "map")
    p3 = fmap3[:, :, ::2, ::2, ::2].contiguous()
    idx3 = torch.arange(DP * HW * HW, device=dev).reshape(DP, HW, HW)[::2, ::2, ::2].expand(
        N3, C3, DP // 2, HW // 2, HW // 2).contiguous()
    add("max_unpool3d", "exact", [p3, idx3], lambda x, i: F.max_unpool3d(x, i, 2), "map3d")
    add("lp_pool1d", "reduction", [seq1], lambda x: F.lp_pool1d(x, 2, 3, 2), "map")
    add("lp_pool2d", "reduction", [fmap], lambda x: F.lp_pool2d(x, 3, 2), "map")
    add("fractional_max_pool2d", "exact", [fmap],
        lambda x: F.fractional_max_pool2d(x, HW * 2 // 3), "map")
    add("fractional_max_pool3d", "exact", [fmap3],
        lambda x: F.fractional_max_pool3d(x, [DP * 2 // 3, HW * 2 // 3, HW * 2 // 3]), "map3d")
    add("adaptive_max_pool3d", "exact", [fmap3],
        lambda x: F.adaptive_max_pool3d(x, [DP // 3, HW // 6, HW // 6]), "map3d")
    add("maxout", "exact", [fmap], lambda x: F.maxout(x, 4), "map")
    add("dice_loss", "reduction", [torch.softmax(fmap_c[:, :8].movedim(1, -1), -1),
                                   I(0, 8, N, HW // 2, HW // 2, 1)], F.dice_loss)
    add("log_loss", "elementwise", [probs, bits], F.log_loss)
    add("multi_margin_loss", "reduction", [logits, labels], F.multi_margin_loss)
    add("triplet_margin_with_distance_loss", "reduction", [vec, vec2, vec3],
        F.triplet_margin_with_distance_loss)
    add("hsigmoid_loss", "reduction", [vec, labels, R(NC - 1, D) * 0.05, R(NC - 1)],
        lambda x, y, w, b: F.hsigmoid_loss(x, y, NC, w, b))
    add("rnnt_loss", "reduction", rnnt_in, F.rnnt_loss)
    cut = [HALF, HALF + NC // 4]
    als = [vec, labels, R(D, HALF + 2) * 0.05, R(D, D // 4) * 0.05,
           R(D // 4, cut[1] - cut[0]) * 0.05, R(D, D // 16) * 0.05,
           R(D // 16, NC - cut[1]) * 0.05]
    add("adaptive_log_softmax_with_loss", "matmul", als,
        lambda x, y, h, a, b, c, d: F.adaptive_log_softmax_with_loss(
            x, y, h, [(a, b), (c, d)], cut))
    S_, H_ = E[1], 12 if size == "card" else 2
    fq = R(4, S_, H_, 64)
    add("flashmask_attention", "matmul", [fq, fq.flip(1), fq * 0.5,
                                          I(S_ // 2, S_ + 1, 4, 1, S_, 1)],
        lambda q, k, v, se: F.flashmask_attention(q, k, v, se, causal=True))
    add("scaled_dot_product_attention", "matmul", [fq, fq.flip(1), fq * 0.5],
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    add("flash_attention", "matmul", [fq, fq.flip(1), fq * 0.5],
        lambda q, k, v: F.flash_attention(q, k, v, causal=True)[0])
    sq = R(2, H_, S_, 64)
    per = 32 if size == "card" else 4
    offs = torch.arange(0, S_ * per + 1, per, device=dev).expand(2, H_, S_ + 1).contiguous()
    add("sparse_attention", "matmul", [sq, sq.flip(2), sq * 0.5, offs, I(0, S_, 2, H_, S_ * per)],
        F.sparse_attention)
    add("gather_tree", "exact", [I(0, NC, 50, 32, 4), I(0, 4, 50, 32, 4)], F.gather_tree)
    add("feature_alpha_dropout", "random", [fmap], lambda x: F.feature_alpha_dropout(x, 0.3))
    bil = z["BIL"]
    add("bilinear", "matmul", [vec[:, :bil], vec2[:, :bil], R(64, bil, bil) * 0.01, R(1, 64)],
        F.bilinear)
    add("class_center_sample", "random", [labels],
        lambda y: F.class_center_sample(y, NC, NC * 3 // 5))
    add("margin_cross_entropy", "reduction", [R(NB, NC, lo=-0.95, hi=0.95), labels],
        F.margin_cross_entropy)
    for n in ("softmax_", "tanh_", "elu_", "leaky_relu_", "hardtanh_", "thresholded_relu_"):
        add(n, "elementwise", [act], lambda x, n=n: getattr(F, n)(x.detach().clone()))

    # layers
    def layer(name, group, ctor, inputs, samples=None, call=None):
        add(f"nn.{name}", group, inputs, ("layer", ctor, call), samples)

    for n in ("ReLU", "ReLU6", "GELU", "Tanh", "Sigmoid", "Swish", "Hardswish", "Hardsigmoid",
              "Identity"):
        layer(n, "elementwise", lambda n=n: getattr(nn, n)(), [act])
    layer("Dropout", "exact", lambda: nn.Dropout().eval(), [act])
    layer("Flatten", "exact", lambda: nn.Flatten(), [fmap], "map")
    layer("ChannelShuffle", "exact", lambda: nn.ChannelShuffle(4), [fmap], "map")
    layer("Upsample", "exact", lambda: nn.Upsample(scale_factor=2), [fmap], "map")
    layer("AvgPool2D", "reduction", lambda: nn.AvgPool2D(3, 2, 1), [fmap], "map")
    layer("MaxPool2D", "exact", lambda: nn.MaxPool2D(3, 2, 1), [fmap], "map")
    layer("AdaptiveAvgPool2D", "reduction", lambda: nn.AdaptiveAvgPool2D(7), [fmap], "map")
    layer("Linear", "matmul", lambda: nn.Linear(D, D // 2, device="cpu"), [act])
    layer("Embedding", "exact", lambda: nn.Embedding(NC, D, device="cpu"), [I(0, NC, NB, 16)])
    layer("Conv1D", "matmul", lambda: nn.Conv1D(C, C // 2, 5, padding=2, device="cpu"), [seq1],
          "map")
    layer("Conv2D", "matmul", lambda: nn.Conv2D(C, C, 3, padding=1, device="cpu"), [fmap],
          "map")
    layer("Conv2DTranspose", "matmul", lambda: nn.Conv2DTranspose(C, C // 2, 3, 2, 1,
                                                                  device="cpu"), [fmap_c], "map")
    layer("LayerNorm", "reduction", lambda: nn.LayerNorm(D, device="cpu"), [act])
    for n, x in (("BatchNorm", fmap), ("BatchNorm1D", seq1), ("BatchNorm2D", fmap)):
        layer(n, "reduction", lambda n=n: getattr(nn, n)(C, device="cpu"), [x])
    layer("CrossEntropyLoss", "reduction", lambda: nn.CrossEntropyLoss(), [logits, labels])
    layer("BCELoss", "reduction", lambda: nn.BCELoss(), [torch.sigmoid(logits), bits])
    layer("MSELoss", "reduction", lambda: nn.MSELoss(), [act, act.flip(0)])
    layer("CTCLoss", "reduction", lambda: nn.CTCLoss(), ctc_in)
    steps = act[:, :16]
    for n in ("SimpleRNN", "GRU", "LSTM"):
        layer(n, "matmul", lambda n=n: getattr(nn, n)(D, 64, device="cpu"), [steps],
              call=lambda m, x: m(x)[0])
    layer("RNN", "matmul", lambda: nn.RNN(nn.GRUCell(D, 64, device="cpu")), [steps],
          call=lambda m, x: m(x)[0])
    for n in ("SimpleRNNCell", "GRUCell", "LSTMCell"):
        layer(n, "matmul", lambda n=n: getattr(nn, n)(D, 64, device="cpu"), [vec],
              call=lambda m, x: m(x)[0])
    # GELU in the stacks: with ReLU, a pre-activation that rounds to the
    # other side of 0 on the card than on the CPU moves that row's input
    # gradient by a whole term (fp32 only; in fp64 the two agree)
    heads = 12 if size == "card" else 2
    kw = dict(dropout=0.0, activation="gelu", device="cpu")

    def enc():
        return nn.TransformerEncoderLayer(D, heads, 4 * D, **kw)

    def dec():
        return nn.TransformerDecoderLayer(D, heads, 4 * D, **kw)

    layer("MultiHeadAttention", "matmul", lambda: nn.MultiHeadAttention(D, heads, device="cpu"),
          [act], "map")
    layer("TransformerEncoderLayer", "matmul", enc, [act], "map")
    layer("TransformerEncoder", "matmul", lambda: nn.TransformerEncoder(enc(), 2), [act], "map")
    layer("TransformerDecoderLayer", "matmul", dec, [act, act.flip(1)], "map")
    layer("TransformerDecoder", "matmul", lambda: nn.TransformerDecoder(dec(), 2),
          [act, act.flip(1)], "map")
    layer("Transformer", "matmul", lambda: nn.Transformer(D, heads, 1, 1, 4 * D, **kw),
          [act, act.flip(1)], "map")
    layer("Layer", "matmul", lambda: _holding(nn.Layer(), fc=nn.Linear(D, 8, device="cpu")),
          [vec], call=lambda m, x: m.fc(x))
    layer("LayerList", "matmul", lambda: nn.LayerList(
        [nn.Linear(D, D, device="cpu"), nn.Linear(D, 8, device="cpu")]), [vec],
          call=lambda m, x: m[1](m[0](x)))
    layer("Sequential", "matmul", lambda: nn.Sequential(
        nn.Linear(D, D, device="cpu"), nn.ReLU(), nn.Linear(D, 8, device="cpu")), [vec])
    layer("ParameterList", "elementwise", lambda: nn.ParameterList(
        [nn.Layer(device="cpu").create_parameter([D])]), [vec], call=lambda m, x: x * m[0])
    for n, ctor in (("ClipGradByGlobalNorm", lambda: nn.ClipGradByGlobalNorm(1.0)),
                    ("ClipGradByNorm", lambda: nn.ClipGradByNorm(1.0)),
                    ("ClipGradByValue", lambda: nn.ClipGradByValue(0.5))):
        add(f"nn.{n}", "reduction", [act, vec],
            lambda a, b, c=ctor: [g for _, g in c()([(None, a), (None, b)])])
    add("nn.clip_grad_norm_", "reduction", [act, vec],
        lambda a, b: _clip_run(nn.clip_grad_norm_, 1.0, a, b))
    add("nn.clip_grad_value_", "exact", [act, vec],
        lambda a, b: _clip_run(nn.clip_grad_value_, 0.5, a, b))
    for n in ("Silu", "Mish", "Softsign", "Tanhshrink", "LogSigmoid", "Softmax", "LogSoftmax",
              "LeakyReLU", "ELU", "SELU", "CELU", "Softplus", "GLU", "Hardtanh", "Softshrink",
              "Hardshrink", "ThresholdedReLU"):
        layer(n, "elementwise", lambda n=n: getattr(nn, n)(), [act])
    layer("RReLU", "elementwise", lambda: nn.RReLU().eval(), [act])
    layer("PReLU", "elementwise", lambda: nn.PReLU(C, device="cpu"), [fmap], "map")
    for n in ("Dropout2D", "Dropout3D", "AlphaDropout", "FeatureAlphaDropout"):
        layer(n, "exact", lambda n=n: getattr(nn, n)().eval(), [fmap])
    layer("Pad1D", "exact", lambda: nn.Pad1D([1, 2], "replicate"), [seq1], "map")
    layer("Pad2D", "exact", lambda: nn.Pad2D([1, 2, 0, 1], "reflect"), [fmap], "map")
    layer("Pad3D", "exact", lambda: nn.Pad3D([1, 1, 0, 1, 1, 0]), [fmap3], "map3d")
    layer("ZeroPad1D", "exact", lambda: nn.ZeroPad1D([1, 2]), [seq1], "map")
    layer("ZeroPad2D", "exact", lambda: nn.ZeroPad2D([1, 2, 0, 1]), [fmap], "map")
    layer("ZeroPad3D", "exact", lambda: nn.ZeroPad3D([1, 1, 0, 1, 1, 0]), [fmap3], "map3d")
    layer("UpsamplingBilinear2D", "matmul", lambda: nn.UpsamplingBilinear2D(size=[2 * HW,
                                                                                  2 * HW]),
          [fmap], "map")
    layer("UpsamplingNearest2D", "exact", lambda: nn.UpsamplingNearest2D(scale_factor=2),
          [fmap], "map")
    layer("PixelShuffle", "exact", lambda: nn.PixelShuffle(2), [fmap], "map")
    layer("PixelUnshuffle", "exact", lambda: nn.PixelUnshuffle(2), [fmap], "map")
    layer("CosineSimilarity", "reduction", lambda: nn.CosineSimilarity(), [fmap, fmap.flip(0)],
          "map")
    layer("PairwiseDistance", "reduction", lambda: nn.PairwiseDistance(), [vec, vec2])
    layer("Unflatten", "exact", lambda: nn.Unflatten(1, [2, C // 2]), [fmap], "map")
    layer("Bilinear", "matmul", lambda: nn.Bilinear(bil, bil, 64, device="cpu"),
          [vec[:, :bil], vec2[:, :bil]])
    layer("Unfold", "exact", lambda: nn.Unfold(3, 2, 1), [fmap], "map")
    layer("Fold", "reduction", lambda: nn.Fold([HW, HW], 2, 2, 1), [cols], "map")
    layer("BatchNorm3D", "reduction", lambda: nn.BatchNorm3D(C3, device="cpu"), [fmap3])
    layer("SyncBatchNorm", "reduction", lambda: nn.SyncBatchNorm(C, device="cpu"), [fmap])
    layer("RMSNorm", "reduction", lambda: nn.RMSNorm(D, device="cpu"), [act])
    layer("GroupNorm", "reduction", lambda: nn.GroupNorm(4, C, device="cpu"), [fmap], "map")
    layer("InstanceNorm1D", "reduction", lambda: nn.InstanceNorm1D(C, device="cpu"), [seq1],
          "map")
    layer("InstanceNorm2D", "reduction", lambda: nn.InstanceNorm2D(C, device="cpu"), [fmap],
          "map")
    layer("InstanceNorm3D", "reduction", lambda: nn.InstanceNorm3D(C3, device="cpu"), [fmap3],
          "map3d")
    layer("LocalResponseNorm", "reduction", lambda: nn.LocalResponseNorm(5), [fmap], "map")
    layer("SpectralNorm", "matmul", lambda: nn.SpectralNorm([C, C, 3, 3], power_iters=2,
                                                            device="cpu"),
          [R(C, C, 3, 3) * 0.02])
    layer("Conv3D", "matmul", lambda: nn.Conv3D(C3, C3, 3, padding=1, device="cpu"), [fmap3],
          "map3d")
    layer("Conv1DTranspose", "matmul", lambda: nn.Conv1DTranspose(C, C // 4, 4, 2, 1,
                                                                  device="cpu"), [seq1], "map")
    layer("Conv3DTranspose", "matmul", lambda: nn.Conv3DTranspose(C3, C3 // 2, 3, 2, 1,
                                                                  device="cpu"), [half3], "map3d")
    for n, args, x, s in (("AvgPool1D", (3, 2, 1), seq1, "map"),
                          ("AvgPool3D", (2,), fmap3, "map3d"),
                          ("MaxPool1D", (3, 2, 1), seq1, "map"),
                          ("MaxPool3D", (2,), fmap3, "map3d"),
                          ("AdaptiveAvgPool1D", (10,), seq1, "map"),
                          ("AdaptiveAvgPool3D", ([DP // 4, HW // 8, HW // 8],), fmap3, "map3d"),
                          ("AdaptiveMaxPool1D", (10,), seq1, "map"),
                          ("AdaptiveMaxPool2D", (5,), fmap, "map"),
                          ("AdaptiveMaxPool3D", ([DP // 3, HW // 6, HW // 6],), fmap3, "map3d"),
                          ("LPPool1D", (2, 3, 2), seq1, "map"),
                          ("LPPool2D", (3, 2), fmap, "map"),
                          ("FractionalMaxPool2D", (HW * 2 // 3,), fmap, "map"),
                          ("FractionalMaxPool3D", ([DP * 2 // 3, HW * 2 // 3, HW * 2 // 3],),
                           fmap3, "map3d"),
                          ("Maxout", (4,), fmap, "map")):
        group = "exact" if "Max" in n else "reduction"
        layer(n, group, lambda n=n, args=args: getattr(nn, n)(*args), [x], s)
    layer("MaxUnPool1D", "exact", lambda: nn.MaxUnPool1D(2), [p1, i1], "map")
    layer("MaxUnPool2D", "exact", lambda: nn.MaxUnPool2D(2), [pooled, idx], "map")
    layer("MaxUnPool3D", "exact", lambda: nn.MaxUnPool3D(2), [p3, idx3], "map3d")
    layer("Softmax2D", "reduction", lambda: nn.Softmax2D(), [fmap], "map")
    for n, inputs in (("BCEWithLogitsLoss", [logits, bits]), ("L1Loss", [act, act.flip(0)]),
                      ("SmoothL1Loss", [act, act.flip(0)]), ("NLLLoss", [log_p, labels]),
                      ("KLDivLoss", [log_p, probs]),
                      ("MarginRankingLoss", [vec[:, 0], vec2[:, 0], signs]),
                      ("CosineEmbeddingLoss", [vec, vec2, signs]),
                      ("TripletMarginLoss", [vec, vec2, vec3]),
                      ("HingeEmbeddingLoss", [logits, pm]), ("PoissonNLLLoss", [logits, bits * 3]),
                      ("GaussianNLLLoss", [logits, probs, pos]),
                      ("MultiLabelSoftMarginLoss", [logits, bits]),
                      ("SoftMarginLoss", [logits, pm]), ("MultiMarginLoss", [logits, labels]),
                      ("TripletMarginWithDistanceLoss", [vec, vec2, vec3]),
                      ("RNNTLoss", rnnt_in)):
        layer(n, "reduction", lambda n=n: getattr(nn, n)(), inputs)
    layer("HSigmoidLoss", "reduction", lambda: nn.HSigmoidLoss(D, NC, device="cpu"),
          [vec, labels])
    layer("AdaptiveLogSoftmaxWithLoss", "matmul",
          lambda: nn.AdaptiveLogSoftmaxWithLoss(D, NC, cut, device="cpu"), [vec, labels])
    layer("LayerDict", "matmul",
          lambda: nn.LayerDict({"proj": nn.Linear(D, D // 2, device="cpu")}), [vec],
          call=lambda m, x: m["proj"](x))
    layer("ParameterDict", "elementwise",
          lambda: nn.ParameterDict({"scale": nn.Layer(device="cpu").create_parameter([D])}),
          [vec], call=lambda m, x: x * m["scale"])
    layer("ParamAttr", "matmul", lambda: nn.Linear(D, D // 2, weight_attr=nn.ParamAttr(
        initializer=nn.initializer.Orthogonal()), device="cpu"), [vec])
    layer("Parameter", "elementwise", lambda: nn.ParameterList(
        [torch.nn.Parameter(nn.Parameter(torch.linspace(-1, 1, D))._data.detach().cpu())]),
        [vec], call=lambda m, x: x * m[0])
    layer("BiRNN", "matmul", lambda: nn.BiRNN(nn.GRUCell(D, 64, device="cpu"),
                                              nn.GRUCell(D, 64, device="cpu")),
          [act[:, :16]], call=lambda m, x: m(x)[0])
    layer("RNNCellBase", "matmul", lambda: nn.LSTMCell(D, 64, device="cpu"), [vec],
          call=lambda m, x: m(x)[0])
    layer("BeamSearchDecoder", "reduction", lambda: nn.GRUCell(16, 64, device="cpu"),
          [R(NB // 8, 64)], call=_beam_search_run)
    layer("dynamic_decode", "reduction", lambda: nn.GRUCell(16, 64, device="cpu"),
          [R(NB // 8, 64) * 2], call=_beam_search_run)

    # ops.extras, fft and signal
    mat, mat2 = R(z["MAT"], z["MAT"]), R(z["MAT"], z["MAT"])
    add("addmm", "matmul", [mat, mat2, mat.T], lambda i, a, b: ex.addmm(i, a, b, 0.5, 2.0))
    add("mm", "matmul", [mat, mat2], ex.mm)
    add("block_diag", "exact", [mat[:10], mat2[:5, :7], vec[:3]],
        lambda *m: ex.block_diag(list(m)))
    add("cdist", "reduction", [vec[:NB // 2], vec2], ex.cdist)
    add("pdist", "reduction", [vec[:NB // 2]], ex.pdist)
    add("vander", "reduction", [R(NB, lo=-1.0, hi=1.0)], lambda x: ex.vander(x, 8))
    add("logcumsumexp", "reduction", [act[:4]], lambda x: ex.logcumsumexp(x, axis=1))
    add("reduce_as", "reduction", [act], lambda x: ex.reduce_as(x, act[:1, :, :1]))
    add("trapezoid", "reduction", [act], lambda x: ex.trapezoid(x, dx=0.5))
    add("cumulative_trapezoid", "reduction", [act[:4]], ex.cumulative_trapezoid)
    # (away from 0, where sinc's derivative cancels to noise)
    add("sinc", "elementwise", [act.abs() + 0.25], ex.sinc)
    add("frexp", "exact", [act], ex.frexp)
    add("isin", "exact", [labels, I(0, NC, NB)], ex.isin)
    add("gammaln", "elementwise", [act.abs() + 0.1], ex.gammaln)
    # (torch has no derivative in the shape argument a)
    add("gammainc", "elementwise", [pos, probs * 3], lambda a, x: ex.gammainc(a.detach(), x))
    add("gammaincc", "elementwise", [pos, probs * 3], lambda a, x: ex.gammaincc(a.detach(), x))
    add("multigammaln", "elementwise", [pos + 2], lambda x: ex.multigammaln(x, 3))
    add("i0e", "elementwise", [act], ex.i0e)
    add("i1e", "elementwise", [act], ex.i1e)
    for n in ("hstack", "vstack", "dstack", "column_stack", "row_stack"):
        add(n, "exact", [vec, vec2], lambda a, b, n=n: getattr(ex, n)([a, b]))
    for n, t in (("hsplit", vec), ("vsplit", vec), ("dsplit", act)):
        add(n, "exact", [t], lambda x, n=n: getattr(ex, n)(x, 4))
    add("cartesian_prod", "exact", [labels[:8].float(), vec[0, :6]],
        lambda a, b: ex.cartesian_prod([a, b]))
    add("combinations", "exact", [vec[0, :12]], lambda x: ex.combinations(x, 2))
    add("reverse", "exact", [act], lambda x: ex.reverse(x, [0, 2]))
    add("diagonal_scatter", "exact", [mat, mat2[0]], ex.diagonal_scatter)
    add("slice_scatter", "exact", [act, act[:, ::4, :]],
        lambda a, v: ex.slice_scatter(a, v, [1], [0], [E[1]], [4]))
    add("take", "exact", [act, I(-NB, act.numel(), 512)], ex.take)
    for n in ("isneginf", "isposinf", "isreal"):
        add(n, "exact", [act / (act > 1).float()], getattr(ex, n))
    add("is_complex", "exact", [act], ex.is_complex)
    add("is_floating_point", "exact", [act], ex.is_floating_point)
    add("is_integer", "exact", [labels], ex.is_integer)
    add("broadcast_shape", "exact", [], lambda: ex.broadcast_shape([E[0], 1, D], [E[1], 1]))
    add("histogram_bin_edges", "reduction", [act], lambda x: ex.histogram_bin_edges(x, 64))
    add("rank", "exact", [act], ex.rank)
    add("shape", "exact", [act], ex.shape)
    add("tolist", "exact", [labels[:16]], ex.tolist)
    add("finfo", "exact", [], lambda: vars(ex.finfo("bfloat16")))
    add("iinfo", "exact", [], lambda: vars(ex.iinfo("int32")))
    add("increment", "exact", [labels[:1]], lambda x: ex.increment(ex.Tensor(x), 3))
    add("shard_index", "exact", [labels], lambda x: ex.shard_index(x, NC, 4, 1))
    add("floor_mod", "exact", [labels, I(1, 50, NB)], ex.floor_mod)
    add("set_printoptions", "exact", [], lambda: ex.set_printoptions(precision=8))
    add("set_grad_enabled", "exact", [act], lambda x: _grad_mode_run(ex, x))
    add("where_", "exact", [act, act.flip(0)], lambda a, b: ex.where_(a > 0, ex.Tensor(a), b))
    for n, args, group in (("sinc_", [act.abs() + 0.25], "elementwise"),
                           ("gammaln_", [act.abs() + 0.1], "elementwise"),
                           ("gammainc_", [pos, probs * 3], "elementwise"),
                           ("gammaincc_", [pos, probs * 3], "elementwise"),
                           ("multigammaln_", [pos + 2, 3], "elementwise"),
                           ("floor_mod_", [labels, I(1, 9, NB)], "exact"),
                           ("addmm_", [mat, mat2, mat.T], "matmul")):
        add(n, group, [a for a in args if torch.is_tensor(a)],
            lambda *a, n=n, args=args: getattr(ex, n)(
                ex.Tensor(a[0].detach()), *(t.detach() for t in a[1:]),
                *[v for v in args if not torch.is_tensor(v)]))
    sig, cube = R(*z["SIG"]), R(4, z["CUBE"], z["CUBE"])
    for n in ("fft", "ifft", "rfft", "ihfft"):
        add(f"fft.{n}", "fft", [sig], lambda x, n=n: getattr(fft, n)(x))
    add("fft.hfft", "fft", [fft.ihfft(sig)._data], fft.hfft)
    add("fft.irfft", "fft", [fft.rfft(sig)._data], fft.irfft)
    for n in ("fft2", "ifft2", "rfft2", "fftn", "ifftn", "rfftn", "ihfft2", "ihfftn"):
        add(f"fft.{n}", "fft", [cube], lambda x, n=n: getattr(fft, n)(x))
    for n, src in (("irfft2", "rfft2"), ("irfftn", "rfftn"), ("hfft2", "ihfft2"),
                   ("hfftn", "ihfftn")):
        add(f"fft.{n}", "fft", [getattr(fft, src)(cube)._data], lambda x, n=n: getattr(fft, n)(x))
    add("fft.fftshift", "exact", [sig], fft.fftshift)
    add("fft.ifftshift", "exact", [sig], fft.ifftshift)
    add("fft.fftfreq", "exact", [], lambda: fft.fftfreq(4096, 0.5))
    add("fft.rfftfreq", "exact", [], lambda: fft.rfftfreq(4096, 0.5))
    clips = R(*z["CLIP"])
    window = torch.hann_window(z["NFFT"], device=dev)
    add("signal.stft", "fft", [clips, window],
        lambda x, w: signal.stft(x, z["NFFT"], z["HOP"], window=w), "clip")
    spec = signal.stft(clips, z["NFFT"], z["HOP"], window=window)._data
    add("signal.istft", "fft", [spec, window],
        lambda s, w: signal.istft(s, z["NFFT"], z["HOP"], window=w, length=z["CLIP"][1]),
        "clip")
    return cases


def _beam_search_run(cell, init):
    """dynamic_decode of a BeamSearchDecoder (4 beams, 12 steps) over
    ``cell``, a GRU over one-hot tokens whose states a fixed matrix
    projects to the vocabulary: ids and scores."""
    import torch
    from paddle_tpu_torch import nn

    vocab, hidden = cell.weight_ih.shape[1], cell.weight_hh.shape[1]
    proj = torch.linspace(-1, 1, hidden * vocab, device=init.device).reshape(hidden, vocab)
    dec = nn.BeamSearchDecoder(cell, 1, 0, 4,
                               embedding_fn=lambda t: nn.functional.one_hot(t, vocab),
                               output_fn=lambda h: h @ proj)
    return nn.dynamic_decode(dec, init, max_step_num=12)


def _holding(layer, **sublayers):
    """``layer`` with ``sublayers`` set as its attributes."""
    for name, sub in sublayers.items():
        setattr(layer, name, sub)
    return layer


def _clip_run(fn, limit, *grads):
    """``fn`` (``nn.clip_grad_norm_`` / ``clip_grad_value_``) on parameters
    whose ``.grad`` are ``grads``: the clipped gradients and what it
    returns."""
    import torch

    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = g.detach().clone()
    total = fn(params, limit)
    return [p.grad for p in params] + ([] if total is None else [total])


def _grad_mode_run(ex, x):
    import torch

    with ex.set_grad_enabled(False):
        off = (x.requires_grad and (x * 2).requires_grad)
    return [off, torch.is_grad_enabled()]


def _to_cpu(v, n):
    """A card value on the CPU (its first ``n`` samples when ``n``)."""
    import torch
    from paddle_tpu_torch.framework.tensor import unwrap

    v = unwrap(v)
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v[:n] if n and v.dim() else v).cpu()
    if isinstance(v, (list, tuple)):
        return type(v)(_to_cpu(x, n) for x in v)
    if isinstance(v, dict):
        return {k: _to_cpu(x, n) for k, x in v.items()}
    return v


def _tensors(v):
    import torch
    from paddle_tpu_torch.framework.tensor import unwrap

    v = unwrap(v)
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _tensors(x)]
    if isinstance(v, dict):
        return [t for x in v.values() for t in _tensors(x)]
    return []


def _weighted_sum(outs, n=None):
    """A fixed non-constant weighting of the float outputs (first ``n``
    samples when ``n``), for the backward."""
    import torch

    total = 0.0
    for k, t in enumerate(outs):
        if not (t.is_floating_point() or t.is_complex()) or not t.requires_grad:
            continue
        t = torch.view_as_real(t.resolve_conj()) if t.is_complex() else t
        t = t[:n] if n and t.dim() else t
        c = torch.cos(torch.arange(t.numel(), device=t.device, dtype=torch.float32) * 0.7
                      + k) + 0.5
        total = total + (t.float() * c.reshape(t.shape)).sum()
    return total


def _agree(got, want, tol):
    """``got`` (card, already on the CPU) within ``tol`` of ``want``: the
    largest error, or None where they disagree in kind, shape or value."""
    import torch

    g_t, w_t = _tensors(got), _tensors(want)
    if len(g_t) != len(w_t):
        return None
    if not g_t:
        return 0.0 if got == want else None
    worst = 0.0
    for a, b in zip(g_t, w_t):
        if a.shape != b.shape or a.dtype != b.dtype:
            return None
        if a.is_complex():
            a, b = torch.view_as_real(a.resolve_conj()), torch.view_as_real(b.resolve_conj())
        if not a.is_floating_point():
            if not torch.equal(a, b):
                return None
            continue
        err = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        if not within(a, b, tol, scaled=True):
            return None
        worst = max(worst, err)
    return worst


def _random_checks(name, out):
    """The draws of a random case: support and moments."""
    import torch
    from paddle_tpu_torch.framework.tensor import unwrap

    if name == "class_center_sample":
        remapped, sampled = (unwrap(t) for t in out)
        return bool((torch.diff(sampled) > 0).all()) and int(remapped.min()) >= 0
    t = unwrap(out).float()
    finite = bool(torch.isfinite(t).all())
    if name == "gumbel_softmax":
        return finite and bool(torch.allclose(t.sum(-1), torch.ones_like(t[..., 0]), atol=1e-5))
    if name.startswith("dropout"):          # a draw a (sample, channel), p 0.5
        units = t.shape[0] * t.shape[1]
        zeros = float((t == 0).float().mean())
        return finite and abs(zeros - 0.5) <= max(0.15, 5 * (0.25 / units) ** 0.5)
    return finite and t.numel() > 0


def _nn_tail_surface(seed, dev="cuda", size="card", leg1=()):
    """Leg 2: every name the slice added, once on ``dev``, against the same
    call on the CPU in fp32 (TF32 off), forward and the backward of a fixed
    weighted sum of its float outputs; where the CPU recomputes only the
    first samples, the gradients of the batch's inputs are compared.
    ``size`` "tiny" (with ``dev`` "cpu") rehearses the table here."""
    import copy

    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch import fft, signal
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import extras

    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    checked, errors, worst = [], [], {}
    t0 = time.perf_counter()
    with _tf32(False, False):
        for name, group, inputs, fn, samples in _nn_tail_cases(gen, dev, size):
            n = NN_TAIL_SAMPLES.get(samples)
            # the batch's inputs: the first and those of its rank and batch
            lead = inputs[0].shape[:1] if inputs and inputs[0].dim() else None
            per_sample = [n is not None and isinstance(t, torch.Tensor)
                          and t.dim() == inputs[0].dim() and t.shape[:1] == lead
                          for t in inputs]
            if isinstance(fn, tuple):                    # ("layer", ctor, call)
                _, ctor, call = fn
                layer_cpu = ctor()
                layer_dev = copy.deepcopy(layer_cpu).to(dev)
                fn_dev = (lambda *a, m=layer_dev, c=call: c(m, *a) if c else m(*a))
                fn_cpu = (lambda *a, m=layer_cpu, c=call: c(m, *a) if c else m(*a))
            else:
                fn_dev = fn_cpu = fn
            diff = group not in ("exact", "random")
            dev_in = [t.detach().clone().requires_grad_(diff and t.is_floating_point())
                      if isinstance(t, torch.Tensor) else t for t in inputs]
            paddle.seed(seed)
            got = fn_dev(*dev_in)
            checked.append(name)
            if group == "random":
                if not _random_checks(name.split("(")[0], got):
                    errors.append(f"{name}: draws outside their support or moments")
                continue
            cpu_in = [_to_cpu(t, n if ps else None).requires_grad_(diff and t.is_floating_point())
                      if isinstance(t, torch.Tensor) else t for t, ps in zip(inputs, per_sample)]
            want = fn_cpu(*cpu_in)
            err = _agree(_to_cpu(got, n), _to_cpu(want, None), NN_TAIL_TOL[group][0])
            if err is None:
                errors.append(f"{name}: values disagree")
                continue
            worst[name] = err
            leaves = [i for i, t in enumerate(dev_in) if isinstance(t, torch.Tensor)
                      and t.requires_grad and (n is None or per_sample[i])]
            g_loss, w_loss = _weighted_sum(_tensors(got), n), _weighted_sum(_tensors(want))
            if not (leaves and torch.is_tensor(g_loss) and g_loss.requires_grad):
                continue
            g_grads = torch.autograd.grad(g_loss, [dev_in[i] for i in leaves],
                                          allow_unused=True)
            w_grads = torch.autograd.grad(w_loss, [cpu_in[i] for i in leaves], allow_unused=True)
            for i, gg, wg in zip(leaves, g_grads, w_grads):
                gg = torch.zeros_like(dev_in[i]) if gg is None else gg
                wg = torch.zeros_like(cpu_in[i]) if wg is None else wg
                gerr = _agree(_to_cpu(gg, n), wg, NN_TAIL_TOL[group][0])
                if gerr is None:
                    errors.append(f"{name}: gradient of input {i} disagrees")
                else:
                    worst[name] = max(worst[name], gerr)
    seconds = time.perf_counter() - t0
    # every public name of nn.functional, nn, ops.extras, fft and signal is
    # in the table or in leg 1 (``leg1``: the labels of its runs)
    want_names = (set(F.__all__) | {n for n, v in vars(tnn).items() if n[:1].isupper()
                                    or (callable(v) and not n.startswith("_"))}
                  | set(extras.__all__) | {f"fft.{n}" for n in fft.__all__}
                  | {f"signal.{n}" for n in signal.__all__})
    have = {c.split("(")[0] for c in checked} | {c.split("(")[0][3:] for c in checked
                                                  if c.startswith("nn.")}
    have |= {label.split()[0].split(".")[-1] for label in leg1}
    missing = sorted(n for n in want_names if n not in have)
    return {"names_checked": len(checked), "missing": missing, "errors": errors,
            "max_abs_err": worst, "seconds": seconds}


def phase_nn_tail(seed):
    """The rest of ``nn``, ``ops.extras``, ``fft`` and ``signal``: leg 1
    the entries that reach kernels (``nn.RMSNorm`` / ``F.rms_norm``,
    ``F.flash_attn_qkvpacked``, ``F.flash_attn_unpadded``) at full width
    with their launches counted; leg 2 every other name once against the
    CPU."""
    kernels, launches, leg1 = _nn_tail_kernels(seed)
    surface = _nn_tail_surface(seed, leg1=leg1)
    worst = sorted(surface["max_abs_err"].items(), key=lambda kv: -kv[1])
    log(f"nn_tail: leg 2 checked {surface['names_checked']} names against the CPU in "
        f"{surface['seconds']:.1f} s; limits "
        f"{json.dumps({g: t for g, (t, _) in NN_TAIL_TOL.items()})}; max errors, largest "
        f"first {json.dumps(dict(worst))}")
    log(f"nn_tail: launches {json.dumps(launches)}")
    check(not surface["missing"], f"nn_tail: names not run on the card: {surface['missing']}")
    check(not surface["errors"], f"nn_tail: {surface['errors']}")
    return {"launches": launches, "kernels": kernels,
            "names_checked": surface["names_checked"], "max_abs_err": surface["max_abs_err"]}


SOURCES = {
    "rms_norm": ("paddle_tpu_torch/kernels/csrc/rms_norm.cu",
                 "paddle_tpu/kernels/rms_norm.py:38"),
    # _rms_bwd_rule, XLA in the JAX package (no pallas_call)
    "rms_norm_bwd": ("paddle_tpu_torch/kernels/csrc/add_rms_norm.cu",
                     "paddle_tpu/kernels/rms_norm.py:77"),
    "decode_attention_dense": ("paddle_tpu_torch/kernels/csrc/decode_attention.cu",
                               "paddle_tpu/kernels/decode_attention.py:194"),
    "decode_attention_paged": ("paddle_tpu_torch/kernels/csrc/decode_attention.cu",
                               "paddle_tpu/kernels/decode_attention.py:490"),
    "flash_attention_fwd": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:210"),
    "flash_attention_bwd": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:447"),
    # the same kernels at ERNIE-base's non-causal fp32 attention
    "flash_attention_fwd_noncausal": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                                      "paddle_tpu/kernels/flash_attention.py:210"),
    "flash_attention_bwd_noncausal": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                                      "paddle_tpu/kernels/flash_attention.py:447"),
    "adamw": ("paddle_tpu_torch/kernels/csrc/adamw.cu", "paddle_tpu/kernels/adamw.py:79"),
    "ssd_scan": ("paddle_tpu_torch/kernels/csrc/ssd_scan.cu",
                 "paddle_tpu/kernels/ssd_scan.py:159"),
    "ssd_scan_bwd": ("paddle_tpu_torch/kernels/csrc/ssd_scan_bwd.cu",
                     "paddle_tpu/kernels/ssd_scan.py:226"),
    "fuse_swiglu_mlp": ("paddle_tpu_torch/kernels/csrc/fused_gemm.cu",
                        "paddle_tpu/kernels/emit.py:111"),
    "fuse_swiglu_mlp_bwd": ("paddle_tpu_torch/kernels/csrc/fused_gemm.cu",
                            "paddle_tpu/kernels/emit.py:165"),
    "fuse_add_rms_norm": ("paddle_tpu_torch/kernels/csrc/add_rms_norm.cu",
                          "paddle_tpu/kernels/emit.py:111"),
    "fuse_add_rms_norm_bwd": ("paddle_tpu_torch/kernels/csrc/add_rms_norm.cu",
                              "paddle_tpu/kernels/emit.py:165"),
    "fuse_rms_norm_head": ("paddle_tpu_torch/kernels/csrc/fused_gemm.cu",
                           "paddle_tpu/kernels/emit.py:111"),
    "fuse_rms_norm_head_bwd": ("paddle_tpu_torch/kernels/csrc/fused_gemm.cu",
                               "paddle_tpu/kernels/emit.py:165"),
    "injected_write_race": ("paddle_tpu_torch/kernels/csrc/injected.cu",
                            "paddle_tpu/kernels/registry.py:152"),
    "injected_parallel_carry": ("paddle_tpu_torch/kernels/csrc/injected.cu",
                                "paddle_tpu/kernels/registry.py:176"),
}
# a site's launches that live in a second source
ALSO_SOURCE = {"fuse_rms_norm_head_bwd": "paddle_tpu_torch/kernels/csrc/add_rms_norm.cu"}
ALSO_REPLACES = {
    "decode_attention_dense": "paddle_tpu/kernels/decode_attention.py:87",
    "decode_attention_paged": "paddle_tpu/kernels/decode_attention.py:389",
    "flash_attention_fwd": "paddle_tpu/kernels/flash_attention.py:115",
    "flash_attention_bwd": "paddle_tpu/kernels/flash_attention.py:290",
}


# the path whose run ``launches`` reports for each kernel
MAIN_PATH = {"rms_norm": "engine", "rms_norm_bwd": "train",
             "decode_attention_dense": "generate", "decode_attention_paged": "engine",
             "flash_attention_fwd": "train", "flash_attention_bwd": "train", "adamw": "train",
             "flash_attention_fwd_noncausal": "ernie_train",
             "flash_attention_bwd_noncausal": "ernie_train",
             "ssd_scan": "ssd_train", "ssd_scan_bwd": "ssd_train",
             **{name: "fuse_train" for name in ("fuse_swiglu_mlp", "fuse_swiglu_mlp_bwd",
                                                "fuse_add_rms_norm", "fuse_add_rms_norm_bwd",
                                                "fuse_rms_norm_head", "fuse_rms_norm_head_bwd")},
             "injected_write_race": "kernel_gate", "injected_parallel_carry": "kernel_gate"}


def kernel_table(cases, paths):
    out = []
    for name, recs in cases.items():
        main = recs[0]
        src, rep = SOURCES[name]
        by_path = {p: rec["launches"].get(name, 0) for p, rec in paths.items()}
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": by_path.get(MAIN_PATH[name]),
                 "launches_by_path": by_path,
                 # decode paths carry per-forward counts, training paths per-step ones
                 "launches_per_decode_step": {
                     p: rec["launches_per_decode_forward"].get(name, 0)
                     for p, rec in paths.items() if "launches_per_decode_forward" in rec},
                 "launches_per_train_step": {
                     p: rec["launches_per_step"][0].get(name, 0)
                     for p, rec in paths.items() if "launches_per_step" in rec},
                 "max_abs_err": main["max_abs_err"],
                 "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": main["library_ms"], "cases": recs}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name in ALSO_SOURCE:
            entry["also_source"] = ALSO_SOURCE[name]
        out.append(entry)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth of the Llama 8B serving phase (width is never cut)")
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    # launch_train's training program, run under the launcher
    ap.add_argument("--launch_child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--launch_store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not (REPO / "paddle_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: paddle_tpu_torch is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if args.launch_child:
        return launch_child(args.launch_child, args.launch_store, args.seed)

    t_start = time.perf_counter()
    laps = [("start", t_start)]             # (phase, time it ended)

    def lap(phase):
        laps.append((phase, time.perf_counter()))
        log(f"chip_smoke: {phase} done in {laps[-1][1] - laps[-2][1]:.1f} s")
    cases, paths = {}, {}
    try:
        card = phase_card()
        lap("card")
        if "build" in phases or "kernels" in phases or "kernel_gate" in phases:
            phase_build()
            lap("build")
        if "kernels" in phases:
            cases = phase_kernels()
            lap("kernels")
        if "kernel_gate" in phases:
            paths["kernel_gate"] = phase_kernel_gate(args.seed)
            lap("kernel_gate")
        if "parity" in phases:
            phase_parity(args.seed)
            lap("parity")
        if "incubate" in phases:
            paths["incubate"] = phase_incubate(args.seed)
            lap("incubate")
        if "train" in phases:
            paths["train"] = phase_train("profile" in phases)
            lap("train")
        if "eager_train" in phases:
            paths["eager_train"] = phase_eager_train(args.seed, paths.get("train"))
            lap("eager_train")
        if "static_graph" in phases:
            paths["static_graph"] = phase_static_graph(args.seed, card)
            lap("static_graph")
        if "longctx_train" in phases:
            paths["longctx_train"] = phase_longctx_train("profile" in phases)
            lap("longctx_train")
        if "fuse_train" in phases:
            paths["fuse_train"] = phase_fuse_train("profile" in phases, paths.get("train"))
            lap("fuse_train")
        if "moe_train" in phases:
            paths["moe_train"] = phase_moe_train("profile" in phases)
            lap("moe_train")
        if "ernie_train" in phases:
            paths["ernie_train"] = phase_ernie_train(args.seed, "profile" in phases)
            lap("ernie_train")
        if "ocr_train" in phases:
            paths["ocr_train"] = phase_ocr_train(args.seed, "profile" in phases)
            lap("ocr_train")
        if "hapi_train" in phases:
            paths["hapi_train"] = phase_hapi_train(args.seed, card, paths.get("ernie_train"))
            lap("hapi_train")
        if "nn_tail" in phases:
            paths["nn_tail"] = phase_nn_tail(args.seed)
            lap("nn_tail")
        if "ssd_train" in phases:
            paths["ssd_train"] = phase_ssd_train("profile" in phases)
            lap("ssd_train")
        resume = None
        if "resume_train" in phases:
            resume = phase_resume_train()
            lap("resume_train")
        if "launch_train" in phases:
            phase_launch_train(args.seed, card, resume)
            lap("launch_train")
        if "optimizers" in phases:
            phase_optimizers(args.seed)
            lap("optimizers")
        model = None
        if "serve" in phases:
            serve_paths, model = phase_serve(args.seed, args.layers)
            paths.update(serve_paths)
            if "profile" in phases:
                phase_profile(model, args.seed)
            lap("serve")
        if "router_serve" in phases:
            paths.update(phase_router_serve(args.seed, args.layers, model))
            lap("router_serve")
        del model
        torch.cuda.empty_cache()
        if "moe_serve" in phases:
            paths.update(phase_moe_serve(args.seed))
            lap("moe_serve")
        if "ssd_serve" in phases:
            paths.update(phase_ssd_serve(args.seed, "profile" in phases))
            lap("ssd_serve")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: phases {phases} in {time.perf_counter() - t_start:.1f} s; seconds by "
        f"phase {json.dumps({b[0]: round(b[1] - a[1], 1) for a, b in zip(laps, laps[1:])})}")
    if cases:
        log(json.dumps({"kernels": kernel_table(cases, paths)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
