"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py
    python3 chip_smoke.py --contend 11    # beside 11 processes that spin

``--contend N`` runs the same phases beside ``N`` processes that spin on
the host's CPUs for the run's length (stopped on exit): the run of a host
slower on host work, the card's work unchanged, to see how far the
script's wall stays under its limit there.

Phases, in order; any failed check raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` for
   ``sm_90a`` and print the build seconds;
3. for each kernel, at the shapes the two main paths give it, check the
   kernel against its plain PyTorch version on the card and time both:
   the curves' kernels bitwise at 4 p_miss lanes x 4 workers x a 64 x 64
   batch of embeddings (contention at bits 8 and 16; the winner-routed
   backward at the 5-lane stack, the noisy lanes and the ideal lane) and
   at the serving tick's 16 workers x 8 slots x 1024 bf16 features; the
   fused pooling epilogue (``maxpool.decode``) timed at both shapes in the
   noisy site's form from the float features (its codes formed in the
   kernel) and from codes, and held bitwise for every subset of its
   outputs from both, with and without a winner, under a per-lane mask
   and the paths' mask; the contention over the float features that forms
   its words, hashes its own sensing bits and reduces its accounting
   (``ocs_contention.noisy``) bitwise against the words + packed draw +
   tournament + accounting also with float16, per-worker ``p_keep``,
   padded id sub-slots, 64 workers and 1 and 64 rounds, and under the
   fault paths' operands (a per-lane worker mask with a dark lane and a
   per-lane, per-worker ``p_keep``) at both paths' shapes; the fault
   pool's forward and backward with an outage lane against the CPU; the
   sweep's kernels timed at its largest groups (``ocs_quant.encode`` over
   the clean bits-16 group, 272 lanes x 64 workers x 64; the contention
   and the pooling epilogue over the noisy bits-16, 64-worker sub-group,
   80 lanes, per-worker ``p_keep``);
   flash attention
   within the JAX parity test's tolerances at the prefill shapes and the
   JAX test's float32 GQA cases, timed at S 256, 1024 and 4096; at phase
   34's shapes (a rank's 8 of 16 workers and heads) ``maxpool.fwd`` and
   ``maxpool.ties_bwd`` bitwise, flash within its limit; the same at
   every shape phase 35 gives them, on a rank and in its one-device runs
   (:func:`check_tp_model_sites`), and ``noisy``/``maxpool.decode`` at
   whisper's 2-row tick;
4. check that at ``p_miss=0`` ``Protocol.ocs(bits).aggregate`` equals
   ``Protocol.ideal_max(bits, tie_break="first").aggregate`` bitwise,
   forward and input gradient, at bits 8 and 16;
5. run ``run_curves`` at the fedocs-cifar width (4 workers, 32 x 32 images,
   encoders (256, 128), K = 64, head (512, 512, 512), 10 classes) for 60
   steps with every launch count set to 0 just before and read just after;
   every kernel of the path must have launched (the fused contention once
   per step and evaluation, ``maxpool.decode`` once per noisy and once per
   ideal pooling, the winner-routed backward once per step over the whole
   lane stack; ``ocs_quant.encode``, the standalone ``maxpool.fwd`` and
   ``ocs_quant.decode`` and the packed draw never), every loss be finite,
   and the ``p_miss=0`` lanes must have trained bit for bit as the ideal
   runs;
6. run a small grid on the card and on the CPU (plain versions) and
   compare losses and accuracies;
7. profile a short run at the curves' width (device busy time, idle share,
   time by kernel; the table goes to ``chiprun_out/``);
8. serve ``qwen1.5-0.5b`` at its full width (bf16, random weights from a
   seed, flash prefill) with ``Protocol.ocs(bits=8, p_miss=0.05)`` in every
   decode tick: 8 Poisson requests of 256-token prompts for 16 tokens
   over 8 slots, launch counts set to 0 just before and read just after;
   flash must launch once per layer per request, the fused contention
   and ``maxpool.decode`` once per layer per tick (``ocs_quant.encode``,
   ``maxpool.fwd``, ``ocs_quant.decode``, the winner backward and the
   packed draw never), every logit be finite and the billing add up;
9. check that at ``p_miss=0`` the OCS engine serves the tokens of
   ``Protocol.ideal_max(8, "first")`` at the full width;
10. serve the reduced qwen config on the card and on the CPU and compare
    prefill logits and tokens;
11. profile 10 decode ticks at the full width: device launches per tick,
    the port's kernel launches per tick and the idle share (the table goes
    to ``chiprun_out/``);
12. run ``run_scheduled_curves`` at the fedocs-cifar width with
    ``CollisionAdaptiveBits((8, 16))`` (launch counts, depth switches),
    with thresholds that make it switch (the 16-bit branch at this
    width), and with ``FixedBits(8)``, whose lanes must equal phase 5's
    bits-8 lanes bit for bit; profile 10 steps of the first and the last
    (wall, idle share: the cost of the per-step read of the depth);
13. run ``run_fault_curves`` at the same width: ``FaultModel.iid`` lanes
    at phase 5's p_miss values, bit for bit phase 5's lanes, then
    ``benchmarks/fault_sweep.py``'s burst grid under ``stale`` and
    ``zero_fill`` (launch counts, dropped and outage frames, every loss
    finite); profile 10 steps of iid lanes beside ``run_curves``;
14. serve phase 8's traffic under bursts and worker outages with
    ``retry(2)`` and ``stale`` (launch counts, outage ticks, degraded
    tokens, retry ticks, every logit finite, the billing); profile 10
    faulty decode ticks;
15. run a small scheduled grid, a small fault grid and the reduced
    serving config under faults on the card and on the CPU and compare;
16. run ``run_sweep`` over ``benchmarks/bench_sweep.py``'s full grid (the
    14 registry scenarios and N 4/16/64 x bits 8/16 x p_miss 0/.01/.05/.1
    x channels 1/4, K = 64, 4 rounds) and ``benchmarks/bench_comm.py``'s
    two sweeps with launch counts (``ocs_contention.noisy`` and
    ``maxpool.decode`` once per (bits, id_bits) sub-group, the standalone
    ``ocs_quant.encode`` once per clean bits group, ``winner_bwd`` and
    flash never), every field of both engines and both latencies bitwise
    against the same sweeps on the CPU (plain versions; run in the
    background pool from the end of phase 3 on), and the rows;
17. run ``run_curves_dp`` at the fedocs-cifar width with 2 DP ranks and
    ``CompressedAllReduce.topk(1/8)`` (``benchmarks/bench_curves.py``'s
    DP settings) with launch counts (the fused contention and
    ``maxpool.decode`` once per step and evaluation over the whole (lane,
    rank) stack, ``winner_bwd`` once per step), the measured DP payload
    equal to the analytic bill at every logged step and over the run,
    a reduced grid on the card against the CPU, and a 10-step profile;
18. run ``launch/train`` at the full qwen1.5-0.5b width (bf16, random
    weights from seed 0, ``--fusion max``, flash), batch 8 x 256 tokens,
    ``adamw(for_arch(...))``, 6 steps with a checkpoint every 3, counted
    (flash 24, ``maxpool.fwd`` 48 and ``maxpool.ties_bwd`` 48 a step,
    nothing else), every loss finite, the peak device memory; a second
    uninterrupted run bitwise the first; the job
    preempted after its step-3 checkpoint and relaunched, bitwise the
    uninterrupted run; ``launch/serve --ckpt-dir --sample`` serving phase
    8's traffic from the final checkpoint, its values bitwise the
    trainer's, counted; then profile 5 train steps (wall, device busy,
    idle share, kernels a step, time by kernel class; the flash
    backward's plain recompute, the xent and the AdamW update alone);
    phase 3 also holds ``maxpool.fwd`` (every subset of its outputs; forced
    ties, +-0, a NaN row, a ragged and a misaligned width) and
    ``maxpool.ties_bwd`` (against its plain version and ``g * (h ==
    max)``) at the train step's site shape, and times them beside
    ``torch.max(dim=0)`` and that composition;
19. run ``trainer.train`` over ``vertical.loss_fn`` at the fedocs-cifar
    width through ``Protocol.ocs(bits=8, p_miss=0.05)`` under bursts and
    dropouts with a ``FaultState`` carry, per-step channel keys and top-k
    0.5 compression, counted (``noisy``, ``maxpool.decode`` and
    ``winner_bwd`` once a step); relaunched after its step-4 checkpoint,
    bitwise the uninterrupted run; a small configuration card vs CPU;
20. sample (``ServeConfig(greedy=False)``) on the reduced qwen config on
    the card and on the CPU: the same tokens;
21. run ``launch/train`` at the full qwen3-moe-30b-a3b width (d_model
    2048, 32 heads of 128 over 4 KV heads, 128 experts of 768, top 8),
    the depth cut to 4 of 48 layers, bf16, random weights from seed 0,
    ``--fusion max``, flash, 8 x 256 tokens, 3 steps, counted (flash,
    ``maxpool.fwd`` and ``maxpool.ties_bwd`` 4 each a step, nothing
    else), every loss finite, the peak device memory; a second run
    bitwise the first; then profile 3 steps; phase 3 also holds flash at
    (1 and 8, 32, 256, 128) with 4 KV heads (GQA 8:1) beside
    ``scaled_dot_product_attention``, and the max site's pair at (16, 8
    x 256 x 2048);
22. serve phase 8's traffic with that model (``tp_fusion="max"``, OCS p
    0.05): 0 channel slots and 0 uplink bits billed (an all-MoE plan has
    no channel site), counted (flash once per layer per request,
    ``maxpool.fwd`` once per layer per prefill and per tick), every logit
    finite; profile 10 decode ticks;
23. build one layer of llama4-scout-17b-a16e, glm4-9b, minicpm-2b and
    qwen2.5-32b at full width, each serving 2 requests of 64-token
    prompts for 4 tokens under OCS p 0.05, counted, every logit finite;
24. run the reduced qwen3-moe and llama4 configs, both ``moe_impl``
    forms, on the card and on the CPU: 3 trainer steps' losses within
    1e-3, and the same served tokens;
25. run ``launch/train`` at the full xlstm-125m width and depth (12
    layers, 3 mLSTM : 1 sLSTM, d_model 768, 4 heads, d_inner 1536, 16
    workers), bf16, ``--fusion max``, ``XLSTM_BATCH`` x 256 tokens, 2
    steps, counted (``maxpool.fwd`` and ``maxpool.ties_bwd`` 9 each a
    step: the mLSTM sites; nothing else), every loss finite, the peak
    device memory; a second run bitwise the first; then profile a step;
    phase 3 also holds ``maxpool.fwd`` and ``ties_bwd`` at the mLSTM site
    (16, ``XLSTM_BATCH`` x 256 x 768) and ``maxpool.fwd`` at jamba's mamba
    site (16, 64 x 8192), both timed with the L2 evicted before each
    call, ``maxpool.fwd`` at phases 26-27's prefill and tick widths,
    ``noisy`` and ``maxpool.decode`` at jamba's mlp site in a tick, and
    flash at jamba's (1, 64, 64, 128) Hkv 8;
26. serve phase 8's traffic with that model (``tp_fusion="max"``, OCS p
    0.05): 0 channel slots and 0 uplink bits (no mlp site), counted
    (``maxpool.fwd`` 9 per prefill and per tick, nothing else), every
    logit finite; the same traffic under phase 14's bursts and outages
    with ``retry(2)`` (some held ticks); profile 10 decode ticks;
27. serve one 8-layer period of jamba-1.5-large at its full width (the
    experts cut 16 -> 4), 2 requests of 64-token prompts for 4 tokens,
    OCS p 0.05, counted from the layout (flash per request;
    ``maxpool.fwd`` at the mamba, attention and mlp sites in a prefill and
    at the mamba and attention sites in a tick; ``noisy`` and
    ``maxpool.decode`` at the 4 mlp sites a tick), every logit finite, the
    peak device memory; profile 10 decode ticks;
28. run the reduced xlstm and jamba configs on the card and on the CPU:
    3 trainer steps' losses within 1e-3, and the same served tokens
    channel-free, under OCS and under ``retry(2)`` (the held ticks'
    copy-on-hold of the recurrent states); ``mamba_assoc_scan`` on the
    card within 1e-3 of the sequential scan;
29. run ``launch/train`` at the full whisper-base width and depth (6 + 6
    layers, d_model 512, 8 heads of 64, 16 workers, vocab 51,865, tied),
    bf16, ``--fusion max --use-flash``, 8 x 384 frames and decoder
    tokens, 6 steps with a checkpoint every 3, counted (flash 12, 6
    non-causal and 6 causal, ``maxpool.fwd`` and ``ties_bwd`` 12 each a
    step; nothing else), every loss finite, the peak device memory; a
    second run and a relaunch after the step-3 checkpoint bitwise the
    first; profile 3 steps; phase 3 also holds flash (two ulps of each
    query row's largest value) at the slice's shapes (whisper's non-causal
    encoder at 384 and 1,408 frames, its causal decoder at 384 and 4
    tokens, pixtral's GQA 4:1 at head_dim 128 at (2, 32, 1024) and (8, 32,
    256)) beside the library, ``maxpool.fwd``
    and ``ties_bwd`` at the whisper and pixtral train sites and
    ``maxpool.fwd`` at their serve widths, and ``noisy`` and
    ``maxpool.decode`` at both tick sites;
30. serve whisper-base with phase 29's values: 8 requests of 1,408
    frames and the 4-token start-of-transcript prompt, greedy for 60
    tokens through ``prefill`` and ``decode_step_channel`` under OCS p
    0.05, counted (flash 12 and ``maxpool.fwd`` 12 a prefill, ``noisy``
    and ``maxpool.decode`` 6 each a tick), every logit finite; at p 0 the
    tokens those of ``ideal_max(8, "first")``; profile 10 ticks;
31. pixtral-12b at full width: serve at full depth (40 layers), 2
    requests of 1,024 patch features for 8 tokens under OCS p 0.05,
    counted (a prefill: flash 40, ``maxpool.fwd`` 80; a tick:
    ``maxpool.fwd``, ``noisy`` and ``maxpool.decode`` 40 each), every
    logit finite, the init peak under a bound from the tree's bytes, the
    serving peak, 10 ticks profiled; then
    ``launch/train`` cut to 4 layers, 3 steps of 8 x 256 patches, counted
    (flash 4, ``maxpool.fwd`` and ``ties_bwd`` 8 each a step), the peak
    under 79.18 GiB, a second run bitwise the first;
32. run the reduced whisper and pixtral configs on the card and on the
    CPU: 3 trainer steps' losses within 1e-3, and the same tokens from a
    prefill and 8 greedy ticks, ideal and under OCS;
33. run the channel engines over ``torch.distributed`` ranks: ``run_curves``
    at phase 5's config on one NCCL rank in this process, bitwise phase
    5's result; then two gloo ranks sharing the card (``spawn`` start
    method, a process-group timeout and a join deadline) run
    ``run_curves`` at phase 5's config, phase 16's sweep grid and
    ``run_curves_dp`` at phase 17's settings with the DP axis on the
    ranks, every rank's result bitwise phases 5, 16 and 17's in every
    field, the DP payload the bill at every logged step, each rank's
    launches counted and held to its block's share;
34. run the dense LM stack over a (1 data x 2 model) mesh of two gloo
    ranks sharing the card (``spawn`` start method, a process-group
    timeout and a join deadline): qwen1.5-0.5b at full width and depth,
    bf16, seed-0 weights, ``tp_fusion="max"``, flash, each rank holding 8
    of 16 workers and heads and half the vocabulary.  (i) ``trainer.train``
    for 3 of phase 18's steps (its batches and optimizer), the losses
    within ``TP_LOSS_ATOL_FIRST`` and ``TP_LOSS_RTOL`` of phase 18's first
    three and step 1's gathered gradient norm within
    ``TP_GRAD_NORM_RTOL`` of phase 18's, each rank's launches a step
    phase 18's, the collective bytes a step by op and type; then the same
    run under a control fault (``wk``/``wv`` outside the *f* copy), which
    must fail both limits; (ii) 4 of phase 8's requests under OCS p 0.05
    with ``tp_fusion="max"`` against a one-device run of the same traffic
    in this process, launches per rank counted; on every rank the max
    site (forward and gradient) and the channel site (pooled value and
    accounting) on its block of an equal stack bitwise the one-device
    law; where the tokens, channel slots or bits differ, the split
    products that are not bitwise the one-device product must be named
    (probed at a tick's, a prefill's and a step's rows) and the float32
    logits of a prefill and 2 decode steps held within
    ``TP_LOGITS_RTOL`` of their largest magnitude, which a control fault
    (one worker's partial lost at the last MLP site) must exceed;
35. run the MoE, recurrent and encoder-decoder models over the same (1 x
    2) mesh, each against a one-device run of the same cut in this
    process: qwen3-moe-30b-a3b at 2 of 48 layers (64 of 128 experts a
    rank: the rank's slots built, its experts run, the slot outputs
    gathered), 3 train steps and 4 of phase 8's requests; xlstm-125m's
    first period (the mLSTM workers and memory split, the sLSTM whole),
    2 steps of 2 x 256 and 2 requests, plain and under ``retry(2)``;
    jamba's phase-27 period (mamba's workers and states split), 2
    requests and the gradient of its mamba layers' norm scales;
    whisper-base (split self- and cross-attention heads, the "plain"
    layout), 2 steps and 2 requests of 1,408 frames; pixtral-12b at 4
    layers, 2 requests of 2 x 1,024 patches.  Step 1's loss and gradient
    norm, later losses, served results, float32 logits and launches held
    as in phase 34 (:func:`run_tp_models_phase`); one control fault a
    family (the MoE dispatch input, mLSTM q and k, mamba's input,
    whisper's encoder output outside the *f* copy) must fail the
    gradient norm's limit;
36. hold the dry-run (``repro_torch.launch.dryrun``: one rank's step
    traced on fake tensors over a fake process group) to the card
    (:func:`run_dryrun_phase`): fake-CUDA traces of a reduced config's
    train, prefill and decode steps count the FLOPs and collectives of
    the same traces on fake CPU tensors; the production cells
    qwen1.5-0.5b and qwen3-moe-30b-a3b ``train_4k`` on the (16, 16) mesh
    traced at full size on fake CUDA tensors and their records printed;
    the (1 x 2) traces of phase 34's step and float32 prefill + 2 decode
    steps and of phase 35's three trained cuts give, op for op, the
    calls and bytes that the gloo ranks recorded there; the dry-run's
    argument bytes of phase 18's 8 x 256 AdamW step equal the bytes the
    caching allocator was asked for before a real step, and
    ``memory_allocated()`` within its rounding (512 bytes a request, and
    a remainder of up to 1 MiB it leaves unsplit in a large block); its
    peak, t_compute and t_memory are printed beside the card's
    ``max_memory_allocated()`` and a step's device busy time; the fake
    traces run in the background pool (two processes, started as phase 3
    ends) while the card's phases run;
37. run the analysis on the card (:func:`run_analysis_phase`): ``python -m
    repro_torch.analysis --device cuda`` in process (the lint, and each
    of the nine registered entries traced on fake CUDA tensors and run
    once on real ones under ``set_sync_debug_mode("error")``), each
    contract's findings, op-stream length, launches and sync verdict
    printed; every entry's fake-CUDA stream (the CLI's own trace) equal,
    op for op but for the device and the port's declared device branches
    (``registry.DEVICE_BRANCHES``), to its fake-CPU stream and holding
    the custom ops of its kernels, which its real run launches; every
    real run sync-free; phase 18's 8 x 256 step with ``remat=True``
    ("full" and "dots") bitwise ``remat=False`` in loss and gradients,
    flash and ``maxpool.fwd`` launched twice a layer and ``ties_bwd`` as
    without remat, each step's ``max_memory_allocated()`` and device ms
    printed; ``launch/train``'s default config for phase 18's flags
    (remat "full", as every full-width config) for ``TP_STEPS`` steps,
    its losses and gradient norms bitwise phase 18's and its launches
    exactly the remat step's;
38. run the seven examples (``repro_torch.examples``) at a shortened
    count on the card (:func:`run_examples_phase`), their lines and wall
    seconds printed;
39. run the split placements of state over a (2 data x 1 model) mesh of
    two gloo ranks sharing the card (:func:`run_split_phase`), each
    against a one-device run in this process: (a) qwen1.5-0.5b whole
    under ``rules_for("long_500k")``, each rank holding its ``kv_seq``
    block of every KV cache (the split-softmax decode): phase 8's first
    request into a 512-position cache for 32 ticks under OCS p 0.05 (the
    writes cross into rank 1's block) and into a 131,072-position cache
    (6 GiB a rank) for 8 ticks, each rank's cache bytes, ms a tick and
    collective bytes a tick printed; (b) phase 34's traffic with each
    rank holding its rows of the engine's cache; both held by phase 34's
    rules (tokens, channel slots and bits equal, else the split product
    named, ``_split_products``; the float32 logits of a prefill and 4
    decode steps over the split cache, and of two rows over the rows
    split, within ``TP_LOGITS_RTOL`` of their largest magnitude, which a
    control fault must exceed: rank 1's softmax denominators unreduced,
    one worker's partial lost); each rank's cache half the one device's;
    launches per rank; (c) phase 18's trainer with AdamW's master weights
    and moments split over the data axis (ZeRO; every rank takes the
    whole batch) to a step-2 checkpoint, relaunched from it to step 3:
    losses and gradient norms bitwise phase 18's, master/m/v bytes a rank
    half of one device's, launches phase 18's a step, and the step-2
    checkpoint restored on one device and trained a step bitwise phase
    18's third step and the ranks' step-3 checkpoint;
40. print one ``{"kernels": [...]}`` line and, last, the device line.

It imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import gc
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port itself: a copy of this script alone fails here
from repro_torch import faults, kernels, tree  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.configs import fedocs_cifar  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import ocs, vertical  # noqa: E402
from repro_torch.data import pipeline, vertical_data  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.maxpool import ops as mp_ops  # noqa: E402
from repro_torch.kernels.maxpool import ref as mp_ref  # noqa: E402
from repro_torch.kernels.ocs_contention import ops as ct_ops  # noqa: E402
from repro_torch.kernels.ocs_contention import ref as ct_ref  # noqa: E402
from repro_torch.kernels.ocs_quant import ops as q_ops  # noqa: E402
from repro_torch.kernels.ocs_quant import ref as q_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, fusion  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import optimizers, schedules  # noqa: E402
from repro_torch.optim.compressed_allreduce import (  # noqa: E402
    CompressedAllReduce)
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.protocol import (CollisionAdaptiveBits,  # noqa: E402
                                  FixedBits, Protocol)
from repro_torch.serve import engine as se  # noqa: E402
from repro_torch.serve.load import poisson_requests  # noqa: E402
from repro_torch.sim import results  # noqa: E402
from repro_torch.sim import scenarios, sweep  # noqa: E402
from repro_torch.sim import train_curves as tc  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
NONTENSOR_OPS_PER_S = 67e12    # H100 SXM float32 rate outside tensor cores
# a site whose operands fit the 50 MB L2 is timed with the L2 evicted
# before each call, by a pass over a buffer of this many bytes
L2_FLUSH_BYTES = 128 * 2**20
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
INT32_LANES = 132 * 64         # H100 SXM: INT32 results per clock (x clock)
# integer operations of one sensing hash in ocs_contention.noisy: threefry's
# 20 add/rotate/xor steps and 5 key injections, the counter, the uniform
# and the compare
OPS_PER_HASH = 80
SM_CLOCK_HZ = 1.98e9           # set from nvidia-smi's clocks.max.sm
LANES, N, B, K, ROUNDS = 4, 4, 64, 64, 3
EVAL_ROWS = 512                # CurveConfig.n_val
# serving: qwen1.5-0.5b (24 layers, d_model 1024, 16 heads of 64, 16
# workers), 8 slots, 8 Poisson requests of 256-token prompts, 16 tokens
# (a depth that keeps the whole script well inside its time limit)
QWEN = "qwen1.5-0.5b"
QWEN_LAYERS, QWEN_D, QWEN_HEADS, QWEN_WORKERS = 24, 1024, 16, 16
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_PROMPT, SERVE_NEW = 8, 512, 256, 16
SERVE_REQUESTS, SERVE_RATE, SERVE_P_MISS = 8, 0.5, 0.05
# the LM trainer: launch/train at the full width, batch 8 x 256 tokens (the
# serving prompt length), 6 steps, a checkpoint every 3
QWEN_PARAMS = 463_987_712
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 256, 6, 3
# the MoE slice: qwen3-moe-30b-a3b at its full width (d_model 2048, 32
# heads of 128 over 4 KV heads, 128 experts of 768, top 8, 16 workers), the
# depth cut to 4 of 48 layers (the optimizer's float32 master weights and
# moments of 48 layers do not fit the card); 3 train steps of 8 x 256
# tokens; serving on phase 8's traffic
QWEN3 = "qwen3-moe-30b-a3b"
LLAMA4 = "llama4-scout-17b-a16e"
MOE_LAYERS, MOE_STEPS, MOE_D = 4, 3, 2048
# the recurrent slice: xlstm-125m at full width and depth (12 layers, 3
# mLSTM : 1 sLSTM, d_model 768, 4 heads, d_inner 1536, 16 workers), 3 train
# steps of XLSTM_BATCH x 256 tokens: the time loop keeps two (16, B, 4, 24,
# 384) float32 memories a token a mLSTM layer for the backward (9 layers x
# 256 tokens x 2 x 2.4 MB x B), and B 5 is the largest batch whose step
# fits the card (peak 60.7 GiB; B 6 runs out of its 79.2 GiB); serving on
# phase 8's traffic.  jamba-1.5-large at full width, one 8-layer period,
# the experts cut 16 -> 4
XLSTM, JAMBA = "xlstm-125m", "jamba-1.5-large-398b"
XLSTM_PARAMS = 141_331_968
XLSTM_BATCH, XLSTM_STEPS, XLSTM_D = 5, 2, 768
JAMBA_EXPERTS, JAMBA_D, JAMBA_PROMPT = 4, 8192, 64
# the encoder-decoder slice: whisper-base at full width and depth (6 + 6
# layers, d_model 512, 8 heads of 64, 16 workers) trains on 8 x 384 frames
# and 384 decoder tokens (the longest --seq whose decoder length min(448,
# seq) the flash kernel's block contract takes), 6 steps, a checkpoint
# every 3, and serves 8 requests of 1,408 frames (the largest multiple of
# 128 inside its 1,500-frame window) with its 4-token start-of-transcript
# prompt (<|startoftranscript|><|en|><|transcribe|><|notimestamps|>) for 60
# tokens; pixtral-12b at full width and depth (40 layers, d_model 5120)
# serves 2 requests of 1,024 patch features (a 512 x 512 image at 16-pixel
# patches) for 8 tokens and trains cut to 4 layers on 8 x 256 patches
WHISPER, PIXTRAL = "whisper-base", "pixtral-12b"
WHISPER_PARAMS = 70_648_320
WHISPER_LAYERS, WHISPER_D = 6, 512
WHISPER_BATCH, WHISPER_SEQ, WHISPER_STEPS = 8, 384, 6
WHISPER_FRAMES, WHISPER_NEW = 1408, 60
WHISPER_SOT = (50258, 50259, 50359, 50363)
PIXTRAL_LAYERS, PIXTRAL_D = 40, 5120
PIXTRAL_PATCHES, PIXTRAL_FEAT, PIXTRAL_NEW = 1024, 1024, 8
PIXTRAL_TRAIN_LAYERS, PIXTRAL_TRAIN_STEPS = 4, 3
# one period (one layer) of each other new config at its full width
WIDE_ARCHS = (LLAMA4, "glm4-9b", "minicpm-2b", "qwen2.5-32b")
WIDE_REQUESTS, WIDE_PROMPT, WIDE_NEW = 2, 64, 4
# the channel trainer hook at the fedocs-cifar width
HOOK_STEPS, HOOK_BATCH = 8, 64
# the sweep: benchmarks/bench_sweep.py's full grid, K 64, 4 rounds (its CPU
# reference takes ~5 s a round)
SWEEP_K, SWEEP_ROUNDS = 64, 4
# the decode ticks a profiled window holds (after 10 timed unprofiled)
PROFILED_TICKS = 5
# the DP curves: benchmarks/bench_curves.py's _DP_SHARDS and _DP_K_FRAC
DP_SHARDS, DP_K_FRAC = 2, 1 / 8
# phase 33: gloo ranks sharing cuda:0 and their process groups' timeout
# (seconds; their processes are killed after twice that)
RANKS, RANKS_TIMEOUT = 2, 75.0
# phase 34: the model axis as gloo ranks sharing cuda:0, their process
# groups' timeout (the join deadline is twice that), 3 train steps and 4
# of phase 8's requests.  The losses: the first step's within 1e-4 of
# phase 18's (the same bf16 products but for the GEMMs over half the
# workers, heads and vocabulary, and a float32 log-sum-exp over the
# vocabulary in another order), the next two within TP_LOSS_RTOL of
# phase 18's, relative.  AdamW's first updates are nearly the gradient's
# sign times the learning rate, so a gradient summed wrong moves the next
# losses little: the control fault (``_qkv_without_f``) moved steps 2-3
# by 4.1e-5 and 3.2e-4 of the loss, the sound run by 1.0e-6 and 1.25e-4.
# Step 1's gathered gradient norm, from equal parameters, tells them
# apart by far more: the sound run 1.8e-5 off phase 18's, the control
# 0.11-0.12 (later steps' norms part as the parameters do: 7.2e-3 at
# step 3).  Both faults must fail their limits.  The float32 logits:
# their largest difference over their largest magnitude (276 here) within
# TP_LOGITS_RTOL: the sound run 1.4e-7, the logits' control fault
# (``_lost_partial``) 1.4e-3.  (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6,
# PR 24.)
TP_RANKS, TP_TIMEOUT, TP_STEPS, TP_REQUESTS = 2, 120.0, 3, 4
TP_LOSS_ATOL_FIRST, TP_LOSS_RTOL = 1e-4, 2e-4
TP_GRAD_NORM_RTOL, TP_LOGITS_RTOL = 1e-3, 1e-5
# phase 35: the MoE, recurrent and encoder-decoder models on the same
# (1 x TP_RANKS) mesh, each held to a one-device run of the same cut in
# the parent under phase 34's limits: qwen3-moe-30b-a3b at 2 of 48 layers
# (64 of 128 experts a rank), 3 train steps of 8 x 256 and 4 of phase 8's
# requests; xlstm-125m's first period (4 of 12 layers), 2 steps of 2 x
# 256 and 2 of phase 8's requests, plain and under retry(2); jamba's
# period of phase 27 (4 of 16 experts), 2 requests and the gradient of
# its mamba layers' norm scales; whisper-base whole, 2 steps of 8 x 384
# and 2 requests of 1,408 frames; pixtral-12b at 4 of 40 layers, 2
# requests of 2 x 1,024 patches.  The ranks' process-group timeout (the
# join deadline is twice that).
TPM_MOE_LAYERS, TPM_MOE_STEPS, TPM_XLSTM_BATCH, TPM_XLSTM_STEPS = 2, 3, 2, 2
TPM_WHISPER_STEPS, TPM_PIXTRAL_LAYERS, TPM_NEW = 2, 4, 8
TPM_TIMEOUT = 300.0
# phase 39: split placements of state over a (2 data x 1 model) mesh of
# gloo ranks sharing cuda:0.  (a) qwen1.5-0.5b whole under
# rules_for("long_500k"): each KV cache split over kv_seq; phase 8's first
# request (a 256-token prompt) into a 512-position cache (256 positions a
# rank) for 32 greedy ticks under OCS p 0.05, so that the writes cross
# into rank 1's block; the long run into a 131,072-position cache (6 GiB
# a rank) for 8 ticks; the float32 logits of a prefill and 4 decode steps.
# (b) phase 34's traffic on the rank's rows of the cache (the default
# rules).  (c) phase 18's trainer with AdamW's master weights and moments
# split over the data axis (ZeRO), every rank taking the whole batch, to a
# step-2 checkpoint and relaunched from it to step 3.  The ranks'
# process-group timeout (the join deadline is twice that).
SPLIT_RANKS, SPLIT_TIMEOUT = 2, 300.0
SPLIT_CACHE, SPLIT_TICKS, SPLIT_LOGIT_STEPS = 512, 32, 4
SPLIT_LONG_CACHE, SPLIT_LONG_TICKS = 131072, 8
ZERO_CKPT_STEP = 2
ZERO_RULES = dict(sharding.DEFAULT_RULES, batch=None)
SOURCES = {"ocs_quant.encode": "ocs_quant.cu",
           "ocs_quant.decode": "ocs_quant.cu", "maxpool.fwd": "maxpool.cu",
           "maxpool.decode": "maxpool.cu", "maxpool.winner_bwd": "maxpool.cu",
           "maxpool.ties_bwd": "maxpool.cu",
           "ocs_contention.contend": "ocs_contention.cu",
           "ocs_contention.noisy": "ocs_contention.cu",
           "flash_attention.fwd": "flash_attention.cu"}
# a substring of each kernel's device function name, for its own time
SYMBOLS = {"ocs_quant.encode": "Encode", "ocs_quant.decode": "Decode",
           "maxpool.fwd": "maxpool_fwd_",
           "maxpool.decode": "maxpool_decode_kernel",
           "maxpool.winner_bwd": "winner_bwd_kernel",
           "maxpool.ties_bwd": "ties_bwd_kernel",
           "ocs_contention.contend": "contend_kernel",
           "ocs_contention.noisy": "noisy_kernel",
           "flash_attention.fwd": "flash_"}
REPLACES = {
    "ocs_quant.encode": "src/repro/kernels/ocs_quant/ocs_quant.py:27",
    "ocs_quant.decode": "src/repro/kernels/ocs_quant/ocs_quant.py:37",
    "maxpool.fwd": "src/repro/kernels/maxpool/maxpool.py:31",
    "maxpool.decode": "src/repro/kernels/maxpool/maxpool.py:31 + "
                      "src/repro/kernels/ocs_quant/ocs_quant.py:37",
    "maxpool.winner_bwd": "src/repro/kernels/maxpool/maxpool.py:72",
    "maxpool.ties_bwd": "src/repro/kernels/maxpool/maxpool.py:72 + "
                        "src/repro/core/fedocs.py:68-79,96-98",
    "ocs_contention.contend":
        "src/repro/kernels/ocs_contention/ocs_contention.py:48",
    "ocs_contention.noisy":
        "src/repro/kernels/ocs_contention/ocs_contention.py:48",
    "flash_attention.fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:32"}


def _time_ms(fn, iters: int = 100) -> float:
    """Mean time per call of ``fn`` called back to back, between two CUDA
    events: for launches this small it is the host's issue rate."""
    for _ in range(5):
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


# one event the profiler recorded on the card: its name, its duration in
# microseconds and its start (ns)
CardEvent = collections.namedtuple("CardEvent", "name us start")


def _card_events(prof) -> list:
    """The card's events of a profiled window, in the order recorded,
    read from the profiler's kineto results: ``prof.events()`` builds an
    event object and a tree for each, ~15x slower, tens of seconds for a
    window of ~10^5 launches."""
    cuda = torch.autograd.DeviceType.CUDA
    return [CardEvent(e.name(), e.duration_ns() / 1e3, e.start_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def _kernel_table(by_name: dict, per: str, rows: int = 60) -> str:
    """A profile's table: each kernel's device milliseconds ``per`` step
    or tick (``by_name``), largest first, and its share of the total."""
    total = sum(by_name.values()) or 1.0
    lines = [f"{'ms ' + per:>14}  {'share':>6}  kernel"]
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:rows]:
        lines.append(f"{ms:14.6f}  {ms / total:6.3f}  {name}")
    return "\n".join(lines) + "\n"


def _device_ms(fn, iters: int = 20, symbol=None, flush=None):
    """(ms, source, own_ms): the device time per call of ``fn``, the summed
    duration of every kernel and memory operation it runs on the card, from
    a profiled window of ``iters`` calls (source ``"profiler"``), and of
    the kernels whose name holds ``symbol`` alone.  Where the profiler sees
    no device time, CUDA-event timing of calls back to back, which is the
    host's issue rate (source ``"events"``), for both; the window is
    profiled a second time before that.  Each call launches the ``symbol``
    kernel once, so where the profiler recorded it fewer than ``iters``
    times (it can drop records) both times are taken per recorded call.
    With ``flush`` (:func:`_l2_flush`: a call that evicts the L2, and the
    names of its kernels) the call runs before each profiled call, and
    its kernels are left out of both times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush[0]()
                fn()
            torch.cuda.synchronize()
        dev = [e for e in _card_events(prof)
               if flush is None or e.name not in flush[1]]
        total_us = sum(e.us for e in dev)
        if total_us:
            break
    if total_us == 0:
        print("profiler saw no device time; timing with CUDA events",
              flush=True)
        ms = _time_ms(fn)
        return ms, "events", ms
    own_us = [e.us for e in dev if symbol is not None and symbol in e.name]
    calls = len(own_us) or iters
    if calls != iters:
        print(f"profiler recorded {calls} of {iters} calls", flush=True)
    return total_us / calls / 1e3, "profiler", sum(own_us) / calls / 1e3


# the kernel that parts the windows of one profiled session
# (torch.cuda._sleep's spin_kernel), the clock cycles it spins, and the
# markers that pad a session at each end: the profiler can drop a
# session's first or last few device events
MARK_KERNEL, MARK_CYCLES, MARK_PAD = "spin_kernel", 1000, 3


def _device_ms_many(calls, flush=None) -> list:
    """:func:`_device_ms` of each ``(fn, iters, symbol)`` of ``calls`` from
    one profiled session: the windows of ``iters`` calls of each fn are
    parted by a marker kernel (``MARK_KERNEL``), the session padded with
    ``MARK_PAD`` more at each end, and the device events between two
    markers, in the card's order, are a window's (the empty stretches
    between the pads dropped).  Where the profiler dropped a marker
    between two windows, each window is timed alone by
    :func:`_device_ms`, and so is a window without device time."""
    for fn, _, _ in calls:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MARK_PAD):
            torch.cuda._sleep(MARK_CYCLES)
        for fn, iters, _ in calls:
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(iters):
                if flush is not None:
                    flush[0]()
                fn()
        for _ in range(MARK_PAD + 1):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    dev = sorted(_card_events(prof), key=lambda e: e.start)
    windows, cur = [], None
    for e in dev:
        if MARK_KERNEL in e.name:
            if cur:
                windows.append(cur)
            cur = []
        elif cur is not None and (flush is None or e.name not in flush[1]):
            cur.append(e)
    if len(windows) != len(calls):
        print(f"profiler recorded {len(windows)} of {len(calls)} windows; "
              "timing each alone", flush=True)
        windows = [[] for _ in calls]
    out = []
    for (fn, iters, symbol), evs in zip(calls, windows):
        total_us = sum(e.us for e in evs)
        if total_us == 0:
            out.append(_device_ms(fn, iters, symbol, flush))
            continue
        own_us = [e.us for e in evs
                  if symbol is not None and symbol in e.name]
        n = len(own_us) or iters
        if n != iters:
            print(f"profiler recorded {n} of {iters} calls", flush=True)
        out.append((total_us / n / 1e3, "profiler", sum(own_us) / n / 1e3))
    return out


def _bound(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        a = a.view(torch.int32 if a.element_size() == 4 else torch.int16)
        b = b.view(a.dtype)
    elif a.dtype in (torch.uint16, torch.uint32):
        a = a.view(torch.int16 if a.dtype == torch.uint16 else torch.int32)
        b = b.view(a.dtype)
    return bool(torch.equal(a, b))


def _check_equal(name, launch, plain, extra) -> float:
    """Run the kernel and its plain version on the same inputs; raise
    unless every output is bitwise equal.  Returns the max abs error."""
    out_k, out_p = launch(), plain()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(outs_k, outs_p):
        if not _bitwise_equal(a, b):
            raise AssertionError(f"{name} {extra}: kernel != plain")
        if a.dtype.is_floating_point:
            d = (a.float() - b.float()).abs()
            d = d[torch.isfinite(d)]
            err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def _contention_operands(dev, lanes, n, cols, bits, seed, dtype, p_miss,
                         n_real=None, id_pad=0, per_worker=False,
                         rounds=ROUNDS):
    """Features, mask, lane keys, p_keep, id bits and the tournament's
    keywords of one call: ``lanes`` x ``n`` workers (the first ``n_real``
    real) x ``cols`` features of ``dtype`` (16 columns where every worker
    ties), ``id_pad`` scan sub-slots past the real id bits, ``p_miss`` per
    lane (and, with ``per_worker``, a little more for each later worker),
    ``rounds`` rounds."""
    n_real = n if n_real is None else n_real
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h = (torch.randn((lanes, n, cols), generator=gen) * 3.0).to(dtype)
    h[:, :, :16] = h[:, :1, :16]
    h = h.to(dev)
    id_bits = ocs.host_id_bits(n_real)
    p = torch.tensor(p_miss[:lanes], device=dev)
    if per_worker:
        p = p[:, None] + 0.01 * torch.arange(n, device=dev)[None]
    p_keep = ocs.sensing_keep_prob(p, dtype, lanes=True)
    keys = jr.split(jr.PRNGKey(bits + seed, dev), lanes)
    mask = torch.arange(n, device=dev) < n_real
    kw = dict(n_slots=bits + id_bits + id_pad, max_rounds=rounds)
    return h, mask, keys, p_keep, id_bits, kw


def _needed_hashes(word, heard, mask, total, n_slots, max_rounds) -> int:
    """The sensing bits ``ocs_contention.noisy`` hashes on these inputs:
    those of an alive, silent worker in a sub-slot d < ``total`` where some
    worker of its column transmits (the tournament of ``ct_ref.contend``,
    counted)."""
    lanes, n, k = word.shape
    w, hd = q_ref.to_int64(word), q_ref.to_int64(heard)
    alive = ct_ref.lane_mask(mask, lanes, n)[:, :, None].expand(lanes, n, k)
    count = 0
    for r in range(max_rounds):
        for d in range(min(n_slots, total)):
            tx = alive & (((w >> (total - 1 - d)) & 1) == 1)
            hbit = ((hd[:, r] >> (n_slots - 1 - d)) & 1) == 1
            any_tx = tx.any(dim=1, keepdim=True)
            count += int((alive & ~tx & any_tx).sum())
            alive = alive & (tx | ~(any_tx & hbit))
    return count


def _kernel_cases(dev, lanes: int, cols: int, bits: int, seed: int,
                  n: int = N, dtype=torch.float32,
                  p_miss=(0.0, 0.02, 0.05, 0.1), bounds: bool = False,
                  per_worker: bool = False):
    """(name, launch, plain, nbytes, ops, library call or None, shape) of
    each kernel at ``lanes`` x ``n`` workers x ``cols`` pooled elements of
    ``dtype``: the features flattened the way the pooling laws hand them
    over.  A name with a ``[form]`` suffix is another form of that
    kernel, not on the main paths.  ``ops`` of the fused contention is the
    hashes these inputs need x ``OPS_PER_HASH`` (counted only with
    ``bounds``).  ``per_worker`` gives each worker its own ``p_keep``."""
    h, mask, keys, p_keep, id_bits, kw = _contention_operands(
        dev, lanes, n, cols, bits, seed, dtype, p_miss,
        per_worker=per_worker)
    total = bits + id_bits
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    # the winner bwd's operands: the curves' lane stack, the noisy lanes
    # and the ideal lane (L + 1), one winner and cotangent per column
    stack_w = torch.randint(0, n, (lanes + 1, cols), generator=gen,
                            dtype=torch.int32).to(dev)
    g = torch.randn((lanes + 1, cols), generator=gen).to(dtype).to(dev)
    fb = h.element_size()
    codes = q_ops.encode(h, bits)
    cb = codes.element_size()
    pooled = mp_ops.maxpool_fused(codes, 1)[0]
    word = ct_ref.contention_words(h, bits, id_bits)
    # the noisy site's epilogue: the contention's winners, the paths' mask
    won = ct_ops.noisy_contention(h, mask, bits, id_bits, keys, p_keep,
                                  **kw).winner
    site = dict(mask=mask.expand(lanes, n), winner=won, correct=True)
    # the packed sensing planes of the same call
    heard = ct_ref.draw_heard_packed(keys, p_keep, n, cols, **kw)
    hashes = _needed_hashes(word, heard, mask, total, **kw) if bounds else 0
    shape = [lanes, n, cols]
    # maxpool.decode's bytes: the rows, mask and winners read, pooled and
    # correct written; operations: a compare and a select per code for the
    # max, a compare for the winner, the decode (and, from floats, the
    # encode: a test, a select and a shift per element)
    site_io = n + lanes * cols * (4 + fb + 1)
    return [
        ("ocs_quant.encode", lambda: q_ops.encode(h, bits),
         lambda: q_ref.encode(h, bits), h.numel() * (fb + cb),
         4 * h.numel(), None, shape),
        ("ocs_quant.decode", lambda: q_ops.decode(pooled, bits, dtype),
         lambda: q_ref.decode(pooled, bits, dtype),
         pooled.numel() * (cb + fb), 8 * pooled.numel(), None,
         list(pooled.shape)),
        ("maxpool.fwd", lambda: mp_ops.maxpool_fused(codes, 1),
         lambda: mp_ref.maxpool_fused(codes, 1),
         codes.numel() * cb + pooled.numel() * (cb + 4),
         pooled.numel() * (n - 1),
         (lambda: torch.max(codes, dim=1)) if bits == 8 else None, shape),
        ("maxpool.decode",
         lambda: _present(mp_ops.maxpool_decode(h, bits, dtype, **site)),
         lambda: _present(mp_ref.maxpool_decode(h, bits, dtype, **site)),
         h.numel() * fb + site_io, h.numel() * 6 + lanes * cols * 8, None,
         shape),
        ("maxpool.decode[codes]",
         lambda: _present(mp_ops.maxpool_decode(codes, bits, dtype, **site)),
         lambda: _present(mp_ref.maxpool_decode(codes, bits, dtype, **site)),
         codes.numel() * cb + site_io, codes.numel() * 3 + lanes * cols * 8,
         None, shape),
        ("maxpool.winner_bwd", lambda: mp_ops.maxpool_winner_bwd(
            stack_w, g, n, 1), lambda: mp_ref.maxpool_winner_bwd(
            stack_w, g, n, 1),
         stack_w.numel() * 4 + g.numel() * (1 + n) * fb, g.numel() * n,
         None, [lanes + 1, n, cols]),
        ("ocs_contention.contend",
         lambda: ct_ops.contend(word, heard, mask, total, **kw),
         lambda: ct_ref.contend(word, heard, mask, total, **kw),
         word.numel() * 4 + heard.numel() * 4 + lanes * cols * 4,
         lanes * cols * ROUNDS * kw["n_slots"] * (6 * n + 3), None, shape),
        # bytes: features, mask, keys and p_keep read, winners, counts and
        # accounting written; operations: the hashes these inputs need, on
        # INT32
        ("ocs_contention.noisy",
         lambda: ct_ops.noisy_contention(h, mask, bits, id_bits, keys,
                                         p_keep, **kw),
         lambda: ct_ref.noisy_contention(h, mask, bits, id_bits, keys,
                                         p_keep, **kw),
         h.numel() * fb + mask.numel() + keys.numel() * 8
         + p_keep.numel() * p_keep.element_size() + lanes * cols * 4
         + (2 * lanes * ROUNDS + 1 + 3 * lanes) * 4,
         hashes * OPS_PER_HASH, None, shape),
    ]


def _present(out: tuple) -> tuple:
    """The outputs a ``maxpool_decode`` call wrote."""
    return tuple(t for t in out if t is not None)


def check_decode_outputs(dev) -> None:
    """Phase 3, ``maxpool.decode`` bitwise against its plain version at
    both paths' shapes (curves: 4 lanes x 4 workers x 4096, bits 8 and 16,
    float32; serving: 1 x 16 x 8192, bits 8, bfloat16), from the float
    features and from codes, for every subset of its outputs, with and
    without a winner, under a per-lane mask with dark workers (lane 0 all
    dark) and under the paths' all-on mask."""
    cases = [(LANES, N, B * K, bits, torch.float32) for bits in (8, 16)] + \
        [(1, QWEN_WORKERS, SERVE_SLOTS * QWEN_D, 8, torch.bfloat16)]
    for lanes, n, cols, bits, dtype in cases:
        gen = torch.Generator(device="cpu").manual_seed(cols + bits)
        h = (torch.randn((lanes, n, cols), generator=gen) * 3).to(dtype)
        h.view(-1)[::13] = -float("inf")        # the lowest code
        h = h.to(dev)
        sources = {"floats": h, "codes": q_ops.encode(h, bits)}
        lane_mask = torch.rand((lanes, n), generator=gen) < 0.7
        lane_mask[0] = False
        masks = {"per-lane": lane_mask.to(dev),
                 "all on": torch.ones(n, dtype=torch.bool, device=dev)}
        winner = torch.randint(0, n, (lanes, cols), generator=gen,
                               dtype=torch.int32).to(dev)
        # correct compares the winner's code: only with a winner
        subsets = [dict(winner=w, max_code=m, argmax=a, correct=c)
                   for w in (None, winner) for m in (False, True)
                   for a in (False, True) for c in (False, True)
                   if w is not None or not c]
        for src, x in sources.items():
            for what, mask in masks.items():
                for kw in subsets:
                    _check_equal(
                        "maxpool.decode",
                        lambda: _present(mp_ops.maxpool_decode(
                            x, bits, dtype, mask=mask, **kw)),
                        lambda: _present(mp_ref.maxpool_decode(
                            x, bits, dtype, mask=mask, **kw)),
                        dict(kw, src=src, mask=what,
                             winner=kw["winner"] is not None))
        print(f"maxpool.decode {(lanes, n, cols)} bits {bits} {dtype}: "
              f"bitwise equal to plain for {len(subsets)} output subsets x "
              f"{len(masks)} masks x {len(sources)} inputs (floats, codes)",
              flush=True)


def _base(name: str) -> str:
    """The kernel of a case name: ``maxpool.decode[codes]`` is a form of
    ``maxpool.decode``."""
    return name.split("[")[0]


def _l2_flush(dev):
    """(call, kernel names): a call that evicts the card's L2 by summing a
    ``L2_FLUSH_BYTES`` buffer (a read: it leaves no dirty line for the
    next call to write back), so that the next call reads its operands
    from HBM, and the names the profiler gives its kernels (a timed call
    launches none of them)."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, device=dev)

    def call():
        return buf.sum()

    call()
    torch.cuda.synchronize()
    names = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        names = {e.name for e in _card_events(prof)}
        if names:
            break
    assert names, "the profiler saw none of the L2 flush's kernels"
    print(f"L2 flush: {L2_FLUSH_BYTES} bytes summed, kernels {names}",
          flush=True)
    return call, names


def _record(name, launch, plain, nbytes, ops, lib, extra, err,
            ops_per_s=NONTENSOR_OPS_PER_S, flush=None) -> dict:
    """Time ``launch`` (the kernel), ``plain`` and ``lib`` on the card and
    build the kernel's record for the ``{"kernels": [...]}`` line: ``ms``
    is the kernel's own device time, ``call_ms`` all device work of the
    wrapper's call (its small conversions and the zeroed counts too).
    With ``flush`` (:func:`_l2_flush`) each timed call starts with the L2
    evicted (``"l2": "flushed"`` in the record)."""
    base = _base(name)
    calls = [(launch, 20, SYMBOLS[base]),
             (plain, 10 if ops > 1e10 else 20, None)]
    if lib is not None:
        calls.append((lib, 20, None))
    got = _device_ms_many(calls, flush=flush)
    (call_ms, src_k, ms), (plain_ms, src_p, _) = got[:2]
    lib_ms, src_l, _ = got[2] if lib is not None else (None, None, None)
    if flush is not None:
        extra = dict(extra, l2="flushed")
    if base == "ocs_contention.noisy":
        ops_per_s = INT32_LANES * SM_CLOCK_HZ
    bound_ms, bound_by = _bound(nbytes, ops, ops_per_s)
    # "events": the profiler saw no device time and a number is the host's
    # issue rate, not device time
    ms_source = ("profiler" if {src_k, src_p, src_l} <= {"profiler", None}
                 else "events")
    rec = {"name": base, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/" + SOURCES[base],
           "replaces": REPLACES[base], "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": lib_ms, "call_ms": call_ms,
           "ms_source": ms_source, "host_ms": _time_ms(launch), **extra}
    lib_txt = "" if lib_ms is None else f", {lib_ms:.6f} ms library"
    print(f"kernel {name} {extra}: max abs err {err:.3g}; device {ms:.6f} "
          f"ms kernel ({call_ms:.6f} ms the whole call), {plain_ms:.6f} ms "
          f"plain{lib_txt}, bound "
          f"{bound_ms:.6f} ms ({bound_by}, {ms_source}); "
          f"{rec['host_ms']:.6f} ms per call back to back", flush=True)
    return rec


def check_kernels(dev) -> dict:
    """Phase 3: every kernel bitwise against its plain version at the
    training step's shape (4 lanes x 4 workers x a 64 x 64 batch of
    embeddings; the winner bwd over the 5-lane stack), timed; bitwise,
    untimed, at the other shapes the curves launch: the ideal run's single
    lane, and the evaluation's 512 x 64 elements (4 noisy lanes and the
    ideal lane); and bitwise, timed, at the serving tick's shape (one lane
    of 16 workers x 8 slots x d_model 1024 bf16 features, bits 8, p_miss
    0.05; the winner bwd is not on serving).
    Then the fused contention's other cases (:func:`check_noisy_cases`)
    and flash attention (:func:`check_flash`)."""
    rows, t0 = {}, time.perf_counter()

    def row(name, launch, plain, nbytes, ops, lib, extra, flush=None):
        err = _check_equal(name, launch, plain, extra)
        return _record(name, launch, plain, nbytes, ops, lib, extra, err,
                       flush=flush)

    for bits in (8, 16):
        for name, launch, plain, nbytes, ops, lib, shape in _kernel_cases(
                dev, LANES, B * K, bits, seed=0, bounds=True):
            if name == "maxpool.winner_bwd" and bits == 16:
                continue            # the float cotangent: the same call
            rows[(name, bits)] = row(name, launch, plain, nbytes, ops, lib,
                                     dict(bits=bits, shape=shape))
        for lanes, cols in ((1, B * K), (LANES, EVAL_ROWS * K),
                            (1, EVAL_ROWS * K)):
            for name, launch, plain, *_, shape in _kernel_cases(
                    dev, lanes, cols, bits, seed=lanes + bits):
                _check_equal(name, launch, plain, dict(bits=bits, shape=shape))
        print(f"kernels at bits={bits}: bitwise equal also at the ideal "
              "lane and the evaluation shapes", flush=True)
    for name, launch, plain, nbytes, ops, lib, shape in _kernel_cases(
            dev, 1, SERVE_SLOTS * QWEN_D, 8, seed=99, n=QWEN_WORKERS,
            dtype=torch.bfloat16, p_miss=(0.05,), bounds=True):
        if name != "maxpool.winner_bwd":
            rows[(name, "serve")] = row(name, launch, plain, nbytes, ops, lib,
                                        dict(bits=8, shape=shape,
                                             dtype="bfloat16"))
    print(f"check_kernels: the channel kernels' rows in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def part(fn, *args):
        t = time.perf_counter()
        got = fn(*args)
        print(f"check_kernels: {fn.__name__} in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        return got

    rows.update(part(check_sweep_kernels, dev, row))
    rows.update(part(check_train_maxpool, dev, row))
    part(check_tp_sites, dev)
    part(check_tp_model_sites, dev)
    rows.update(part(check_moe_site, dev, row))
    rows.update(part(check_recurrent_sites, dev, row))
    part(check_decode_outputs, dev)
    part(check_noisy_cases, dev)
    part(check_fault_cases, dev)
    rows[("flash_attention.fwd", "serve")] = part(check_flash, dev)
    rows[("flash_attention.fwd", "moe")] = part(check_flash_gqa128, dev)
    rows[("flash_attention.fwd", "jamba")] = part(check_flash_jamba, dev)
    rows.update(part(check_encdec_sites, dev, row))
    rows[("flash_attention.fwd", "encdec")] = part(check_flash_encdec, dev)
    return rows


def sweep_grid():
    """``benchmarks/bench_sweep.py``'s full grid: the 14 registry
    scenarios and N (4, 16, 64) x bits (8, 16) x p_miss (0, .01, .05, .1)
    x channels (1, 4)."""
    return [scenarios.get(n) for n in scenarios.names()] + \
        scenarios.scenario_grid(n_workers=(4, 16, 64), bits=(8, 16),
                                p_miss=(0.0, 0.01, 0.05, 0.1),
                                n_channels=(1, 4))


def check_sweep_kernels(dev, row) -> dict:
    """Phase 3, the sweep's kernels at its largest groups, bitwise and
    timed: ``ocs_quant.encode`` over the clean bits-16 group (its
    scenarios x ``SWEEP_ROUNDS`` lanes of the grid's 64 padded workers x
    K 64),
    ``ocs_contention.noisy`` and ``maxpool.decode`` over the noisy bits-16
    sub-group of 64 workers (id_bits 6; per-worker ``p_keep``)."""
    cells = sweep_grid()
    n_max = max(s.n_workers for s in cells)
    clean_lanes = SWEEP_ROUNDS * sum(s.bits == 16 for s in cells)
    noisy_lanes = SWEEP_ROUNDS * sum(s.bits == 16 and s.n_workers == n_max
                                     for s in cells)
    out = {}
    gen = torch.Generator(device="cpu").manual_seed(17)
    h = torch.randn((clean_lanes, n_max, SWEEP_K), generator=gen).to(dev)
    shape = list(h.shape)
    out[("ocs_quant.encode", "sweep")] = row(
        "ocs_quant.encode", lambda: q_ops.encode(h, 16),
        lambda: q_ref.encode(h, 16), h.numel() * (4 + 2), 4 * h.numel(),
        None, dict(bits=16, shape=shape))
    p_miss = tuple(np.linspace(0.0, 0.1, noisy_lanes))
    for name, launch, plain, nbytes, ops, lib, shape in _kernel_cases(
            dev, noisy_lanes, SWEEP_K, 16, seed=18, n=n_max, p_miss=p_miss,
            bounds=True, per_worker=True):
        if name in ("ocs_contention.noisy", "maxpool.decode"):
            out[(name, "sweep")] = row(name, launch, plain, nbytes, ops, lib,
                                       dict(bits=16, shape=shape))
    return out


def check_noisy_cases(dev) -> None:
    """Phase 3, the fused contention beyond the two paths' shapes, bitwise
    against ``ct_ref.noisy_contention`` (the words, the packed draw, the
    tournament and the accounting) on the card: float16 features and
    ``p_keep``, a per-worker ``(L, N, 1)`` ``p_keep``, a padded scan
    (``max_id_bits > id_bits``: 3 inert id sub-slots and 20 real workers
    of 33), 64 workers (two per lane of a warp), and 1 and 64 rounds (the
    accounting's last-block reduction over every round)."""
    cases = {
        "float16": dict(lanes=2, n=8, cols=1000, bits=8,
                        dtype=torch.float16, p_miss=(0.1, 0.3)),
        "per-worker p_keep": dict(lanes=3, n=9, cols=700, bits=8,
                                  dtype=torch.float32,
                                  p_miss=(0.05, 0.2, 0.5), n_real=6,
                                  per_worker=True),
        "padded id sub-slots": dict(lanes=2, n=33, cols=900, bits=16,
                                    dtype=torch.bfloat16, p_miss=(0.1, 0.4),
                                    n_real=20, id_pad=3),
        "64 workers": dict(lanes=2, n=64, cols=777, bits=8,
                           dtype=torch.float32, p_miss=(0.02, 0.3)),
        "1 round": dict(lanes=3, n=4, cols=4096, bits=8, dtype=torch.float32,
                        p_miss=(0.1, 0.3, 0.6), rounds=1),
        "64 rounds": dict(lanes=3, n=4, cols=4096, bits=8,
                          dtype=torch.float32, p_miss=(0.1, 0.3, 0.6),
                          rounds=64),
        "64 rounds bf16": dict(lanes=2, n=16, cols=2048, bits=8,
                               dtype=torch.bfloat16, p_miss=(0.2, 0.7),
                               n_real=12, per_worker=True, rounds=64),
    }
    for what, case in cases.items():
        bits = case["bits"]
        h, mask, keys, p_keep, id_bits, kw = _contention_operands(
            dev, seed=len(what), **case)
        _check_equal(
            "ocs_contention.noisy",
            lambda: tuple(ct_ops.noisy_contention(h, mask, bits, id_bits,
                                                  keys, p_keep, **kw)),
            lambda: tuple(ct_ref.noisy_contention(h, mask, bits, id_bits,
                                                  keys, p_keep, **kw)), what)
        print(f"ocs_contention.noisy {what} {tuple(h.shape)} {h.dtype}, "
              f"p_keep {tuple(p_keep.shape)}, n_slots {kw['n_slots']} of "
              f"{bits + id_bits} live, {kw['max_rounds']} rounds: bitwise "
              "equal to the words + packed draw + tournament + accounting",
              flush=True)


def _dark_lane_operands(dev, lanes, n, cols, bits, dtype, seed):
    """The fault paths' contention operands: a per-lane ``online (L, N)``
    mask whose lane 0 is all dark, and a per-lane, per-worker ``p_keep
    (L, N, 1)``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h = (torch.randn((lanes, n, cols), generator=gen) * 3.0).to(dtype)
    h[:, :, :16] = h[:, :1, :16]
    online = torch.rand((lanes, n), generator=gen) < 0.6
    online[0] = False
    p = torch.rand((lanes, n), generator=gen) * 0.6
    p_keep = ocs.sensing_keep_prob(p, dtype, lanes=True)
    keys = jr.split(jr.PRNGKey(seed + bits), lanes)
    return [t.to(dev) for t in (h, online, keys, p_keep)]


def check_fault_cases(dev) -> None:
    """Phase 3, the fault paths' operands: ``ocs_contention.noisy`` bitwise
    against ``ct_ref.noisy_contention`` under a per-lane ``online (L, N)``
    mask with one lane all dark and a per-lane, per-worker ``p_keep``, at
    the fault curves' shapes (4 lanes x 4 workers x 4096 and the
    evaluation's 32768, bits 8 and 16) and the faulty serve tick's (1 and
    3 lanes x 16 workers x 8192 bf16, bits 8); then the fault pool
    (``faults.aggregate_with_ideal``: 4 fault lanes, lane 0 in total
    outage, + the ideal lane) forward and backward on the card against the
    CPU under each policy, with no NaN and no gradient into h on the
    outage lane."""
    cases = [(4, N, B * K, bits, torch.float32) for bits in (8, 16)] + [
        (4, N, EVAL_ROWS * K, 8, torch.float32),
        (1, QWEN_WORKERS, SERVE_SLOTS * QWEN_D, 8, torch.bfloat16),
        (3, QWEN_WORKERS, SERVE_SLOTS * QWEN_D, 8, torch.bfloat16)]
    for lanes, n, cols, bits, dtype in cases:
        h, online, keys, p_keep = _dark_lane_operands(
            dev, lanes, n, cols, bits, dtype, seed=cols + lanes)
        id_bits = ocs.host_id_bits(n)
        kw = dict(n_slots=bits + id_bits, max_rounds=ROUNDS)
        _check_equal(
            "ocs_contention.noisy",
            lambda: tuple(ct_ops.noisy_contention(h, online, bits, id_bits,
                                                  keys, p_keep, **kw)),
            lambda: tuple(ct_ref.noisy_contention(h, online, bits, id_bits,
                                                  keys, p_keep, **kw)),
            dict(shape=[lanes, n, cols], dark_lane=0))
        print(f"ocs_contention.noisy {(lanes, n, cols)} {dtype} bits {bits},"
              f" per-lane online with lane 0 dark, p_keep "
              f"{tuple(p_keep.shape)}: bitwise equal to plain", flush=True)

    lanes = LANES
    gen = torch.Generator(device="cpu").manual_seed(3)
    h = torch.randn((lanes + 1, N, B, K), generator=gen) * 2
    h[:, :, 0, :8] = -float("inf")          # columns that decode to -inf
    stale = torch.randn((lanes, B, K), generator=gen)
    g1 = torch.randn((lanes + 1, B, K), generator=gen)
    g2 = torch.randn((lanes, B, K), generator=gen)
    for pol in (faults.DegradePolicy.zero_fill(),
                faults.DegradePolicy.stale(), faults.DegradePolicy.retry(2)):
        models = [faults.FaultModel.iid(0.0, policy=pol).with_dropout(1.0,
                                                                      0.0)]
        models += [faults.FaultModel.burst(
            burst_len=2.0 + i, gap_len=3.0, p_miss_bad=0.5, p_miss_good=0.05,
            policy=pol).with_dropout(0.3, 0.4) for i in range(lanes - 1)]
        outs = []
        for where in ("cpu", dev):
            fm = faults.stack_models(models, N, where)
            st = faults.init_state(N, (B, K), device=where).map(
                lambda t: t[None].expand((lanes,) + t.shape).clone())
            st = faults.FaultState(
                bad=st.bad, offline=st.offline,
                stale=stale.to(where).requires_grad_(True), age=st.age,
                consec=st.consec)
            x = h.to(where).requires_grad_(True)
            pooled, ns, acct = faults.aggregate_with_ideal(
                Protocol.ocs(8), fm, st, x,
                jr.split(jr.PRNGKey(5), lanes).to(where))
            gh, gs = torch.autograd.grad([pooled, ns.stale], [x, st.stale],
                                         [g1.to(where), g2.to(where)])
            outs.append([pooled.detach(), ns.stale.detach(), gh, gs] + [
                getattr(acct, f.name)
                for f in faults.FaultAccounting.__dataclass_fields__.values()])
        for a, b in zip(*outs):
            if not _bitwise_equal(a.cpu(), b.cpu()):
                raise AssertionError(f"fault pool {pol.kind}: card != CPU")
        pooled, gh, outage = outs[1][0], outs[1][2], outs[1][-1]
        assert int(outage[0]) == 1, "lane 0 is not an outage"
        assert not bool(torch.isnan(pooled).any()), "NaN in the fault pool"
        assert not bool(torch.isnan(gh).any()), "NaN in the fault gradient"
        assert not bool(gh[0].any()), "gradient reached h on an outage lane"
        print(f"fault pool ({lanes} lanes + ideal, lane 0 in outage, "
              f"{pol.kind}): forward, accounting and the gradients of h and "
              "of the stale cache bitwise equal to the CPU; no NaN, no "
              "gradient into h on the outage lane", flush=True)


# flash against its plain version: float32 within the JAX parity test's
# 3e-5; a 16-bit output within FLASH_ROW_ULPS ulps of its type at each query
# row's largest |plain| value.  Both round nearly the same float32 sum to 16
# bits, so a sound kernel is off by at most one ulp there; a limit in
# absolute terms would be as large as the outputs of a long non-causal row
# (|out| ~ 0.04 at 1,408 keys), where a dropped key tile would pass it.
FLASH_F32_ATOL, FLASH_ROW_ULPS = 3e-5, 2


def _row_rel_err(got, want) -> float:
    """Each query row's largest |got - want| over its largest |want|, the
    largest over the rows."""
    g, w = got.float(), want.float()
    return float(((g - w).abs().amax(-1) / w.abs().amax(-1)).max())


def _check_flash(got, want, what: str) -> dict:
    """Hold a flash output to its plain version (the limits above), print
    both errors, raise past the limit; returns ``max_abs_err`` and, for a
    16-bit output, ``max_row_rel_err``."""
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        print(f"flash {what}: max abs err {err:.3g} (tolerance "
              f"{FLASH_F32_ATOL})", flush=True)
        if not err <= FLASH_F32_ATOL:
            raise AssertionError(f"flash kernel != plain ({what}): {err}")
        return dict(max_abs_err=err)
    rel, ulp = _row_rel_err(got, want), torch.finfo(got.dtype).eps
    print(f"flash {what}: max abs err {err:.3g}, max|plain| "
          f"{float(want.float().abs().max()):.4g}, row-relative err "
          f"{rel:.4g} = {rel / ulp:.3f} ulps (tolerance {FLASH_ROW_ULPS})",
          flush=True)
    if not rel <= FLASH_ROW_ULPS * ulp:
        raise AssertionError(f"flash kernel != plain ({what}): row-relative "
                             f"{rel} > {FLASH_ROW_ULPS} ulps")
    return dict(max_abs_err=err, max_row_rel_err=rel)


def _flash_inputs(dev, h, hkv, s, dtype, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype).to(dev)
            for shape in ((1, h, s, 64), (1, hkv, s, 64), (1, hkv, s, 64))]


def check_flash(dev) -> dict:
    """Phase 3, flash attention: the kernel against its plain version on
    the card (:func:`_check_flash`: atol 3e-5 in float32, the JAX parity
    test's; in bfloat16 and float16 two ulps of each query row's largest
    value: the kernel sums in another order than the whole softmax, and the
    tensor-core design rounds P to 16 bits before PV) at the prefill
    shapes — (1, 16, S, 64) bf16 causal for S 128, 256 (this run's
    prompts), 512, 1024 and 4096, and float16 at 256 — and at
    the JAX test's float32 GQA cases (1, 4, 192, 64), Hkv 1, 2, 4, causal
    and not, blocks of 64; 192 at the default blocks of 128 must be
    refused.  Timed at S = 256 (the record), 1024 and 4096 (its
    ``long_prompts``)."""
    cases = ([(16, 16, s, torch.bfloat16, True, 128)
              for s in (128, 256, 512, 1024, 4096)]
             + [(16, 16, 256, torch.float16, True, 128)]
             + [(4, hkv, 192, torch.float32, causal, 64)
                for hkv in (1, 2, 4) for causal in (True, False)])
    for h, hkv, s, dtype, causal, block in cases:
        q, k, v = _flash_inputs(dev, h, hkv, s, dtype, seed=s + hkv)
        _check_flash(fa_ops.flash_attention(q, k, v, causal, block, block),
                     fa_ref.flash_attention(q, k, v, causal),
                     f"{(1, h, s, 64)} Hkv {hkv} {dtype} causal={causal}")
    q, k, v = _flash_inputs(dev, 4, 2, 192, torch.float32, seed=0)
    try:
        fa_ops.flash_attention(q, k, v)
    except ValueError:
        print("flash: S=192 at blocks of 128 refused, as JAX asserts",
              flush=True)
    else:
        raise AssertionError("flash: S=192 at blocks of 128 was accepted")

    recs = []
    for s in (SERVE_PROMPT, 1024, 4096):
        h, d = QWEN_HEADS, 64
        q, k, v = _flash_inputs(dev, h, h, s, torch.bfloat16, seed=1)
        errs = _check_flash(fa_ops.flash_attention(q, k, v),
                            fa_ref.flash_attention(q, k, v),
                            f"{(1, h, s, d)} bf16 causal (timed)")
        # bytes: q, k, v read once, out written once; operations: the
        # causal pairs' two products (QK^T and PV), 2 flops a multiply-add,
        # on the bf16 tensor-core rate
        nbytes = 4 * q.numel() * q.element_size()
        ops = 4 * h * d * s * (s + 1) // 2
        recs.append(_record(
            "flash_attention.fwd",
            lambda q=q, k=k, v=v: fa_ops.flash_attention(q, k, v),
            lambda q=q, k=k, v=v: fa_ref.flash_attention(q, k, v), nbytes,
            ops, lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True),
            dict(shape=[1, h, s, d], dtype="bfloat16", causal=True,
                 max_row_rel_err=errs["max_row_rel_err"]),
            errs["max_abs_err"], BF16_TENSOR_OPS_PER_S))
    keep = ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "max_row_rel_err", "ms_source")
    return dict(recs[0], long_prompts=[{k: r[k] for k in keep}
                                       for r in recs[1:]])


def check_flash_gqa128(dev) -> dict:
    """Phase 3, flash at the MoE slice's attention: head_dim 128, 32 query
    heads over 4 KV heads (GQA 8:1), bf16 causal, S 256 — one prefill
    (1, 32, 256, 128) and the train step (8, 32, 256, 128) — held to the
    plain version (:func:`_check_flash`), timed beside
    ``scaled_dot_product_attention`` (``enable_gqa``).  Untimed, held at
    phase 23's prefills (S 64
    and each wide config's heads: GQA 5:1 and 16:1 at head_dim 128,
    minicpm's 36-head MHA at 64)."""
    recs = []
    for b in (1, TRAIN_BATCH):
        gen = torch.Generator(device="cpu").manual_seed(b)
        q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
                   .to(dev) for shape in ((b, 32, TRAIN_SEQ, 128),
                                          (b, 4, TRAIN_SEQ, 128),
                                          (b, 4, TRAIN_SEQ, 128)))
        errs = _check_flash(fa_ops.flash_attention(q, k, v),
                            fa_ref.flash_attention(q, k, v),
                            f"{tuple(q.shape)} Hkv 4 bf16 causal")
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
        ops = 4 * b * 32 * 128 * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
        recs.append(_record(
            "flash_attention.fwd",
            lambda q=q, k=k, v=v: fa_ops.flash_attention(q, k, v),
            lambda q=q, k=k, v=v: fa_ref.flash_attention(q, k, v), nbytes,
            ops, lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            dict(shape=list(q.shape), kv_heads=4, dtype="bfloat16",
                 causal=True, path="moe",
                 max_row_rel_err=errs["max_row_rel_err"]),
            errs["max_abs_err"], BF16_TENSOR_OPS_PER_S))
    wide = sorted({(c.n_heads, c.n_kv_heads, c.head_dim_)
                   for c in map(get_config, WIDE_ARCHS)})
    for h, hkv, d in wide:
        gen = torch.Generator(device="cpu").manual_seed(h * hkv + d)
        q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
                   .to(dev) for shape in ((1, h, WIDE_PROMPT, d),
                                          (1, hkv, WIDE_PROMPT, d),
                                          (1, hkv, WIDE_PROMPT, d)))
        _check_flash(fa_ops.flash_attention(q, k, v),
                     fa_ref.flash_attention(q, k, v),
                     f"{tuple(q.shape)} Hkv {hkv} (GQA {h // hkv}:1) bf16 "
                     f"causal")
    return {"prefill": recs[0], "train": recs[1]}


def check_flash_jamba(dev) -> dict:
    """Phase 3, flash at jamba-1.5-large's attention layer in a phase-27
    prefill: (1, 64, 64, 128) over 8 KV heads (GQA 8:1), bf16 causal,
    held to the plain version (:func:`_check_flash`), timed beside
    ``scaled_dot_product_attention`` (``enable_gqa``)."""
    gen = torch.Generator(device="cpu").manual_seed(64)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
               for shape in ((1, 64, JAMBA_PROMPT, 128),
                             (1, 8, JAMBA_PROMPT, 128),
                             (1, 8, JAMBA_PROMPT, 128)))
    errs = _check_flash(fa_ops.flash_attention(q, k, v),
                        fa_ref.flash_attention(q, k, v),
                        f"{tuple(q.shape)} Hkv 8 bf16 causal")
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    ops = 4 * 64 * 128 * JAMBA_PROMPT * (JAMBA_PROMPT + 1) // 2
    return _record(
        "flash_attention.fwd", lambda: fa_ops.flash_attention(q, k, v),
        lambda: fa_ref.flash_attention(q, k, v), nbytes, ops,
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        dict(shape=list(q.shape), kv_heads=8, dtype="bfloat16", causal=True,
             path="jamba", max_row_rel_err=errs["max_row_rel_err"]),
        errs["max_abs_err"], BF16_TENSOR_OPS_PER_S)


def check_p0_equivalence(dev) -> None:
    """Phase 4: at p_miss=0 the OCS law is the ideal 'first' law."""

    gen = torch.Generator(device="cpu").manual_seed(1)
    h0 = (torch.randn((N, B, K), generator=gen) * 2.0).to(dev)
    g = torch.randn((B, K), generator=gen).to(dev)
    for bits in (8, 16):
        outs = []
        for proto, rng in ((Protocol.ocs(bits, p_miss=0.0),
                            jr.PRNGKey(7, dev)),
                           (Protocol.ideal_max(bits, tie_break="first"),
                            None)):
            h = h0.clone().requires_grad_(True)
            pooled, _ = proto.aggregate(h, rng)
            (grad,) = torch.autograd.grad(pooled, h, g)
            outs.append((pooled.detach(), grad))
        (pa, ga), (pb, gb) = outs
        assert _bitwise_equal(pa, pb), f"bits={bits}: p0 forward differs"
        assert _bitwise_equal(ga, gb), f"bits={bits}: p0 gradient differs"
        print(f"p0: Protocol.ocs({bits}) == ideal_max({bits}, 'first'), "
              "forward and gradient, bitwise", flush=True)


def cifar_config(**overrides):
    """``configs/fedocs_cifar.cifar10_like`` as a curve grid: its worker
    grid, image side, widths and classes."""
    v = fedocs_cifar.cifar10_like()
    grid = math.isqrt(v.n_workers)
    kw = dict(grid=grid, hw=grid * math.isqrt(v.input_dim),
              n_classes=v.output_dim, encoder_dims=tuple(v.encoder_dims),
              embed_dim=v.embed_dim, head_dims=tuple(v.head_dims),
              bits=(8, 16), p_miss=(0.0, 0.02, 0.05, 0.1))
    kw.update(overrides)
    return tc.CurveConfig(**kw)


@contextlib.contextmanager
def _packed_draws_on_card():
    """Count the calls of the packed sensing draw on a CUDA tensor: the
    main paths draw inside ``ocs_contention.noisy`` and never call it."""
    seen = {"calls": 0}
    orig = ct_ref.draw_heard_packed

    def watched(rng, *args, **kw):
        seen["calls"] += rng.device.type == "cuda"
        return orig(rng, *args, **kw)

    ct_ref.draw_heard_packed = watched
    try:
        yield seen
    finally:
        ct_ref.draw_heard_packed = orig


def run_main_path(dev):
    """Phase 5: run_curves at the fedocs-cifar width, counted."""

    ccfg = cifar_config()
    torch.cuda.synchronize()
    with _packed_draws_on_card() as draws:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = tc.run_curves(ccfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    print(f"run_curves fedocs-cifar width: {ccfg.steps} steps x "
          f"{len(ccfg.bits)} bits x {len(ccfg.p_miss)} lanes + ideal: "
          f"{wall:.3f} s wall; launches {counts}; packed draws on the card "
          f"{draws['calls']}", flush=True)
    # not on this path: flash attention is serving's kernel (phase 8); the
    # packed-plane contention is the TPU kernel's interface, the encode is
    # formed inside the contention and the pooling epilogue, and the
    # standalone max-pool and decode have given their work to
    # maxpool.decode, and the tie-routed backward is the LM step's (phase
    # 3 holds all five)
    off_path = ("flash_attention.fwd", "ocs_contention.contend",
                "maxpool.fwd", "ocs_quant.decode", "ocs_quant.encode",
                "maxpool.ties_bwd")
    missing = [k for k, v in counts.items() if v == 0 and k not in off_path]
    assert not missing, f"kernels not launched on the main path: {missing}"
    # one fused tournament per training step and per evaluation, each bits;
    # one pooling epilogue for the noisy lanes and one for the ideal lane;
    # one winner-routed backward over the whole lane stack per step
    sites = (ccfg.steps + 1) * len(ccfg.bits)
    assert counts["ocs_contention.noisy"] == sites, (counts, sites)
    assert counts["maxpool.decode"] == 2 * sites, (counts, sites)
    assert counts["maxpool.winner_bwd"] == ccfg.steps * len(ccfg.bits), \
        counts
    for name in off_path[1:]:
        assert counts[name] == 0, (name, counts)
    assert draws["calls"] == 0, "the packed sensing draw ran on the card"
    for arr in (res.loss_history, res.ideal_loss_history, res.nll,
                res.nll_ideal):
        assert np.all(np.isfinite(arr)), "non-finite loss"
    assert res.acc.shape == (2, 4) and np.all((0 <= res.acc) & (res.acc <= 1))
    for bi in range(len(ccfg.bits)):
        for x, y in zip(tree.leaves(res.noisy_params[bi]),
                        tree.leaves(res.ideal_params[bi])):
            assert torch.equal(x[0], y[0]), "p0 lane diverged from ideal"
        assert res.acc[bi, 0] == res.acc_ideal[bi]
    print("p0 lanes trained bit for bit as the ideal runs", flush=True)
    for line in results.curve_rows(results.summarize_curves(res)):
        print(line)
    return counts, wall, res


def profile_main_path(dev) -> None:
    """Phase 7: where a training step's time goes — torch.profiler over
    10 steps at the fedocs-cifar width (one depth, bits=8).  The device
    time is the summed duration of the card's kernels and copies; the idle
    share compares it with the same run's wall time unprofiled.  The full
    table goes to chiprun_out/profile_main.txt."""
    ccfg = cifar_config(steps=10, bits=(8,))
    tc.run_curves(ccfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tc.run_curves(ccfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tc.run_curves(ccfg, device=dev)
        torch.cuda.synchronize()
    by_name, launches = {}, 0
    for e in _card_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.us
        launches += 1
    device_s = sum(by_name.values()) / 1e6
    # int64 elementwise kernels: the threefry draws (sensing, batches)
    int64_s = sum(us for name, us in by_name.items()
                  if "<long" in name or "Functor<long" in name) / 1e6
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_main.txt").write_text(_kernel_table(
        {k: v / 1e3 for k, v in by_name.items()}, "a run"))
    print(f"profile, 10 steps + eval at bits=8: wall {wall:.4f} s "
          f"unprofiled, device busy {device_s:.4f} s, idle share "
          f"{1 - device_s / wall:.3f}; {launches} device kernels and "
          f"copies ({launches / 11:.0f} per step or evaluation); int64 "
          f"elementwise kernels {int64_s:.4f} s of the device time",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:10.3f} ms  {name[:100]}", flush=True)


def check_against_cpu(dev) -> None:
    """Phase 6: a small grid on the card against the plain CPU path.

    Float sums differ in order between the card and the CPU (~1e-6
    relative), and such a difference can move an embedding across a D-bit
    bucket edge and so change a winner; the tolerances cover that."""

    ccfg = tc.CurveConfig(bits=(8, 16), p_miss=(0.0, 0.3), steps=8,
                          batch=16, n_train=128, n_val=64, hw=8,
                          encoder_dims=(8,), embed_dim=8, head_dims=(8,),
                          log_every=4)
    gpu = tc.run_curves(ccfg, device=dev)
    cpu = tc.run_curves(ccfg, device="cpu")
    loss_err = float(np.max(np.abs(gpu.loss_history - cpu.loss_history)))
    acc_err = float(np.max(np.abs(gpu.acc - cpu.acc))) * ccfg.n_val
    print(f"small grid card vs CPU: max loss diff {loss_err:.3g}, "
          f"max accuracy diff {acc_err:.0f} of {ccfg.n_val} samples",
          flush=True)
    assert loss_err < 1e-3, loss_err
    assert acc_err <= 2, acc_err


# ---------------------------------------------------------------------------
# serving: qwen1.5-0.5b with the OCS channel in every decode tick
# ---------------------------------------------------------------------------

def _ocs(p_miss: float) -> Protocol:
    return Protocol.ocs(bits=8, p_miss=np.full((QWEN_WORKERS,), p_miss,
                                               np.float32))


def _watch_logits(m, dev) -> dict:
    """Wrap the model's prefill and channel decode so that every logit
    they return is checked finite on the card, without a sync per tick;
    ``state["ok"]`` is read once at the end."""
    state = {"ok": torch.ones((), dtype=torch.bool, device=dev)}
    prefill, step = m.prefill, m.decode_step_channel

    def checked_prefill(*args, **kw):
        logits, cache = prefill(*args, **kw)
        state["ok"] = state["ok"] & torch.isfinite(logits).all()
        return logits, cache

    def checked_step(*args, **kw):
        logits, cache, chan = step(*args, **kw)
        state["ok"] = state["ok"] & torch.isfinite(logits).all()
        return logits, cache, chan

    m.prefill, m.decode_step_channel = checked_prefill, checked_step
    return state


def run_serving(dev):
    """Phase 8: the serving main path at the full qwen1.5-0.5b width (bf16,
    random weights from seed 0, flash prefill), OCS at p_miss 0.05 for all
    16 workers in every decode tick: 16 Poisson requests (rate 0.5 a tick)
    of 256-token prompts for 16 tokens each over 8 slots, launch counts set
    to 0 just before and read just after."""
    cfg = get_config(QWEN, use_flash=True)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_workers) == \
        (QWEN_LAYERS, QWEN_D, QWEN_HEADS, QWEN_WORKERS)
    m = M.build(cfg)
    values = m.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree.leaves(values))
    finite = _watch_logits(m, dev)
    proto = _ocs(SERVE_P_MISS)
    eng = se.ServeEngine(m, values, se.ServeConfig(
        batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, eos_id=-1,
        protocol=proto), device=dev)
    reqs = poisson_requests(SERVE_REQUESTS, SERVE_RATE, cfg.vocab_size,
                            prompt_len=SERVE_PROMPT,
                            max_new_tokens=SERVE_NEW, seed=0)
    # warm-up (cuBLAS handles, the allocator's pools), not counted
    eng.run([se.Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=2)])
    torch.cuda.synchronize()
    with _packed_draws_on_card() as draws:
        kernels.reset_launch_counts()
        se.reset_dispatch_counts()
        t0 = time.perf_counter()
        outs = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    ticks = se.dispatch_counts()["tick"]
    n_tokens = sum(len(c.tokens) for c in outs.values())
    print(f"serve {QWEN} full width ({n_params} parameters, bf16): "
          f"{len(outs)} requests, {n_tokens} tokens, {ticks} ticks in "
          f"{wall:.3f} s wall; {1e3 * wall / ticks:.2f} ms per tick "
          f"(prefills included); {n_tokens / wall:.2f} tokens per second; "
          f"launches {counts}; packed draws on the card {draws['calls']}",
          flush=True)
    sites = m.channel_sites()
    assert sites == QWEN_LAYERS
    assert counts["flash_attention.fwd"] == QWEN_LAYERS * SERVE_REQUESTS, \
        counts
    assert counts["ocs_contention.noisy"] == sites * ticks, (counts, ticks)
    assert counts["maxpool.decode"] == sites * ticks, (counts, ticks)
    for name in ("ocs_contention.contend", "maxpool.fwd", "ocs_quant.decode",
                 "ocs_quant.encode", "maxpool.winner_bwd",
                 "maxpool.ties_bwd"):
        assert counts[name] == 0, (name, counts)
    assert draws["calls"] == 0, "the packed sensing draw ran on the card"
    assert bool(finite["ok"]), "a logit is not finite"
    per_tok = proto.comm_load(QWEN_WORKERS, QWEN_D).uplink_bits * sites
    assert sorted(outs) == list(range(SERVE_REQUESTS))
    for c in outs.values():
        assert len(c.tokens) == SERVE_NEW, (c.rid, len(c.tokens))
        assert c.channel_slots > 0, c.rid
        assert c.uplink_bits == (len(c.tokens) - 1) * per_tok, c.rid
    lat = [c.latency_us(eng.config.clock) for c in outs.values()]
    print(f"serve: every request {SERVE_NEW} tokens, every logit finite, "
          f"channel "
          f"slots per request {min(c.channel_slots for c in outs.values())}"
          f"-{max(c.channel_slots for c in outs.values())}, uplink bits "
          f"per request {outs[0].uplink_bits}; ChannelClock latency "
          f"{min(lat):.0f}-{max(lat):.0f} us", flush=True)
    return dict(counts=counts, wall=wall, ticks=ticks, tokens=n_tokens,
                m=m, values=values, eng=eng, reqs=reqs, proto=proto)


def check_serving_p0(dev, serve) -> None:
    """Phase 9: at p_miss 0 the OCS engine serves bitwise the tokens of
    ``Protocol.ideal_max(8, "first")`` at the full width (4 requests, 8
    tokens: tests/test_serve.py's contract)."""
    eng = se.ServeEngine(serve["m"], serve["values"], se.ServeConfig(
        batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, eos_id=-1),
        device=dev)
    reqs = poisson_requests(4, SERVE_RATE, serve["m"].cfg.vocab_size,
                            prompt_len=SERVE_PROMPT, max_new_tokens=8,
                            seed=1)
    a = eng.run(reqs, protocol=_ocs(0.0))
    b = eng.run(reqs, protocol=Protocol.ideal_max(8, tie_break="first"))
    for rid in a:
        assert a[rid].tokens == b[rid].tokens, (rid, a[rid].tokens,
                                                b[rid].tokens)
    print("serve p0: OCS(p_miss=0) == ideal_max(8, 'first') in every token "
          f"of {len(a)} requests x 8 at {QWEN}'s width", flush=True)


def check_serving_against_cpu(dev) -> None:
    """Phase 10: the reduced qwen config in float32 with the flash prefill,
    the same weights on the card and the CPU: prefill logits within 1e-4
    (float order), a channel-free run serves equal tokens; under OCS at
    p_miss 0.05 the agreeing tokens and channel slots are reported."""
    cfg = get_reduced(QWEN, use_flash=True)
    m = M.build(cfg)
    cpu_values = m.init(torch.Generator().manual_seed(0))
    gpu_values = tree.map(lambda t: t.to(dev), cpu_values)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    lc, _ = m.prefill(cpu_values, {"tokens": toks}, max_seq=96)
    lg, _ = m.prefill(gpu_values, {"tokens": toks.to(dev)}, max_seq=96)
    err = float((lg.cpu() - lc).abs().max())
    print(f"serve reduced, card vs CPU: prefill logits max diff {err:.3g}",
          flush=True)
    assert err <= 1e-4, err
    reqs = poisson_requests(6, SERVE_RATE, cfg.vocab_size, prompt_len=64,
                            max_new_tokens=12, seed=2)
    p = np.full((cfg.n_workers,), SERVE_P_MISS, np.float32)
    for proto in (None, Protocol.ocs(bits=8, p_miss=p)):
        config = se.ServeConfig(batch_slots=2, max_seq=96, eos_id=-1,
                                protocol=proto)
        want = se.ServeEngine(m, cpu_values, config, device="cpu").run(reqs)
        got = se.ServeEngine(m, gpu_values, config, device=dev).run(reqs)
        same_tok = sum(a == b for rid in want for a, b in
                       zip(got[rid].tokens, want[rid].tokens))
        total = sum(len(c.tokens) for c in want.values())
        same_slots = sum(got[r].channel_slots == want[r].channel_slots
                         for r in want)
        what = "channel-free" if proto is None else "OCS p_miss 0.05"
        print(f"serve reduced, card vs CPU, {what}: {same_tok} of {total} "
              f"tokens equal, channel_slots equal for {same_slots} of "
              f"{len(want)} requests", flush=True)
        for rid in want:
            if got[rid].tokens != want[rid].tokens:
                first = next(i for i, (a, b) in enumerate(
                    zip(got[rid].tokens, want[rid].tokens)) if a != b)
                print(f"  request {rid}: first differing token at {first}: "
                      f"card {got[rid].tokens} CPU {want[rid].tokens}",
                      flush=True)
        if proto is None:
            assert same_tok == total, "channel-free tokens differ"


def _profile_ticks(tick, what: str, table: str) -> dict:
    """Where a decode tick's time goes: ``tick(0)`` warm, ticks 1-10 timed
    unprofiled, then ``PROFILED_TICKS`` more under torch.profiler, the
    device side alone (device busy time a tick, idle share, launches a
    tick, time by kernel; the table goes to ``<table>`` in the output
    directory)."""
    tick(0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(1, 11):
        tick(t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_tick = {k: v / 10 for k, v in kernels.launch_counts().items() if v}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(11, 11 + PROFILED_TICKS):
            tick(t)
        torch.cuda.synchronize()
    by_name, launches = {}, 0
    for e in _card_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.us
        launches += 1
    # the profiled window's device time, scaled to the timed window's 10
    # ticks
    scale = 10 / PROFILED_TICKS
    device_s = scale * sum(by_name.values()) / 1e6
    int64_s = scale * sum(us for name, us in by_name.items()
                          if "<long" in name or "Functor<long" in name) / 1e6
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / table).write_text(_kernel_table(
        {k: v / (1e3 * PROFILED_TICKS) for k, v in by_name.items()},
        "a tick"))
    print(f"profile, 10 decode ticks of {what} ({PROFILED_TICKS} more "
          f"profiled, device times scaled to 10): wall {wall:.4f} s "
          f"unprofiled ({100 * wall:.2f} ms per tick), device busy "
          f"{device_s:.4f} s, idle share {1 - device_s / wall:.3f}; "
          f"{scale * launches:.0f} device kernels and copies "
          f"({launches / PROFILED_TICKS:.0f} launches per tick); int64 "
          f"elementwise kernels {int64_s:.4f} s of the device time; the "
          f"port's kernel launches per tick {per_tick}", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {scale * us / 1e3:10.3f} ms  {name[:100]}", flush=True)
    return dict(wall_ms=100 * wall, device_ms=100 * device_s,
                idle=1 - device_s / wall, launches=launches / PROFILED_TICKS)


def profile_serving(dev, serve, table="profile_serve.txt") -> dict:
    """Phase 11: where a decode tick's time goes at the full width, the
    engine's slots filled (prefills not profiled; :func:`_profile_ticks`)."""
    eng, proto, m = serve["eng"], serve["proto"], serve["m"]
    eng._reset()
    for slot, req in enumerate(serve["reqs"][:eng.B]):
        eng._insert(slot, req)
    return _profile_ticks(
        lambda t: eng._tick(proto, t),
        f"{m.cfg.name} at the full width ({m.cfg.n_layers} layers, {eng.B} "
        f"slots, OCS p {SERVE_P_MISS})", table)


# ---------------------------------------------------------------------------
# the scheduled and fault curve engines, faulty serving
# ---------------------------------------------------------------------------

# benchmarks/fault_sweep.py's grid: a clean lane and bursts of 2-16 frames
# with gaps of 4x, bad-state misses 0.5, dropouts 0.4 / recoveries 0.4
FAULT_BURSTS = (2, 4, 8, 16)
# the faulty serve: bursts of 4 ticks in gaps of 16, dropouts 0.9 /
# recoveries 0.1, so all 16 workers are dark on ~0.9^16 = 0.19 of ticks
SERVE_FAULT = dict(burst_len=4, gap_len=16, p_miss_bad=0.5, p_miss_good=0.01)
SERVE_DROPOUT = (0.9, 0.1)


def _fault_grid(policy):
    return [faults.FaultModel.iid(0.0, policy=policy)] + [
        faults.FaultModel.burst(burst_len=b, gap_len=4 * b, p_miss_bad=0.5,
                                p_miss_good=0.01, policy=policy
                                ).with_dropout(0.4, 0.4)
        for b in FAULT_BURSTS]


def _assert_curve_counts(counts, ccfg, runs, what):
    """A curve engine's launches: the fused contention once per step and
    per evaluation, ``maxpool.decode`` once for the fault/noisy lanes and
    once for the ideal lane, ``winner_bwd`` once per step over the whole
    lane stack; encode, the standalone max-pool and decode, the
    packed-plane contention and flash never."""
    sites = (ccfg.steps + 1) * runs
    assert counts["ocs_contention.noisy"] == sites, (what, counts)
    assert counts["maxpool.decode"] == 2 * sites, (what, counts)
    assert counts["maxpool.winner_bwd"] == ccfg.steps * runs, (what, counts)
    for name in ("flash_attention.fwd", "ocs_contention.contend",
                 "maxpool.fwd", "ocs_quant.decode", "ocs_quant.encode",
                 "maxpool.ties_bwd"):
        assert counts[name] == 0, (what, name, counts)


def _counted(fn):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after: (result, counts, wall seconds, packed draws on the
    card)."""
    torch.cuda.synchronize()
    with _packed_draws_on_card() as draws:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    assert draws["calls"] == 0, "the packed sensing draw ran on the card"
    return out, counts, wall


def run_scheduled(dev, curves):
    """Phase 12: ``run_scheduled_curves`` at the fedocs-cifar width (the
    p_miss lanes of phase 5, 60 steps, batch 64): with
    ``CollisionAdaptiveBits((8, 16))``, launch counts and depth switches;
    with ``FixedBits(8)``, its lanes bit for bit those of phase 5's
    ``run_curves`` at bits 8 (parameters, loss history, accuracy)."""
    ccfg = cifar_config()
    adaptive = CollisionAdaptiveBits((8, 16))
    res, counts, wall = _counted(
        lambda: tc.run_scheduled_curves(ccfg, adaptive, device=dev))
    _assert_curve_counts(counts, ccfg, 1, "scheduled")
    switches = int(np.count_nonzero(np.diff(res.bits_per_step)))
    assert np.all(np.isfinite(res.loss_history)), "non-finite loss"
    assert set(np.unique(res.bits_per_step)) <= {8, 16}
    print(f"run_scheduled_curves fedocs-cifar width, CollisionAdaptiveBits"
          f"((8, 16)): {ccfg.steps} steps x {len(ccfg.p_miss)} lanes + "
          f"ideal in {wall:.3f} s wall; depth switches {switches}, steps at "
          f"16 bits {int((res.bits_per_step == 16).sum())}; launches "
          f"{counts}; acc {res.acc.tolist()}; collision_frac at the logged "
          f"steps {res.collision_frac.tolist()}", flush=True)
    # thresholds around this grid's collision fractions at 8 bits
    # (0.0038-0.0048 in the run above): the depth moves, and the 16-bit
    # branch trains at this width too
    trigger = CollisionAdaptiveBits((8, 16), escalate=0.0042,
                                    deescalate=0.004, decay=0.0)
    hair, hcounts, hwall = _counted(
        lambda: tc.run_scheduled_curves(ccfg, trigger, device=dev))
    _assert_curve_counts(hcounts, ccfg, 1, "scheduled hair-trigger")
    hswitches = int(np.count_nonzero(np.diff(hair.bits_per_step)))
    assert hswitches > 0, "the hair-trigger schedule never switched"
    assert np.all(np.isfinite(hair.loss_history)), "non-finite loss"
    print(f"run_scheduled_curves hair-trigger {trigger}: {hwall:.3f} s wall;"
          f" depth switches {hswitches}, steps at 16 bits "
          f"{int((hair.bits_per_step == 16).sum())}; acc "
          f"{hair.acc.tolist()}", flush=True)
    fixed, fcounts, fwall = _counted(
        lambda: tc.run_scheduled_curves(ccfg, FixedBits(8), device=dev))
    _assert_curve_counts(fcounts, ccfg, 1, "scheduled FixedBits")
    assert np.array_equal(fixed.loss_history, curves.loss_history[0])
    assert np.array_equal(fixed.acc, curves.acc[0])
    assert np.array_equal(fixed.nll, curves.nll[0])
    for x, y in zip(tree.leaves(fixed.params),
                    tree.leaves(curves.noisy_params[0])):
        assert _bitwise_equal(x, y), "FixedBits(8) lane != run_curves lane"
    print(f"run_scheduled_curves FixedBits(8): {fwall:.3f} s wall; lanes bit "
          "for bit run_curves(bits=(8,))'s noisy lanes (params, loss "
          "history, acc, nll)", flush=True)
    return dict(counts=counts, wall=wall, switches=switches,
                fixed_wall=fwall, trigger_switches=hswitches)


def profile_scheduled(dev) -> dict:
    """Phase 12, profile: 10 steps + eval at the fedocs-cifar width with
    ``CollisionAdaptiveBits((8, 16))`` (one 4-byte read of the next depth
    a step) and with ``FixedBits(8)`` (no read), each timed unprofiled
    twice in turns, then profiled: wall, device busy and idle share."""
    ccfg = cifar_config(steps=10)
    scheds = {"adaptive": CollisionAdaptiveBits((8, 16)),
              "fixed": FixedBits(8)}
    for sch in scheds.values():
        tc.run_scheduled_curves(ccfg, sch, device=dev)
    walls = {k: [] for k in scheds}
    for name in ("adaptive", "fixed", "fixed", "adaptive"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tc.run_scheduled_curves(ccfg, scheds[name], device=dev)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    out = {}
    for name, sch in scheds.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tc.run_scheduled_curves(ccfg, sch, device=dev)
            torch.cuda.synchronize()
        device_s = sum(e.us for e in _card_events(prof)) / 1e6
        wall = float(np.mean(walls[name]))
        out[name] = dict(walls=walls[name], device_s=device_s,
                         idle=1 - device_s / wall)
        print(f"profile scheduled {name}, 10 steps + eval: wall "
              f"{walls[name]} s unprofiled, device busy {device_s:.4f} s, "
              f"idle share {1 - device_s / wall:.3f}", flush=True)
    return out


def _busy(fn):
    """(device busy seconds, device kernels and copies) of ``fn`` under
    torch.profiler, the device side alone."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ev = _card_events(prof)
    return sum(e.us for e in dev_ev) / 1e6, len(dev_ev)


def profile_fault_curves(dev) -> dict:
    """Phase 13, profile: 10 steps + eval at the fedocs-cifar width, bits
    8: ``run_curves`` and ``run_fault_curves`` of ``FaultModel.iid`` lanes
    at the same p_miss values (the same training, plus the chains, the
    outage gating and the fault accounting), timed unprofiled in turns
    (plain, fault, fault, plain), then profiled: wall, device busy,
    kernels per step and idle share."""
    ccfg = cifar_config(steps=10, bits=(8,))
    iid = [faults.FaultModel.iid(p) for p in ccfg.p_miss]
    runs = {"run_curves": lambda: tc.run_curves(ccfg, device=dev),
            "run_fault_curves": lambda: tc.run_fault_curves(ccfg, iid,
                                                            device=dev)}
    for fn in runs.values():
        fn()
    walls = {k: [] for k in runs}
    for name in ("run_curves", "run_fault_curves", "run_fault_curves",
                 "run_curves"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    out = {}
    for name, fn in runs.items():
        busy, launches = _busy(fn)
        wall = float(np.mean(walls[name]))
        out[name] = dict(walls=walls[name], device_s=busy,
                         per_step=launches / 11, idle=1 - busy / wall)
        print(f"profile {name}, 10 steps + eval at bits=8: wall "
              f"{walls[name]} s unprofiled, device busy {busy:.4f} s, idle "
              f"share {1 - busy / wall:.3f}; {launches} device kernels and "
              f"copies ({launches / 11:.0f} per step or evaluation)",
              flush=True)
    return out


def run_fault_curves_phase(dev, curves):
    """Phase 13: ``run_fault_curves`` at the fedocs-cifar width, bits (8,
    16), 60 steps: a grid of ``FaultModel.iid`` lanes at phase 5's p_miss
    values, bit for bit phase 5's noisy lanes; then
    ``benchmarks/fault_sweep.py``'s grid (iid(0) and bursts of 2, 4, 8, 16
    frames, gaps 4x, bad-state misses 0.5, dropout 0.4 / recovery 0.4)
    under ``stale`` and ``zero_fill``, launch counts, dropped and outage
    frames; every loss finite."""
    ccfg = cifar_config()
    iid = [faults.FaultModel.iid(p) for p in ccfg.p_miss]
    res, counts, wall = _counted(
        lambda: tc.run_fault_curves(ccfg, iid, device=dev))
    _assert_curve_counts(counts, ccfg, len(ccfg.bits), "fault iid")
    for f in ("loss_history", "acc", "nll"):
        assert np.array_equal(getattr(res, f), getattr(curves, f)), f
    for bi in range(len(ccfg.bits)):
        for x, y in zip(tree.leaves(res.params[bi]),
                        tree.leaves(curves.noisy_params[bi])):
            assert _bitwise_equal(x, y), "iid fault lane != run_curves lane"
    assert not res.outage_frames.any() and not res.dropped_frames.any()
    print(f"run_fault_curves iid lanes {list(ccfg.p_miss)}: {wall:.3f} s "
          "wall; bit for bit run_curves' noisy lanes at bits 8 and 16 "
          "(params, loss history, acc, nll)", flush=True)
    out = {"iid": dict(counts=counts, wall=wall)}
    for pol in (faults.DegradePolicy.stale(),
                faults.DegradePolicy.zero_fill()):
        grid = _fault_grid(pol)
        fc, counts, wall = _counted(
            lambda: tc.run_fault_curves(ccfg, grid, device=dev))
        _assert_curve_counts(counts, ccfg, len(ccfg.bits), pol.kind)
        assert np.all(np.isfinite(fc.loss_history)), "non-finite loss"
        assert np.all(np.isfinite(fc.nll)), "non-finite eval loss"
        assert fc.outage_frames.sum() > 0, "the burst grid saw no outage"
        print(f"run_fault_curves {pol.kind}, {len(grid)} lanes (iid(0), "
              f"bursts {FAULT_BURSTS}), bits {ccfg.bits}: {wall:.3f} s wall;"
              f" launches {counts}; dropped frames {fc.dropped_frames.tolist()}"
              f", outage frames {fc.outage_frames.tolist()}, max staleness "
              f"{fc.stale_age.max(axis=1).tolist()}", flush=True)
        for line in results.fault_curve_rows(
                results.summarize_fault_curves(fc)):
            print(line)
        out[pol.kind] = dict(counts=counts, wall=wall,
                             outages=fc.outage_frames.tolist())
    return out


def run_faulty_serving(dev, serve):
    """Phase 14: phase 8's traffic (qwen1.5-0.5b full width, 16 Poisson
    requests of 256-token prompts, 16 tokens each, 8 slots, OCS bits 8 at
    p_miss 0.05) under ``FaultModel.burst(4, 16, p_miss_bad=0.5,
    p_miss_good=0.01).with_dropout(0.9, 0.1)``, with ``retry(2)`` and with
    ``stale``: launch counts (contention and ``maxpool.decode`` once per
    layer per tick, flash once per layer per request), outage ticks,
    degraded tokens and retry ticks; every logit finite and the billing
    adding up."""
    m, values, reqs, proto = (serve["m"], serve["values"], serve["reqs"],
                              serve["proto"])
    finite = _watch_logits(m, dev)
    sites = m.channel_sites()
    per_tok = proto.comm_load(QWEN_WORKERS, QWEN_D).uplink_bits * sites
    out = {}
    for pol in (faults.DegradePolicy.retry(2), faults.DegradePolicy.stale()):
        fm = faults.FaultModel.burst(policy=pol, **SERVE_FAULT).with_dropout(
            *SERVE_DROPOUT)
        eng = se.ServeEngine(m, values, se.ServeConfig(
            batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, eos_id=-1,
            protocol=proto, fault=fm), device=dev)
        flags = []
        tick = eng._tick

        def watched(*args, **kw):
            res = tick(*args, **kw)
            flags.append(res[3])
            return res

        eng._tick = watched
        se.reset_dispatch_counts()
        outs, counts, wall = _counted(lambda: eng.run(reqs))
        ticks = se.dispatch_counts()["tick"]
        outage = sum(1 for ok, _ in flags if not ok)
        retrying = sum(1 for _, r in flags if r)
        degraded = sum(c.degraded_tokens for c in outs.values())
        retry_ticks = sum(c.retry_ticks for c in outs.values())
        n_tokens = sum(len(c.tokens) for c in outs.values())
        print(f"faulty serve {QWEN} full width, {pol.kind}: {len(outs)} "
              f"requests, {n_tokens} tokens, {ticks} ticks in {wall:.3f} s "
              f"wall; outage ticks {outage}, held (retry) ticks {retrying}, "
              f"degraded tokens {degraded}, retry ticks billed to requests "
              f"{retry_ticks}; launches {counts}", flush=True)
        assert len(flags) == ticks
        assert counts["flash_attention.fwd"] == QWEN_LAYERS * SERVE_REQUESTS
        assert counts["ocs_contention.noisy"] == sites * ticks, counts
        assert counts["maxpool.decode"] == sites * ticks, counts
        for name in ("ocs_contention.contend", "maxpool.fwd",
                     "ocs_quant.decode", "ocs_quant.encode",
                     "maxpool.winner_bwd", "maxpool.ties_bwd"):
            assert counts[name] == 0, (name, counts)
        assert outage > 0, "no outage tick: the fault path was not driven"
        assert bool(finite["ok"]), "a logit is not finite"
        assert sorted(outs) == list(range(SERVE_REQUESTS))
        for c in outs.values():
            assert len(c.tokens) == SERVE_NEW, (c.rid, len(c.tokens))
            assert c.channel_slots > 0, c.rid
            assert c.uplink_bits == (len(c.tokens) - 1) * per_tok, c.rid
        if pol.kind == "retry":
            assert retrying > 0 and retry_ticks > 0
            assert retrying <= outage
        else:
            assert retrying == 0 and retry_ticks == 0
            assert degraded > 0
        out[pol.kind] = dict(counts=counts, wall=wall, ticks=ticks,
                             outage=outage, held=retrying, degraded=degraded,
                             retry_ticks=retry_ticks)
    return out


def profile_faulty_serving(dev, serve) -> dict:
    """Phase 14, profile: 10 decode ticks at the full width with the 8
    slots filled, under phase 14's fault model with ``stale`` (the chains
    stepped and the policy applied every tick), timed unprofiled, then
    ``PROFILED_TICKS`` more profiled: wall, device busy, launches per tick
    and idle share,
    beside phase 11's channel tick."""
    fm = faults.FaultModel.burst(policy=faults.DegradePolicy.stale(),
                                 **SERVE_FAULT).with_dropout(*SERVE_DROPOUT)
    fm = fm.to(dev)
    eng, proto = serve["eng"], serve["proto"]
    eng._reset()
    eng.fstate = faults.init_state(QWEN_WORKERS, device=dev)
    for slot, req in enumerate(serve["reqs"][:SERVE_SLOTS]):
        eng._insert(slot, req)
    eng._tick(proto, 0, fm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flags = [eng._tick(proto, t, fm)[3] for t in range(1, 11)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, launches = _busy(lambda: [eng._tick(proto, t, fm) for t in
                                    range(11, 11 + PROFILED_TICKS)])
    # the profiled window's device time, scaled to the timed window's 10
    # ticks
    busy *= 10 / PROFILED_TICKS
    print(f"profile, 10 faulty decode ticks at the full width (stale, "
          f"{sum(not ok for ok, _ in flags)} outage ticks of the 10 timed; "
          f"{PROFILED_TICKS} more profiled, device time scaled to 10): "
          f"wall {wall:.4f} s unprofiled ({100 * wall:.2f} ms per tick), "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.3f}; "
          f"{launches / PROFILED_TICKS:.0f} device kernels and copies per "
          f"tick", flush=True)
    return dict(wall=wall, device_s=busy, per_tick=launches / PROFILED_TICKS,
                idle=1 - busy / wall)


def check_new_paths_against_cpu(dev) -> None:
    """Phase 15: a small scheduled grid, a small fault grid and the
    reduced serving config under a fault model, on the card and on the
    CPU (plain versions), compared as phases 6 and 10 compare: losses
    within 1e-3 and accuracies within 2 samples (float order can move an
    embedding across a D-bit bucket edge); depths, fault telemetry and
    tokens reported."""
    ccfg = tc.CurveConfig(bits=(8, 16), p_miss=(0.1, (0.0, 0.1, 0.1, 0.3),
                                                0.4),
                          steps=8, batch=16, n_train=128, n_val=64, hw=8,
                          encoder_dims=(8,), embed_dim=8, head_dims=(8,),
                          log_every=4)
    sch = CollisionAdaptiveBits((8, 16), escalate=0.02, deescalate=0.015,
                                decay=0.5)
    gpu = tc.run_scheduled_curves(ccfg, sch, device=dev)
    cpu = tc.run_scheduled_curves(ccfg, sch, device="cpu")
    loss_err = float(np.max(np.abs(gpu.loss_history - cpu.loss_history)))
    acc_err = float(np.max(np.abs(gpu.acc - cpu.acc))) * ccfg.n_val
    same = bool(np.array_equal(gpu.bits_per_step, cpu.bits_per_step))
    print(f"small scheduled grid card vs CPU: max loss diff {loss_err:.3g}, "
          f"max accuracy diff {acc_err:.0f} of {ccfg.n_val} samples; depths "
          f"equal {same} ({gpu.bits_per_step.tolist()})", flush=True)
    assert loss_err < 1e-3 and acc_err <= 2, (loss_err, acc_err)

    grid = [faults.FaultModel.iid(0.0, policy=faults.DegradePolicy.stale())]
    grid += [faults.FaultModel.burst(
        burst_len=b, gap_len=2 * b, p_miss_bad=0.5, p_miss_good=0.01,
        policy=faults.DegradePolicy.stale()).with_dropout(0.6, 0.3)
        for b in (2, 4)]
    fcfg = dataclasses.replace(ccfg, p_miss=(0.0,))
    gpu = tc.run_fault_curves(fcfg, grid, device=dev)
    cpu = tc.run_fault_curves(fcfg, grid, device="cpu")
    loss_err = float(np.max(np.abs(gpu.loss_history - cpu.loss_history)))
    acc_err = float(np.max(np.abs(gpu.acc - cpu.acc))) * fcfg.n_val
    same = all(np.array_equal(getattr(gpu, f), getattr(cpu, f)) for f in (
        "dropped_frames", "outage_frames", "stale_age", "retry_slots"))
    print(f"small fault grid card vs CPU: max loss diff {loss_err:.3g}, max "
          f"accuracy diff {acc_err:.0f} of {fcfg.n_val} samples; fault "
          f"telemetry equal {same} (outages {gpu.outage_frames.tolist()})",
          flush=True)
    assert loss_err < 1e-3 and acc_err <= 2, (loss_err, acc_err)

    cfg = get_reduced(QWEN, use_flash=True)
    m = M.build(cfg)
    cpu_values = m.init(torch.Generator().manual_seed(0))
    gpu_values = tree.map(lambda t: t.to(dev), cpu_values)
    reqs = poisson_requests(6, SERVE_RATE, cfg.vocab_size, prompt_len=64,
                            max_new_tokens=12, seed=2)
    p = np.full((cfg.n_workers,), SERVE_P_MISS, np.float32)
    for pol in (faults.DegradePolicy.stale(), faults.DegradePolicy.retry(2)):
        fm = faults.FaultModel.burst(policy=pol, **SERVE_FAULT).with_dropout(
            0.6, 0.3)
        config = se.ServeConfig(batch_slots=2, max_seq=96, eos_id=-1,
                                protocol=Protocol.ocs(bits=8, p_miss=p),
                                fault=fm)
        want = se.ServeEngine(m, cpu_values, config, device="cpu").run(reqs)
        got = se.ServeEngine(m, gpu_values, config, device=dev).run(reqs)
        same_tok = sum(a == b for rid in want for a, b in
                       zip(got[rid].tokens, want[rid].tokens))
        total = sum(len(c.tokens) for c in want.values())
        bill = [(c.degraded_tokens, c.retry_ticks) for c in want.values()]
        same_bill = sum((got[r].degraded_tokens, got[r].retry_ticks)
                        == (want[r].degraded_tokens, want[r].retry_ticks)
                        for r in want)
        print(f"serve reduced under faults ({pol.kind}), card vs CPU: "
              f"{same_tok} of {total} tokens equal, degraded tokens and "
              f"retry ticks equal for {same_bill} of {len(want)} requests "
              f"(CPU {bill})", flush=True)


# ---------------------------------------------------------------------------
# the scenario sweep and the compressed-comms DP curves
# ---------------------------------------------------------------------------

def _same_sweep(a, b, what) -> None:
    """Every field of both engines and both latencies of two sweeps,
    bitwise (float values in their raw bits)."""
    for eng in ("clean", "noisy"):
        ra, rb = getattr(a, eng), getattr(b, eng)
        assert (ra is None) == (rb is None), (what, eng)
        if ra is None:
            continue
        pairs = [(f.name, getattr(ra, f.name), getattr(rb, f.name))
                 for f in dataclasses.fields(ra)]
        pairs.append(("latency_slots", getattr(a, eng + "_latency_slots"),
                      getattr(b, eng + "_latency_slots")))
        for name, x, y in pairs:
            assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            assert np.array_equal(x, y), f"{what}: {eng}.{name} card != CPU"


def _bench_comm_sweeps(dev):
    """``benchmarks/bench_comm.py``'s two sweeps on ``dev``: the clean
    O(K)-vs-O(N*K) rows (N 4/16/64, one (N, 64) draw each from
    ``default_rng(0)``) and the noisy degradation rows (N 16, bits 16,
    p_miss 0/.01/.02/.05/.1, 4 rounds, seed 1)."""
    workers = (4, 16, 64)
    rng = np.random.default_rng(0)
    h_by = [rng.standard_normal((n, 64)).astype(np.float32)[None]
            for n in workers]
    t0 = time.perf_counter()
    clean = sweep.run_sweep(
        [scenarios.Scenario(f"bench/N{n}", n_workers=n) for n in workers],
        k_elems=64, rounds=1, h_by_scenario=h_by, include_noisy=False,
        device=dev)
    us = (time.perf_counter() - t0) * 1e6 / len(workers)
    grid = scenarios.scenario_grid(n_workers=(16,), bits=(16,),
                                   p_miss=(0.0, 0.01, 0.02, 0.05, 0.1),
                                   name_prefix="bench")
    noisy = sweep.run_sweep(grid, k_elems=64, rounds=4, seed=1,
                            include_clean=False, device=dev)
    rows = []
    for i, n in enumerate(workers):
        c = clean.clean_cell(i)
        rows.append(f"comm/ocs_sim/N{n},{us:.0f},payload_tx="
                    f"{int(c.payload_tx)};blocking_tx={int(c.blocking_tx)};"
                    f"slots={int(c.contention_slots)};"
                    f"concat_tx={int(c.concat_payload_tx)}")
    for i, sc in enumerate(grid):
        rows.append(f"comm/ocs_noisy/N{sc.n_workers}_p{sc.p_miss:g},0,"
                    f"frac_correct={noisy.noisy.correct[i].mean():.3f};"
                    f"collisions={noisy.noisy.collisions[i].mean():.1f}")
    return clean, noisy, rows


def _assert_sweep_counts(counts, cells, clean: bool, noisy: bool, what):
    """A sweep's launches: the fused contention and the pooling epilogue
    once per (bits, id_bits) sub-group of the noisy engine, the standalone
    encode once per bits group of the clean engine; nothing else."""
    groups = {(s.bits, ocs.host_id_bits(s.n_workers)) for s in cells}
    n_bits = len({s.bits for s in cells})
    want = {k: 0 for k in kernels.KERNELS}
    want["ocs_quant.encode"] = n_bits if clean else 0
    want["ocs_contention.noisy"] = len(groups) if noisy else 0
    want["maxpool.decode"] = len(groups) if noisy else 0
    assert counts == want, (what, counts, want)


def cpu_sweeps() -> tuple:
    """Phase 16's CPU reference: the full grid's sweep on the CPU, its
    wall seconds, and ``bench_comm.py``'s two sweeps there.  It needs no
    card, so it runs in the background pool (:func:`_background`) while
    the earlier phases use the card."""
    t0 = time.perf_counter()
    cpu = sweep.run_sweep(sweep_grid(), k_elems=SWEEP_K, rounds=SWEEP_ROUNDS,
                          device="cpu")
    return cpu, time.perf_counter() - t0, _bench_comm_sweeps("cpu")


def run_sweep_phase(dev, cpu_ref) -> dict:
    """Phase 16: ``run_sweep`` over ``bench_sweep.py``'s full grid and
    ``bench_comm.py``'s two sweeps on the card, counted, and held bitwise
    against the same sweeps on the CPU (``cpu_ref``, the future of
    :func:`cpu_sweeps` in the background pool)."""
    cells = sweep_grid()
    res, counts, wall = _counted(lambda: sweep.run_sweep(
        cells, k_elems=SWEEP_K, rounds=SWEEP_ROUNDS, device=dev))
    _assert_sweep_counts(counts, cells, True, True, "grid")
    t0 = time.perf_counter()
    cpu, cpu_wall, (cclean, cnoisy, crows) = cpu_ref.result()
    print(f"run_sweep: waited {time.perf_counter() - t0:.3f} s for the CPU "
          "reference of the background pool", flush=True)
    _same_sweep(res, cpu, "grid")
    rows = results.to_rows(results.summarize(res))
    assert rows == results.to_rows(results.summarize(cpu))
    assert 0 < res.noisy.correct.mean() < 1, "the grid saw no noise"
    print(f"run_sweep {len(cells)} cells x {SWEEP_ROUNDS} rounds, K "
          f"{SWEEP_K}, N up to {res.n_max}: {wall:.3f} s wall on the card "
          f"({cpu_wall:.3f} s on the CPU, plain versions); launches "
          f"{counts}; every field of both engines and both latencies "
          "bitwise the CPU's", flush=True)
    for line in rows:
        print(line)
    (bclean, bnoisy, brows), bcounts, bwall = _counted(
        lambda: _bench_comm_sweeps(dev))
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"ocs_quant.encode": 1, "ocs_contention.noisy": 1,
                 "maxpool.decode": 1})
    assert bcounts == want, bcounts
    _same_sweep(bclean, cclean, "bench_comm clean")
    _same_sweep(bnoisy, cnoisy, "bench_comm noisy")
    assert [r.split(",", 2)[::2] for r in brows] == \
        [r.split(",", 2)[::2] for r in crows]
    print(f"bench_comm sweeps: {bwall:.3f} s wall on the card; launches "
          f"{bcounts}; bitwise the CPU's", flush=True)
    for line in brows:
        print(line)
    return dict(counts=counts, wall=wall, cpu_wall=cpu_wall,
                bench_wall=bwall, result=res)


def _dp_config(**overrides):
    return cifar_config(dp_shards=DP_SHARDS, **overrides)


def run_dp_phase(dev) -> dict:
    """Phase 17: ``run_curves_dp`` at the fedocs-cifar width, 2 ranks,
    top-k 1/8, counted: the measured payload equal to the analytic bill
    at every logged step and over the run; then a reduced grid on the
    card against the CPU: the accounting bitwise, losses within phase 6's
    1e-3 and accuracies within 2 samples (float order can move an
    embedding across a D-bit bucket edge)."""
    ccfg = _dp_config()
    car = CompressedAllReduce.topk(DP_K_FRAC)
    res, counts, wall = _counted(
        lambda: tc.run_curves_dp(ccfg, car, device=dev))
    sites = (ccfg.steps + 1) * len(ccfg.bits)
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"ocs_contention.noisy": sites, "maxpool.decode": sites,
                 "maxpool.winner_bwd": ccfg.steps * len(ccfg.bits)})
    assert counts == want, (counts, want)
    one_rank = tree.map(lambda x: x[0], res.params[0])
    assert res.dp_payload_bits_step == car.payload_bits(one_rank) * DP_SHARDS
    assert res.dp_dense_bits_step == car.dense_bits(one_rank) * DP_SHARDS
    assert np.all(res.dp_payload_bits == res.dp_payload_bits_step), \
        "measured DP payload != the exact-k bill"
    assert np.all(res.dp_payload_bits_total
                  == res.dp_payload_bits_step * ccfg.steps)
    for arr in (res.loss_history, res.nll):
        assert np.all(np.isfinite(arr)), "non-finite loss"
    assert np.all(np.isfinite(res.acc)) and np.all(
        (0 <= res.acc) & (res.acc <= 1))
    print(f"run_curves_dp fedocs-cifar width: {ccfg.steps} steps x "
          f"{len(ccfg.bits)} bits x {len(ccfg.p_miss)} lanes x {DP_SHARDS} "
          f"ranks, top-k {DP_K_FRAC:g}: {wall:.3f} s wall; launches "
          f"{counts}; measured DP payload {res.dp_payload_bits_step} bits a "
          f"step (dense {res.dp_dense_bits_step}) at every logged step, "
          f"{res.dp_payload_bits_total.tolist()} over the run; acc "
          f"{res.acc.tolist()}", flush=True)
    for line in results.dp_curve_rows(results.summarize_dp_curves(res)):
        print(line)

    small = tc.CurveConfig(bits=(8, 16), p_miss=(0.0, 0.3), steps=8,
                           batch=16, n_train=128, n_val=64, hw=8,
                           encoder_dims=(8,), embed_dim=8, head_dims=(8,),
                           log_every=4, dp_shards=2)
    gpu = tc.run_curves_dp(small, car, device=dev)
    cpu = tc.run_curves_dp(small, car, device="cpu")
    for f in ("dp_payload_bits", "dp_payload_bits_total",
              "dp_payload_bits_step", "dp_dense_bits_step"):
        assert np.array_equal(getattr(gpu, f), getattr(cpu, f)), f
    loss_err = float(np.max(np.abs(gpu.loss_history - cpu.loss_history)))
    acc_err = float(np.max(np.abs(gpu.acc - cpu.acc))) * small.n_val
    print(f"small DP grid card vs CPU: accounting equal; max loss diff "
          f"{loss_err:.3g}, max accuracy diff {acc_err:.0f} of "
          f"{small.n_val} samples", flush=True)
    assert loss_err < 1e-3 and acc_err <= 2, (loss_err, acc_err)
    return dict(counts=counts, wall=wall, result=res)


def profile_dp(dev) -> dict:
    """Phase 17, profile: 10 steps + eval of ``run_curves_dp`` at the
    fedocs-cifar width, bits 8, 2 ranks, beside ``run_curves`` at the same
    width, timed unprofiled in turns (plain, dp, dp, plain), then
    profiled: wall, device busy, kernels per step and idle share."""
    car = CompressedAllReduce.topk(DP_K_FRAC)
    runs = {"run_curves": lambda: tc.run_curves(
                cifar_config(steps=10, bits=(8,)), device=dev),
            "run_curves_dp": lambda: tc.run_curves_dp(
                _dp_config(steps=10, bits=(8,)), car, device=dev)}
    for fn in runs.values():
        fn()
    walls = {k: [] for k in runs}
    for name in ("run_curves", "run_curves_dp", "run_curves_dp",
                 "run_curves"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    out = {}
    for name, fn in runs.items():
        busy, launches = _busy(fn)
        wall = float(np.mean(walls[name]))
        out[name] = dict(walls=walls[name], device_s=busy,
                         per_step=launches / 11, idle=1 - busy / wall)
        print(f"profile {name}, 10 steps + eval at bits=8: wall "
              f"{walls[name]} s unprofiled, device busy {busy:.4f} s, idle "
              f"share {1 - busy / wall:.3f}; {launches} device kernels and "
              f"copies ({launches / 11:.0f} per step or evaluation)",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# the LM trainer with checkpoints, serving from its checkpoint, and the
# channel trainer hook
# ---------------------------------------------------------------------------

def _train_site_input(dev, e, seed, ties=False, offset=0,
                      n=QWEN_WORKERS, dtype=torch.bfloat16):
    """(``n`` workers, ``e`` columns) bf16 (or ``dtype``) partials: randn,
    or with ``ties`` values on a coarse grid (many workers tie at the
    max), -0.0 beside +0.0 at a zero max, +-inf, and NaNs in a few
    columns: positive ones in column 4 of every 64, a negative one (sign
    bit set) alone in column 41 of every 64.  ``offset`` elements before
    the first make the base pointer misaligned.  The special workers are
    3, 9, 5, 6 and 12 modulo ``n`` (distinct for ``n`` 8 and 16)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if not ties:
        h = torch.randn((n, e), generator=gen)
    else:
        h = torch.randint(-4, 3, (n, e), generator=gen) / 2.0
        h[:, 1::7] = -1.0
        h[3 % n, 1::7], h[9 % n, 1::7] = -0.0, 0.0   # a -0.0/+0.0 tie at 0
        h[5 % n, 2::11] = float("inf")
        h[:, 3::13] = -float("inf")
        h[6 % n, 4::64] = float("nan")
    h = h.to(dtype)
    if ties and dtype == torch.bfloat16:
        h.view(torch.int16)[12 % n, 41::64] = -0x003F    # 0xFFC1
    elif ties:
        h.view(torch.int32)[12 % n, 41::64] = -0x003FFFFF   # 0xFFC00001
    buf = torch.empty(h.numel() + offset, dtype=dtype, device=dev)
    out = buf[offset:].view(h.shape)
    out.copy_(h)
    return out


def _site_cotangent(dev, shape, seed, special=False):
    """bf16 cotangents; with ``special`` +-0 and +-inf in some columns."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g = torch.randn(shape, generator=gen)
    if special:
        flat = g.view(-1)
        flat[0::5], flat[1::5] = 0.0, -0.0
        flat[2::37], flat[3::41] = float("inf"), -float("inf")
    return g.to(torch.bfloat16).to(dev)


def _same_nan_as_nan(a, b, what) -> None:
    """Bitwise equal where not NaN, NaN at the same places (a NaN's
    payload is the device's)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    assert torch.equal(na, nb), f"{what}: NaN at other places"
    z = torch.zeros_like(a)
    assert _bitwise_equal(torch.where(na, z, a), torch.where(nb, z, b)), \
        f"{what}: differs"


def check_train_maxpool(dev, row) -> dict:
    """Phase 3, the LM train step's fusion site, (16 workers, 8 x 256
    tokens x 1024) bfloat16 partials (the ``tie_break="all"`` law):
    ``maxpool.fwd`` bitwise against its plain version for each subset of
    its optional outputs (winner, tie mask) on randn partials and on
    partials with forced ties, +-0, +-inf and NaNs, also at a ragged
    e (1003) and a misaligned base (e 1000); ``maxpool.ties_bwd`` bitwise
    against its plain version and against the torch composition it
    replaces, ``g * (h == max)``, for finite cotangents and, NaN as NaN,
    for cotangents with +-0 and +-inf.  Timed: the law's forward (the
    pooled max and the tie mask, no winner) beside ``torch.max(dim=0)``
    and the winner form, the backward beside that composition.  Bytes:
    the partials read, the max and the mask (or winner) written; the mask
    and the cotangent read, the gradient written."""
    shape = (QWEN_WORKERS, TRAIN_BATCH, TRAIN_SEQ, QWEN_D)
    cols = math.prod(shape[1:])
    cases = {"randn": _train_site_input(dev, cols, 18).view(shape),
             "ties": _train_site_input(dev, cols, 19, ties=True).view(shape),
             "ragged e 1003": _train_site_input(dev, 1003, 20, ties=True),
             "misaligned e 1000": _train_site_input(dev, 1000, 21, ties=True,
                                                    offset=1)}
    for what, h in cases.items():
        for winner in (False, True):
            for ties in (False, True):
                _check_equal(
                    "maxpool.fwd",
                    lambda: _present(mp_ops.maxpool_fwd(h, 0, winner=winner,
                                                        ties=ties)),
                    lambda: _present(mp_ref.maxpool_fwd(h, 0, winner=winner,
                                                        ties=ties)),
                    dict(input=what, winner=winner, ties=ties))
        _check_ties_bwd(dev, h, 22, what)
    print(f"maxpool.fwd at the train site: bitwise equal to plain for 4 "
          f"output subsets x {len(cases)} inputs ({list(cases)}); "
          f"maxpool.ties_bwd bitwise equal to plain and to g * (h == max) "
          f"(NaN as NaN where g holds +-inf)", flush=True)

    h = cases["randn"]
    nbytes_fwd = h.numel() * 2 + cols * (2 + 2)
    out = {("maxpool.fwd", "train"): row(
        "maxpool.fwd", lambda: mp_ops.maxpool_ties(h, 0),
        lambda: mp_ref.maxpool_ties(h, 0), nbytes_fwd, 2 * h.numel(),
        lambda: torch.max(h, dim=0),
        dict(shape=list(h.shape), dtype="bfloat16", path="train",
             outputs="pooled, ties"))}
    out[("maxpool.fwd[winner]", "train")] = row(
        "maxpool.fwd[winner]", lambda: mp_ops.maxpool_fused(h, 0),
        lambda: mp_ref.maxpool_fused(h, 0), h.numel() * 2 + cols * (2 + 4),
        h.numel(), lambda: torch.max(h, dim=0),
        dict(shape=list(h.shape), dtype="bfloat16", path="train",
             outputs="pooled, winner"))
    pooled, mask = mp_ops.maxpool_ties(h, 0)
    g = _site_cotangent(dev, h.shape[1:], 23)
    out[("maxpool.ties_bwd", "train")] = row(
        "maxpool.ties_bwd",
        lambda: mp_ops.maxpool_ties_bwd(mask, g, QWEN_WORKERS, 0),
        lambda: mp_ref.ties_bwd(mask, g, QWEN_WORKERS, 0),
        cols * (2 + 2) + h.numel() * 2, h.numel(),
        lambda: g.unsqueeze(0) * (h == pooled.unsqueeze(0)).to(h.dtype),
        dict(shape=list(h.shape), dtype="bfloat16", path="train",
             library="g * (h == max) (3 launches)"))
    return out


def _check_ties_bwd(dev, h, seed: int, what: str) -> None:
    """``maxpool.ties_bwd`` from the kernel's tie mask of ``h`` bitwise
    against its plain version and ``g * (h == max)``, for a finite
    cotangent and, NaN as NaN, for one with +-0 and +-inf."""
    pooled, mask = mp_ops.maxpool_ties(h, 0)
    for special in (False, True):
        g = _site_cotangent(dev, h.shape[1:], seed, special)
        got = mp_ops.maxpool_ties_bwd(mask, g, h.shape[0], 0)
        composed = g.unsqueeze(0) * (h == pooled.unsqueeze(0)).to(h.dtype)
        for want, by in ((mp_ref.ties_bwd(mask, g, h.shape[0], 0),
                          "plain"), (composed, "g * (h == max)")):
            if special:
                _same_nan_as_nan(got, want, f"ties_bwd {what} vs {by}")
            else:
                assert _bitwise_equal(got, want), \
                    f"ties_bwd {what} vs {by}: differs"


def _check_fwd_subsets(cases, shape, path) -> None:
    """``maxpool.fwd`` bitwise against its plain version for each subset
    of its optional outputs, on each of ``cases``' (workers, cols) inputs
    viewed as ``shape``."""
    for what, h in cases.items():
        h = h.view(shape)
        for winner in (False, True):
            for ties in (False, True):
                _check_equal(
                    "maxpool.fwd",
                    lambda: _present(mp_ops.maxpool_fwd(h, 0, winner=winner,
                                                        ties=ties)),
                    lambda: _present(mp_ref.maxpool_fwd(h, 0, winner=winner,
                                                        ties=ties)),
                    dict(input=what, winner=winner, ties=ties, path=path))
    print(f"maxpool.fwd at {path} {shape}: bitwise equal to plain for 4 "
          f"output subsets x {len(cases)} inputs", flush=True)


def check_tp_sites(dev) -> None:
    """Phase 3, the kernels at the shapes that phase 34's ranks give them
    (each rank of the (1 x ``TP_RANKS``) mesh holds 8 of qwen1.5's 16
    workers and heads): ``maxpool.fwd`` bitwise against its plain version
    for each subset of its optional outputs at the train site (8 workers,
    8 x 256 x 1024), a prefill's (8, 1 x 256 x 1024) and a tick's (8, 8 x
    1 x 1024), on randn partials and on partials with forced ties, +-0,
    +-inf and NaNs; ``maxpool.ties_bwd`` at the train site bitwise against
    its plain version and ``g * (h == max)``; flash over 8 heads, causal
    bf16, at the train step's (8, 8, 256, 64) and a prefill's (1, 8, 256,
    64) within :func:`_check_flash`'s limit."""
    n = QWEN_WORKERS // TP_RANKS
    for path, shape in (
            ("tp train", (n, TRAIN_BATCH, TRAIN_SEQ, QWEN_D)),
            ("tp serve prefill", (n, 1, SERVE_PROMPT, QWEN_D)),
            ("tp serve tick", (n, SERVE_SLOTS, 1, QWEN_D))):
        cols = math.prod(shape[1:])
        cases = {"randn": _train_site_input(dev, cols, 60, n=n),
                 "ties": _train_site_input(dev, cols, 61, ties=True, n=n)}
        _check_fwd_subsets(cases, shape, path)
        if path == "tp train":
            for what, h in cases.items():
                _check_ties_bwd(dev, h.view(shape), 62, f"{path} {what}")
            print(f"maxpool.ties_bwd at {path} {shape}: bitwise equal to "
                  f"plain and to g * (h == max) (NaN as NaN where g holds "
                  f"+-inf)", flush=True)
    h = QWEN_HEADS // TP_RANKS
    for site, b, seq in (("tp train", TRAIN_BATCH, TRAIN_SEQ),
                         ("tp serve prefill", 1, SERVE_PROMPT)):
        q, k, v = _flash_case(dev, b, h, h, seq, QWEN_D // QWEN_HEADS,
                              seed=63 + b)
        _check_flash(fa_ops.flash_attention(q, k, v, True),
                     fa_ref.flash_attention(q, k, v, True),
                     f"{tuple(q.shape)} Hkv {h} bf16 causal=True ({site})")


def _tpm_sites():
    """Phase 35's max sites, each over a rank's 8 of 16 workers and over
    all 16 in the one-device run it is held to: (path, the site's rows
    and width, dtype, whether a backward runs there).  bf16: qwen3-moe's
    attention site in a step, a prefill and a tick of 8 slots; xlstm's
    mLSTM sites in a step (2 x 256), a prefill and a tick of 2 slots;
    jamba's mamba, attention and mlp sites in a 64-token prefill (and the
    gradient reading's backward) and its mamba and attention sites in a
    tick of 2; whisper's mlp sites in a step and in a prefill of 2 x 1,408
    frames and of the 4-token prompt; pixtral's in a prefill of 2 x 1,024
    patches and a tick of 2.  float32: the logits readings' one-row
    prefill and decode steps."""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("qwen3-moe train", (TRAIN_BATCH, TRAIN_SEQ, MOE_D), bf, True),
        ("qwen3-moe prefill", (1, SERVE_PROMPT, MOE_D), bf, False),
        ("qwen3-moe tick", (SERVE_SLOTS, 1, MOE_D), bf, False),
        ("xlstm train", (TPM_XLSTM_BATCH, TRAIN_SEQ, XLSTM_D), bf, True),
        ("xlstm prefill", (1, SERVE_PROMPT, XLSTM_D), bf, False),
        ("xlstm tick", (WIDE_REQUESTS, 1, XLSTM_D), bf, False),
        ("jamba prefill", (1, JAMBA_PROMPT, JAMBA_D), bf, True),
        ("jamba tick", (WIDE_REQUESTS, 1, JAMBA_D), bf, False),
        ("whisper train", (WHISPER_BATCH, WHISPER_SEQ, WHISPER_D), bf, True),
        ("whisper encoder prefill", (WIDE_REQUESTS, WHISPER_FRAMES,
                                     WHISPER_D), bf, False),
        ("whisper decoder prefill", (WIDE_REQUESTS, len(WHISPER_SOT),
                                     WHISPER_D), bf, False),
        ("pixtral prefill", (WIDE_REQUESTS, PIXTRAL_PATCHES, PIXTRAL_D), bf,
         False),
        ("pixtral tick", (WIDE_REQUESTS, 1, PIXTRAL_D), bf, False),
        ("qwen3-moe logits prefill", (1, SERVE_PROMPT, MOE_D), f32, False),
        ("qwen3-moe logits step", (1, 1, MOE_D), f32, False),
        ("xlstm logits prefill", (1, SERVE_PROMPT, XLSTM_D), f32, False),
        ("xlstm logits step", (1, 1, XLSTM_D), f32, False),
        ("whisper logits encoder", (1, WHISPER_FRAMES, WHISPER_D), f32,
         False),
        ("whisper logits decoder", (1, len(WHISPER_SOT), WHISPER_D), f32,
         False),
        ("whisper logits step", (1, 1, WHISPER_D), f32, False),
        ("pixtral logits prefill", (1, PIXTRAL_PATCHES, PIXTRAL_D), f32,
         False),
        ("pixtral logits step", (1, 1, PIXTRAL_D), f32, False)]


def _tpm_flash():
    """Phase 35's flash launches, bf16, with every head (the one-device
    run) and a rank's half: (path, (b, h, hkv, s, d), causal).
    qwen3-moe's 32 heads over 4 KV heads in a step and a prefill; jamba's
    64 over 8 in a prefill; whisper's 8 heads, non-causal in the encoder
    (a step's 384 frames, 2 x 1,408 in serving) and causal in the decoder
    (a step, the 4-token prompt); pixtral's 32 over 8 in a prefill of 2 x
    1,024 patches.  The float32 logits readings run without flash."""
    return [
        ("qwen3-moe train", (TRAIN_BATCH, 32, 4, TRAIN_SEQ, 128), True),
        ("qwen3-moe prefill", (1, 32, 4, SERVE_PROMPT, 128), True),
        ("jamba prefill", (1, 64, 8, JAMBA_PROMPT, 128), True),
        ("whisper encoder train", (WHISPER_BATCH, 8, 8, WHISPER_SEQ, 64),
         False),
        ("whisper encoder serve", (WIDE_REQUESTS, 8, 8, WHISPER_FRAMES, 64),
         False),
        ("whisper decoder train", (WHISPER_BATCH, 8, 8, WHISPER_SEQ, 64),
         True),
        ("whisper decoder prefill", (WIDE_REQUESTS, 8, 8, len(WHISPER_SOT),
                                     64), True),
        ("pixtral prefill", (WIDE_REQUESTS, 32, 8, PIXTRAL_PATCHES, 128),
         True)]


def check_tp_model_sites(dev) -> None:
    """Phase 3, the kernels at the shapes that phase 35 gives them, on a
    rank (8 of 16 workers, half the heads) and in the one-device runs it
    is held to: ``maxpool.fwd`` bitwise against its plain version for
    each subset of its optional outputs at every site of
    :func:`_tpm_sites`, on randn partials and on partials with forced
    ties, +-0, +-inf and NaNs; ``maxpool.ties_bwd`` bitwise against its
    plain version and ``g * (h == max)`` where a backward runs; flash
    within :func:`_check_flash`'s limit at every case of
    :func:`_tpm_flash`; ``noisy`` and ``maxpool.decode`` bitwise at
    whisper's channel site in a tick of 2 rows (the whole 16-worker stack,
    which a channel site gathers)."""
    seed = 70
    for path, rows, dtype, train in _tpm_sites():
        for n in (QWEN_WORKERS // TP_RANKS, QWEN_WORKERS):
            shape = (n,) + rows
            cols = math.prod(rows)
            cases = {"randn": _train_site_input(dev, cols, seed, n=n,
                                                dtype=dtype),
                     "ties": _train_site_input(dev, cols, seed + 1,
                                               ties=True, n=n, dtype=dtype)}
            seed += 2
            _check_fwd_subsets(cases, shape, f"tp {path} {dtype}")
            if train:
                for what, h in cases.items():
                    _check_ties_bwd(dev, h.view(shape), seed,
                                    f"tp {path} {what}")
                print(f"maxpool.ties_bwd at tp {path} {shape}: bitwise "
                      f"equal to plain and to g * (h == max)", flush=True)
            del cases
    for path, (b, h, hkv, seq, d), causal in _tpm_flash():
        for ways in (1, TP_RANKS):
            q, k, v = _flash_case(dev, b, h // ways, hkv // ways, seq, d,
                                  seed=b + h // ways + seq)
            _check_flash(fa_ops.flash_attention(q, k, v, causal),
                         fa_ref.flash_attention(q, k, v, causal),
                         f"{tuple(q.shape)} Hkv {hkv // ways} bf16 "
                         f"causal={causal} (tp {path})")
    for name, launch, plain, *_, shape in _kernel_cases(
            dev, 1, WIDE_REQUESTS * WHISPER_D, 8, seed=68, n=QWEN_WORKERS,
            dtype=torch.bfloat16, p_miss=(SERVE_P_MISS,)):
        if name in ("ocs_contention.noisy", "maxpool.decode"):
            _check_equal(name, launch, plain, dict(bits=8, shape=shape,
                                                   path="tp whisper tick"))
            print(f"{name} at the tp whisper tick {shape}: bitwise equal to "
                  f"plain", flush=True)


def check_moe_site(dev, row) -> dict:
    """Phase 3, the MoE slice's max-fusion site (the attention
    out-projection of qwen3-moe-30b-a3b), (16 workers, 8 x 256 tokens x
    2048) bfloat16 in the train step and phase 22's serve widths (a
    256-token prefill, a tick of 8 slots): ``maxpool.fwd`` bitwise against
    its plain version for each subset of its optional outputs on randn
    partials and on partials with forced ties, +-0, +-inf and NaNs; at the
    train step's width ``maxpool.ties_bwd``
    bitwise against its plain version and ``g * (h == max)``.  Timed: the
    law's form beside ``torch.max(dim=0)``, the backward beside that
    composition."""
    # the serve path's widths: one 256-token prefill, one tick of 8 slots
    for site, serve_shape in (
            ("prefill", (QWEN_WORKERS, 1, SERVE_PROMPT, MOE_D)),
            ("tick", (QWEN_WORKERS, SERVE_SLOTS, 1, MOE_D))):
        n_cols = math.prod(serve_shape[1:])
        _check_fwd_subsets(
            {"randn": _train_site_input(dev, n_cols, 34),
             "ties": _train_site_input(dev, n_cols, 35, ties=True)},
            serve_shape, f"moe serve {site}")
    shape = (QWEN_WORKERS, TRAIN_BATCH, TRAIN_SEQ, MOE_D)
    cols = math.prod(shape[1:])
    cases = {"randn": _train_site_input(dev, cols, 30).view(shape),
             "ties": _train_site_input(dev, cols, 31, ties=True).view(shape)}
    _check_fwd_subsets(cases, shape, "moe")
    for what, h in cases.items():
        _check_ties_bwd(dev, h, 32, what)
    print(f"maxpool.ties_bwd at the MoE site {shape}: bitwise equal to "
          f"plain and to g * (h == max) on {len(cases)} inputs", flush=True)
    h = cases["randn"]
    out = {("maxpool.fwd", "moe"): row(
        "maxpool.fwd", lambda: mp_ops.maxpool_ties(h, 0),
        lambda: mp_ref.maxpool_ties(h, 0), h.numel() * 2 + cols * (2 + 2),
        2 * h.numel(), lambda: torch.max(h, dim=0),
        dict(shape=list(h.shape), dtype="bfloat16", path="moe",
             outputs="pooled, ties"))}
    pooled, mask = mp_ops.maxpool_ties(h, 0)
    g = _site_cotangent(dev, h.shape[1:], 33)
    out[("maxpool.ties_bwd", "moe")] = row(
        "maxpool.ties_bwd",
        lambda: mp_ops.maxpool_ties_bwd(mask, g, QWEN_WORKERS, 0),
        lambda: mp_ref.ties_bwd(mask, g, QWEN_WORKERS, 0),
        cols * (2 + 2) + h.numel() * 2, h.numel(),
        lambda: g.unsqueeze(0) * (h == pooled.unsqueeze(0)).to(h.dtype),
        dict(shape=list(h.shape), dtype="bfloat16", path="moe",
             library="g * (h == max) (3 launches)"))
    return out


def _same_tree(a, b) -> bool:
    """Bitwise equality of two trees (dataclass carries field by field)."""
    if a is None or b is None:
        return a is b
    if dataclasses.is_dataclass(a):
        return all(_same_tree(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        _bitwise_equal(x, y) for x, y in zip(la, lb))


def _rows(history, first_step=0) -> list:
    """History rows from ``first_step`` on, without the host-clock time."""
    return [{k: v for k, v in r.items() if k != "step_time_s"}
            for r in history if r["step"] >= first_step]


def _assert_same_run(a, b, what, first_step=0) -> None:
    assert _same_tree(a.values, b.values), f"{what}: values differ"
    assert _same_tree(a.opt_state, b.opt_state), f"{what}: opt state differs"
    assert _same_tree(a.aux_state, b.aux_state), f"{what}: aux differs"
    assert _rows(a.history, first_step) == _rows(b.history, first_step), \
        f"{what}: history differs"


def _preempt(ckpt_dir: str, step: int) -> None:
    """Leave ``ckpt_dir`` as a job preempted after its step-``step``
    checkpoint left it: later step directories and the pointer gone."""
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and int(name[5:]) > step:
            shutil.rmtree(os.path.join(ckpt_dir, name))
    pathlib.Path(ckpt_dir, "latest").write_text(str(step))


def _without_remat(run):
    """``launch_train.setup``'s ``run`` with ``remat=False``.  The full
    configs keep the JAX default ``remat=True``; the train phases before
    phase 37 measure the step without the recompute (their launch counts
    and peaks are each step's forward once), and phase 37 holds the
    default, remat, to it."""
    run.cfg = run.cfg.with_(remat=False)
    run.m = M.build(run.cfg)
    return run


def _train_run(ckpt_dir, steps=TRAIN_STEPS):
    """``launch/train``'s run at the full qwen1.5-0.5b width (fusion
    ``max``, flash), every step logged, a checkpoint every 3 steps."""
    argv = ["--arch", QWEN, "--steps", str(steps), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", "0"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", ckpt_dir]
    run = _without_remat(launch_train.setup(launch_train.parse_args(argv)))
    run.tcfg = dataclasses.replace(run.tcfg, ckpt_every=TRAIN_CKPT_EVERY,
                                   log_every=1)
    return run


def _assert_train_counts(counts, steps, what) -> None:
    """Per step: flash once per layer (the forward; the backward recomputes
    through the plain version), ``maxpool.fwd`` (the pooled max and the tie
    mask) and ``maxpool.ties_bwd`` at both fusion sites of every layer,
    nothing else."""
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"flash_attention.fwd": QWEN_LAYERS * steps,
                 "maxpool.fwd": 2 * QWEN_LAYERS * steps,
                 "maxpool.ties_bwd": 2 * QWEN_LAYERS * steps})
    assert counts == want, (what, counts, want)


def run_train_phase(dev) -> dict:
    """Phase 18: ``launch/train`` at the full qwen1.5-0.5b width (bf16,
    random weights from seed 0, ``--fusion max``, flash), batch 8 x 256
    tokens, ``adamw(for_arch(...))``, 6 steps with a checkpoint every 3,
    counted; a second uninterrupted run bitwise the first (deterministic
    backward passes); the job preempted after its step-3 checkpoint and
    relaunched, bitwise the uninterrupted run from step 3 on (values,
    optimizer state, history); then ``launch/serve --ckpt-dir`` on the
    final checkpoint serves phase 8's traffic with ``--sample``, its
    values bitwise the trainer's.  The checkpoints live in a directory
    under ``build/`` that the phase removes."""
    work = ROOT / "build" / "train_ckpt"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=work)
    try:
        usage = shutil.disk_usage(ckpt)
        print(f"train: checkpoints under {work}: {usage.free / 2**30:.1f} "
              f"GiB free of {usage.total / 2**30:.1f} GiB", flush=True)
        run = _train_run(ckpt)
        n_params = sum(t.numel() for t in tree.leaves(run.values))
        assert n_params == QWEN_PARAMS, n_params
        torch.cuda.reset_peak_memory_stats()
        full, counts, wall = _counted(lambda: launch_train.launch(run))
        peak = torch.cuda.max_memory_allocated()
        _assert_train_counts(counts, TRAIN_STEPS, "uninterrupted")
        losses = [r["loss"] for r in full.history]
        grad_norms = [r["grad_norm"] for r in full.history]
        assert len(losses) == TRAIN_STEPS and all(
            math.isfinite(x) for x in losses), losses
        saved = sorted(n for n in os.listdir(ckpt) if n.startswith("step_"))
        size = sum(f.stat().st_size for f in
                   pathlib.Path(ckpt, saved[-1]).iterdir())
        print(f"train {QWEN} full width ({n_params} parameters, bf16, "
              f"fusion max, flash): {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens in {wall:.3f} s wall (checkpoints "
              f"{saved}, {size / 2**30:.2f} GiB each, included); losses "
              f"{losses}; step host times "
              f"{[round(r['step_time_s'], 4) for r in full.history]}; peak "
              f"device memory {peak / 2**30:.2f} GiB ({peak} bytes; 21.67 "
              f"GiB while the max law kept each site's partials for its "
              f"backward); launches {counts}",
              flush=True)

        again, counts2, wall2 = _counted(
            lambda: launch_train.launch(_train_run(None)))
        _assert_train_counts(counts2, TRAIN_STEPS, "second run")
        _assert_same_run(full, again, "two uninterrupted runs")
        del again
        print(f"train: a second uninterrupted run ({wall2:.3f} s, no "
              f"checkpoints) bitwise the first: values, optimizer state, "
              f"history", flush=True)

        _preempt(ckpt, TRAIN_CKPT_EVERY)
        resumed, counts3, wall3 = _counted(
            lambda: launch_train.launch(_train_run(ckpt)))
        rest = TRAIN_STEPS - TRAIN_CKPT_EVERY
        _assert_train_counts(counts3, rest, "resumed")
        assert resumed.history[0]["step"] == TRAIN_CKPT_EVERY, \
            resumed.history[0]
        _assert_same_run(full, resumed, "resume", TRAIN_CKPT_EVERY)
        del resumed
        print(f"train: relaunched after preemption at step "
              f"{TRAIN_CKPT_EVERY}, {rest} steps in {wall3:.3f} s (restore "
              f"and checkpoints included), bitwise the uninterrupted run",
              flush=True)

        srv = launch_serve.setup(launch_serve.parse_args([
            "--arch", QWEN, "--ckpt-dir", ckpt, "--sample", "--seed", "0",
            "--batch-slots", str(SERVE_SLOTS), "--max-seq",
            str(SERVE_MAX_SEQ), "--eos-id", "-1", "--p-miss",
            str(SERVE_P_MISS), "--bits", "8", "--requests",
            str(SERVE_REQUESTS), "--rate", str(SERVE_RATE), "--prompt-len",
            str(SERVE_PROMPT), "--max-new", str(SERVE_NEW)]))
        eng = srv.engine
        assert srv.step == TRAIN_STEPS, srv.step
        assert _same_tree(eng.values, full.values), \
            "restored values != the trainer's"
        del full
        finite = _watch_logits(eng.m, dev)
        se.reset_dispatch_counts()
        outs, counts4, wall4 = _counted(lambda: eng.run(srv.requests))
        ticks = se.dispatch_counts()["tick"]
        sites = eng.m.channel_sites()
        want = {k: 0 for k in kernels.KERNELS}
        want.update({"flash_attention.fwd": QWEN_LAYERS * SERVE_REQUESTS,
                     "ocs_contention.noisy": sites * ticks,
                     "maxpool.decode": sites * ticks})
        assert counts4 == want, (counts4, want)
        assert bool(finite["ok"]), "a logit is not finite"
        assert sorted(outs) == list(range(SERVE_REQUESTS))
        assert all(len(c.tokens) == SERVE_NEW for c in outs.values())
        n_tok = sum(len(c.tokens) for c in outs.values())
        print(f"serve from the step-{srv.step} checkpoint, sampling: "
              f"{len(outs)} requests, {n_tok} tokens, {ticks} ticks in "
              f"{wall4:.3f} s wall; restored values bitwise the trainer's; "
              f"launches {counts4}; request 0 tokens {outs[0].tokens}",
              flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return dict(counts=counts, wall=wall, resumed_wall=wall3, peak=peak,
                losses=losses,
                grad_norms=grad_norms,
                serve_counts=counts4, serve_wall=wall4)


def _categorize(name: str) -> str:
    if "flash_" in name:
        return "flash_attention.fwd"
    if "maxpool_fwd_" in name:
        return "maxpool.fwd"
    if "ties_bwd_kernel" in name:
        return "maxpool.ties_bwd"
    if any(s in name.lower() for s in ("gemm", "xmma", "nvjet", "cutlass")):
        return "GEMM (cuBLAS)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies and fills"
    return "other (elementwise, reductions)"


def _profile_steps(run, n: int, table: str,
                   activities=(ProfilerActivity.CUDA,)):
    """``n`` train steps of ``run`` (the trainer's step function, its
    carries donated, batches from the pipeline; ``run.values`` is updated
    in place) timed unprofiled after a warm-up step, then ``n``
    more under torch.profiler: (values, opt state, wall seconds of the
    unprofiled steps, device ms a step by kernel class, by kernel, device
    launches).  The profiler table goes to ``<table>`` in the output
    directory.  The default, ``(ProfilerActivity.CUDA,)``, records the
    device side alone: the host side's events take the profiler seconds to
    parse for a step of ~10^4 launches, and minutes for one of ~10^5."""
    step_fn = make_train_step(run.m.loss, run.opt)
    values, opt = run.values, run.opt.init(run.values)
    values, opt, _ = step_fn(values, opt, run.data(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(1, n + 1):
        values, opt, _ = step_fn(values, opt, run.data(s))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=list(activities)) as prof:
        for s in range(n + 1, 2 * n + 1):
            values, opt, _ = step_fn(values, opt, run.data(s))
        torch.cuda.synchronize()
    by_class, by_name, launches = {}, {}, 0
    for e in _card_events(prof):
        c = _categorize(e.name)
        ms = e.us / (n * 1e3)
        by_class[c] = by_class.get(c, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        launches += 1
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / table).write_text(_kernel_table(by_name, "a step"))
    return values, opt, wall, by_class, by_name, launches


def profile_train(dev) -> dict:
    """Phase 18, profile: 5 full-width train steps (the trainer's step
    function, batches from the pipeline) timed unprofiled after a warm-up
    step, then 5 more under torch.profiler: device busy time, idle share,
    device kernels per step, time by kernel class (the table goes to
    chiprun_out/profile_train.txt).  Then, alone at the step's shapes, the
    device time (profiler) of the flash backward's recompute through the
    plain version (24 layers x (forward + backward - forward)), of the
    xent's forward and backward, and of the step's in-place AdamW update
    with its clipping."""
    run = _train_run(None, steps=11)
    values, opt, wall, by_class, by_name, launches = _profile_steps(
        run, 5, "profile_train.txt")
    step_ms = sum(by_class.values())

    grads = tree.map(lambda v: torch.full_like(v, 1e-3), values)
    # the step's in-place AdamW update alone (its clipping included)
    adamw_ms = _device_ms(lambda: run.opt.update_inplace(grads, opt, values),
                          iters=5)[0]
    del grads, values, opt
    cfg = run.cfg
    gen = torch.Generator(device="cpu").manual_seed(5)
    shape = (TRAIN_BATCH, QWEN_HEADS, TRAIN_SEQ, cfg.head_dim_)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
               .requires_grad_(True) for _ in range(3))
    g = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
    fwd_ms = _device_ms(lambda: fa_ops.flash_attention(q, k, v, True))[0]
    both_ms = _device_ms(lambda: torch.autograd.grad(
        fa_ops.flash_attention(q, k, v, True), (q, k, v), g))[0]
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, QWEN_D), generator=gen).to(
        torch.bfloat16).to(dev).requires_grad_(True)
    table = (torch.randn((cfg.vocab_size, QWEN_D), generator=gen) * 0.02).to(
        torch.bfloat16).to(dev).requires_grad_(True)
    tgt = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=gen, dtype=torch.int32).to(dev)
    xent_ms = _device_ms(lambda: torch.autograd.grad(M._xent(
        cfg, {"embed": {"tokens": table}}, x, tgt), (x, table)), iters=10)[0]
    res = dict(wall_ms=1e3 * wall / 5, device_ms=step_ms,
               idle=1 - step_ms * 5 / (1e3 * wall), kernels=launches / 5,
               by_class=by_class, flash_bwd_ms=QWEN_LAYERS * (both_ms
                                                              - fwd_ms),
               xent_ms=xent_ms, adamw_ms=adamw_ms)
    print(f"profile, 5 full-width train steps ({TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens): wall {res['wall_ms']:.3f} ms a step unprofiled, device "
          f"busy {step_ms:.3f} ms a step, idle share {res['idle']:.3f}; "
          f"{res['kernels']:.0f} device kernels and copies a step; by class "
          f"(ms a step) {by_class}; alone, device ms: the flash backward's "
          f"plain recompute {res['flash_bwd_ms']:.3f} a step ({QWEN_LAYERS} "
          f"layers x ({both_ms:.4f} - {fwd_ms:.4f})), the xent forward + "
          f"backward {xent_ms:.3f}, the AdamW update {adamw_ms:.3f}",
          flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:10.3f} ms a step  {name[:100]}", flush=True)
    return res


def _hook(vcfg, batch, dev, steps, ckpt_every=0):
    """The channel trainer hook: ``vertical.loss_fn`` through
    ``Protocol.ocs(bits=8, p_miss=0.05)`` under a burst-and-dropout fault
    model with a ``FaultState`` carry, per-step sensing keys from
    ``channel_rng_seed`` and top-k 0.5 compression; batches of the
    patch task drawn from the step.  Returns (loss, init, optimizer, data,
    config) for ``trainer.train``."""
    fm = faults.FaultModel.burst(
        burst_len=3.0, gap_len=3.0, p_miss_bad=0.6, p_miss_good=SERVE_P_MISS,
        policy=faults.DegradePolicy.stale()).with_dropout(0.3, 0.5).to(dev)

    def loss(values, data, rng_aux):
        key, fs = rng_aux
        views, labels = data
        out, metrics = vertical.loss_fn(vcfg, values, views, labels,
                                        rng=key, fault=fm, fault_state=fs)
        metrics = dict(metrics)
        metrics["aux_state"] = metrics.pop("fault_state")
        return out, metrics

    grid = math.isqrt(vcfg.n_workers)
    task = vertical_data.PatchTaskConfig(
        grid=grid, hw=grid * math.isqrt(vcfg.input_dim),
        n_classes=vcfg.output_dim)

    def data(step):
        views, labels = vertical_data.patch_classification(task, batch,
                                                           seed=step)
        return (torch.from_numpy(views).to(dev),
                torch.from_numpy(labels).to(dev))

    init = vertical.init(vcfg, seed=0, device=dev)
    opt = optimizers.adamw(schedules.linear_warmup_cosine(1e-2, 2, steps))
    tcfg = trainer.TrainerConfig(
        steps=steps, log_every=1, ckpt_every=ckpt_every,
        channel_rng_seed=7, compress_k=0.5,
        aux_state=faults.init_state(vcfg.n_workers, (batch, vcfg.embed_dim),
                                    device=dev))
    return loss, init, opt, data, tcfg


def _hook_config(**overrides):
    return fedocs_cifar.cifar10_like(
        aggregation=Protocol.ocs(bits=8, p_miss=SERVE_P_MISS), **overrides)


def run_hook_phase(dev) -> dict:
    """Phase 19: ``trainer.train`` over ``vertical.loss_fn`` at the
    fedocs-cifar width (4 workers, encoders (256, 128), K 64, head (512,
    512, 512)), batch 64, 8 steps, counted (the fused contention, the
    pooling epilogue and the winner-routed backward once a step); the run
    preempted after its step-4 checkpoint and relaunched, bitwise the
    uninterrupted run (the fault carry included); a small configuration
    on the card against the CPU: the fault carry's chains bitwise, losses
    within phase 6's 1e-3."""
    vcfg = _hook_config()
    loss, init, opt, data, tcfg = _hook(vcfg, HOOK_BATCH, dev, HOOK_STEPS)
    full, counts, wall = _counted(
        lambda: trainer.train(loss, init, opt, data, tcfg))
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"ocs_contention.noisy": HOOK_STEPS,
                 "maxpool.decode": HOOK_STEPS,
                 "maxpool.winner_bwd": HOOK_STEPS})
    assert counts == want, (counts, want)
    losses = [r["loss_mean"] for r in full.history]
    assert all(math.isfinite(x) for x in losses), losses
    work = ROOT / "build" / "train_ckpt"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=work)
    try:
        half = HOOK_STEPS // 2
        tc_ckpt = dataclasses.replace(tcfg, ckpt_dir=ckpt, ckpt_every=half)
        trainer.train(loss, init, opt, data, tc_ckpt)
        _preempt(ckpt, half)
        resumed = trainer.train(loss, init, opt, data, tc_ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    assert resumed.history[0]["step"] == half
    _assert_same_run(full, resumed, "channel hook resume", half)
    print(f"channel trainer hook, fedocs-cifar width, {HOOK_STEPS} steps x "
          f"batch {HOOK_BATCH}: {wall:.3f} s wall; launches {counts}; "
          f"losses {losses}; payload bits a step "
          f"{full.history[0]['dp_payload_bits']:.0f}; the run relaunched "
          f"after its step-{half} checkpoint bitwise the uninterrupted run "
          f"(values, optimizer state, fault carry, history); fault carry age {int(full.aux_state.age)} consec "
          f"{int(full.aux_state.consec)} offline "
          f"{full.aux_state.offline.tolist()}", flush=True)

    small = fedocs_cifar.reduced(
        aggregation=Protocol.ocs(bits=8, p_miss=SERVE_P_MISS))
    runs = {}
    for where in (dev, torch.device("cpu")):
        loss, init, opt, data, tcfg = _hook(small, 16, where, 6)
        runs[where.type] = trainer.train(loss, init, opt, data, tcfg)
    gpu, cpu = runs["cuda"], runs["cpu"]
    for f in ("bad", "offline", "age", "consec"):
        assert torch.equal(getattr(gpu.aux_state, f).cpu(),
                           getattr(cpu.aux_state, f)), f
    loss_err = max(abs(a["loss_mean"] - b["loss_mean"])
                   for a, b in zip(gpu.history, cpu.history))
    print(f"channel hook, small config card vs CPU: fault chains equal, "
          f"max loss diff {loss_err:.3g}", flush=True)
    assert loss_err < 1e-3, loss_err

    # profile: 5 steps at the full width, the per-step key derivation
    # (int64 threefry as torch ops) counted apart
    loss, init, opt, data, tcfg = _hook(vcfg, HOOK_BATCH, dev, 5)
    _, _, prof_wall = _counted(
        lambda: trainer.train(loss, init, opt, data, tcfg))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train(loss, init, opt, data, tcfg)
        torch.cuda.synchronize()
    dev_ev = _card_events(prof)
    busy = sum(e.us for e in dev_ev) / 1e6
    int64 = [e for e in dev_ev if "<long" in e.name]
    res = dict(wall_ms=prof_wall * 200, device_ms=busy * 200,
               idle=1 - busy / prof_wall, kernels=len(dev_ev) / 5,
               int64_kernels=len(int64) / 5)
    print(f"profile, channel hook, 5 steps (init included): "
          f"{res['wall_ms']:.3f} ms a step wall unprofiled, device busy "
          f"{res['device_ms']:.3f} ms, idle share {res['idle']:.3f}; "
          f"{res['kernels']:.0f} device kernels a step, "
          f"{res['int64_kernels']:.0f} of them int64 (the key derivation "
          f"and the fault chains' draws)", flush=True)
    return dict(counts=counts, wall=wall, profile=res)


def check_sampling_against_cpu(dev) -> None:
    """Phase 20: ``ServeConfig(greedy=False)`` on the reduced qwen config,
    the same weights on the card and the CPU, channel-free: the sampled
    tokens equal (the Gumbel draws agree within two float32 ulps of
    their logs and the logits within float order; a flip on a near-tie
    would show here)."""
    cfg = get_reduced(QWEN, use_flash=True)
    m = M.build(cfg)
    cpu_values = m.init(torch.Generator().manual_seed(0))
    gpu_values = tree.map(lambda t: t.to(dev), cpu_values)
    reqs = poisson_requests(6, SERVE_RATE, cfg.vocab_size, prompt_len=64,
                            max_new_tokens=12, seed=2)
    config = se.ServeConfig(batch_slots=2, max_seq=96, eos_id=-1,
                            greedy=False, seed=3)
    want = se.ServeEngine(m, cpu_values, config, device="cpu").run(reqs)
    got = se.ServeEngine(m, gpu_values, config, device=dev).run(reqs)
    total = sum(len(c.tokens) for c in want.values())
    diff = [rid for rid in want if got[rid].tokens != want[rid].tokens]
    for rid in diff:
        print(f"  request {rid}: card {got[rid].tokens} CPU "
              f"{want[rid].tokens}", flush=True)
    print(f"sampling, reduced config card vs CPU: {total} tokens, "
          f"{len(diff)} requests differ", flush=True)
    assert not diff, "sampled tokens differ between the card and the CPU"


# ---------------------------------------------------------------------------
# the MoE FFN and the new configs
# ---------------------------------------------------------------------------

def _cpu_tree(t):
    """A copy of a tree's tensors on the CPU (other leaves as they are)."""
    if dataclasses.is_dataclass(t) or t is None:
        return t
    return tree.map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                    else x, t)


def _assert_same_run_cpu(a, b, what) -> None:
    """``a`` (values, opt state, history rows) held on the CPU against the
    run ``b``, bitwise, one leaf at a time (each held leaf copied back to
    ``b``'s device)."""
    for name, x, y in (("values", a[0], b.values),
                       ("opt state", a[1], b.opt_state)):
        lx, ly = tree.leaves(x), tree.leaves(y)
        assert len(lx) == len(ly), (what, name)
        for u, v in zip(lx, ly):
            assert (_bitwise_equal(u.to(v.device), v)
                    if isinstance(u, torch.Tensor) else u == v), \
                f"{what}: {name} differ"
    assert a[2] == _rows(b.history), f"{what}: history differs"


def _release(what: str) -> None:
    """Collect garbage and return the allocator's cached blocks to the
    card before a phase that fills it; print what is still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory allocated at {what}: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)


def _moe_train_run(steps=MOE_STEPS):
    """``launch/train``'s run at the full qwen3-moe-30b-a3b width, the
    depth cut to ``MOE_LAYERS`` (``--layers``), fusion ``max``, flash,
    every step logged."""
    run = _without_remat(launch_train.setup(launch_train.parse_args([
        "--arch", QWEN3, "--layers", str(MOE_LAYERS), "--steps", str(steps),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed",
        "0"])))
    cfg = run.cfg
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.n_experts, cfg.experts_per_token, cfg.n_workers,
            cfg.tp_fusion, cfg.use_flash, cfg.dtype) == (
        MOE_D, 32, 4, 128, 128, 8, QWEN_WORKERS, "max", True,
        torch.bfloat16), cfg
    run.tcfg = dataclasses.replace(run.tcfg, log_every=1)
    return run


def _moe_train_counts(counts, steps, what) -> None:
    """Per step: flash once per layer (the forward) and ``maxpool.fwd`` and
    ``maxpool.ties_bwd`` once per layer (the attention out-projection's
    max site: 32 heads over 16 workers); the experts have no fusion
    site."""
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"flash_attention.fwd": MOE_LAYERS * steps,
                 "maxpool.fwd": MOE_LAYERS * steps,
                 "maxpool.ties_bwd": MOE_LAYERS * steps})
    assert counts == want, (what, counts, want)


def run_moe_train_phase(dev) -> dict:
    """Phase 21: ``launch/train`` at the full qwen3-moe-30b-a3b width (the
    depth cut to 4 layers; bf16, random weights from seed 0, ``--fusion
    max``, flash), batch 8 x 256 tokens, ``adamw(for_arch(...))``, 3
    steps, counted, every loss finite, the peak device memory; a second
    run bitwise the first (values, optimizer state, history: the first
    run's are held on the CPU, two runs' state does not fit the card
    together); then 3 steps profiled."""
    print(f"train {QWEN3}: the depth cut to {MOE_LAYERS} of 48 layers",
          flush=True)
    _release("train phase start")
    run = _moe_train_run()
    n_params = sum(t.numel() for t in tree.leaves(run.values))
    # the tree holds the final norm beside what param_count counts
    assert n_params == run.cfg.param_count() + run.cfg.d_model, n_params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first, counts, wall = _counted(lambda: launch_train.launch(run))
    peak = torch.cuda.max_memory_allocated()
    del run
    _moe_train_counts(counts, MOE_STEPS, "first run")
    losses = [r["loss"] for r in first.history]
    assert len(losses) == MOE_STEPS and all(
        math.isfinite(x) for x in losses), losses
    aux = [r["aux"] for r in first.history]
    print(f"train {QWEN3} full width, {MOE_LAYERS} layers ({n_params} "
          f"parameters, bf16, fusion max, flash): {MOE_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {wall:.3f} s wall; losses "
          f"{losses}; router aux {aux}; step host times "
          f"{[round(r['step_time_s'], 4) for r in first.history]}; peak "
          f"device memory {peak / 2**30:.2f} GiB ({peak} bytes); launches "
          f"{counts}", flush=True)
    held = (_cpu_tree(first.values), _cpu_tree(first.opt_state),
            _rows(first.history))
    del first
    _release("first run held on the CPU")
    again, counts2, wall2 = _counted(
        lambda: launch_train.launch(_moe_train_run()))
    _moe_train_counts(counts2, MOE_STEPS, "second run")
    _assert_same_run_cpu(held, again, "two MoE runs")
    del again, held
    _release("second run compared")
    print(f"train {QWEN3}: a second run ({wall2:.3f} s) bitwise the first: "
          f"values, optimizer state, history", flush=True)

    run = _moe_train_run(steps=2 * MOE_STEPS + 1)
    values, opt, pwall, by_class, by_name, launches = _profile_steps(
        run, MOE_STEPS, "profile_train_moe.txt")
    # the step's in-place AdamW update alone (its clipping included)
    grads = tree.map(lambda v: torch.full_like(v, 1e-3), values)
    adamw_ms = _device_ms(lambda: run.opt.update_inplace(grads, opt, values),
                          iters=3)[0]
    del run, values, opt, grads
    torch.cuda.empty_cache()
    step_ms = sum(by_class.values())
    res = dict(wall=wall, peak=peak, counts=counts,
               wall_ms=1e3 * pwall / MOE_STEPS, device_ms=step_ms,
               idle=1 - step_ms * MOE_STEPS / (1e3 * pwall),
               kernels=launches / MOE_STEPS, by_class=by_class,
               adamw_ms=adamw_ms)
    print(f"profile, {MOE_STEPS} {QWEN3} train steps ({MOE_LAYERS} layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens): wall {res['wall_ms']:.3f} "
          f"ms a step unprofiled, device busy {step_ms:.3f} ms a step, idle "
          f"share {res['idle']:.3f}; {res['kernels']:.0f} device kernels and "
          f"copies a step; by class (ms a step) {by_class}; alone, the "
          f"AdamW update {adamw_ms:.3f} device ms", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:10.3f} ms a step  {name[:100]}", flush=True)
    return res


def run_moe_serving(dev) -> dict:
    """Phase 22: serve phase 8's traffic (16 Poisson requests of 256-token
    prompts for 16 tokens over 8 slots) with qwen3-moe-30b-a3b at its full
    width, 4 layers, ``tp_fusion="max"``, flash prefill, under
    ``Protocol.ocs(bits=8, p_miss=0.05)``: an all-MoE plan has no channel
    site, so the engine bills 0 channel slots and 0 uplink bits.  Counted:
    flash once per layer per request, ``maxpool.fwd`` once per layer per
    prefill and per tick (the attention's max site), nothing else; every
    logit finite.  Then 10 decode ticks profiled."""
    cfg = get_config(QWEN3, n_layers=MOE_LAYERS, tp_fusion="max",
                     use_flash=True)
    m = M.build(cfg)
    values = m.init(torch.Generator(device=dev).manual_seed(0))
    finite = _watch_logits(m, dev)
    proto = _ocs(SERVE_P_MISS)
    eng = se.ServeEngine(m, values, se.ServeConfig(
        batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, eos_id=-1,
        protocol=proto), device=dev)
    reqs = poisson_requests(SERVE_REQUESTS, SERVE_RATE, cfg.vocab_size,
                            prompt_len=SERVE_PROMPT,
                            max_new_tokens=SERVE_NEW, seed=0)
    eng.run([se.Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=2)])
    se.reset_dispatch_counts()
    outs, counts, wall = _counted(lambda: eng.run(reqs))
    ticks = se.dispatch_counts()["tick"]
    assert m.channel_sites() == 0
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"flash_attention.fwd": MOE_LAYERS * SERVE_REQUESTS,
                 "maxpool.fwd": MOE_LAYERS * (SERVE_REQUESTS + ticks)})
    assert counts == want, (counts, want)
    assert bool(finite["ok"]), "a logit is not finite"
    assert sorted(outs) == list(range(SERVE_REQUESTS))
    for c in outs.values():
        assert len(c.tokens) == SERVE_NEW, (c.rid, len(c.tokens))
        assert c.channel_slots == 0 and c.uplink_bits == 0, c.rid
    n_tok = sum(len(c.tokens) for c in outs.values())
    print(f"serve {QWEN3} full width, {MOE_LAYERS} layers, OCS p "
          f"{SERVE_P_MISS}: {len(outs)} requests, {n_tok} tokens, {ticks} "
          f"ticks in {wall:.3f} s wall; {1e3 * wall / ticks:.2f} ms per tick "
          f"(prefills included); 0 channel slots and 0 uplink bits billed "
          f"(no channel site); launches {counts}", flush=True)
    prof = profile_serving(dev, dict(eng=eng, proto=proto, reqs=reqs, m=m),
                           "profile_serve_moe.txt")
    del eng, values, m
    torch.cuda.empty_cache()
    return dict(counts=counts, wall=wall, ticks=ticks, tokens=n_tok,
                profile=prof)


def run_wide_configs(dev) -> dict:
    """Phase 23: one period (one layer) of llama4-scout-17b-a16e, glm4-9b,
    minicpm-2b and qwen2.5-32b at their full widths (bf16, random weights
    from seed 0, ``tp_fusion="max"``, flash prefill), each serving 2
    requests of 64-token prompts for 4 tokens under OCS p 0.05, counted:
    flash once per layer per request; ``maxpool.fwd`` at each layer's
    attention site (worker layout only) and FFN site in a prefill, and at
    the attention site and llama4's shared expert in a tick; the channel
    kernels once per mlp layer per tick; every logit finite.  Each model
    is freed before the next."""
    total = {k: 0 for k in kernels.KERNELS}
    walls = {}
    for arch in WIDE_ARCHS:
        base = get_config(arch)
        cfg = base.with_(n_layers=base.period, tp_fusion="max",
                         use_flash=True)
        m = M.build(cfg)
        values = m.init(torch.Generator(device=dev).manual_seed(0))
        n_params = sum(t.numel() for t in tree.leaves(values))
        finite = _watch_logits(m, dev)
        eng = se.ServeEngine(m, values, se.ServeConfig(
            batch_slots=WIDE_REQUESTS, max_seq=2 * WIDE_PROMPT, eos_id=-1,
            protocol=_ocs(SERVE_P_MISS)), device=dev)
        reqs = poisson_requests(WIDE_REQUESTS, 1.0, cfg.vocab_size,
                                prompt_len=WIDE_PROMPT,
                                max_new_tokens=WIDE_NEW, seed=0)
        se.reset_dispatch_counts()
        outs, counts, wall = _counted(lambda: eng.run(reqs))
        ticks = se.dispatch_counts()["tick"]
        attn = 1 if attention.attn_layout(cfg) == "worker" else 0
        shared = 1 if cfg.moe_shared_expert else 0
        sites = m.channel_sites()
        want = {k: 0 for k in kernels.KERNELS}
        want.update({
            "flash_attention.fwd": cfg.n_layers * WIDE_REQUESTS,
            "maxpool.fwd": cfg.n_layers * (WIDE_REQUESTS * (attn + 1)
                                           + ticks * (attn + shared)),
            "ocs_contention.noisy": sites * ticks,
            "maxpool.decode": sites * ticks})
        assert counts == want, (arch, counts, want)
        assert bool(finite["ok"]), f"{arch}: a logit is not finite"
        assert all(len(c.tokens) == WIDE_NEW for c in outs.values())
        for k, v in counts.items():
            total[k] += v
        walls[arch] = wall
        print(f"serve {arch}, one layer at the full width ({n_params} "
              f"parameters, bf16, d_model {cfg.d_model}, {cfg.n_heads} heads "
              f"of {cfg.head_dim_} over {cfg.n_kv_heads} KV heads, "
              f"{attention.attn_layout(cfg)} attention layout): "
              f"{WIDE_REQUESTS} requests, {ticks} ticks in {wall:.3f} s; "
              f"every logit finite; launches {counts}", flush=True)
        del eng, values, m, outs
        torch.cuda.empty_cache()
    return dict(counts=total, walls=walls)


def check_moe_against_cpu(dev) -> None:
    """Phase 24: the reduced qwen3-moe-30b-a3b and llama4-scout-17b-a16e
    configs in float32 (``tp_fusion="max"``; flash for qwen3-moe, whose
    reduced head_dim 16 the kernel takes — llama4's reduced 12 it does
    not), both ``moe_impl`` forms, the same weights on the card and the
    CPU: 3 trainer steps with losses within phase 6's 1e-3, and 6 requests
    served with equal tokens, channel-free and under OCS p 0.05 (0
    channel slots)."""
    for arch in (QWEN3, LLAMA4):
        for impl in ("sort_scatter", "gather"):
            cfg = get_reduced(arch, moe_impl=impl, tp_fusion="max",
                              use_flash=arch == QWEN3)
            m = M.build(cfg)
            cpu_values = m.init(torch.Generator().manual_seed(0))
            gpu_values = tree.map(lambda t: t.to(dev), cpu_values)
            pcfg = pipeline.for_model(cfg, batch=4, seq_len=32, seed=0)
            losses = []
            for d, v in (("cpu", cpu_values), (dev, gpu_values)):
                opt = optimizers.adamw(schedules.for_arch(arch, 3e-3, 3),
                                       weight_decay=0.01)
                res = trainer.train(
                    m.loss, v, opt,
                    lambda s, d=d: pipeline.batch_for_step(pcfg, s,
                                                           device=d),
                    trainer.TrainerConfig(steps=3, log_every=1))
                losses.append([r["loss"] for r in res.history])
            diff = max(abs(a - b) for a, b in zip(*losses))
            assert diff < 1e-3, (arch, impl, losses)
            reqs = poisson_requests(6, SERVE_RATE, cfg.vocab_size,
                                    prompt_len=64, max_new_tokens=12, seed=2)
            p = np.full((cfg.n_workers,), SERVE_P_MISS, np.float32)
            for proto in (None, Protocol.ocs(bits=8, p_miss=p)):
                config = se.ServeConfig(batch_slots=2, max_seq=96,
                                        eos_id=-1, protocol=proto)
                want = se.ServeEngine(m, cpu_values, config,
                                      device="cpu").run(reqs)
                got = se.ServeEngine(m, gpu_values, config,
                                     device=dev).run(reqs)
                for rid in want:
                    assert got[rid].tokens == want[rid].tokens, (
                        arch, impl, rid, got[rid].tokens, want[rid].tokens)
                    assert got[rid].channel_slots == 0
            print(f"{arch} reduced, {impl}, card vs CPU: 3 train losses "
                  f"within {diff:.3g}; tokens equal channel-free and under "
                  f"OCS p {SERVE_P_MISS}", flush=True)


# ---------------------------------------------------------------------------
# the recurrent mixers: xlstm-125m and jamba-1.5-large
# ---------------------------------------------------------------------------

def check_recurrent_sites(dev, row) -> dict:
    """Phase 3, the recurrent slice's max-fusion sites, bf16: the mLSTM
    down-projection of xlstm-125m in the train step, (16 workers,
    ``XLSTM_BATCH`` x 256 tokens x 768), and jamba's mamba
    out-projection in one 64-token prefill, (16, 64, 8192):
    ``maxpool.fwd`` bitwise against its plain version for each subset of
    its optional outputs on randn partials and on partials with forced
    ties, +-0, +-inf and NaNs; at the mLSTM site ``maxpool.ties_bwd``
    bitwise against its plain version and ``g * (h == max)``.  The same
    ``maxpool.fwd`` check at the serve widths of phases 26-27 (an xlstm
    256-token prefill and tick of 8 slots, a jamba tick of 2 slots), and
    ``noisy`` and ``maxpool.decode`` bitwise at jamba's mlp site in a tick
    (1 lane x 16 workers x 2 slots x 8192, bf16, bits 8, p_miss 0.05).
    Timed, with the L2 evicted before each call (both sites' operands fit
    it): the law's form beside ``torch.max(dim=0)`` at both sites, the
    backward beside that composition at the mLSTM site."""
    for site, serve_shape in (
            ("xlstm serve prefill", (QWEN_WORKERS, 1, SERVE_PROMPT, XLSTM_D)),
            ("xlstm serve tick", (QWEN_WORKERS, SERVE_SLOTS, 1, XLSTM_D)),
            ("jamba serve tick", (QWEN_WORKERS, WIDE_REQUESTS, 1, JAMBA_D))):
        n_cols = math.prod(serve_shape[1:])
        _check_fwd_subsets(
            {"randn": _train_site_input(dev, n_cols, 44),
             "ties": _train_site_input(dev, n_cols, 45, ties=True)},
            serve_shape, site)
    for name, launch, plain, *_, shape in _kernel_cases(
            dev, 1, WIDE_REQUESTS * JAMBA_D, 8, seed=46, n=QWEN_WORKERS,
            dtype=torch.bfloat16, p_miss=(SERVE_P_MISS,)):
        if name in ("ocs_contention.noisy", "maxpool.decode"):
            _check_equal(name, launch, plain,
                         dict(bits=8, shape=shape, path="jamba serve tick"))
            print(f"{name} at the jamba serve tick {shape} bf16 bits 8: "
                  "bitwise equal to plain", flush=True)
    flush = _l2_flush(dev)
    out = {}
    for path, shape in (
            ("xlstm", (QWEN_WORKERS, XLSTM_BATCH, TRAIN_SEQ, XLSTM_D)),
            ("jamba", (QWEN_WORKERS, 1, JAMBA_PROMPT, JAMBA_D))):
        cols = math.prod(shape[1:])
        cases = {"randn": _train_site_input(dev, cols, 40).view(shape),
                 "ties": _train_site_input(dev, cols, 41,
                                           ties=True).view(shape)}
        _check_fwd_subsets(cases, shape, path)
        h = cases["randn"]
        out[("maxpool.fwd", path)] = row(
            "maxpool.fwd", lambda h=h: mp_ops.maxpool_ties(h, 0),
            lambda h=h: mp_ref.maxpool_ties(h, 0),
            h.numel() * 2 + cols * (2 + 2), 2 * h.numel(),
            lambda h=h: torch.max(h, dim=0),
            dict(shape=list(h.shape), dtype="bfloat16", path=path,
                 outputs="pooled, ties"), flush=flush)
        if path != "xlstm":
            continue
        for what, hc in cases.items():
            _check_ties_bwd(dev, hc, 42, what)
        print(f"maxpool.ties_bwd at the mLSTM site {shape}: bitwise equal "
              f"to plain and to g * (h == max)", flush=True)
        pooled, mask = mp_ops.maxpool_ties(h, 0)
        g = _site_cotangent(dev, h.shape[1:], 43)
        out[("maxpool.ties_bwd", path)] = row(
            "maxpool.ties_bwd",
            lambda: mp_ops.maxpool_ties_bwd(mask, g, QWEN_WORKERS, 0),
            lambda: mp_ref.ties_bwd(mask, g, QWEN_WORKERS, 0),
            cols * (2 + 2) + h.numel() * 2, h.numel(),
            lambda: g.unsqueeze(0) * (h == pooled.unsqueeze(0)).to(h.dtype),
            dict(shape=list(h.shape), dtype="bfloat16", path=path,
                 library="g * (h == max) (3 launches)"), flush=flush)
    del flush
    return out


def _xlstm_train_run(steps=XLSTM_STEPS):
    """``launch/train``'s run at the full xlstm-125m width and depth,
    fusion ``max``, every step logged."""
    run = _without_remat(launch_train.setup(launch_train.parse_args([
        "--arch", XLSTM, "--steps", str(steps), "--batch", str(XLSTM_BATCH),
        "--seq", str(TRAIN_SEQ), "--seed", "0"])))
    cfg = run.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_inner,
            cfg.n_workers, cfg.tp_fusion, cfg.dtype, cfg.tie_embeddings) \
        == (12, XLSTM_D, 4, 2 * XLSTM_D, QWEN_WORKERS, "max",
            torch.bfloat16, True), cfg
    assert cfg.param_count() == XLSTM_PARAMS, cfg.param_count()
    run.tcfg = dataclasses.replace(run.tcfg, log_every=1)
    return run


def _mlstm_sites(cfg) -> int:
    return cfg.n_periods * sum(1 for m, _ in cfg.layer_plan()
                               if m == "mlstm")


def _xlstm_train_counts(counts, steps, what) -> None:
    """Per step ``maxpool.fwd`` and ``maxpool.ties_bwd`` once at each of the
    9 mLSTM down-projections (the sLSTM blocks and the ``none`` FFN have no
    fusion site, there is no attention), nothing else."""
    sites = _mlstm_sites(get_config(XLSTM))
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"maxpool.fwd": sites * steps,
                 "maxpool.ties_bwd": sites * steps})
    assert counts == want, (what, counts, want)


def run_xlstm_train_phase(dev) -> dict:
    """Phase 25: ``launch/train`` at the full xlstm-125m width and depth
    (12 layers, 3 mLSTM : 1 sLSTM, d_model 768, 4 heads, d_inner 1536, 16
    workers; bf16, random weights from seed 0, ``--fusion max``),
    ``XLSTM_BATCH`` x 256 tokens, ``XLSTM_STEPS`` steps, counted
    (``maxpool.fwd`` and ``ties_bwd`` 9 each a step, nothing else), every
    loss finite, the peak device memory; a second run bitwise the first; then one step
    profiled, the device side alone (wall, device busy, idle share,
    kernels a step)."""
    _release("xlstm train phase start")
    run = _xlstm_train_run()
    n_params = sum(t.numel() for t in tree.leaves(run.values))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first, counts, wall = _counted(lambda: launch_train.launch(run))
    peak = torch.cuda.max_memory_allocated()
    del run
    _xlstm_train_counts(counts, XLSTM_STEPS, "first run")
    losses = [r["loss"] for r in first.history]
    assert len(losses) == XLSTM_STEPS and all(
        math.isfinite(x) for x in losses), losses
    print(f"train {XLSTM} full width and depth ({n_params} parameters in the "
          f"tree, {XLSTM_PARAMS} by param_count; bf16, fusion max): "
          f"{XLSTM_STEPS} steps of {XLSTM_BATCH} x {TRAIN_SEQ} tokens in "
          f"{wall:.3f} s wall; losses {losses}; step host times "
          f"{[round(r['step_time_s'], 4) for r in first.history]}; peak "
          f"device memory {peak / 2**30:.2f} GiB ({peak} bytes); launches "
          f"{counts}", flush=True)
    _release("first xlstm run done")
    again, counts2, wall2 = _counted(
        lambda: launch_train.launch(_xlstm_train_run()))
    _xlstm_train_counts(counts2, XLSTM_STEPS, "second run")
    _assert_same_run(first, again, "two xlstm runs")
    del first, again
    _release("second xlstm run compared")
    print(f"train {XLSTM}: a second run ({wall2:.3f} s) bitwise the first: "
          f"values, optimizer state, history", flush=True)
    run = _xlstm_train_run(steps=3)
    values, opt, pwall, by_class, by_name, launches = _profile_steps(
        run, 1, "profile_train_xlstm.txt", (ProfilerActivity.CUDA,))
    del run, values, opt
    _release("xlstm profile done")
    step_ms = sum(by_class.values())
    res = dict(wall=wall, peak=peak, counts=counts, wall_ms=1e3 * pwall,
               device_ms=step_ms, idle=1 - step_ms / (1e3 * pwall),
               kernels=launches, by_class=by_class)
    print(f"profile, one {XLSTM} train step ({XLSTM_BATCH} x "
          f"{TRAIN_SEQ} tokens): wall {res['wall_ms']:.3f} ms a step "
          f"unprofiled, device busy {step_ms:.3f} ms a step, idle share "
          f"{res['idle']:.3f}; {res['kernels']:.0f} device kernels and "
          f"copies a step; by class (ms a step) {by_class}", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:10.3f} ms a step  {name[:100]}", flush=True)
    return res


def run_xlstm_serving(dev) -> dict:
    """Phase 26: serve phase 8's traffic (16 Poisson requests of 256-token
    prompts for 16 tokens over 8 slots) with xlstm-125m at its full width
    and depth, ``tp_fusion="max"``, under ``Protocol.ocs(bits=8,
    p_miss=0.05)``: no mlp site, so 0 channel slots and 0 uplink bits;
    counted (``maxpool.fwd`` 9 per prefill and 9 per tick, the mLSTM
    sites; nothing else); every logit finite.  Then the same traffic
    under phase 14's bursts and outages with ``retry(2)`` (some held
    ticks; the held ticks restore the recurrent states, which phase 28
    holds against the CPU), counted the same way; the peak device
    memory; then 10 decode ticks profiled."""
    cfg = get_config(XLSTM, tp_fusion="max")
    sites = _mlstm_sites(cfg)
    m = M.build(cfg)
    values = m.init(torch.Generator(device=dev).manual_seed(0))
    finite = _watch_logits(m, dev)
    proto = _ocs(SERVE_P_MISS)
    reqs = poisson_requests(SERVE_REQUESTS, SERVE_RATE, cfg.vocab_size,
                            prompt_len=SERVE_PROMPT,
                            max_new_tokens=SERVE_NEW, seed=0)
    assert m.channel_sites() == 0
    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kind, fm in (("ocs", None), ("retry", faults.FaultModel.burst(
            policy=faults.DegradePolicy.retry(2), **SERVE_FAULT
            ).with_dropout(*SERVE_DROPOUT))):
        eng = se.ServeEngine(m, values, se.ServeConfig(
            batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, eos_id=-1,
            protocol=proto, fault=fm), device=dev)
        se.reset_dispatch_counts()
        outs, counts, wall = _counted(lambda: eng.run(reqs))
        ticks = se.dispatch_counts()["tick"]
        want = {k: 0 for k in kernels.KERNELS}
        want["maxpool.fwd"] = sites * (SERVE_REQUESTS + ticks)
        assert counts == want, (kind, counts, want)
        assert bool(finite["ok"]), "a logit is not finite"
        assert sorted(outs) == list(range(SERVE_REQUESTS))
        for c in outs.values():
            assert len(c.tokens) == SERVE_NEW, (c.rid, len(c.tokens))
            assert c.channel_slots == 0 and c.uplink_bits == 0, c.rid
        retry_ticks = sum(c.retry_ticks for c in outs.values())
        if fm is not None:
            assert retry_ticks > 0, "no held tick: the retry was not driven"
        n_tok = sum(len(c.tokens) for c in outs.values())
        print(f"serve {XLSTM} full width ({kind}), OCS p {SERVE_P_MISS}: "
              f"{len(outs)} requests, {n_tok} tokens, {ticks} ticks in "
              f"{wall:.3f} s wall; {1e3 * wall / ticks:.2f} ms per tick "
              f"(prefills included); retry ticks billed {retry_ticks}; 0 "
              f"channel slots and 0 uplink bits (no channel site); "
              f"launches {counts}", flush=True)
        res[kind] = dict(counts=counts, wall=wall, ticks=ticks,
                         tokens=n_tok, retry_ticks=retry_ticks)
        if fm is None:
            serve = dict(eng=eng, proto=proto, reqs=reqs, m=m)
    res["peak"] = torch.cuda.max_memory_allocated()
    print(f"serve {XLSTM}: peak device memory {res['peak'] / 2**30:.2f} GiB "
          f"({res['peak']} bytes)", flush=True)
    res["profile"] = profile_serving(dev, serve, "profile_serve_xlstm.txt")
    del serve, eng, values, m
    _release("xlstm serving done")
    return res


def run_jamba_serving(dev) -> dict:
    """Phase 27: one 8-layer period of jamba-1.5-large at its full width
    (d_model 8192, d_inner 16384, state 16, conv 4, 64 heads of 128 over 8
    KV heads, d_ff 24576, no rotary positions; bf16, random weights from
    seed 0, ``tp_fusion="max"``, flash prefill) with the experts cut from
    16 to 4 (top-2 and every width kept: the period's 45.2 B parameters
    do not fit the card), serving 2 requests of 64-token prompts for 4
    tokens under OCS p 0.05, counted: flash once per request; a prefill
    ``maxpool.fwd`` at the 7 mamba sites, the attention's worker-layout
    site and the 4 mlp sites; a tick ``maxpool.fwd`` at the mamba and
    attention sites and ``noisy`` and ``maxpool.decode`` at the 4 mlp
    sites; every logit finite; the peak device memory; then 10 decode
    ticks profiled."""
    _release("jamba phase start")
    torch.cuda.reset_peak_memory_stats()
    base = get_config(JAMBA)
    cfg = base.with_(n_layers=base.period, n_experts=JAMBA_EXPERTS,
                     tp_fusion="max", use_flash=True)
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, cfg.conv_width,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff,
            cfg.experts_per_token, cfg.use_rope) == (
        JAMBA_D, 2 * JAMBA_D, 16, 4, 64, 8, 128, 24576, 2, False), cfg
    m = M.build(cfg)
    values = m.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree.leaves(values))
    finite = _watch_logits(m, dev)
    proto = _ocs(SERVE_P_MISS)
    eng = se.ServeEngine(m, values, se.ServeConfig(
        batch_slots=WIDE_REQUESTS, max_seq=2 * JAMBA_PROMPT, eos_id=-1,
        protocol=proto), device=dev)
    reqs = poisson_requests(WIDE_REQUESTS, 1.0, cfg.vocab_size,
                            prompt_len=JAMBA_PROMPT,
                            max_new_tokens=WIDE_NEW, seed=0)
    se.reset_dispatch_counts()
    outs, counts, wall = _counted(lambda: eng.run(reqs))
    ticks = se.dispatch_counts()["tick"]
    plan = cfg.layer_plan()
    mamba = sum(1 for mx, _ in plan if mx == "mamba")
    attn = sum(1 for mx, _ in plan if mx == "attn") * (
        attention.attn_layout(cfg) == "worker")
    mlp = m.channel_sites()
    assert (mamba, attn, mlp) == (7, 1, 4), (mamba, attn, mlp)
    want = {k: 0 for k in kernels.KERNELS}
    want.update({
        "flash_attention.fwd": WIDE_REQUESTS,
        "maxpool.fwd": WIDE_REQUESTS * (mamba + attn + mlp)
        + ticks * (mamba + attn),
        "ocs_contention.noisy": mlp * ticks,
        "maxpool.decode": mlp * ticks})
    assert counts == want, (counts, want)
    assert bool(finite["ok"]), "jamba: a logit is not finite"
    assert all(len(c.tokens) == WIDE_NEW for c in outs.values())
    assert all(c.channel_slots > 0 for c in outs.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"serve {JAMBA}, one period at the full width, {JAMBA_EXPERTS} of "
          f"16 experts ({n_params} parameters in the tree, "
          f"{cfg.param_count()} by param_count; bf16): {WIDE_REQUESTS} "
          f"requests, {ticks} ticks in {wall:.3f} s; every logit finite; "
          f"peak device memory {peak / 2**30:.2f} GiB ({peak} bytes); "
          f"launches {counts}", flush=True)
    prof = profile_serving(dev, dict(eng=eng, proto=proto, reqs=reqs, m=m),
                           "profile_serve_jamba.txt")
    del eng, values, m, outs
    _release("jamba done")
    return dict(counts=counts, wall=wall, ticks=ticks, params=n_params,
                peak=peak, profile=prof)


def check_recurrent_against_cpu(dev) -> None:
    """Phase 28: the reduced xlstm-125m and jamba-1.5-large configs in
    float32 (``tp_fusion="max"``; flash for jamba's attention), the same
    weights on the card and the CPU: 3 trainer steps with losses within
    phase 6's 1e-3, and 6 requests served with equal tokens and retry
    ticks, channel-free, under OCS p 0.05 and under bursts and outages
    with ``retry(2)`` (some held ticks: the copy-on-hold of the recurrent
    states); then the sequential and the associative mamba scans on the
    card against each other within the JAX test's 1e-3."""
    fault = faults.FaultModel.burst(
        burst_len=4, gap_len=16, p_miss_bad=0.5, p_miss_good=0.01,
        policy=faults.DegradePolicy.retry(2)).with_dropout(0.5, 0.3)
    for arch in (XLSTM, JAMBA):
        cfg = get_reduced(arch, tp_fusion="max", use_flash=arch == JAMBA)
        m = M.build(cfg)
        cpu_values = m.init(torch.Generator().manual_seed(0))
        if cfg.tie_embeddings:
            # logits flat enough that greedy tokens are not the prompt's
            cpu_values["embed"]["tokens"].mul_(0.02)
        gpu_values = tree.map(lambda t: t.to(dev), cpu_values)
        pcfg = pipeline.for_model(cfg, batch=4, seq_len=32, seed=0)
        losses = []
        for d, v in (("cpu", cpu_values), (dev, gpu_values)):
            opt = optimizers.adamw(schedules.for_arch(arch, 3e-3, 3),
                                   weight_decay=0.01)
            res = trainer.train(
                m.loss, v, opt,
                lambda s, d=d: pipeline.batch_for_step(pcfg, s, device=d),
                trainer.TrainerConfig(steps=3, log_every=1))
            losses.append([r["loss"] for r in res.history])
        diff = max(abs(a - b) for a, b in zip(*losses))
        assert diff < 1e-3, (arch, losses)
        reqs = poisson_requests(6, SERVE_RATE, cfg.vocab_size,
                                prompt_len=16, max_new_tokens=12, seed=2)
        p = np.full((cfg.n_workers,), SERVE_P_MISS, np.float32)
        held = 0
        for proto, fm in ((None, None), (Protocol.ocs(bits=8, p_miss=p),
                                         None),
                          (Protocol.ocs(bits=8, p_miss=p), fault)):
            config = se.ServeConfig(batch_slots=2, max_seq=48, eos_id=-1,
                                    protocol=proto, fault=fm)
            want = se.ServeEngine(m, cpu_values, config,
                                  device="cpu").run(reqs)
            got = se.ServeEngine(m, gpu_values, config, device=dev).run(reqs)
            for rid in want:
                assert got[rid].tokens == want[rid].tokens, (
                    arch, fm, rid, got[rid].tokens, want[rid].tokens)
                assert got[rid].retry_ticks == want[rid].retry_ticks
            if fm is not None:
                held = sum(c.retry_ticks for c in got.values())
                assert held > 0, "no held tick: the retry was not driven"
        print(f"{arch} reduced, card vs CPU: 3 train losses within "
              f"{diff:.3g}; tokens equal channel-free, under OCS p "
              f"{SERVE_P_MISS} and under retry(2) ({held} retry ticks "
              f"billed)", flush=True)
    cfg = get_reduced(JAMBA)
    p = tree.map(lambda t: t.to(dev), mamba_mod.mamba_init(
        cfg, torch.Generator().manual_seed(1)))
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(dev)
    seq = mamba_mod.mamba_full(cfg, p, x)
    assoc = mamba_mod.mamba_full(cfg.with_(mamba_assoc_scan=True), p, x)
    err = float((seq - assoc).abs().max())
    assert err <= 1e-3, err
    print(f"mamba_assoc_scan on the card against the sequential scan "
          f"(reduced jamba, 2 x 64 tokens): max abs difference {err:.3g} "
          f"(tolerance 1e-3)", flush=True)


# ---------------------------------------------------------------------------
# the encoder-decoder and the frontends: whisper-base and pixtral-12b
# ---------------------------------------------------------------------------

def _flash_case(dev, b, h, hkv, s, d, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def check_flash_encdec(dev) -> dict:
    """Phase 3, flash at the encoder-decoder slice's shapes, bf16, held to
    the plain version (:func:`_check_flash`; at each non-causal shape past
    256 keys the plain output with a 128-key tile lost must fail the same
    limit) and timed beside
    ``scaled_dot_product_attention(is_causal=...)``: whisper-base's
    non-causal encoder at phase 29's 384 frames and phase 30's 1,408, its
    causal decoder at phase 29's 384 tokens and phase 30's 4-token prompt
    (a query tile taller than the sequence), and pixtral-12b's causal GQA
    4:1 at head_dim 128 in phase 31's serving prefill (2 x 1,024 patches)
    and training step (8 x 256).  Bytes: q, k, v read once, out written
    once; operations: the two products over the pairs the mask keeps, 2
    flops a multiply-add, on the bf16 tensor-core rate."""
    out = {}
    for site, (b, h, hkv, s, d), causal in (
            ("whisper encoder train", (WHISPER_BATCH, 8, 8, WHISPER_SEQ, 64),
             False),
            ("whisper encoder serve", (WHISPER_BATCH, 8, 8, WHISPER_FRAMES,
                                       64), False),
            ("whisper decoder train", (WHISPER_BATCH, 8, 8, WHISPER_SEQ, 64),
             True),
            ("whisper decoder prefill", (WHISPER_BATCH, 8, 8,
                                         len(WHISPER_SOT), 64), True),
            ("pixtral serve", (WIDE_REQUESTS, 32, 8, PIXTRAL_PATCHES, 128),
             True),
            ("pixtral train", (TRAIN_BATCH, 32, 8, TRAIN_SEQ, 128), True)):
        q, k, v = _flash_case(dev, b, h, hkv, s, d, seed=s + b)
        want = fa_ref.flash_attention(q, k, v, causal)
        errs = _check_flash(fa_ops.flash_attention(q, k, v, causal), want,
                            f"{tuple(q.shape)} Hkv {hkv} bf16 "
                            f"causal={causal} ({site})")
        if not causal and s > 256:
            # the limit's control: the plain output with keys 128-255
            # dropped (a lost key tile) must fail it
            kept = torch.cat([torch.arange(128), torch.arange(256, s)]
                             ).to(dev)
            lost = _row_rel_err(fa_ref.flash_attention(
                q, k[:, :, kept], v[:, :, kept], False), want)
            ulps = lost / torch.finfo(torch.bfloat16).eps
            print(f"flash ({site}): a lost 128-key tile is {lost:.4g} "
                  f"row-relative, {ulps:.1f} ulps", flush=True)
            assert ulps > FLASH_ROW_ULPS, lost
        pairs = s * (s + 1) // 2 if causal else s * s
        out[site] = _record(
            "flash_attention.fwd",
            lambda q=q, k=k, v=v, c=causal: fa_ops.flash_attention(q, k, v,
                                                                   c),
            lambda q=q, k=k, v=v, c=causal: fa_ref.flash_attention(q, k, v,
                                                                   c),
            2 * (q.numel() + k.numel()) * q.element_size(),
            4 * b * h * d * pairs,
            lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(
                q, k, v, is_causal=c, enable_gqa=hkv < h),
            dict(shape=list(q.shape), kv_heads=hkv, dtype="bfloat16",
                 causal=causal, path=site,
                 max_row_rel_err=errs["max_row_rel_err"]),
            errs["max_abs_err"], BF16_TENSOR_OPS_PER_S)
    return out


def check_encdec_sites(dev, row) -> dict:
    """Phase 3, the slice's max-fusion sites, bf16: whisper-base's mlp
    out-projection in phase 29's step (16 workers, 8 x 384 x 512; the
    encoder's and the decoder's sites have this width) and pixtral-12b's
    attention and mlp out-projections (16, 8 x 256 x 5120) in phase 31's
    step, whose flat width its serving prefill (16, 2 x 1024 x 5120)
    shares: ``maxpool.fwd`` bitwise against its plain version for each
    subset of its optional outputs on randn partials and on partials with
    forced ties, +-0, +-inf and NaNs, also at phase 30's encoder and
    decoder prefill widths and phase 31's tick width; ``maxpool.ties_bwd``
    bitwise against its plain version and ``g * (h == max)`` at both
    train sites; ``noisy`` and ``maxpool.decode`` bitwise at both tick
    sites (1 lane x 16 workers x whisper's 8 slots x 512 and pixtral's 2
    x 5120, bits 8, p_miss 0.05).  Timed: the law's form beside
    ``torch.max(dim=0)`` and the backward beside that composition (the
    whisper site, 50.3 MB, with the L2 evicted before each call), and the
    two channel kernels at the pixtral tick site."""
    for site, shape in (
            ("whisper serve encoder", (QWEN_WORKERS, WHISPER_BATCH,
                                       WHISPER_FRAMES, WHISPER_D)),
            ("whisper serve decoder prefill", (QWEN_WORKERS, WHISPER_BATCH,
                                               len(WHISPER_SOT), WHISPER_D)),
            ("pixtral serve tick", (QWEN_WORKERS, WIDE_REQUESTS, 1,
                                    PIXTRAL_D))):
        n_cols = math.prod(shape[1:])
        _check_fwd_subsets(
            {"randn": _train_site_input(dev, n_cols, 50),
             "ties": _train_site_input(dev, n_cols, 51, ties=True)},
            shape, site)
    out = {}
    for path, slots, d in (("whisper tick", WHISPER_BATCH, WHISPER_D),
                           ("pixtral tick", WIDE_REQUESTS, PIXTRAL_D)):
        for name, launch, plain, nbytes, ops, lib, shape in _kernel_cases(
                dev, 1, slots * d, 8, seed=52, n=QWEN_WORKERS,
                dtype=torch.bfloat16, p_miss=(SERVE_P_MISS,), bounds=True):
            if name not in ("ocs_contention.noisy", "maxpool.decode"):
                continue
            extra = dict(bits=8, shape=shape, dtype="bfloat16", path=path)
            if path == "pixtral tick":
                out[(name, path)] = row(name, launch, plain, nbytes, ops,
                                        lib, extra)
            else:
                _check_equal(name, launch, plain, extra)
                print(f"{name} at the {path} {shape}: bitwise equal to "
                      f"plain", flush=True)
    flush = _l2_flush(dev)
    # the pixtral serving prefill (2 x 1024 patches) has the train site's
    # flat width (8 x 256 tokens), which is all the kernel sees
    assert WIDE_REQUESTS * PIXTRAL_PATCHES == TRAIN_BATCH * TRAIN_SEQ
    for path, shape in (
            ("whisper", (QWEN_WORKERS, WHISPER_BATCH, WHISPER_SEQ,
                         WHISPER_D)),
            ("pixtral", (QWEN_WORKERS, TRAIN_BATCH, TRAIN_SEQ, PIXTRAL_D))):
        cols = math.prod(shape[1:])
        cases = {"randn": _train_site_input(dev, cols, 53).view(shape),
                 "ties": _train_site_input(dev, cols, 54,
                                           ties=True).view(shape)}
        _check_fwd_subsets(cases, shape, path)
        for what, hc in cases.items():
            _check_ties_bwd(dev, hc, 55, what)
        print(f"maxpool.ties_bwd at the {path} train site {shape}: bitwise "
              f"equal to plain and to g * (h == max)", flush=True)
        h = cases["randn"]
        site_flush = flush if path == "whisper" else None
        out[("maxpool.fwd", path)] = row(
            "maxpool.fwd", lambda h=h: mp_ops.maxpool_ties(h, 0),
            lambda h=h: mp_ref.maxpool_ties(h, 0),
            h.numel() * 2 + cols * (2 + 2), 2 * h.numel(),
            lambda h=h: torch.max(h, dim=0),
            dict(shape=list(h.shape), dtype="bfloat16", path=path,
                 outputs="pooled, ties"), flush=site_flush)
        pooled, mask = mp_ops.maxpool_ties(h, 0)
        g = _site_cotangent(dev, h.shape[1:], 56)
        out[("maxpool.ties_bwd", path)] = row(
            "maxpool.ties_bwd",
            lambda: mp_ops.maxpool_ties_bwd(mask, g, QWEN_WORKERS, 0),
            lambda: mp_ref.ties_bwd(mask, g, QWEN_WORKERS, 0),
            cols * (2 + 2) + h.numel() * 2, h.numel(),
            lambda: g.unsqueeze(0) * (h == pooled.unsqueeze(0)).to(h.dtype),
            dict(shape=list(h.shape), dtype="bfloat16", path=path,
                 library="g * (h == max) (3 launches)"), flush=site_flush)
        del cases, h, pooled, mask, g
    del flush
    return out


def _whisper_train_run(ckpt_dir, steps=WHISPER_STEPS):
    """``launch/train``'s run at the full whisper-base width and depth
    (fusion ``max``, flash), ``WHISPER_BATCH`` x 384 frames and 384
    decoder tokens, every step logged, a checkpoint every 3 steps."""
    argv = ["--arch", WHISPER, "--steps", str(steps), "--batch",
            str(WHISPER_BATCH), "--seq", str(WHISPER_SEQ), "--fusion", "max",
            "--use-flash", "--seed", "0"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", ckpt_dir]
    run = _without_remat(launch_train.setup(launch_train.parse_args(argv)))
    cfg = run.cfg
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim_, cfg.n_workers, cfg.vocab_size, cfg.frontend_dim,
            cfg.tie_embeddings, cfg.use_abs_pos, cfg.dtype) == (
        WHISPER_LAYERS, WHISPER_LAYERS, WHISPER_D, 8, 64, QWEN_WORKERS,
        51865, 80, True, True, torch.bfloat16), cfg
    assert attention.attn_layout(cfg) == "plain"
    assert cfg.param_count() == WHISPER_PARAMS, cfg.param_count()
    run.tcfg = dataclasses.replace(run.tcfg, ckpt_every=TRAIN_CKPT_EVERY,
                                   log_every=1)
    return run


def _whisper_train_counts(counts, steps, what) -> None:
    """Per step: flash at the 6 encoder layers (non-causal) and the 6
    decoder layers (causal; the cross-attention is plain, as in the JAX
    package), ``maxpool.fwd`` and ``ties_bwd`` at the 12 mlp sites (8
    heads do not divide 16 workers: no attention site), nothing else."""
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"flash_attention.fwd": 2 * WHISPER_LAYERS * steps,
                 "maxpool.fwd": 2 * WHISPER_LAYERS * steps,
                 "maxpool.ties_bwd": 2 * WHISPER_LAYERS * steps})
    assert counts == want, (what, counts, want)


def run_whisper_train_phase(dev) -> dict:
    """Phase 29: ``launch/train`` at the full whisper-base width and depth
    (6 + 6 layers, d_model 512, 8 heads of 64, 16 workers, vocab 51,865,
    tied; bf16, random weights from seed 0, ``--fusion max --use-flash``),
    8 x 384 frames of 80 features and 384 decoder tokens (the longest
    ``--seq`` whose decoder length ``min(448, seq)`` the flash kernel's
    block contract takes), 6 steps with a checkpoint every 3, counted,
    every loss finite, the peak device memory; a second run bitwise the
    first; the job preempted after its step-3 checkpoint and relaunched,
    bitwise the uninterrupted run from step 3 on; then 3 steps profiled.
    Returns the trained values for phase 30."""
    _release("whisper train phase start")
    work = ROOT / "build" / "train_ckpt"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=work)
    try:
        run = _whisper_train_run(ckpt)
        n_params = sum(t.numel() for t in tree.leaves(run.values))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        full, counts, wall = _counted(lambda: launch_train.launch(run))
        peak = torch.cuda.max_memory_allocated()
        del run
        _whisper_train_counts(counts, WHISPER_STEPS, "uninterrupted")
        losses = [r["loss"] for r in full.history]
        assert len(losses) == WHISPER_STEPS and all(
            math.isfinite(x) for x in losses), losses
        print(f"train {WHISPER} full width and depth ({n_params} parameters "
              f"in the tree, {WHISPER_PARAMS} by param_count; bf16, fusion "
              f"max, flash): {WHISPER_STEPS} steps of {WHISPER_BATCH} x "
              f"{WHISPER_SEQ} frames and tokens in {wall:.3f} s wall "
              f"(checkpoints included); losses {losses}; step host times "
              f"{[round(r['step_time_s'], 4) for r in full.history]}; peak "
              f"device memory {peak / 2**30:.2f} GiB ({peak} bytes); "
              f"launches {counts}", flush=True)
        again, counts2, wall2 = _counted(
            lambda: launch_train.launch(_whisper_train_run(None)))
        _whisper_train_counts(counts2, WHISPER_STEPS, "second run")
        _assert_same_run(full, again, "two whisper runs")
        del again
        _preempt(ckpt, TRAIN_CKPT_EVERY)
        resumed, counts3, wall3 = _counted(
            lambda: launch_train.launch(_whisper_train_run(ckpt)))
        _whisper_train_counts(counts3, WHISPER_STEPS - TRAIN_CKPT_EVERY,
                              "resumed")
        assert resumed.history[0]["step"] == TRAIN_CKPT_EVERY
        _assert_same_run(full, resumed, "whisper resume", TRAIN_CKPT_EVERY)
        del resumed
        print(f"train {WHISPER}: a second run ({wall2:.3f} s) bitwise the "
              f"first; relaunched after its step-{TRAIN_CKPT_EVERY} "
              f"checkpoint ({wall3:.3f} s), bitwise the uninterrupted run "
              f"(the encoder leaves among them)", flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    run = _whisper_train_run(None, steps=7)
    values, opt, pwall, by_class, by_name, launches = _profile_steps(
        run, 3, "profile_train_whisper.txt")
    del run, values, opt
    step_ms = sum(by_class.values())
    res = dict(wall=wall, peak=peak, counts=counts, values=full.values,
               wall_ms=1e3 * pwall / 3, device_ms=step_ms,
               idle=1 - step_ms * 3 / (1e3 * pwall), kernels=launches / 3,
               by_class=by_class)
    print(f"profile, 3 {WHISPER} train steps ({WHISPER_BATCH} x "
          f"{WHISPER_SEQ}): wall {res['wall_ms']:.3f} ms a step unprofiled, "
          f"device busy {step_ms:.3f} ms a step, idle share "
          f"{res['idle']:.3f}; {res['kernels']:.0f} device kernels and "
          f"copies a step; by class (ms a step) {by_class}", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:10.3f} ms a step  {name[:100]}", flush=True)
    return res


def _greedy_ticks(m, values, batch, ticks, proto, seed, finite):
    """The serving path of an encoder-decoder or a patch LM, the JAX
    package's model API (its engine prefills token prompts only):
    ``prefill``, then ``ticks`` greedy ``decode_step_channel`` ticks under
    ``proto`` with the sensing key ``fold_in(PRNGKey(seed), tick)``.
    Every logit is checked finite on the card into ``finite["ok"]``.
    Returns (tokens (B, ticks + 1) on the host, prefill seconds, tick
    seconds, the summed channel accounting)."""
    s = batch["tokens" if "tokens" in batch else "feats"].shape[1]
    dev = batch["feats"].device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = m.prefill(values, batch, max_seq=s + ticks)
    finite["ok"] = finite["ok"] & torch.isfinite(logits).all()
    tok = torch.argmax(logits, -1).to(torch.int32)
    toks = [tok]
    _sync(dev)
    t1 = time.perf_counter()
    chan = None
    for t in range(ticks):
        pos = torch.full_like(tok, s + t)
        logits, cache, ch = m.decode_step_channel(
            values, tok[:, None], pos, cache, proto,
            jr.fold_in(jr.PRNGKey(seed), t))
        finite["ok"] = finite["ok"] & torch.isfinite(logits).all()
        chan = ch if chan is None else {k: chan[k] + ch[k] for k in chan}
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks.append(tok)
    out = torch.stack(toks, 1).cpu()
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1, {k: v.item() for k, v in chan.items()}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _profile_model_ticks(m, values, batch, proto, table) -> dict:
    """A prefill, then :func:`_profile_ticks` over ``decode_step_channel``
    (the model API, the encoder-decoder and patch models' serving path)."""
    s = batch["tokens" if "tokens" in batch else "feats"].shape[1]
    logits, cache = m.prefill(values, batch, max_seq=s + 21)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

    def tick(t):
        return m.decode_step_channel(values, tok, torch.full(
            (tok.shape[0],), s + t, dtype=torch.int32, device=tok.device),
            cache, proto, jr.fold_in(jr.PRNGKey(1), t))

    return _profile_ticks(tick, f"{m.cfg.name} ({tok.shape[0]} rows, OCS "
                          f"p {SERVE_P_MISS})", table)


def run_whisper_serving(dev, values) -> dict:
    """Phase 30: whisper-base at its full width and depth with phase 29's
    trained values (``tp_fusion="max"``, flash prefill) serves 8 requests
    of 1,408 frames (the largest multiple of 128 inside whisper's
    1,500-frame window: the flash kernel's block contract) with whisper's
    4-token start-of-transcript prompt, greedy for 60 tokens through
    ``prefill`` and ``decode_step_channel`` under OCS bits 8, p_miss 0.05,
    counted (a prefill: flash at the 6 encoder and the 6 decoder layers,
    ``maxpool.fwd`` at the 12 mlp sites; a tick: ``noisy`` and
    ``maxpool.decode`` at the 6 decoder mlp sites; nothing else), every
    logit finite; at p_miss 0 the tokens bitwise those of
    ``Protocol.ideal_max(8, "first")``; then 10 ticks profiled."""
    cfg = get_config(WHISPER, tp_fusion="max", use_flash=True)
    m = M.build(cfg)
    gen = torch.Generator(device="cpu").manual_seed(30)
    batch = {"feats": torch.randn((WHISPER_BATCH, WHISPER_FRAMES,
                                   cfg.frontend_dim), generator=gen).to(dev),
             "tokens": torch.tensor([WHISPER_SOT] * WHISPER_BATCH,
                                    dtype=torch.int32, device=dev)}
    finite = {"ok": torch.ones((), dtype=torch.bool, device=dev)}
    ticks = WHISPER_NEW - 1
    sites = m.channel_sites()
    assert sites == WHISPER_LAYERS
    (toks, pre_s, tick_s, chan), counts, wall = _counted(
        lambda: _greedy_ticks(m, values, batch, ticks, _ocs(SERVE_P_MISS), 0,
                              finite))
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"flash_attention.fwd": 2 * WHISPER_LAYERS,
                 "maxpool.fwd": 2 * WHISPER_LAYERS,
                 "ocs_contention.noisy": sites * ticks,
                 "maxpool.decode": sites * ticks})
    assert counts == want, (counts, want)
    assert bool(finite["ok"]), "whisper: a logit is not finite"
    assert toks.shape == (WHISPER_BATCH, WHISPER_NEW)
    assert chan["calls"] == sites * ticks and chan["contention_slots"] > 0
    print(f"serve {WHISPER} full width and depth (phase 29's values), OCS p "
          f"{SERVE_P_MISS}: {WHISPER_BATCH} requests of {WHISPER_FRAMES} "
          f"frames and a {len(WHISPER_SOT)}-token prompt, {WHISPER_NEW} "
          f"greedy tokens each in {wall:.3f} s wall: prefill {pre_s:.4f} s, "
          f"{ticks} ticks {tick_s:.4f} s ({1e3 * tick_s / ticks:.3f} ms a "
          f"tick); channel {chan}; every logit finite; launches {counts}; "
          f"request 0 tokens {toks[0].tolist()}", flush=True)
    a = _greedy_ticks(m, values, batch, 8, _ocs(0.0), 0, finite)[0]
    b = _greedy_ticks(m, values, batch, 8,
                      Protocol.ideal_max(8, tie_break="first"), 0, finite)[0]
    assert torch.equal(a, b), (a, b)
    print(f"serve {WHISPER} p0: OCS(p_miss=0) == ideal_max(8, 'first') in "
          f"every token of {WHISPER_BATCH} requests x 9", flush=True)
    prof = _profile_model_ticks(m, values, batch, _ocs(SERVE_P_MISS),
                                "profile_serve_whisper.txt")
    return dict(counts=counts, wall=wall, prefill_s=pre_s,
                tick_ms=1e3 * tick_s / ticks, ticks=ticks, profile=prof)


def _init_peak_bound(values) -> int:
    """The most device bytes ``init`` may hold above what was allocated
    before it: the tree, one drawn period beside the stack it is copied
    into, and the largest leaf's float32 draw beside its scaled copy (8
    bytes an element).  A ``torch.stack`` of the drawn periods holds the
    blocks twice and exceeds it."""
    stacks = [values[k] for k in ("blocks", "encoder") if k in values]
    draws = [t.numel() for k, sub in values.items()
             if k not in ("blocks", "encoder") for t in tree.leaves(sub)]
    draws += [t[0].numel() for st in stacks for t in tree.leaves(st)]
    period = max(sum(t[0].numel() * t.element_size()
                     for t in tree.leaves(st)) for st in stacks)
    return (sum(t.numel() * t.element_size() for t in tree.leaves(values))
            + period + 8 * max(draws))


def _pixtral_train_run(steps=PIXTRAL_TRAIN_STEPS):
    """``launch/train``'s run at the full pixtral-12b width, the depth cut
    to ``PIXTRAL_TRAIN_LAYERS`` (``--layers``), fusion ``max``, flash,
    8 x 256 patches of 1,024 features, every step logged."""
    run = _without_remat(launch_train.setup(launch_train.parse_args([
        "--arch", PIXTRAL, "--layers", str(PIXTRAL_TRAIN_LAYERS), "--steps",
        str(steps), "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--seed", "0"])))
    run.tcfg = dataclasses.replace(run.tcfg, log_every=1)
    return run


def _pixtral_train_counts(counts, steps, what) -> None:
    """Per step: flash once per layer, ``maxpool.fwd`` and ``ties_bwd`` at
    each layer's attention site (32 heads over 16 workers) and mlp site."""
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"flash_attention.fwd": PIXTRAL_TRAIN_LAYERS * steps,
                 "maxpool.fwd": 2 * PIXTRAL_TRAIN_LAYERS * steps,
                 "maxpool.ties_bwd": 2 * PIXTRAL_TRAIN_LAYERS * steps})
    assert counts == want, (what, counts, want)


def run_pixtral_phase(dev) -> dict:
    """Phase 31: pixtral-12b at its full width.  Serving at full depth (40
    layers, d_model 5120, 32 heads of 128 over 8 KV heads, d_ff 14336, 16
    workers; 12,253,020,160 parameters by ``param_count``; bf16, random
    weights from seed 0, ``tp_fusion="max"``, flash prefill): 2 requests
    of 1,024 patch features of 1,024-d (a 512 x 512 image at 16-pixel
    patches), greedy for 8 tokens through ``prefill`` and
    ``decode_step_channel`` under OCS p 0.05, counted (a prefill: flash
    40, ``maxpool.fwd`` at the 40 attention and 40 mlp sites; a tick:
    ``maxpool.fwd`` at the 40 attention sites, ``noisy`` and
    ``maxpool.decode`` at the 40 mlp sites), every logit finite, the
    model's init peak above what was allocated before it under
    :func:`_init_peak_bound`, the peak device memory, 10 ticks profiled.
    Then ``launch/train`` cut to ``PIXTRAL_TRAIN_LAYERS`` layers (the
    float32 master and moments of 40 layers do not fit the card), 3 steps
    of 8 x 256 patches, counted, the peak under the card's 79.18 GiB, a
    second run bitwise the first (the first run's state held on the
    CPU)."""
    cfg = get_config(PIXTRAL, tp_fusion="max", use_flash=True)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.frontend_dim,
            cfg.n_workers, cfg.dtype) == (
        PIXTRAL_LAYERS, PIXTRAL_D, 32, 8, 128, 14336, 131072,
        PIXTRAL_FEAT, QWEN_WORKERS, torch.bfloat16), cfg
    assert attention.attn_layout(cfg) == "worker"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    m = M.build(cfg)
    values = m.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree.leaves(values))
    assert n_params == cfg.param_count() + cfg.d_model, n_params
    bound = _init_peak_bound(values)
    print(f"{PIXTRAL} init: {n_params} parameters in the tree "
          f"({cfg.param_count()} by param_count, the final norm beside), "
          f"{n_params * 2 / 2**30:.2f} GiB bf16; init peak "
          f"{init_peak / 2**30:.2f} GiB ({init_peak} bytes), "
          f"{(init_peak - base) / 2**30:.2f} GiB above the {base} bytes "
          f"allocated before it, under its bound {bound / 2**30:.2f} GiB "
          f"({bound} bytes)", flush=True)
    assert init_peak - base <= bound, (init_peak, base, bound)
    gen = torch.Generator(device="cpu").manual_seed(31)
    batch = {"feats": torch.randn((WIDE_REQUESTS, PIXTRAL_PATCHES,
                                   PIXTRAL_FEAT), generator=gen).to(dev)}
    finite = {"ok": torch.ones((), dtype=torch.bool, device=dev)}
    ticks = PIXTRAL_NEW - 1
    (toks, pre_s, tick_s, chan), counts, wall = _counted(
        lambda: _greedy_ticks(m, values, batch, ticks, _ocs(SERVE_P_MISS), 0,
                              finite))
    sites = m.channel_sites()
    assert sites == PIXTRAL_LAYERS
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"flash_attention.fwd": PIXTRAL_LAYERS,
                 "maxpool.fwd": 2 * PIXTRAL_LAYERS + PIXTRAL_LAYERS * ticks,
                 "ocs_contention.noisy": sites * ticks,
                 "maxpool.decode": sites * ticks})
    assert counts == want, (counts, want)
    assert bool(finite["ok"]), "pixtral: a logit is not finite"
    assert toks.shape == (WIDE_REQUESTS, PIXTRAL_NEW)
    serve_peak = torch.cuda.max_memory_allocated()
    print(f"serve {PIXTRAL} full width and depth, OCS p {SERVE_P_MISS}: "
          f"{WIDE_REQUESTS} requests of {PIXTRAL_PATCHES} patches, "
          f"{PIXTRAL_NEW} greedy tokens each in {wall:.3f} s wall: prefill "
          f"{pre_s:.4f} s, {ticks} ticks {tick_s:.4f} s "
          f"({1e3 * tick_s / ticks:.3f} ms a tick); channel {chan}; every "
          f"logit finite; peak device memory {serve_peak / 2**30:.2f} GiB "
          f"({serve_peak} bytes); launches {counts}; tokens "
          f"{toks.tolist()}", flush=True)
    prof = _profile_model_ticks(m, values, batch, _ocs(SERVE_P_MISS),
                                "profile_serve_pixtral.txt")
    del values, m
    _release("pixtral serving done")

    run = _pixtral_train_run()
    n_train = sum(t.numel() for t in tree.leaves(run.values))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first, tcounts, twall = _counted(lambda: launch_train.launch(run))
    train_peak = torch.cuda.max_memory_allocated()
    del run
    _pixtral_train_counts(tcounts, PIXTRAL_TRAIN_STEPS, "first run")
    assert train_peak < 79.18 * 2**30, train_peak
    losses = [r["loss"] for r in first.history]
    assert len(losses) == PIXTRAL_TRAIN_STEPS and all(
        math.isfinite(x) for x in losses), losses
    print(f"train {PIXTRAL} full width, {PIXTRAL_TRAIN_LAYERS} of 40 layers "
          f"({n_train} parameters, bf16, fusion max, flash): "
          f"{PIXTRAL_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"patches in {twall:.3f} s wall; losses {losses}; step host times "
          f"{[round(r['step_time_s'], 4) for r in first.history]}; peak "
          f"device memory {train_peak / 2**30:.2f} GiB ({train_peak} "
          f"bytes); launches {tcounts}", flush=True)
    held = (_cpu_tree(first.values), _cpu_tree(first.opt_state),
            _rows(first.history))
    del first
    _release("first pixtral run held on the CPU")
    again, counts2, _ = _counted(
        lambda: launch_train.launch(_pixtral_train_run()))
    _pixtral_train_counts(counts2, PIXTRAL_TRAIN_STEPS, "second run")
    _assert_same_run_cpu(held, again, "two pixtral runs")
    del again, held
    _release("second pixtral run compared")
    print(f"train {PIXTRAL}: a second run bitwise the first: values, "
          f"optimizer state, history", flush=True)
    return dict(counts=counts, wall=wall, prefill_s=pre_s,
                tick_ms=1e3 * tick_s / ticks, init_peak=init_peak,
                init_base=base, serve_peak=serve_peak, profile=prof,
                train_counts=tcounts, train_wall=twall, train_peak=train_peak,
                params=n_params, train_params=n_train)


def check_encdec_against_cpu(dev) -> None:
    """Phase 32: the reduced whisper-base and pixtral-12b configs in
    float32 (``tp_fusion="max"``, flash), the same weights on the card and
    the CPU: 3 trainer steps with losses within phase 6's 1e-3, and the
    tokens of a prefill and 8 greedy decode ticks equal, ideal and under
    OCS p 0.05."""
    for arch in (WHISPER, PIXTRAL):
        cfg = get_reduced(arch, tp_fusion="max", use_flash=True)
        m = M.build(cfg)
        cpu_values = m.init(torch.Generator().manual_seed(0))
        if cfg.tie_embeddings:
            # logits flat enough that greedy tokens are not the prompt's
            cpu_values["embed"]["tokens"].mul_(0.02)
        gpu_values = tree.map(lambda t: t.to(dev), cpu_values)
        pcfg = pipeline.for_model(cfg, batch=4, seq_len=32, seed=0)
        losses = []
        for d, v in (("cpu", cpu_values), (dev, gpu_values)):
            opt = optimizers.adamw(schedules.for_arch(arch, 3e-3, 3),
                                   weight_decay=0.01)
            res = trainer.train(
                m.loss, v, opt,
                lambda s, d=d: pipeline.batch_for_step(pcfg, s, device=d),
                trainer.TrainerConfig(steps=3, log_every=1))
            losses.append([r["loss"] for r in res.history])
        diff = max(abs(a - b) for a, b in zip(*losses))
        assert diff < 1e-3, (arch, losses)
        rng = np.random.default_rng(32)
        batch = {"feats": torch.from_numpy(rng.standard_normal(
            (2, 32, cfg.frontend_dim)).astype(np.float32))}
        if cfg.encoder_decoder:
            batch["tokens"] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 4)).astype(np.int32))
        p = np.full((cfg.n_workers,), SERVE_P_MISS, np.float32)
        for proto in (Protocol.ideal_max(8, tie_break="first"),
                      Protocol.ocs(bits=8, p_miss=p)):
            got, want = (_greedy_ticks(
                m, v, {k: t.to(d) for k, t in batch.items()}, 8, proto, 0,
                {"ok": torch.ones((), dtype=torch.bool, device=d)})[0]
                for d, v in ((dev, gpu_values), ("cpu", cpu_values)))
            assert torch.equal(got, want), (arch, proto.kind, got, want)
        print(f"{arch} reduced, card vs CPU: 3 train losses within "
              f"{diff:.3g}; prefill + 8 greedy ticks' tokens equal, ideal "
              f"and under OCS p {SERVE_P_MISS}", flush=True)


_PHASE_SECONDS = {}


# ---------------------------------------------------------------------------
# the engines over torch.distributed ranks
# ---------------------------------------------------------------------------

def _differences(a, b, what="") -> list:
    """The fields where two results differ, recursively (dataclasses
    field by field, tensors and arrays bitwise, floats in their raw
    bits)."""
    if dataclasses.is_dataclass(b) and not isinstance(b, type):
        if type(a) is not type(b):
            return [what]
        return [d for f in dataclasses.fields(b) for d in _differences(
            getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")]
    if isinstance(b, dict):
        if sorted(a) != sorted(b):
            return [what]
        return [d for k in b for d in _differences(a[k], b[k],
                                                   f"{what}[{k}]")]
    if isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [what]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _differences(x, y, f"{what}[{i}]")]
    if isinstance(b, torch.Tensor):
        same = isinstance(a, torch.Tensor) and _bitwise_equal(a, b)
        return [] if same else [what]
    if isinstance(b, np.ndarray):
        a = np.asarray(a)
        if a.dtype != b.dtype or a.shape != b.shape:
            return [what]
        if b.dtype.kind == "f":
            a, b = a.view(f"i{b.itemsize}"), b.view(f"i{b.itemsize}")
        return [] if np.array_equal(a, b) else [what]
    return [] if a == b else [what]


def _sweep_group_counts(cells, rank: int) -> dict:
    """What rank ``rank`` of ``RANKS`` launches on the sweep: one encode
    per clean ``bits`` group and one ``noisy`` and one ``maxpool.decode``
    per ``(bits, id_bits)`` sub-group whose placement gives it a block
    (a group of ``g`` scenarios takes ``min(RANKS, g)`` ranks)."""
    def used(size):
        return rank < min(RANKS, size)

    by_bits, by_sub = {}, {}
    for sc in cells:
        by_bits[sc.bits] = by_bits.get(sc.bits, 0) + 1
        key = (sc.bits, ocs.host_id_bits(sc.n_workers))
        by_sub[key] = by_sub.get(key, 0) + 1
    want = {k: 0 for k in kernels.KERNELS}
    want["ocs_quant.encode"] = sum(map(used, by_bits.values()))
    want["ocs_contention.noisy"] = want["maxpool.decode"] = sum(
        map(used, by_sub.values()))
    return want


def _rank_paths() -> dict:
    """Phase 33's task on each gloo rank: the curves, the sweep and the DP
    engine placed over the ranks, each counted and timed.  The rank loads
    the library the parent built and builds nothing."""
    built = kernels.BUILD_DIR / f"libreprotorch_{kernels._source_hash()}.so"
    assert built.exists(), "the parent process did not build the kernels"
    kernels.library()
    dev = torch.device("cuda")
    car = CompressedAllReduce.topk(DP_K_FRAC)
    out = {}
    for name, fn in (
            ("curves", lambda: tc.run_curves(cifar_config(), device=dev,
                                             n_devices=RANKS)),
            ("sweep", lambda: sweep.run_sweep(
                sweep_grid(), k_elems=SWEEP_K, rounds=SWEEP_ROUNDS,
                device=dev, n_devices=RANKS)),
            ("dp", lambda: tc.run_curves_dp(_dp_config(), car, device=dev,
                                            n_devices=RANKS))):
        res, counts, wall = _counted(fn)
        out[name] = dict(result=res, counts=counts, wall=wall)
    return out


def run_ranks_phase(dev, curves, swept, dp) -> dict:
    """Phase 33: the engines over ``torch.distributed`` ranks.  (i) One
    NCCL rank in this process (a ``FileStore`` group of one):
    ``run_curves`` at phase 5's config, bitwise phase 5's result.  (ii)
    ``RANKS`` gloo ranks sharing cuda:0, started with the ``spawn`` start
    method: ``run_curves`` at phase 5's config, ``bench_sweep.py``'s grid
    and ``run_curves_dp`` at phase 17's settings with the DP axis on the
    ranks, every rank's result bitwise phases 5, 16 and 17's in every
    field, the DP payload the bill at every logged step, each rank's
    launches its block's share.  The ranks' process groups time out after
    ``RANKS_TIMEOUT`` s and their processes are killed after twice that."""
    ccfg = cifar_config()
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(str(work / "nccl_store"), 1),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=RANKS_TIMEOUT))
        try:
            one, one_counts, one_wall = _counted(lambda: tc.run_curves(
                ccfg, device=dev, n_devices=1))
        finally:
            dist.destroy_process_group()
        failed = [f"nccl rank {d}" for d in _differences(one, curves,
                                                         "curves")]
        _assert_curve_counts(one_counts, ccfg, len(ccfg.bits), "nccl rank")
        print(f"one NCCL rank: run_curves {one_wall:.3f} s wall, launches "
              f"{one_counts}; " + (f"DIFFERS in {failed[:12]}" if failed
                                   else "bitwise phase 5's result"),
              flush=True)

        t0 = time.perf_counter()
        got = comm.spawn(_rank_paths, RANKS, workdir=work / "gloo",
                         timeout=RANKS_TIMEOUT, threads=4)
        spawn_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = {"curves": curves, "sweep": swept["result"], "dp": dp["result"]}
    for r, out in enumerate(got):
        for name, ref in want.items():
            diff = _differences(out[name]["result"], ref, name)
            print(f"gloo rank {r}/{RANKS}: {name} {out[name]['wall']:.3f} s "
                  f"wall, launches {out[name]['counts']}; "
                  + ("bitwise the one-device result" if not diff else
                     f"DIFFERS in {diff[:12]} ({len(diff)} fields)"),
                  flush=True)
            failed += [f"rank {r} {d}" for d in diff]
    assert not failed, f"ranks != the one-device runs: {failed[:40]}"
    for r, out in enumerate(got):
        _assert_curve_counts(out["curves"]["counts"], ccfg, len(ccfg.bits),
                             f"gloo rank {r} curves")
        sw = _sweep_group_counts(sweep_grid(), r)
        assert out["sweep"]["counts"] == sw, (r, out["sweep"]["counts"], sw)
        dcfg = _dp_config()
        sites = (dcfg.steps + 1) * len(dcfg.bits)
        dp_want = {k: 0 for k in kernels.KERNELS}
        dp_want.update({"ocs_contention.noisy": sites,
                        "maxpool.decode": sites,
                        "maxpool.winner_bwd": dcfg.steps * len(dcfg.bits)})
        assert out["dp"]["counts"] == dp_want, (r, out["dp"]["counts"])
        res = out["dp"]["result"]
        assert np.all(res.dp_payload_bits == res.dp_payload_bits_step), \
            "measured DP payload on ranks != the exact-k bill"
    print(f"{RANKS} gloo ranks sharing cuda:0: spawn to join "
          f"{spawn_wall:.3f} s; every rank's curves, sweep and DP results "
          "bitwise the one-device runs; launches as each block's share",
          flush=True)
    summed = {name: {k: sum(out[name]["counts"][k] for out in got)
                     for k in kernels.KERNELS} for name in want}
    return dict(nccl_counts=one_counts, nccl_wall=one_wall, counts=summed,
                walls={name: [out[name]["wall"] for out in got]
                       for name in want}, spawn_wall=spawn_wall)


# ---------------------------------------------------------------------------
# the dense LM stack over a (1 data x 2 model) mesh
# ---------------------------------------------------------------------------

def _tp_train_args(dev):
    """Phase 18's flags (``launch/train``)."""
    return launch_train.parse_args([
        "--arch", QWEN, "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", "0",
        "--device", dev.type])


def _tp_train_run(dev):
    """Phase 18's run (its batches and its 6-step schedule), cut to
    ``TP_STEPS`` steps, every step logged, no checkpoints."""
    run = _without_remat(launch_train.setup(_tp_train_args(dev)))
    run.tcfg = dataclasses.replace(run.tcfg, steps=TP_STEPS, log_every=1,
                                   ckpt_dir=None)
    return run


def _tp_serve_model(dev, dtype=torch.bfloat16):
    cfg = get_config(QWEN, use_flash=True, tp_fusion="max")
    if dtype != cfg.dtype:
        cfg = cfg.with_(dtype=dtype, param_dtype=dtype)
    m = M.build(cfg)
    return m, m.init(torch.Generator(device=dev).manual_seed(0))


def _tp_serve(m, values, dev):
    """4 of phase 8's requests under OCS p 0.05: ({rid: (tokens, channel
    slots, uplink bits)}, counts, wall, ticks), the counts and ticks of
    the run after a warm-up request."""
    eng = se.ServeEngine(m, values, se.ServeConfig(
        batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, eos_id=-1,
        protocol=_ocs(SERVE_P_MISS)), device=dev)
    reqs = poisson_requests(SERVE_REQUESTS, SERVE_RATE, m.cfg.vocab_size,
                            prompt_len=SERVE_PROMPT,
                            max_new_tokens=SERVE_NEW, seed=0)[:TP_REQUESTS]
    eng.run([se.Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=2)])
    se.reset_dispatch_counts()
    outs, counts, wall = _counted(lambda: eng.run(reqs))
    got = {rid: (c.tokens, c.channel_slots, c.uplink_bits)
           for rid, c in outs.items()}
    return got, counts, wall, se.dispatch_counts()["tick"], reqs


def _tp_logits(m, values, reqs, dev) -> torch.Tensor:
    """The float32 prefill's last logits of the first request and those of
    two greedy decode steps after it (``decode_step``: the max sites)."""
    prompt = torch.as_tensor(np.asarray(reqs[0].prompt, np.int32),
                             device=dev)[None]
    logits, cache = m.prefill(values, {"tokens": prompt},
                              max_seq=SERVE_PROMPT + 2)
    seq = [logits]
    pos = torch.full((1,), SERVE_PROMPT, dtype=torch.int32, device=dev)
    for t in range(2):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        logits, cache = m.decode_step(values, tok, pos + t, cache)
        seq.append(logits)
    return torch.cat(seq).float().cpu()


def _tp_products(dev, mesh) -> dict:
    """Whether each product the model axis splits is, on this rank's
    block, bitwise the block of the one-device product in bf16, at a
    tick's, a prefill's and a train step's rows: the q projection, the
    MLP's up and down projections over the workers, the attention
    out-projection's worker partials, the unembedding (the token table's
    transpose); a tick's attention over the rank's heads; and flash over
    the rank's heads at the prefill."""
    axis = sharding.mesh_axis(mesh, "model")
    gen = torch.Generator(device=dev).manual_seed(5)
    d, n, f, vocab = QWEN_D, QWEN_WORKERS, 2816, 151936

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    table = rnd(vocab, d)
    out = {}
    for rows in (SERVE_SLOTS, SERVE_PROMPT, TRAIN_BATCH * TRAIN_SEQ):
        x = rnd(1, rows, d)
        cases = {"q_proj": (x[0], rnd(d, d)),
                 "mlp_up": (x, rnd(n, d, f // n)),
                 "mlp_down": (rnd(n, rows, f // n), rnd(n, f // n, d)),
                 "attn_out": (rnd(n, rows, d // n), rnd(n, d // n, d)),
                 "unembed": (x[0], table.T)}
        for name, (a, w) in cases.items():
            whole = torch.matmul(a, w)
            if w.ndim == 2:                 # columns split
                got = torch.matmul(a, sharding.split_dim(w, axis, 1))
                want = sharding.split_dim(whole, axis, 1)
            else:                           # the worker batch split
                a_mine = a if a.shape[0] == 1 else sharding.split_dim(
                    a, axis)
                got = torch.matmul(a_mine, sharding.split_dim(w, axis))
                want = sharding.split_dim(whole, axis)
            out[f"{name}@{rows}"] = _bitwise_equal(got, want)
    # a tick's attention (plain PyTorch) over the rank's heads: q whole
    # as the projection leaves it, k and v views of the whole cache, over
    # 16 draws (an output that rounds otherwise may be one in thousands)
    hd = d // QWEN_HEADS
    pos = torch.arange(SERVE_SLOTS, device=dev) + SERVE_PROMPT
    valid = (torch.arange(SERVE_MAX_SEQ, device=dev)[None, :]
             <= pos[:, None])[:, None, :]
    cfg = get_config(QWEN)
    same = True
    for _ in range(16):
        q = rnd(SERVE_SLOTS, 1, QWEN_HEADS, hd)
        k, v = (rnd(SERVE_SLOTS, SERVE_MAX_SEQ, QWEN_HEADS, hd)
                for _ in range(2))
        whole = attention._sdpa(cfg, q, k, v, valid)
        got = attention._sdpa(cfg, sharding.split_dim(q, axis, 2).clone(),
                              sharding.split_dim(k, axis, 2),
                              sharding.split_dim(v, axis, 2), valid)
        same = same and _bitwise_equal(got,
                                       sharding.split_dim(whole, axis, 2))
    out["decode_attn@tick"] = same
    q, k, v = (rnd(1, QWEN_HEADS, SERVE_PROMPT, hd) for _ in range(3))
    whole = fa_ops.flash_attention(q, k, v, True)
    got = fa_ops.flash_attention(*(sharding.split_dim(t, axis, 1)
                                   for t in (q, k, v)), True)
    out[f"flash@{SERVE_PROMPT}"] = _bitwise_equal(
        got, sharding.split_dim(whole, axis, 1))
    return out


def _tp_sites(dev, mesh) -> dict:
    """Whether a fusion site over the model group, given this rank's block
    of a stack, is bitwise the one-device law on the whole stack: the max
    site (``tie_break="all"``) at a tick's and a train step's shape,
    forward and the block's gradient, and the OCS channel site at a
    tick's shape, the pooled value and the accounting."""
    axis = sharding.mesh_axis(mesh, "model")
    cfg = get_config(QWEN, tp_fusion="max")
    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def fuse(h, g):
        h = h.detach().requires_grad_(True)
        pooled = fusion.worker_reduce(cfg, {}, h)
        return pooled, torch.autograd.grad(pooled, h, g)[0]

    out = {}
    for name, rows in (("tick", (SERVE_SLOTS, 1)),
                       ("train", (TRAIN_BATCH, TRAIN_SEQ))):
        h = rnd(QWEN_WORKERS, *rows, QWEN_D)
        g = rnd(*rows, QWEN_D)
        want, want_grad = fuse(h, g)
        with sharding.use_mesh(mesh):
            got, grad = fuse(sharding.split_dim(h, axis), g)
        out[f"max@{name}"] = (_bitwise_equal(got, want) and _bitwise_equal(
            grad, sharding.split_dim(want_grad, axis)))
    proto = _ocs(SERVE_P_MISS)
    key = jr.PRNGKey(3, dev)
    h = rnd(QWEN_WORKERS, SERVE_SLOTS, 1, QWEN_D)
    want, wacct = proto.aggregate(h, key)
    with sharding.use_mesh(mesh):
        got, gacct = fusion.worker_reduce_channel(
            cfg, {}, sharding.split_dim(h, axis), proto, key)
    out["channel@tick"] = _bitwise_equal(got, want) and all(
        _bitwise_equal(getattr(gacct, f.name), getattr(wacct, f.name))
        for f in dataclasses.fields(wacct))
    return out


def _qkv_without_f(cfg, p, x, kv_x, heads):
    """Phase 34's control fault: ``attention._qkv`` with ``wk``, ``wv``,
    ``bk`` and ``bv`` outside the model group's *f* copy, so that each
    rank keeps only its own heads' share of their gradients."""
    d = cfg.dtype
    x = heads.copy(x)
    kv_x = x if kv_x is None else heads.copy(kv_x)
    q = attention._proj(x, p["wq"].to(d))
    k = attention._proj(kv_x, p["wk"].to(d))
    v = attention._proj(kv_x, p["wv"].to(d))
    if "bq" in p:
        q = q + p["bq"].to(d)
        k = k + p["bk"].to(d)
        v = v + p["bv"].to(d)
    return q, k, v


def _tp_train(dev, mesh) -> dict:
    """``TP_STEPS`` of phase 18's steps on this rank's blocks of ``mesh``:
    losses, gathered gradient norms, launches, wall, collective bytes."""
    run = _tp_train_run(dev)
    axes = run.m.axes()
    shd = sharding.tree_shardings_for_values(axes, run.values, mesh)
    blocks = sharding.shard_values(run.values, axes, mesh)
    run.values = None
    gc.collect()
    torch.cuda.empty_cache()
    with sharding.use_mesh(mesh), comm.recording() as rec:
        res, counts, wall = _counted(lambda: trainer.train(
            run.m.loss, blocks, run.opt, run.data, run.tcfg,
            shardings=shd))
    out = dict(losses=[r["loss"] for r in res.history],
               grad_norms=[r["grad_norm"] for r in res.history],
               counts=counts, wall=wall, bytes=comm.summarize(rec),
               step_s=[r["step_time_s"] for r in res.history])
    del res, blocks, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_rank() -> dict:
    """Phase 34's task on each gloo rank: the trainer and the engine on
    this rank's blocks of a (1 x ``TP_RANKS``) mesh, counted, timed and
    their collectives recorded, and the trainer again under the control
    fault (:func:`_qkv_without_f`).  The rank loads the library the
    parent built and builds nothing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    built = kernels.BUILD_DIR / f"libreprotorch_{kernels._source_hash()}.so"
    assert built.exists(), "the parent process did not build the kernels"
    kernels.library()
    dev = torch.device("cuda")
    mesh = launch_mesh.make_mesh(1, TP_RANKS)
    out = {"coord": mesh.coord(), "train": _tp_train(dev, mesh)}
    sound = attention._qkv
    attention._qkv = _qkv_without_f
    try:
        ctl = _tp_train(dev, mesh)
    finally:
        attention._qkv = sound
    out["control"] = {k: ctl[k] for k in ("losses", "grad_norms")}

    m, whole = _tp_serve_model(dev)
    blocks = sharding.shard_values(whole, m.axes(), mesh)
    del whole
    with sharding.use_mesh(mesh), comm.recording() as rec:
        got, counts, wall, ticks, reqs = _tp_serve(m, blocks, dev)
    out["serve"] = dict(result=got, counts=counts, wall=wall, ticks=ticks,
                        bytes=comm.summarize(rec))
    del blocks
    m32, whole = _tp_serve_model(dev, torch.float32)
    blocks = sharding.shard_values(whole, m32.axes(), mesh)
    del whole
    with sharding.use_mesh(mesh), comm.recording() as rec:
        out["logits"] = _tp_logits(m32, blocks, reqs, dev)
    out["logits_bytes"] = comm.summarize(rec)
    out["products"] = _tp_products(dev, mesh)
    out["sites"] = _tp_sites(dev, mesh)
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def _lost_partial(values) -> dict:
    """The logits' control fault: ``values`` with the last layer's MLP
    down-projection of worker 0 zeroed (one worker's partial lost at one
    site)."""
    out = tree.map(lambda t: t, values)
    ffn = out["blocks"]["pos0"]["ffn"]
    ffn["w_down"] = ffn["w_down"].clone()
    ffn["w_down"][-1, 0].zero_()
    return out


def _rel_gaps(got, want) -> list:
    """|got - want| / |want|, element by element."""
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def _logits_rel_err(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def run_tp_phase(dev, phase18) -> dict:
    """Phase 34: the dense LM stack over a (1 data x ``TP_RANKS`` model)
    mesh of gloo ranks sharing cuda:0 (see the module doc), against
    phase 18's losses and gradient norms and a one-device run of the
    serving traffic in this process.  Every reading is printed before
    any is held to its limit."""
    _release("tp phase start")
    m, values = _tp_serve_model(dev)
    want, one_counts, one_wall, one_ticks, reqs = _tp_serve(m, values, dev)
    del values
    m32, values = _tp_serve_model(dev, torch.float32)
    one_logits = _tp_logits(m32, values, reqs, dev)
    ctl_logits = _tp_logits(m32, _lost_partial(values), reqs, dev)
    del values
    _release("tp phase spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        got = comm.spawn(_tp_rank, TP_RANKS, workdir=work / "gloo",
                         timeout=TP_TIMEOUT, threads=2)
        spawn_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert [o["coord"] for o in got] == [(0, r) for r in range(TP_RANKS)]
    train_want = {k: 0 for k in kernels.KERNELS}
    train_want.update({"flash_attention.fwd": QWEN_LAYERS * TP_STEPS,
                       "maxpool.fwd": 2 * QWEN_LAYERS * TP_STEPS,
                       "maxpool.ties_bwd": 2 * QWEN_LAYERS * TP_STEPS})
    first = phase18["losses"][:TP_STEPS]
    first_gn = phase18["grad_norms"][:TP_STEPS]
    gaps = {}
    for r, o in enumerate(got):
        t, c = o["train"], o["control"]
        gaps[r] = dict(
            first=abs(t["losses"][0] - first[0]),
            loss=_rel_gaps(t["losses"], first),
            grad_norm=_rel_gaps(t["grad_norms"], first_gn),
            control_loss=_rel_gaps(c["losses"], first),
            control_grad_norm=_rel_gaps(c["grad_norms"], first_gn))
        per_step = {k: {"calls": v["calls"] / TP_STEPS,
                        "bytes": v["bytes"] / TP_STEPS}
                    for k, v in t["bytes"].items()}
        print(f"tp rank {r}/{TP_RANKS}: train {TP_STEPS} steps in "
              f"{t['wall']:.3f} s wall (step host times "
              f"{[round(x, 4) for x in t['step_s']]}), losses {t['losses']} "
              f"against phase 18's {first} (relative gaps "
              f"{gaps[r]['loss']}), gradient norms {t['grad_norms']} "
              f"against phase 18's {first_gn} (relative gaps "
              f"{gaps[r]['grad_norm']}); launches {t['counts']}; "
              f"collectives a step {per_step}; peak device memory "
              f"{o['peak']} bytes", flush=True)
        print(f"tp rank {r}/{TP_RANKS}: control (wk/wv/bk/bv outside the "
              f"f copy): losses {c['losses']} (relative gaps "
              f"{gaps[r]['control_loss']}), gradient norms "
              f"{c['grad_norms']} (relative gaps "
              f"{gaps[r]['control_grad_norm']})", flush=True)
    ticks = one_ticks
    serve_want = {k: 0 for k in kernels.KERNELS}
    serve_want.update({
        "flash_attention.fwd": QWEN_LAYERS * TP_REQUESTS,
        "maxpool.fwd": 2 * QWEN_LAYERS * TP_REQUESTS + QWEN_LAYERS * ticks,
        "ocs_contention.noisy": QWEN_LAYERS * ticks,
        "maxpool.decode": QWEN_LAYERS * ticks})
    print(f"tp one device: serve {TP_REQUESTS} requests in {one_wall:.3f} s "
          f"wall, {one_ticks} ticks, launches {one_counts}; request 0 "
          f"tokens {want[0][0]}", flush=True)
    same = all(o["serve"]["result"] == want for o in got)
    errs = [_logits_rel_err(o["logits"], one_logits) for o in got]
    ctl_err = _logits_rel_err(ctl_logits, one_logits)
    for r, o in enumerate(got):
        sv = o["serve"]
        per_tick = {k: {"calls": v["calls"] / sv["ticks"],
                        "bytes": v["bytes"] / sv["ticks"]}
                    for k, v in sv["bytes"].items()}
        differ = [rid for rid in want if sv["result"].get(rid) != want[rid]]
        print(f"tp rank {r}/{TP_RANKS}: serve {sv['wall']:.3f} s wall, "
              f"{sv['ticks']} ticks, launches {sv['counts']}; collectives a "
              f"tick (prefills included) {per_tick}; requests differing "
              f"from the one-device run {differ}; float32 prefill and 2 "
              f"decode steps' logits: max diff "
              f"{float((o['logits'] - one_logits).abs().max()):.4g}, "
              f"{errs[r]:.4g} of max|logit| "
              f"{float(one_logits.abs().max()):.4g}; sites bitwise the "
              f"one-device law on equal inputs {o['sites']}; split "
              f"products bitwise the one-device block {o['products']}",
              flush=True)
        for rid in differ[:2]:
            fields = [name for name, a, b in zip(
                ("tokens", "channel_slots", "uplink_bits"),
                sv["result"][rid], want[rid]) if a != b]
            print(f"  request {rid} differs in {fields}: rank "
                  f"{sv['result'][rid][1:]}, one device {want[rid][1:]}, "
                  f"first tokens {sv['result'][rid][0][:4]} against "
                  f"{want[rid][0][:4]}", flush=True)
    print(f"tp: logits control (worker 0's last MLP partial lost, one "
          f"device): {ctl_err:.4g} of max|logit|", flush=True)
    print(f"tp: {TP_RANKS} gloo ranks on cuda:0, spawn to join "
          f"{spawn_wall:.3f} s", flush=True)

    for r, o in enumerate(got):
        g = gaps[r]
        assert o["train"]["counts"] == train_want, \
            (r, o["train"]["counts"], train_want)
        assert g["first"] <= TP_LOSS_ATOL_FIRST, (r, g)
        assert max(g["loss"]) <= TP_LOSS_RTOL, (r, g)
        assert g["grad_norm"][0] <= TP_GRAD_NORM_RTOL, (r, g)
        # the limits' control: the fault must fail both
        assert g["control_grad_norm"][0] > TP_GRAD_NORM_RTOL, (r, g)
        assert max(g["control_loss"]) > TP_LOSS_RTOL, (r, g)
        sv = o["serve"]
        assert sv["ticks"] == one_ticks, (r, sv["ticks"], one_ticks)
        assert sv["counts"] == serve_want, (r, sv["counts"], serve_want)
        assert all(o["sites"].values()), (r, o["sites"])
    assert ctl_err > TP_LOGITS_RTOL, ctl_err
    if not same:
        broken = sorted({k for o in got for k, ok in o["products"].items()
                         if not ok})
        assert broken, "tokens differ although every split product is " \
            "bitwise the one-device product"
        assert max(errs) <= TP_LOGITS_RTOL, errs
        print(f"tp: the tokens or channel slots differ from the one-device "
              f"run; the products not bitwise on the card: {broken}; the "
              f"float32 logits within {TP_LOGITS_RTOL} of max|logit|",
              flush=True)
    else:
        print("tp: every rank's tokens, channel slots and uplink bits "
              "equal the one-device run's", flush=True)
    summed = {name: {k: sum(o[name]["counts"][k] for o in got)
                     for k in kernels.KERNELS} for name in ("train", "serve")}
    return dict(counts=summed, same_tokens=same, spawn_wall=spawn_wall,
                walls={name: [o[name]["wall"] for o in got]
                       for name in ("train", "serve")},
                bytes={"train": [o["train"]["bytes"] for o in got],
                       "logits": [o["logits_bytes"] for o in got]})


# ---------------------------------------------------------------------------
# the MoE, recurrent and encoder-decoder models over a (1 data x 2 model)
# mesh
# ---------------------------------------------------------------------------

TPM_TRAINED = (QWEN3, XLSTM, WHISPER)
TPM_SERVED = (QWEN3, XLSTM, JAMBA, WHISPER, PIXTRAL)


def _on(mesh):
    """The mesh context of a rank's run; none for the one-device run."""
    return (sharding.use_mesh(mesh) if mesh is not None
            else contextlib.nullcontext())


def _tpm_train_run(arch, dev, steps=None, moe_layers=TPM_MOE_LAYERS):
    """``launch/train``'s run of phase 35 for ``arch``: qwen3-moe cut to
    ``moe_layers``, xlstm to one period, whisper whole; fusion max,
    flash; every step logged, no checkpoints."""
    run = _without_remat(launch_train.setup(_tpm_train_args(arch, dev,
                                                            moe_layers)))
    run.tcfg = dataclasses.replace(run.tcfg, log_every=1, ckpt_dir=None,
                                   steps=steps or run.tcfg.steps)
    return run


def _tpm_train_args(arch, dev, moe_layers=TPM_MOE_LAYERS):
    """Phase 35's ``launch/train`` flags for ``arch``."""
    if arch == QWEN3:
        argv = ["--layers", str(moe_layers), "--steps",
                str(TPM_MOE_STEPS), "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ)]
    elif arch == XLSTM:
        argv = ["--layers", str(get_config(XLSTM).period), "--steps",
                str(TPM_XLSTM_STEPS), "--batch", str(TPM_XLSTM_BATCH),
                "--seq", str(TRAIN_SEQ)]
    else:
        argv = ["--steps", str(TPM_WHISPER_STEPS), "--batch",
                str(WHISPER_BATCH), "--seq", str(WHISPER_SEQ)]
    return launch_train.parse_args(
        ["--arch", arch, "--fusion", "max", "--use-flash", "--seed", "0",
         "--device", dev.type] + argv)


def _tpm_train(arch, dev, mesh, steps=None, moe_layers=TPM_MOE_LAYERS
               ) -> dict:
    """Phase 35's train steps of ``arch`` on one device (``mesh`` None) or
    on this rank's blocks of ``mesh``: losses, gradient norms (gathered),
    router aux, launches, wall, collective bytes."""
    run = _tpm_train_run(arch, dev, steps, moe_layers)
    shd, values = None, run.values
    if mesh is not None:
        axes = run.m.axes()
        shd = sharding.tree_shardings_for_values(axes, run.values, mesh)
        values = sharding.shard_values(run.values, axes, mesh)
    run.values = None
    _release(f"{arch} train values placed")
    with _on(mesh), comm.recording() as rec:
        res, counts, wall = _counted(lambda: trainer.train(
            run.m.loss, values, run.opt, run.data, run.tcfg,
            shardings=shd))
    out = dict(losses=[r["loss"] for r in res.history],
               grad_norms=[r["grad_norm"] for r in res.history],
               aux=[r.get("aux") for r in res.history], counts=counts,
               wall=wall, bytes=comm.summarize(rec),
               step_s=[r["step_time_s"] for r in res.history])
    del res, values, run
    _release(f"{arch} train done")
    return out


def _tpm_model(arch, dtype=torch.bfloat16):
    """Phase 35's serving model of ``arch`` (fusion max, flash); float32
    without flash for the logits readings."""
    if arch == QWEN3:
        cfg = get_config(QWEN3, n_layers=TPM_MOE_LAYERS)
    elif arch == XLSTM:
        cfg = get_config(XLSTM)
        cfg = cfg.with_(n_layers=cfg.period)
    elif arch == JAMBA:
        cfg = get_config(JAMBA)
        cfg = cfg.with_(n_layers=cfg.period, n_experts=JAMBA_EXPERTS)
    elif arch == PIXTRAL:
        cfg = get_config(PIXTRAL, n_layers=TPM_PIXTRAL_LAYERS)
    else:
        cfg = get_config(arch)
    cfg = cfg.with_(tp_fusion="max", use_flash=True, remat=False)
    if dtype != cfg.dtype:
        cfg = cfg.with_(dtype=dtype, param_dtype=dtype, use_flash=False)
    return M.build(cfg)


def _tpm_values(m, dev, mesh):
    """The seed-0 values on one device, or this rank's blocks of them:
    the ranks draw the whole tree one after another (two whole jamba
    periods do not fit the card beside each other), each keeping its
    blocks."""
    if mesh is None:
        return m.init(torch.Generator(device=dev).manual_seed(0))
    mine = None
    for r in range(comm.world_size()):
        if r == comm.rank():
            whole = m.init(torch.Generator(device=dev).manual_seed(0))
            mine = sharding.shard_values(whole, m.axes(), mesh)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return mine


def _tpm_requests(arch, vocab) -> list:
    """Phase 8's first 4 requests for qwen3-moe, its first 2 for xlstm,
    phase 27's 2 for jamba."""
    if arch == JAMBA:
        return poisson_requests(WIDE_REQUESTS, 1.0, vocab,
                                prompt_len=JAMBA_PROMPT,
                                max_new_tokens=WIDE_NEW, seed=0)
    reqs = poisson_requests(SERVE_REQUESTS, SERVE_RATE, vocab,
                            prompt_len=SERVE_PROMPT,
                            max_new_tokens=SERVE_NEW, seed=0)
    return reqs[:TP_REQUESTS if arch == QWEN3 else WIDE_REQUESTS]


def _tpm_engine(m, values, dev, reqs, fault=None) -> dict:
    """The engine under OCS p 0.05 (and ``fault``): every field of every
    completion, launches, wall, ticks."""
    slots = SERVE_SLOTS if m.cfg.name == QWEN3 else WIDE_REQUESTS
    max_seq = 2 * JAMBA_PROMPT if m.cfg.name == JAMBA else SERVE_MAX_SEQ
    eng = se.ServeEngine(m, values, se.ServeConfig(
        batch_slots=slots, max_seq=max_seq, eos_id=-1,
        protocol=_ocs(SERVE_P_MISS), fault=fault), device=dev)
    se.reset_dispatch_counts()
    outs, counts, wall = _counted(lambda: eng.run(reqs))
    return dict(result={rid: dataclasses.astuple(c)
                        for rid, c in sorted(outs.items())},
                counts=counts, wall=wall,
                ticks=se.dispatch_counts()["tick"])


def _tpm_frontend_batch(arch, dev, rows, dtype=torch.bfloat16) -> dict:
    """Whisper's frames and start-of-transcript prompt, or pixtral's
    patch features, from a seed."""
    cfg = get_config(arch)
    gen = torch.Generator(device="cpu").manual_seed(35)
    seq = WHISPER_FRAMES if arch == WHISPER else PIXTRAL_PATCHES
    batch = {"feats": torch.randn((WIDE_REQUESTS, seq, cfg.frontend_dim),
                                  generator=gen)[:rows].to(dtype).to(dev)}
    if arch == WHISPER:
        batch["tokens"] = torch.tensor([WHISPER_SOT] * rows,
                                       dtype=torch.int32, device=dev)
    return batch


def _tpm_model_api(m, values, dev) -> dict:
    """Whisper's or pixtral's 2 requests through ``prefill`` and
    ``TPM_NEW - 1`` greedy ``decode_step_channel`` ticks under OCS p 0.05:
    tokens, the channel accounting, launches, wall."""
    batch = _tpm_frontend_batch(m.cfg.name, dev, WIDE_REQUESTS)
    finite = {"ok": torch.ones((), dtype=torch.bool, device=dev)}
    (toks, _, _, chan), counts, wall = _counted(lambda: _greedy_ticks(
        m, values, batch, TPM_NEW - 1, _ocs(SERVE_P_MISS), 0, finite))
    assert bool(finite["ok"]), f"{m.cfg.name}: a logit is not finite"
    return dict(result=(toks.tolist(), chan), counts=counts, wall=wall,
                ticks=TPM_NEW - 1)


def _tpm_logits(arch, m, values, dev) -> torch.Tensor:
    """The float32 logits of a one-row prefill and of two greedy
    ``decode_step``s after it."""
    if arch in (WHISPER, PIXTRAL):
        batch = _tpm_frontend_batch(arch, dev, 1, torch.float32)
    else:
        prompt = _tpm_requests(arch, m.cfg.vocab_size)[0].prompt
        batch = {"tokens": torch.as_tensor(np.asarray(prompt, np.int32),
                                           device=dev)[None]}
    start = batch["tokens" if "tokens" in batch else "feats"].shape[1]
    logits, cache = m.prefill(values, batch, max_seq=start + 2)
    seq = [logits]
    pos = torch.full((1,), start, dtype=torch.int32, device=dev)
    for t in range(2):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        logits, cache = m.decode_step(values, tok, pos + t, cache)
        seq.append(logits)
    return torch.cat(seq).float().cpu()


def _tpm_mamba_grad(m, values, dev) -> dict:
    """jamba's reading of the backward: the loss of the first request's
    prompt against itself shifted, and the float32 norm of its gradient
    over the mamba layers' input-norm scales, which only the mamba
    mixer's input gradient reaches (replicated leaves, whole on every
    rank; the weight gradients of a 16 B-parameter period would not fit
    the card twice)."""
    prompt = _tpm_requests(JAMBA, m.cfg.vocab_size)[0].prompt
    tok = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    live = tree.map(lambda t: t, values)
    leaves = []
    for i, (mixer, _) in enumerate(m.cfg.layer_plan()):
        if mixer == "mamba":
            norm = live["blocks"][f"pos{i}"]["norm1"]
            norm["scale"] = norm["scale"].detach().requires_grad_(True)
            leaves.append(norm["scale"])
    with torch.enable_grad():
        loss = m.loss(live, batch)[0]
        grads = torch.autograd.grad(loss, leaves)
    norm = torch.sqrt(sum(torch.sum(g.float().square()) for g in grads))
    return dict(loss=float(loss.detach()), grad_norm=float(norm))


def _tpm_serve(arch, dev, mesh) -> dict:
    """Phase 35's serving of ``arch`` on one device or on this rank's
    blocks: the engine (qwen3-moe, xlstm and, under ``retry(2)``, xlstm
    again, jamba) or the model API (whisper, pixtral), with the collective
    bytes; jamba's gradient reading; the float32 logits (not jamba's: a
    float32 period is 65 GB)."""
    m = _tpm_model(arch)
    values = _tpm_values(m, dev, mesh)
    out = {}
    with _on(mesh), comm.recording() as rec:
        if arch in (WHISPER, PIXTRAL):
            out["serve"] = _tpm_model_api(m, values, dev)
        else:
            out["serve"] = _tpm_engine(
                m, values, dev, _tpm_requests(arch, m.cfg.vocab_size))
    out["serve"]["bytes"] = comm.summarize(rec)
    if arch == XLSTM:
        fm = faults.FaultModel.burst(policy=faults.DegradePolicy.retry(2),
                                     **SERVE_FAULT).with_dropout(
                                         *SERVE_DROPOUT)
        with _on(mesh):
            out["retry"] = _tpm_engine(
                m, values, dev, _tpm_requests(arch, m.cfg.vocab_size), fm)
    if arch == JAMBA:
        with _on(mesh):
            out["grad"] = _tpm_mamba_grad(m, values, dev)
            if mesh is not None:
                sound = mamba_mod.fusion
                mamba_mod.fusion = _FusionWithout(None)
                try:
                    out["control"] = _tpm_mamba_grad(m, values, dev)
                finally:
                    mamba_mod.fusion = sound
    del values
    _release(f"{arch} served")
    if arch != JAMBA:
        m32 = _tpm_model(arch, torch.float32)
        values = _tpm_values(m32, dev, mesh)
        with _on(mesh):
            out["logits"] = _tpm_logits(arch, m32, values, dev)
        del values
        _release(f"{arch} float32 logits")
    return out


# the probes of :func:`_tpm_products` that each model's serving runs
TPM_PROBES = {QWEN3: ("decode_attn qwen3-moe", "moe_experts"),
              XLSTM: ("mlstm_v",),
              JAMBA: ("decode_attn jamba", "mamba_in", "moe_experts"),
              WHISPER: ("decode_attn whisper", "whisper plain"),
              PIXTRAL: ("decode_attn pixtral",)}


def _tpm_products(dev, mesh) -> dict:
    """Whether each product phase 35 splits is, on this rank's block,
    bitwise the block of the one-device product in bf16: a tick's decode
    attention over the rank's heads (16 draws) at qwen3-moe's, jamba's,
    whisper's (self and cross) and pixtral's heads and cache lengths; the
    experts' products over 64 of 128 (a prefill's and a tick's slots);
    the workers' products over 8 of 16 (mamba's in-projection at a
    tick, the mLSTM value projection at a prefill); and whisper's "plain"
    out-projection, whose rank halves are added in bf16 by the
    all-reduce."""
    axis = sharding.mesh_axis(mesh, "model")
    gen = torch.Generator(device=dev).manual_seed(35)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    out = {}
    for name, arch, slots, seq in (
            ("qwen3-moe", QWEN3, SERVE_SLOTS, SERVE_MAX_SEQ),
            ("jamba", JAMBA, WIDE_REQUESTS, 2 * JAMBA_PROMPT),
            ("whisper self", WHISPER, WIDE_REQUESTS,
             len(WHISPER_SOT) + TPM_NEW),
            ("whisper cross", WHISPER, WIDE_REQUESTS, WHISPER_FRAMES),
            ("pixtral", PIXTRAL, WIDE_REQUESTS, PIXTRAL_PATCHES + TPM_NEW)):
        cfg = get_config(arch).with_(dtype=torch.bfloat16)
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        valid = torch.ones((slots, 1, seq), dtype=torch.bool, device=dev)
        same = True
        for _ in range(16):
            q = rnd(slots, 1, h, hd)
            k, v = (rnd(slots, seq, hkv, hd) for _ in range(2))
            whole = attention._sdpa(cfg, q, k, v, valid)
            got = attention._sdpa(cfg, sharding.split_dim(q, axis, 2).clone(),
                                  sharding.split_dim(k, axis, 2),
                                  sharding.split_dim(v, axis, 2), valid)
            same = same and _bitwise_equal(
                got, sharding.split_dim(whole, axis, 2))
        out[f"decode_attn {name}"] = same
    moe = get_config(QWEN3)
    for what, rows in (("tick", SERVE_SLOTS), ("prefill", SERVE_PROMPT)):
        cap = max(1, math.ceil(rows * moe.experts_per_token
                               / moe.n_experts * moe.capacity_factor))
        buf = rnd(moe.n_experts, cap, moe.d_model)
        w = rnd(moe.n_experts, moe.d_model, moe.moe_d_ff)
        out[f"moe_experts@{what}"] = _bitwise_equal(
            torch.bmm(sharding.split_dim(buf, axis),
                      sharding.split_dim(w, axis)),
            sharding.split_dim(torch.bmm(buf, w), axis))
    jb, xl = get_config(JAMBA), get_config(XLSTM)
    for name, rows, d, cols in (
            ("mamba_in@tick", WIDE_REQUESTS, jb.d_model,
             2 * jb.d_inner // jb.n_workers),
            ("mlstm_v@prefill", SERVE_PROMPT, xl.d_inner,
             xl.d_inner // xl.n_workers)):
        x, w = rnd(1, rows, d), rnd(QWEN_WORKERS, d, cols)
        out[name] = _bitwise_equal(
            torch.matmul(x, sharding.split_dim(w, axis)),
            sharding.split_dim(torch.matmul(x, w), axis))
    a, w = rnd(WIDE_REQUESTS, 8 * 64), rnd(8 * 64, WHISPER_D)
    halves = [torch.matmul(sharding.split_dim(a, ax, 1),
                           sharding.split_dim(w, ax, 0))
              for ax in (sharding.Axis("model", 2, i, None) for i in (0, 1))]
    out["whisper plain out-projection"] = _bitwise_equal(
        halves[0] + halves[1], torch.matmul(a, w))
    return out


class _FusionWithout:
    """``models.fusion`` whose ``copy_in`` leaves its first ``skip``
    tensors (all for ``None``) outside the model group's *f* copy: phase
    35's control faults of the mLSTM (q and k) and of mamba (its input)."""

    def __init__(self, skip):
        self.skip = skip

    def __getattr__(self, name):
        return getattr(fusion, name)

    def copy_in(self, axis, *tensors):
        k = len(tensors) if self.skip is None else self.skip
        return tensors[:k] + fusion.copy_in(axis, *tensors[k:])


def _qkv_kv_x_outside(cfg, p, x, kv_x, heads):
    """Phase 35's control fault of the cross-attention:
    ``attention._qkv`` with the encoder's output outside the *f* copy."""
    d = cfg.dtype
    x = heads.copy(x)
    kv_x = x if kv_x is None else kv_x
    q = attention._proj(x, p["wq"].to(d))
    k = attention._proj(kv_x, heads.copy(p["wk"]).to(d))
    v = attention._proj(kv_x, heads.copy(p["wv"]).to(d))
    if "bq" in p:
        q = q + p["bq"].to(d)
        k = k + heads.copy(p["bk"]).to(d)
        v = v + heads.copy(p["bv"]).to(d)
    return q, k, v


# each trained family's control fault: (owner, attribute, replacement)
TPM_CONTROLS = {
    QWEN3: (moe_mod._Slots, "copy", lambda self, x: x),
    XLSTM: (ssm_mod, "fusion", _FusionWithout(2)),
    WHISPER: (attention, "_qkv", _qkv_kv_x_outside)}


def _tpm_rank() -> dict:
    """Phase 35's task on each gloo rank: the trainers, their control
    faults (one step each) and the serving of every model on this rank's
    blocks of a (1 x ``TP_RANKS``) mesh.  The rank loads the library the
    parent built and builds nothing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    built = kernels.BUILD_DIR / f"libreprotorch_{kernels._source_hash()}.so"
    assert built.exists(), "the parent process did not build the kernels"
    kernels.library()
    return _tpm_rank_on(torch.device("cuda"))


def _tpm_rank_on(dev) -> dict:
    mesh = launch_mesh.make_mesh(1, TP_RANKS)
    out = {"coord": mesh.coord()}
    for arch in TPM_TRAINED:
        out[arch] = {"train": _tpm_train(arch, dev, mesh)}
        owner, attr, fault = TPM_CONTROLS[arch]
        sound = getattr(owner, attr)
        setattr(owner, attr, fault)
        try:
            ctl = _tpm_train(arch, dev, mesh, steps=1)
        finally:
            setattr(owner, attr, sound)
        out[arch]["control"] = {k: ctl[k] for k in ("losses", "grad_norms")}
    for arch in TPM_SERVED:
        out.setdefault(arch, {}).update(_tpm_serve(arch, dev, mesh))
    out["products"] = _tpm_products(dev, mesh)
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def _tpm_want(arch, what, ticks) -> dict:
    """The launches of phase 35's ``what`` (``train`` a run, ``serve``)
    on one device and on each rank: a rank runs every site of the model
    on its block (flash over its heads, ``maxpool.fwd`` over its
    workers, the channel kernels over the gathered stack)."""
    want = {k: 0 for k in kernels.KERNELS}
    if what == "train":
        steps = {QWEN3: TPM_MOE_STEPS, XLSTM: TPM_XLSTM_STEPS,
                 WHISPER: TPM_WHISPER_STEPS}[arch]
        sites = {QWEN3: TPM_MOE_LAYERS, XLSTM: 3,
                 WHISPER: 2 * WHISPER_LAYERS}[arch]
        flash = {QWEN3: TPM_MOE_LAYERS, XLSTM: 0,
                 WHISPER: 2 * WHISPER_LAYERS}[arch]
        want.update({"flash_attention.fwd": flash * steps,
                     "maxpool.fwd": sites * steps,
                     "maxpool.ties_bwd": sites * steps})
        return want
    reqs = {QWEN3: TP_REQUESTS}.get(arch, WIDE_REQUESTS)
    if arch == QWEN3:
        want.update({"flash_attention.fwd": TPM_MOE_LAYERS * reqs,
                     "maxpool.fwd": TPM_MOE_LAYERS * (reqs + ticks)})
    elif arch == XLSTM:
        want["maxpool.fwd"] = 3 * (reqs + ticks)
    elif arch == JAMBA:
        # 7 mamba sites and the attention's a tick, the 4 mlp sites too in
        # a prefill; the mlp sites' channel kernels a tick
        want.update({"flash_attention.fwd": reqs,
                     "maxpool.fwd": 12 * reqs + 8 * ticks,
                     "ocs_contention.noisy": 4 * ticks,
                     "maxpool.decode": 4 * ticks})
    elif arch == WHISPER:
        # one prefill of both rows: flash at the 6 encoder and 6 decoder
        # layers, the 12 mlp sites; a tick the 6 decoder mlp channel sites
        want.update({"flash_attention.fwd": 2 * WHISPER_LAYERS,
                     "maxpool.fwd": 2 * WHISPER_LAYERS,
                     "ocs_contention.noisy": WHISPER_LAYERS * ticks,
                     "maxpool.decode": WHISPER_LAYERS * ticks})
    else:
        # one prefill: flash and the attention and mlp sites a layer; a
        # tick the attention sites and the mlp channel sites
        want.update({"flash_attention.fwd": TPM_PIXTRAL_LAYERS,
                     "maxpool.fwd": TPM_PIXTRAL_LAYERS * (2 + ticks),
                     "ocs_contention.noisy": TPM_PIXTRAL_LAYERS * ticks,
                     "maxpool.decode": TPM_PIXTRAL_LAYERS * ticks})
    return want


def _tpm_loss_held(got: float, want: float) -> bool:
    """Phase 35's step-1 loss: within ``TP_LOSS_ATOL_FIRST`` of one
    device's, or within ``TP_LOSS_RTOL`` of it relative.  The random
    full-width tied embeddings give xlstm and whisper losses of 740 and
    390 (qwen3-moe's is 12), at which a split product that rounds otherwise
    (whisper's plain out-projection, added from two bf16 halves; GEMMs
    over half the columns) moves the loss by more than 1e-4: by 6.6e-6
    and 2.5e-5 of it, and jamba's bf16 reading by 7.8e-5 (NVIDIA H100
    80GB HBM3, 700 W; PERF.md §6)."""
    gap = abs(got - want)
    return gap <= TP_LOSS_ATOL_FIRST or gap <= TP_LOSS_RTOL * abs(want)


def _per(summary: dict, n: int) -> dict:
    return {k: {"calls": v["calls"] / n, "bytes": v["bytes"] / n}
            for k, v in summary.items()}


def run_tp_models_phase(dev) -> dict:
    """Phase 35: the MoE, recurrent and encoder-decoder models over a (1
    data x ``TP_RANKS`` model) mesh of gloo ranks sharing cuda:0, each
    against a one-device run of the same cut in this process (see the
    constants' comment): step 1's loss as :func:`_tpm_loss_held` and
    its gradient norm within ``TP_GRAD_NORM_RTOL`` relative (a control
    fault a family, one input outside the *f* copy, must fail the norm's
    limit; jamba's reading is the gradient of its mamba layers' norm
    scales), later losses within ``TP_LOSS_RTOL``; served tokens, slots
    and bits equal (retry ticks and degraded tokens too), or, as in
    phase 34, a split product of that model named not bitwise on the
    card (:func:`_tpm_products`); the float32 logits of a prefill and 2
    decode steps within ``TP_LOGITS_RTOL`` of their largest magnitude;
    launches a rank equal to one device's and to the model's sites.
    Every reading is printed before any is held to its limit."""
    _release("tp models phase start")
    one = {}
    for arch in TPM_TRAINED:
        one[arch] = {"train": _tpm_train(arch, dev, None)}
    for arch in TPM_SERVED:
        one.setdefault(arch, {}).update(_tpm_serve(arch, dev, None))
    _release("tp models phase spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        got = comm.spawn(_tpm_rank, TP_RANKS, workdir=work / "gloo",
                         timeout=TPM_TIMEOUT, threads=2)
        spawn_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert [o["coord"] for o in got] == [(0, r) for r in range(TP_RANKS)]

    checks = []          # (what, ok) held after every reading is printed
    for arch in TPM_TRAINED:
        want = one[arch]["train"]
        print(f"tpm {arch} one device: train {len(want['losses'])} steps in "
              f"{want['wall']:.3f} s wall, losses {want['losses']}, "
              f"gradient norms {want['grad_norms']}, aux {want['aux']}; "
              f"launches {want['counts']}", flush=True)
        checks.append((f"{arch} one-device train launches",
                       want["counts"] == _tpm_want(arch, "train", 0)))
        for r, o in enumerate(got):
            t, c = o[arch]["train"], o[arch]["control"]
            first = abs(t["losses"][0] - want["losses"][0])
            loss = _rel_gaps(t["losses"][1:], want["losses"][1:])
            gn = _rel_gaps(t["grad_norms"], want["grad_norms"])
            ctl = _rel_gaps(c["grad_norms"], want["grad_norms"][:1])[0]
            steps = len(t["losses"])
            print(f"tpm {arch} rank {r}/{TP_RANKS}: train {steps} steps in "
                  f"{t['wall']:.3f} s wall (step host times "
                  f"{[round(x, 4) for x in t['step_s']]}), losses "
                  f"{t['losses']} (step 1 {first:.4g} off, later relative "
                  f"gaps {loss}), gradient norms {t['grad_norms']} (relative "
                  f"gaps {gn}), aux {t['aux']}; launches {t['counts']}; "
                  f"collectives a step {_per(t['bytes'], steps)}; control "
                  f"(one input outside the f copy): step-1 gradient norm "
                  f"{c['grad_norms'][0]} ({ctl:.4g} off)", flush=True)
            checks += [
                (f"{arch} rank {r} train launches",
                 t["counts"] == want["counts"]),
                (f"{arch} rank {r} step-1 loss",
                 _tpm_loss_held(t["losses"][0], want["losses"][0])),
                (f"{arch} rank {r} later losses",
                 max(loss, default=0.0) <= TP_LOSS_RTOL),
                (f"{arch} rank {r} step-1 gradient norm",
                 gn[0] <= TP_GRAD_NORM_RTOL),
                (f"{arch} rank {r} control fails the norm's limit",
                 ctl > TP_GRAD_NORM_RTOL)]
    same = {}
    for arch in TPM_SERVED:
        want = one[arch]
        kinds = ("serve", "retry") if arch == XLSTM else ("serve",)
        for kind in kinds:
            w = want[kind]
            print(f"tpm {arch} one device ({kind}): {w['ticks']} ticks in "
                  f"{w['wall']:.3f} s wall, launches {w['counts']}; result "
                  f"{str(w['result'])[:300]}", flush=True)
            checks.append((f"{arch} one-device {kind} launches",
                           w["counts"] == _tpm_want(arch, "serve",
                                                    w["ticks"])))
            if kind == "retry":
                checks.append((f"{arch} retry ticks were driven", any(
                    c[-1] > 0 for c in w["result"].values())))
            for r, o in enumerate(got):
                g = o[arch][kind]
                equal = g["result"] == w["result"]
                same[(arch, kind, r)] = equal
                bytes_ = _per(g["bytes"], g["ticks"]) if "bytes" in g else {}
                print(f"tpm {arch} rank {r}/{TP_RANKS} ({kind}): "
                      f"{g['ticks']} ticks in {g['wall']:.3f} s wall, "
                      f"launches {g['counts']}; collectives a tick "
                      f"(prefills included) {bytes_}; equal to the "
                      f"one-device run: {equal}", flush=True)
                if not equal:
                    print(f"  rank {str(g['result'])[:300]}", flush=True)
                checks.append((f"{arch} rank {r} {kind} launches",
                               g["counts"] == w["counts"]
                               and g["ticks"] == w["ticks"]))
        if "logits" in want:
            errs = [_logits_rel_err(o[arch]["logits"], want["logits"])
                    for o in got]
            print(f"tpm {arch}: float32 prefill and 2 decode steps' logits "
                  f"{[f'{e:.4g}' for e in errs]} of max|logit| "
                  f"{float(want['logits'].abs().max()):.4g}", flush=True)
            checks += [(f"{arch} rank {r} logits", e <= TP_LOGITS_RTOL)
                       for r, e in enumerate(errs)]
        if "grad" in want:
            gw = want["grad"]
            for r, o in enumerate(got):
                gap = _rel_gaps([o[arch]["grad"]["grad_norm"]],
                                [gw["grad_norm"]])[0]
                ctl = _rel_gaps([o[arch]["control"]["grad_norm"]],
                                [gw["grad_norm"]])[0]
                print(f"tpm {arch} rank {r}/{TP_RANKS}: the mamba layers' "
                      f"norm scales' gradient norm {o[arch]['grad']} against "
                      f"one "
                      f"device's {gw} ({gap:.4g} off); control (mamba's "
                      f"input outside the f copy) {o[arch]['control']} "
                      f"({ctl:.4g} off)", flush=True)
                checks += [
                    (f"{arch} rank {r} loss",
                     _tpm_loss_held(o[arch]["grad"]["loss"], gw["loss"])),
                    (f"{arch} rank {r} gradient norm",
                     gap <= TP_GRAD_NORM_RTOL),
                    (f"{arch} rank {r} control fails the norm's limit",
                     ctl > TP_GRAD_NORM_RTOL)]
    broken = sorted({k for o in got for k, ok in o["products"].items()
                     if not ok})
    print(f"tpm: {TP_RANKS} gloo ranks on cuda:0, spawn to join "
          f"{spawn_wall:.3f} s; peak device memory by rank "
          f"{[o['peak'] for o in got]} bytes; split products not bitwise "
          f"the one-device block on the card: {broken}", flush=True)
    differ = sorted({k[:2] for k, ok in same.items() if not ok})
    for arch, kind in differ:
        # phase 34's branch: a served result may part from the one-device
        # run only where a split product of that model rounds otherwise,
        # with its float32 logits held
        named = [k for k in broken if any(k.startswith(p)
                                          for p in TPM_PROBES[arch])]
        print(f"tpm: {arch} ({kind}) served otherwise than the one-device "
              f"run; its split products not bitwise: {named}", flush=True)
        checks.append((f"{arch} {kind}: a split product of it rounds "
                       f"otherwise", bool(named)))
    failed = [what for what, ok in checks if not ok]
    assert not failed, failed
    print(f"tpm: every limit held ({len(checks)} checks)", flush=True)
    summed = {what: {k: 0 for k in kernels.KERNELS}
              for what in ("train", "serve")}
    for o in got:
        for arch, kind in ([(a, "train") for a in TPM_TRAINED]
                           + [(a, k) for a in TPM_SERVED
                              for k in ("serve", "retry") if k in o[a]]):
            for k, v in o[arch][kind]["counts"].items():
                summed["train" if kind == "train" else "serve"][k] += v
    return dict(counts=summed, spawn_wall=spawn_wall,
                walls={arch: {kind: [o[arch][kind]["wall"] for o in got]
                              for kind in ("train", "serve", "retry")
                              if kind in got[0][arch]}
                       for arch in dict.fromkeys(TPM_TRAINED + TPM_SERVED)},
                bytes={arch: [o[arch]["train"]["bytes"] for o in got]
                       for arch in TPM_TRAINED})


# ---------------------------------------------------------------------------
# phase 36: the dry-run held to the card
# ---------------------------------------------------------------------------

# a reduced config's cells, traced on fake CUDA and fake CPU tensors on a
# fake (2 x 4) mesh
DRY_ARCH, DRY_MESH = "glm4-9b", (2, 4)
DRY_SHAPES = (ShapeConfig("t", "train", 16, 8),
              ShapeConfig("p", "prefill", 32, 4),
              ShapeConfig("d", "decode", 32, 8))
# production cells traced at full size on the (16, 16) mesh
DRY_CELLS = ((QWEN, "train_4k"), (QWEN3, "train_4k"))
DRY_DEVICE = "cuda"     # the device of the fake tensors the card is held to
# the caching allocator rounds a request up to 512 bytes, and may hand a
# request of more than 1 MiB a block up to 1 MiB larger (a remainder it
# does not split off)
ALLOC_ROUND, ALLOC_SPLIT = 512, 2**20


def _dry_trace(cfg, shape, mesh_shape, device, rules=None, inputs=None):
    """:func:`dryrun.trace` of ``cfg``'s step at ``shape`` on rank 0 of a
    fake ``(data, model)`` world, ``rules`` by default ``rules_for``'s."""
    data, model = mesh_shape
    with dryrun.fake_world(data * model):
        mesh = launch_mesh.make_mesh(data, model)
        if rules is None:
            rules = launch_mesh.rules_for(shape.name, shape.global_batch,
                                          mesh)
        return dryrun.trace(dryrun.build_step, cfg, shape, mesh, rules, 1,
                            device, inputs)


def _dry_job(job):
    """One fake trace of phase 36, in a pool worker: ``("cell", arch,
    shape_name, device)`` -> ``run_cell``'s record, or ``("trace", cfg,
    shape, mesh_shape, device, rules, inputs)`` -> its counts."""
    if job[0] == "cell":
        _, arch, shape_name, device = job
        return dryrun.run_cell(arch, shape_name, False, device=device,
                               extrapolate=False)
    got = _dry_trace(*job[1:])
    return {k: got[k] for k in ("flops", "hbm_bytes", "records", "peak",
                                "argument_bytes_by_device", "trace_s")}


def _summed(*summaries, times: int = 1) -> dict:
    """``comm.summarize`` records added, and repeated ``times``."""
    out: dict = {}
    for summ in summaries:
        for k, v in summ.items():
            cur = out.setdefault(k, {"calls": 0, "bytes": 0})
            cur["calls"] += v["calls"] * times
            cur["bytes"] += v["bytes"] * times
    return dict(sorted(out.items()))


def _launch_step(args):
    """The config (``remat=False``, as :func:`_without_remat`), the first
    batch (on the CPU) and a train step's ``ShapeConfig`` of
    ``launch/train``'s flags ``args``."""
    cfg = launch_train.config(args).with_(remat=False)
    batch = pipeline.batch_for_step(launch_train.data_config(args, cfg), 0,
                                    device=torch.device("cpu"))
    rows, seq = tree.leaves(batch)[0].shape[:2]
    return cfg, batch, ShapeConfig("launch", "train", seq, rows)


def _dry_jobs() -> dict:
    """Every fake trace of phase 36, by name: (a) the reduced cells on
    both devices and the production cells; (b) phase 34's step and
    float32 prefill + 2 decode steps and phase 35's trained cuts on a
    (1 x ``TP_RANKS``) mesh (``use_mesh(mesh)``'s default rules, as
    there); (c) phase 18's step on one device."""
    cpu, dev = torch.device("cpu"), DRY_DEVICE
    rules = sharding.DEFAULT_RULES
    mesh = (1, TP_RANKS)
    cfg = get_reduced(DRY_ARCH, n_workers=4, tp_fusion="max", use_flash=True)
    jobs = {("reduced", shape.kind, d): ("trace", cfg, shape, DRY_MESH, d,
                                         None, None)
            for shape in DRY_SHAPES for d in ("cpu", dev)}
    jobs.update({("cell", arch): ("cell", arch, name, dev)
                 for arch, name in DRY_CELLS})
    runs = {QWEN: (_tp_train_args(cpu), TP_STEPS)}
    for arch in TPM_TRAINED:
        args = _tpm_train_args(arch, cpu)
        runs[arch] = (args, args.steps)
    for arch, (args, steps) in runs.items():
        cfg, batch, shape = _launch_step(args)
        jobs[("rank", arch, steps)] = ("trace", cfg, shape, mesh, dev,
                                       rules, batch)
    cfg32 = get_config(QWEN, use_flash=True, tp_fusion="max").with_(
        dtype=torch.float32, param_dtype=torch.float32)
    jobs[("logits", "prefill")] = (
        "trace", cfg32, ShapeConfig("p", "prefill", SERVE_PROMPT, 1), mesh,
        dev, rules, None)
    jobs[("logits", "decode")] = (
        "trace", cfg32, ShapeConfig("d", "decode", SERVE_PROMPT + 2, 1),
        mesh, dev, rules, None)
    cfg, batch, shape = _launch_step(_tp_train_args(cpu))
    jobs[("memory",)] = ("trace", cfg, shape, (1, 1), dev, rules, batch)
    return jobs


def _dry_ranks(done, tp, tpm, checks) -> None:
    """36(b): the fake (1 x ``TP_RANKS``) rank's collectives against what
    each gloo rank recorded in phases 34-35."""
    recorded = {QWEN: tp["bytes"]["train"], **tpm["bytes"]}
    for key, got in done.items():
        if key[0] != "rank":
            continue
        _, arch, steps = key
        want = _summed(comm.summarize(got["records"]), times=steps)
        for r, real in enumerate(recorded[arch]):
            print(f"dry-run (1 x {TP_RANKS}) {arch} train step x {steps}: "
                  f"fake {want}; gloo rank {r} recorded {real}", flush=True)
            checks.append((f"{arch} train collectives rank {r}",
                           _summed(real) == want))
    once = comm.summarize(done[("logits", "decode")]["records"])
    want = _summed(comm.summarize(done[("logits", "prefill")]["records"]),
                   once, once)
    for r, real in enumerate(tp["bytes"]["logits"]):
        print(f"dry-run (1 x {TP_RANKS}) {QWEN} float32 prefill + 2 decode "
              f"steps: fake {want}; gloo rank {r} recorded {real}",
              flush=True)
        checks.append((f"logits collectives rank {r}", _summed(real) == want))


def _dry_memory_on_card(dev) -> dict:
    """36(c), the card's side: phase 18's 8 x 256 AdamW step's arguments
    (values, AdamW state, batch) made with nothing else allocated, the
    bytes they take (requested and allocated), then 3 steps: the peak
    above the arguments' start, each step's stream ms (CUDA events, the
    host's gaps included) and one step's device busy ms (profiler)."""
    cfg, batch, _ = _launch_step(_tp_train_args(dev))
    _release("dry-run memory reading")

    def stats():
        st = torch.cuda.memory_stats()
        return (st["requested_bytes.all.current"],
                st["allocated_bytes.all.current"])

    base = stats()
    m = M.build(cfg)
    values = m.init(torch.Generator(device=dev).manual_seed(0))
    opt = optimizers.adamw(schedules.constant(1e-4))
    state = opt.init(values)
    batch = tree.map(lambda t: t.to(dev), batch)
    sizes = [t.numel() * t.element_size()
             for t in tree.leaves((values, state, batch)) if t.is_cuda]
    requested, allocated = (a - b for a, b in zip(stats(), base))
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(m.loss, opt)
    ms = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        values, state, _ = step(values, state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() - base[1]
    busy_s, _ = _busy(lambda: step(values, state, batch))
    del values, state, batch
    _release("dry-run memory reading done")
    return dict(requested=requested, allocated=allocated, sizes=sizes,
                peak=peak, stream_ms=ms, busy_ms=1e3 * busy_s)


def _dry_memory(fake, card, checks) -> dict:
    """36(c): the dry-run's argument bytes and peak against the card's."""
    fake_args = fake["argument_bytes_by_device"]["cuda"]
    fake_peak = fake["peak"]["cuda"]["Total"]
    terms = hlo_analysis.roofline_terms(fake["flops"], fake["hbm_bytes"], 0)
    slack = sum(-n % ALLOC_ROUND + (ALLOC_SPLIT if n > ALLOC_SPLIT else 0)
                for n in card["sizes"])
    out = dict(fake_args=fake_args, requested=card["requested"],
               allocated=card["allocated"], tensors=len(card["sizes"]),
               fake_peak=fake_peak, real_peak=card["peak"],
               peak_ratio=fake_peak / card["peak"],
               stream_ms=card["stream_ms"], busy_ms=card["busy_ms"],
               t_compute_ms=1e3 * terms["t_compute_s"],
               t_memory_ms=1e3 * terms["t_memory_s"])
    print(f"dry-run memory, {QWEN} {TRAIN_BATCH} x {TRAIN_SEQ} AdamW step: "
          f"argument bytes fake {fake_args} / requested "
          f"{card['requested']} / memory_allocated {card['allocated']} "
          f"({out['tensors']} tensors on the card; the allocator's rounding "
          f"allows {slack} above the requests); peak fake {fake_peak} / "
          f"max_memory_allocated {card['peak']} (ratio "
          f"{out['peak_ratio']:.4f}); t_compute {out['t_compute_ms']:.3f} "
          f"ms, t_memory {out['t_memory_ms']:.3f} ms (H100 SXM peaks) beside "
          f"a step's device busy {card['busy_ms']:.3f} ms and stream ms "
          f"{card['stream_ms']}", flush=True)
    checks.append(("argument bytes requested", card["requested"] == fake_args))
    checks.append(("argument bytes allocated",
                   0 <= card["allocated"] - fake_args <= slack))
    return out


def submit_dry_jobs(pool) -> dict:
    """Phase 36's fake traces (:func:`_dry_jobs`), submitted to the
    background pool, the longest first (the xlstm rank's time loops, then
    the production cells); their futures by name."""
    jobs = _dry_jobs()
    order = sorted(jobs, key=lambda k: (k[:2] != ("rank", XLSTM),
                                        k[0] != "cell"))
    return {key: pool.submit(_dry_job, jobs[key]) for key in order}


def run_dryrun_phase(dev, tp, tpm, pending) -> dict:
    """Phase 36: the dry-run held to the card (see the module doc).  The
    fake traces (``pending``, :func:`submit_dry_jobs`' futures) run in
    the background pool's processes, each a fake world of its own,
    destroyed as its trace ends, while the earlier phases use the card;
    this process measures phase 18's step on the card.  Every reading is
    printed before any is held to its limit."""
    checks = []
    card = _dry_memory_on_card(dev)
    t0 = time.perf_counter()
    done = {key: f.result() for key, f in pending.items()}
    print(f"dry-run: waited {time.perf_counter() - t0:.3f} s for the fake "
          "traces of the background pool", flush=True)
    out = {"cells": {}, "trace_s": {str(k): round(v["trace_s"], 1)
                                    for k, v in done.items()
                                    if "trace_s" in v}}
    for shape in DRY_SHAPES:
        got = {d: done[("reduced", shape.kind, d)]
               for d in ("cpu", DRY_DEVICE)}
        summ = {d: comm.summarize(g["records"]) for d, g in got.items()}
        print(f"dry-run reduced {DRY_ARCH} {shape.kind} on a fake "
              f"{DRY_MESH} mesh, fake {DRY_DEVICE} / fake cpu: flops "
              f"{got[DRY_DEVICE]['flops']} / {got['cpu']['flops']}, hbm "
              f"bytes {got[DRY_DEVICE]['hbm_bytes']} / "
              f"{got['cpu']['hbm_bytes']}, collectives {summ[DRY_DEVICE]} / "
              f"{summ['cpu']}", flush=True)
        checks.append((f"{shape.kind} fake {DRY_DEVICE} == fake cpu",
                       got[DRY_DEVICE]["flops"] == got["cpu"]["flops"]
                       and got[DRY_DEVICE]["records"]
                       == got["cpu"]["records"]))
    for arch, shape_name in DRY_CELLS:
        rec = done[("cell", arch)]
        path = ROOT / "chiprun_out" / f"dryrun_{arch}__{shape_name}.json"
        path.parent.mkdir(exist_ok=True)
        path.write_text(json.dumps(rec, indent=1))
        keep = ("status", "error", "trace", "lower_s", "fsdp",
                "flops_per_dev", "hbm_bytes_per_dev", "roofline",
                "useful_flops_ratio")
        brief = {k: rec[k] for k in keep if k in rec}
        if rec["status"] == "ok":
            brief["collectives"] = {k: rec["collectives"][k] for k in (
                "counts", "payload_bytes", "link_bytes_per_dev")}
            brief["memory"] = {k: rec["memory"][k] for k in (
                "argument_size_in_bytes", "peak_bytes")}
        out["cells"][arch] = brief
        print(f"dry-run production cell {arch} {shape_name} (16 x 16, fake "
              f"{DRY_DEVICE}): {json.dumps(brief)}", flush=True)
        checks.append((f"{arch} {shape_name} record", rec["status"] == "ok"))
    _dry_ranks(done, tp, tpm, checks)
    out["memory"] = _dry_memory(done[("memory",)], card, checks)
    print(f"dry-run trace seconds by job (background pool of "
          f"{BACKGROUND_WORKERS}): {out['trace_s']}", flush=True)
    failed = [what for what, ok in checks if not ok]
    assert not failed, failed
    return out


ANALYSIS_JSON = "chiprun_out/analysis_cuda.json"
REMAT_POLICIES = ("full", "dots")
EXAMPLE_RUNS = {
    "quickstart": ["--steps", "3"],
    "patch_classification": ["--steps", "3", "--method", "all"],
    "reconstruction": ["--steps", "3"],
    "train_curves": ["--steps", "3"],
    "scenario_sweep": ["--rounds", "1"],
    "lm_train": ["--steps", "3"],
    "serve_demo": ["--train-steps", "3", "--requests", "4", "--max-new",
                   "4"],
}
# the kernels the examples reach: the max laws (quickstart, lm_train), the
# channel (train_curves, serve_demo, scenario_sweep, patch_classification)
# and the sweep's clean core's encode
EXAMPLE_KERNELS = ("ocs_quant.encode", "maxpool.fwd", "maxpool.decode",
                   "maxpool.winner_bwd", "maxpool.ties_bwd",
                   "ocs_contention.noisy")


def _remat_want(remat: bool, steps: int = 1) -> dict:
    """Phase 18's launches a step, where ``remat`` adds the recompute of
    each period's forward: flash and ``maxpool.fwd`` twice, ``ties_bwd``
    (backward only) once."""
    fwd = 2 if remat else 1
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"flash_attention.fwd": fwd * QWEN_LAYERS * steps,
                 "maxpool.fwd": fwd * 2 * QWEN_LAYERS * steps,
                 "maxpool.ties_bwd": 2 * QWEN_LAYERS * steps})
    return want


def _remat_steps(dev) -> dict:
    """Phase 18's 8 x 256 step (loss and gradients) with and without
    remat: bitwise, each one's launches exactly :func:`_remat_want`'s,
    and each one's peak and device ms."""
    from repro_torch.train.train_step import value_and_grad
    cfg0, batch, _ = _launch_step(_tp_train_args(dev))
    batch = tree.map(lambda t: t.to(dev), batch)
    out, first = {}, None
    for remat, policy in ((False, "full"),) + tuple(
            (True, p) for p in REMAT_POLICIES):
        cfg = cfg0.with_(remat=remat, remat_policy=policy)
        m = M.build(cfg)
        values = m.init(torch.Generator(device=dev).manual_seed(0))
        _release(f"remat={remat} {policy}")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        loss, _, grads = value_and_grad(m.loss, values, batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        busy_s, _ = _busy(lambda: value_and_grad(m.loss, values, batch))
        key = f"remat={remat} {policy}" if remat else "remat=False"
        if first is None:
            first = (loss, grads)
            same = True
        else:
            same = torch.equal(loss, first[0]) and all(
                torch.equal(a, b) for a, b in zip(tree.leaves(grads),
                                                  tree.leaves(first[1])))
        out[key] = dict(loss=float(loss), peak_bytes=peak,
                        device_ms=1e3 * busy_s, bitwise=same,
                        counts=counts,
                        counts_held=counts == _remat_want(remat))
        print(f"remat: {key}: loss {float(loss)!r}, peak above the values "
              f"{peak} bytes ({peak / 2**30:.3f} GiB), device "
              f"{1e3 * busy_s:.3f} ms, bitwise remat=False: {same}; "
              f"launches {counts}", flush=True)
        del values, grads, loss
    del first
    _release("remat done")
    return out


def _remat_trainer(dev, phase18) -> dict:
    """``launch/train``'s default config for phase 18's flags (remat on,
    as every full-width config) cut to ``TP_STEPS`` steps of phase 18's
    schedule: its losses and gradient norms bitwise phase 18's (no remat)
    and its launches exactly :func:`_remat_want`'s."""
    run = launch_train.setup(_tp_train_args(dev))
    assert run.cfg.remat and run.cfg.remat_policy == "full", run.cfg
    run.tcfg = dataclasses.replace(run.tcfg, steps=TP_STEPS, log_every=1,
                                   ckpt_dir=None)
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = _counted(lambda: launch_train.launch(run))
    peak = torch.cuda.max_memory_allocated()
    del run
    losses = [r["loss"] for r in res.history]
    grad_norms = [r["grad_norm"] for r in res.history]
    del res
    _release("remat trainer done")
    out = dict(counts=counts, wall=wall, peak=peak, losses=losses,
               grad_norms=grad_norms,
               counts_held=counts == _remat_want(True, TP_STEPS),
               bitwise=(losses == phase18["losses"][:TP_STEPS]
                        and grad_norms == phase18["grad_norms"][:TP_STEPS]))
    print(f"remat trainer ({QWEN} default config, remat full): {TP_STEPS} "
          f"steps in {wall:.3f} s wall; losses {losses}, gradient norms "
          f"{grad_norms}, bitwise phase 18's: {out['bitwise']}; peak device "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB); launches {counts}",
          flush=True)
    return out


def run_analysis_phase(dev, phase18) -> dict:
    """Phase 37: the port's analysis on the card (see the module doc)."""
    from repro_torch.analysis import registry as an_registry
    from repro_torch.analysis.contracts import stream_differences
    from repro_torch.analysis.__main__ import main as analysis_main
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    info = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = analysis_main(["--root", str(ROOT), "--device", "cuda", "--json",
                        str(ROOT / ANALYSIS_JSON)], info=info)
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    for name, got in info.items():
        print(f"analysis {name}: {got['findings']} findings, "
              f"{got['stream_ops']} ops in the fake-CUDA stream "
              f"({got['copies']} copies), custom ops {got['custom_ops']}, "
              f"launches {got['launches']}, real run sync-free under "
              f"set_sync_debug_mode('error'): {got['sync_free']}",
              flush=True)
    print(f"analysis: exit {rc} in {wall:.3f} s; launches {counts}",
          flush=True)
    checks = [("exit 0", rc == 0)]
    for c in an_registry.CONTRACTS:
        got = info[c.name]
        cpu, cuda = an_registry.trace_entry(c, "cpu"), got["trace"]
        diff = stream_differences(cpu.stream, cuda.stream,
                                  an_registry.DEVICE_BRANCHES)
        agree = cpu.error is None and cuda.error is None and not diff
        if diff:
            print(f"analysis {c.name}: the streams part at {diff[:3]}",
                  flush=True)
        held = {an_registry.CUSTOM_OPS[k] for k in c.kernels} <= {
            op.name for op in cuda.stream}
        launched = all((got["launches"] or {}).get(k, 0) > 0
                       for k in c.kernels)
        print(f"analysis {c.name}: fake-CPU {len(cpu.stream)} ops, "
              f"fake-CUDA {len(cuda.stream)} ops, agree {agree}, custom "
              f"ops held {held}, kernels launched {launched}", flush=True)
        checks += [(f"{c.name} streams agree", agree),
                   (f"{c.name} custom ops", held),
                   (f"{c.name} launched", launched),
                   (f"{c.name} runs sync-free", got["sync_free"] is True)]
        del got["trace"]
    remat = _remat_steps(dev)
    trainer_run = _remat_trainer(dev, phase18)
    # the remat path's launches: each step's counted call and the trainer
    # (the device-ms windows are timing, as a kernel's comparison is)
    remat_counts = {k: trainer_run["counts"][k] + sum(
        r["counts"][k] for r in remat.values()) for k in kernels.KERNELS}
    checks += [(f"{k} bitwise", r["bitwise"]) for k, r in remat.items()]
    checks += [(f"{k} launches", r["counts_held"]) for k, r in remat.items()]
    checks += [("remat trainer bitwise phase 18", trainer_run["bitwise"]),
               ("remat trainer launches", trainer_run["counts_held"])]
    failed = [what for what, ok in checks if not ok]
    assert not failed, failed
    for k in ("ocs_contention.noisy", "maxpool.decode",
              "maxpool.winner_bwd"):
        assert counts[k] > 0, (k, counts)
    return dict(counts=counts, remat_counts=remat_counts, remat=remat,
                trainer=trainer_run, info=info, wall=wall)


def run_examples_phase(dev) -> dict:
    """Phase 38: each example's ``main`` on the card at a shortened
    count; its lines are printed by the example, its wall seconds here."""
    import importlib
    walls = {}
    kernels.reset_launch_counts()
    ckpt = ROOT / "build" / "examples_ckpt"
    for name, argv in EXAMPLE_RUNS.items():
        argv = argv + ["--device", dev.type]
        if name == "lm_train":
            shutil.rmtree(ckpt, ignore_errors=True)
            argv += ["--ckpt-dir", str(ckpt)]
        print(f"== example {name} {' '.join(argv)}", flush=True)
        t0 = time.perf_counter()
        importlib.import_module(f"repro_torch.examples.{name}").main(argv)
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t0, 3)
        print(f"== example {name}: {walls[name]} s", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    counts = kernels.launch_counts()
    missing = [k for k in EXAMPLE_KERNELS if counts[k] == 0]
    assert not missing, (missing, counts)
    print(f"examples wall seconds {walls}; launches {counts}", flush=True)
    _release("examples done")
    return dict(counts=counts, walls=walls)


# ---------------------------------------------------------------------------
# split placements of state over a (2 data x 1 model) mesh
# ---------------------------------------------------------------------------

def _split_requests(vocab, new: int) -> list:
    """Phase 8's first request (a 256-token prompt) for ``new`` tokens: a
    prefill's token and ``new - 1`` ticks."""
    req = poisson_requests(1, SERVE_RATE, vocab, prompt_len=SERVE_PROMPT,
                           max_new_tokens=new, seed=0)[0]
    return [se.Request(rid=0, prompt=req.prompt, max_new_tokens=new)]


def _split_serve(m, values, dev, reqs, slots, max_seq) -> dict:
    """The engine under OCS p 0.05 on ``reqs``: {rid: (tokens, channel
    slots, uplink bits)}, launches, wall, ticks, the bytes of its cache
    (this rank's block under a mesh) and the collectives by op a tick."""
    eng = se.ServeEngine(m, values, se.ServeConfig(
        batch_slots=slots, max_seq=max_seq, eos_id=-1,
        protocol=_ocs(SERVE_P_MISS)), device=dev)
    se.reset_dispatch_counts()
    with comm.recording() as rec:
        outs, counts, wall = _counted(lambda: eng.run(reqs))
    ticks = se.dispatch_counts()["tick"]
    cache = sum(t.numel() * t.element_size() for t in tree.leaves(eng.cache))
    del eng
    return dict(result={rid: (c.tokens, c.channel_slots, c.uplink_bits)
                        for rid, c in sorted(outs.items())},
                counts=counts, wall=wall, ticks=ticks, cache_bytes=cache,
                bytes=_per(comm.summarize(rec), ticks))


def _split_logits(m, values, prompts, dev, max_seq, steps) -> torch.Tensor:
    """The float32 prefill's last logits of ``prompts`` (rows) and those
    of ``steps`` greedy ``decode_step``s after it."""
    tokens = torch.as_tensor(np.stack(prompts).astype(np.int32), device=dev)
    logits, cache = m.prefill(values, {"tokens": tokens}, max_seq=max_seq)
    seq = [logits]
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                     device=dev)
    for t in range(steps):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        logits, cache = m.decode_step(values, tok, pos + t, cache)
        seq.append(logits)
    return torch.stack(seq).float().cpu()


def _split_want(requests: int, ticks: int) -> dict:
    """A rank's launches serving ``requests`` prefills and ``ticks`` ticks
    of qwen1.5 whole (phase 34's rule on one device)."""
    want = {k: 0 for k in kernels.KERNELS}
    want.update({
        "flash_attention.fwd": QWEN_LAYERS * requests,
        "maxpool.fwd": 2 * QWEN_LAYERS * requests + QWEN_LAYERS * ticks,
        "ocs_contention.noisy": QWEN_LAYERS * ticks,
        "maxpool.decode": QWEN_LAYERS * ticks})
    return want


def _split_denominators(x, seq):
    """39(a)'s control fault: rank 1 keeps its own block's softmax
    denominators (the collective still runs, so the ranks stay in step)."""
    total = comm.all_reduce(x, "sum", seq.group)
    return x if seq.index == 1 else total


def _split_products(dev, mesh, rules) -> dict:
    """Whether the products each split changes are, on this rank, bitwise
    the one-device product, by split (``"kv_seq"``, ``"rows"``): a tick's
    attention over this rank's block of a 512-position cache combined
    over the ``kv_seq`` group (the split softmax) against the whole
    cache's; and over this rank's rows of a tick's slots against the
    whole product's rows, the q projection, the MLP's up and down
    projections over the workers, the attention out-projection's worker
    partials, the unembedding and the tick's attention (16 draws each
    attention)."""
    gen = torch.Generator(device=dev).manual_seed(39)
    cfg = get_config(QWEN)
    d, n, f, hd = QWEN_D, QWEN_WORKERS, 2816, QWEN_D // QWEN_HEADS

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    out = {"kv_seq": {}, "rows": {}}
    with sharding.use_mesh(mesh, rules):
        seq, offset = sharding.kv_seq_block(SPLIT_CACHE // SPLIT_RANKS)
        same = True
        for _ in range(16):
            q = rnd(1, 1, QWEN_HEADS, hd, dtype=cfg.dtype)
            k, v = (rnd(1, SPLIT_CACHE, QWEN_HEADS, hd, dtype=cfg.dtype)
                    for _ in range(2))
            valid = (torch.arange(SPLIT_CACHE, device=dev)[None, :]
                     <= SERVE_PROMPT + 3)[:, None, :]
            whole = attention._sdpa(cfg, q, k, v, valid)
            mine = slice(offset, offset + SPLIT_CACHE // SPLIT_RANKS)
            got = attention._sdpa(cfg, q, k[:, mine], v[:, mine],
                                  valid[..., mine], seq)
            same = same and _bitwise_equal(got, whole)
        out["kv_seq"]["split_softmax@tick"] = same
    rows = sharding.mesh_axis(mesh, "data")
    b = SERVE_SLOTS
    x = rnd(1, b, d)
    cases = {"q_proj": (x[0], rnd(d, d), 0),
             "mlp_up": (x, rnd(n, d, f // n), 1),
             "mlp_down": (rnd(n, b, f // n), rnd(n, f // n, d), 1),
             "attn_out": (rnd(n, b, d // n), rnd(n, d // n, d), 1),
             "unembed": (x[0], rnd(151936, d).T, 0)}
    for name, (a, w, dim) in cases.items():
        whole = torch.matmul(a, w)
        got = torch.matmul(sharding.split_dim(a, rows, dim), w)
        out["rows"][f"{name}@tick"] = _bitwise_equal(
            got, sharding.split_dim(whole, rows, dim))
    pos = torch.arange(b, device=dev) + SERVE_PROMPT
    valid = (torch.arange(SERVE_MAX_SEQ, device=dev)[None, :]
             <= pos[:, None])[:, None, :]
    same = True
    for _ in range(16):
        q = rnd(b, 1, QWEN_HEADS, hd, dtype=cfg.dtype)
        k, v = (rnd(b, SERVE_MAX_SEQ, QWEN_HEADS, hd, dtype=cfg.dtype)
                for _ in range(2))
        whole = attention._sdpa(cfg, q, k, v, valid)
        got = attention._sdpa(cfg, *(sharding.split_dim(t, rows)
                                     for t in (q, k, v, valid)))
        same = same and _bitwise_equal(got, sharding.split_dim(whole, rows))
    out["rows"]["decode_attn@tick"] = same
    return out


def _tick_rows_probe(m, values, dev, mesh) -> bool:
    """Whether a decode step over this rank's rows of the slots, on one
    device, is bitwise the rows' block of the step over all of them (the
    bf16 model, the slots' prompts prefilled, one greedy step)."""
    rows = sharding.mesh_axis(mesh, "data")
    reqs = poisson_requests(SERVE_REQUESTS, SERVE_RATE, m.cfg.vocab_size,
                            prompt_len=SERVE_PROMPT, max_new_tokens=1,
                            seed=0)[:SERVE_SLOTS]
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]).astype(
        np.int32), device=dev)

    def step(t):
        logits, cache = m.prefill(values, {"tokens": t},
                                  max_seq=SERVE_PROMPT + 1)
        pos = torch.full((t.shape[0],), SERVE_PROMPT, dtype=torch.int32,
                         device=dev)
        return m.decode_step(values, logits.argmax(-1)[:, None].to(
            torch.int32), pos, cache)[0]

    return _bitwise_equal(step(sharding.split_dim(tokens, rows)),
                          sharding.split_dim(step(tokens), rows))


def _split_cache_rank(dev, mesh) -> dict:
    """39(a) and (b) on this rank: the kv_seq split under the long-context
    rules (the boundary and long runs, the float32 logits and their
    control), then the rows split under the default rules (phase 34's
    traffic, the float32 logits of two rows)."""
    rules = launch_mesh.rules_for("long_500k", 1, mesh)
    out = {}
    m, whole = _tp_serve_model(dev)
    values = sharding.shard_values(whole, m.axes(), mesh, rules)
    del whole
    with sharding.use_mesh(mesh, rules):
        out["boundary"] = _split_serve(
            m, values, dev, _split_requests(m.cfg.vocab_size,
                                            SPLIT_TICKS + 1), 1,
            SPLIT_CACHE)
        out["long"] = _split_serve(
            m, values, dev, _split_requests(m.cfg.vocab_size,
                                            SPLIT_LONG_TICKS + 1), 1,
            SPLIT_LONG_CACHE)
    _release("split cache kv_seq runs done")
    with sharding.use_mesh(mesh):
        reqs = poisson_requests(SERVE_REQUESTS, SERVE_RATE,
                                m.cfg.vocab_size, prompt_len=SERVE_PROMPT,
                                max_new_tokens=SERVE_NEW,
                                seed=0)[:TP_REQUESTS]
        out["rows"] = _split_serve(m, values, dev, reqs, SERVE_SLOTS,
                                   SERVE_MAX_SEQ)
    out["tick_rows"] = _tick_rows_probe(m, values, dev, mesh)
    del values
    _release("split cache rows run done")
    m32, whole = _tp_serve_model(dev, torch.float32)
    values = sharding.shard_values(whole, m32.axes(), mesh, rules)
    del whole
    prompt = [_split_requests(m32.cfg.vocab_size, 1)[0].prompt]
    with sharding.use_mesh(mesh, rules), comm.recording() as rec:
        out["logits"] = _split_logits(m32, values, prompt, dev, SPLIT_CACHE,
                                      SPLIT_LOGIT_STEPS)
    out["logits_bytes"] = comm.summarize(rec)
    sound = attention._seq_sum
    attention._seq_sum = _split_denominators
    try:
        with sharding.use_mesh(mesh, rules):
            out["control"] = _split_logits(m32, values, prompt, dev,
                                           SPLIT_CACHE, SPLIT_LOGIT_STEPS)
    finally:
        attention._seq_sum = sound
    with sharding.use_mesh(mesh):
        out["rows_logits"] = _split_logits(
            m32, values, [r.prompt for r in reqs[:SPLIT_RANKS]], dev,
            SERVE_MAX_SEQ, 2)
    del values
    out["products"] = _split_products(dev, mesh, rules)
    out["products"]["rows"]["decode_step@tick"] = out.pop("tick_rows")
    _release("split cache logits done")
    return out


def _zero_run(dev, ckpt_dir, steps):
    """Phase 18's run (its batches and schedule, ``remat=False``) for
    ``steps`` steps, every step logged, its checkpoint in ``ckpt_dir``
    (none but the final carry)."""
    run = _tp_train_run(dev)
    run.tcfg = dataclasses.replace(run.tcfg, steps=steps,
                                   ckpt_dir=str(ckpt_dir),
                                   ckpt_every=TRAIN_CKPT_EVERY)
    return run


def _zero_rank(dev, mesh, ckpt_dir) -> dict:
    """39(c) on this rank: phase 18's trainer with AdamW's master weights
    and moments split over the data axis (ZeRO), every rank taking the
    whole batch (``ZERO_RULES``), to its step-2 checkpoint; then
    relaunched from it to step 3."""
    out = {}
    for steps in (ZERO_CKPT_STEP, TP_STEPS):
        run = _zero_run(dev, ckpt_dir, steps)
        pl = sharding.placement(run.m.axes(), run.values, mesh, ZERO_RULES)
        values = sharding.shard_values(run.values, pl.axes, mesh, ZERO_RULES)
        run.values = None
        with sharding.use_mesh(mesh, ZERO_RULES), comm.recording() as rec:
            res, counts, wall = _counted(lambda: trainer.train(
                run.m.loss, values, run.opt, run.data, run.tcfg,
                shardings=pl))
        state = res.opt_state
        out[steps] = dict(
            rows=_rows(res.history), counts=counts, wall=wall,
            bytes=comm.summarize(rec),
            state_bytes=sum(t.numel() * t.element_size() for k in
                            ("master", "m", "v")
                            for t in tree.leaves(state[k])))
        del res, state, values, run
        _release(f"zero run to step {steps} done")
    return out


def _split_rank(ckpt_dir) -> dict:
    """Phase 39's task on each gloo rank (a (2 x 1) mesh): 39(a)-(c).  The
    rank loads the library the parent built and builds nothing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    built = kernels.BUILD_DIR / f"libreprotorch_{kernels._source_hash()}.so"
    assert built.exists(), "the parent process did not build the kernels"
    kernels.library()
    return _split_rank_on(torch.device("cuda"), ckpt_dir)


def _split_rank_on(dev, ckpt_dir) -> dict:
    mesh = launch_mesh.make_mesh(SPLIT_RANKS, 1)
    out = {"coord": mesh.coord()}
    out.update(_split_cache_rank(dev, mesh))
    out["zero"] = _zero_rank(dev, mesh, ckpt_dir)
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def _zero_continued(dev, ckpt_dir, phase18) -> dict:
    """39(c) on one device: the ZeRO run's step-2 checkpoint restored with
    no mesh and trained one step (phase 18's third), against phase 18's
    third step and the ranks' step-3 checkpoint, bitwise."""
    run = _tp_train_run(dev)
    template = {"values": run.values, "opt": run.opt.init(run.values)}
    carry, step, _ = checkpointer.restore(str(ckpt_dir), ZERO_CKPT_STEP,
                                          template=template)
    del template
    run.values = None
    _release("zero checkpoint restored on one device")
    values, opt, metrics = make_train_step(run.m.loss, run.opt)(
        carry["values"], carry["opt"], run.data(step))
    got = dict(loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]))
    final, _, _ = checkpointer.restore(str(ckpt_dir), TP_STEPS,
                                       template={"values": values,
                                                 "opt": opt})
    got["same_carry"] = (_same_tree(values, final["values"])
                         and _same_tree(opt, final["opt"]))
    got["want"] = dict(loss=phase18["losses"][ZERO_CKPT_STEP],
                       grad_norm=phase18["grad_norms"][ZERO_CKPT_STEP])
    del carry, values, opt, final, run
    _release("zero continuation done")
    return got


def run_split_phase(dev, phase18) -> dict:
    """Phase 39: split placements of state over a (``SPLIT_RANKS`` data x
    1 model) mesh of gloo ranks sharing cuda:0, against one-device runs in
    this process (see the module doc).  Every reading is printed before
    any is held to its limit."""
    _release("split phase start")
    m, values = _tp_serve_model(dev)
    one = {}
    for name, new, max_seq in (("boundary", SPLIT_TICKS + 1, SPLIT_CACHE),
                               ("long", SPLIT_LONG_TICKS + 1,
                                SPLIT_LONG_CACHE)):
        one[name] = _split_serve(m, values, dev,
                                 _split_requests(m.cfg.vocab_size, new), 1,
                                 max_seq)
        _release(f"split one-device {name} run done")
    reqs = poisson_requests(SERVE_REQUESTS, SERVE_RATE, m.cfg.vocab_size,
                            prompt_len=SERVE_PROMPT, max_new_tokens=SERVE_NEW,
                            seed=0)[:TP_REQUESTS]
    one["rows"] = _split_serve(m, values, dev, reqs, SERVE_SLOTS,
                               SERVE_MAX_SEQ)
    del values
    m32, values = _tp_serve_model(dev, torch.float32)
    prompt = [_split_requests(m32.cfg.vocab_size, 1)[0].prompt]
    rows_prompts = [r.prompt for r in reqs[:SPLIT_RANKS]]
    one_logits = _split_logits(m32, values, prompt, dev, SPLIT_CACHE,
                               SPLIT_LOGIT_STEPS)
    one_rows = _split_logits(m32, values, rows_prompts, dev, SERVE_MAX_SEQ,
                             2)
    ctl_rows = _split_logits(m32, _lost_partial(values), rows_prompts, dev,
                             SERVE_MAX_SEQ, 2)
    del values
    _release("split phase spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    ckpt_dir = work / "zero_ckpt"
    try:
        t0 = time.perf_counter()
        got = comm.spawn(_split_rank, SPLIT_RANKS, (str(ckpt_dir),),
                         workdir=work / "gloo", timeout=SPLIT_TIMEOUT,
                         threads=2)
        spawn_wall = time.perf_counter() - t0
        ckpt_gib = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                       if f.is_file()) / 2**30
        cont = _zero_continued(dev, ckpt_dir, phase18)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert [o["coord"] for o in got] == [(r, 0) for r in range(SPLIT_RANKS)]

    checks, same = [], {}
    for name in ("boundary", "long", "rows"):
        w = one[name]
        print(f"split one device: {name} {w['wall']:.3f} s wall, "
              f"{w['ticks']} ticks ({1e3 * w['wall'] / w['ticks']:.3f} ms a "
              f"tick, prefills included), cache {w['cache_bytes']} bytes, "
              f"launches {w['counts']}", flush=True)
        same[name] = all(o[name]["result"] == w["result"] for o in got)
    errs = [_logits_rel_err(o["logits"], one_logits) for o in got]
    ctl_errs = [_logits_rel_err(o["control"], one_logits) for o in got]
    row_errs = [_logits_rel_err(o["rows_logits"], one_rows) for o in got]
    ctl_row = _logits_rel_err(ctl_rows, one_rows)
    for r, o in enumerate(got):
        for name in ("boundary", "long", "rows"):
            g, w = o[name], one[name]
            differ = [rid for rid in w["result"]
                      if g["result"].get(rid) != w["result"][rid]]
            print(f"split rank {r}/{SPLIT_RANKS} {name}: {g['wall']:.3f} s "
                  f"wall, {g['ticks']} ticks "
                  f"({1e3 * g['wall'] / g['ticks']:.3f} ms a tick, prefills "
                  f"included), cache {g['cache_bytes']} bytes "
                  f"({g['cache_bytes'] / w['cache_bytes']:.4f} of one "
                  f"device's), launches {g['counts']}, collectives a tick "
                  f"{g['bytes']}; requests differing from the one-device "
                  f"run {differ}", flush=True)
            for rid in differ[:2]:
                print(f"  request {rid}: rank {g['result'][rid][1:]} first "
                      f"tokens {g['result'][rid][0][:6]}, one device "
                      f"{w['result'][rid][1:]} {w['result'][rid][0][:6]}",
                      flush=True)
        print(f"split rank {r}/{SPLIT_RANKS}: float32 logits of a prefill "
              f"and {SPLIT_LOGIT_STEPS} decode steps over the kv_seq split "
              f"{errs[r]:.4g} of max|logit| "
              f"{float(one_logits.abs().max()):.4g} (collectives "
              f"{o['logits_bytes']}); control (rank 1's denominators "
              f"unreduced) {ctl_errs[r]:.4g}; two rows over the rows split "
              f"{row_errs[r]:.4g}; products bitwise the one-device product "
              f"{o['products']}; peak device memory {o['peak']} bytes",
              flush=True)
        z = o["zero"]
        rows = z[ZERO_CKPT_STEP]["rows"] + z[TP_STEPS]["rows"]
        print(f"split rank {r}/{SPLIT_RANKS} zero: steps "
              f"{[x['step'] for x in rows]} losses "
              f"{[x['loss'] for x in rows]} against phase 18's "
              f"{phase18['losses'][:TP_STEPS]}, gradient norms "
              f"{[x['grad_norm'] for x in rows]} against "
              f"{phase18['grad_norms'][:TP_STEPS]}; master/m/v bytes a rank "
              f"{z[TP_STEPS]['state_bytes']} (one device "
              f"{12 * QWEN_PARAMS}); walls {z[ZERO_CKPT_STEP]['wall']:.3f} "
              f"s to the checkpoint, {z[TP_STEPS]['wall']:.3f} s relaunched "
              f"(checkpoints included); launches "
              f"{z[ZERO_CKPT_STEP]['counts']} / {z[TP_STEPS]['counts']}; "
              f"collectives {z[ZERO_CKPT_STEP]['bytes']} / "
              f"{z[TP_STEPS]['bytes']}", flush=True)
    print(f"split: rows logits control (worker 0's last MLP partial lost, "
          f"one device) {ctl_row:.4g}; zero checkpoint {ckpt_gib:.2f} GiB "
          f"on disk (steps {ZERO_CKPT_STEP} and {TP_STEPS}); restored on "
          f"one device, step {ZERO_CKPT_STEP + 1}: loss {cont['loss']} / "
          f"gradient norm {cont['grad_norm']} against phase 18's "
          f"{cont['want']}, carry bitwise the ranks' step-{TP_STEPS} "
          f"checkpoint {cont['same_carry']}; {SPLIT_RANKS} gloo ranks on "
          f"cuda:0, spawn to join {spawn_wall:.3f} s", flush=True)

    want_rows = _rows_of(phase18, TP_STEPS)
    for r, o in enumerate(got):
        for name, reqs_n in (("boundary", 1), ("long", 1),
                             ("rows", TP_REQUESTS)):
            g, w = o[name], one[name]
            checks += [
                (f"rank {r} {name} ticks", g["ticks"] == w["ticks"]),
                (f"rank {r} {name} launches",
                 g["counts"] == _split_want(reqs_n, g["ticks"])),
                (f"rank {r} {name} cache bytes",
                 g["cache_bytes"] * SPLIT_RANKS == w["cache_bytes"])]
        z = o["zero"]
        rows = z[ZERO_CKPT_STEP]["rows"] + z[TP_STEPS]["rows"]
        train_want = {k: 0 for k in kernels.KERNELS}
        for steps, key in ((ZERO_CKPT_STEP, ZERO_CKPT_STEP),
                           (TP_STEPS - ZERO_CKPT_STEP, TP_STEPS)):
            train_want.update({
                "flash_attention.fwd": QWEN_LAYERS * steps,
                "maxpool.fwd": 2 * QWEN_LAYERS * steps,
                "maxpool.ties_bwd": 2 * QWEN_LAYERS * steps})
            checks.append((f"rank {r} zero launches to step {key}",
                           z[key]["counts"] == train_want))
        checks += [
            (f"rank {r} logits", errs[r] <= TP_LOGITS_RTOL),
            (f"rank {r} logits control", ctl_errs[r] > TP_LOGITS_RTOL),
            (f"rank {r} rows logits", row_errs[r] <= TP_LOGITS_RTOL),
            (f"rank {r} zero bitwise phase 18",
             [(x["step"], x["loss"], x["grad_norm"]) for x in rows]
             == want_rows),
            (f"rank {r} zero state halved",
             z[TP_STEPS]["state_bytes"] * SPLIT_RANKS == 12 * QWEN_PARAMS)]
    checks += [("rows logits control", ctl_row > TP_LOGITS_RTOL),
               ("zero restored on one device",
                cont["loss"] == cont["want"]["loss"]
                and cont["grad_norm"] == cont["want"]["grad_norm"]
                and cont["same_carry"])]
    for name, ok in same.items():
        if ok:
            print(f"split: {name}: every rank's tokens, channel slots and "
                  f"uplink bits equal the one-device run's", flush=True)
            continue
        split = "rows" if name == "rows" else "kv_seq"
        broken = sorted({k for o in got
                         for k, v in o["products"][split].items() if not v})
        print(f"split: {name}: the tokens or channel slots differ from "
              f"the one-device run; the {split} split's products not "
              f"bitwise on the card: {broken}", flush=True)
        checks.append((f"{name} differs with a split product named",
                       bool(broken)))
    failed = [what for what, ok in checks if not ok]
    assert not failed, failed
    summed = {name: {k: sum(o[name]["counts"][k] for o in got)
                     for k in kernels.KERNELS}
              for name in ("boundary", "long", "rows")}
    summed["zero"] = {k: sum(o["zero"][s]["counts"][k] for o in got
                             for s in (ZERO_CKPT_STEP, TP_STEPS))
                      for k in kernels.KERNELS}
    return dict(counts=summed, same=same, spawn_wall=spawn_wall,
                walls={name: [o[name]["wall"] for o in got]
                       for name in ("boundary", "long", "rows")},
                one_walls={name: one[name]["wall"] for name in one},
                ticks={name: one[name]["ticks"] for name in one},
                cache_bytes={name: [o[name]["cache_bytes"] for o in got]
                             for name in ("boundary", "long", "rows")},
                zero_walls=[[o["zero"][s]["wall"]
                             for s in (ZERO_CKPT_STEP, TP_STEPS)]
                            for o in got])


def _rows_of(phase18, steps) -> list:
    """(step, loss, gradient norm) of phase 18's first ``steps`` steps."""
    return [(i, phase18["losses"][i], phase18["grad_norms"][i])
            for i in range(steps)]


def _timed(fn, *args):
    """Call one phase; keep its wall seconds for the closing summary."""
    t0 = time.perf_counter()
    out = fn(*args)
    _PHASE_SECONDS[fn.__name__] = round(time.perf_counter() - t0, 3)
    print(f"phase {fn.__name__}: {_PHASE_SECONDS[fn.__name__]} s",
          flush=True)
    return out


# the background pool: phase 16's CPU reference and phase 36's fake
# traces need no card, so they run in these processes while the card's
# phases do
BACKGROUND_WORKERS = 2


@contextlib.contextmanager
def _background():
    """A pool of ``BACKGROUND_WORKERS`` processes (``spawn``), shut down on
    exit; where a phase failed, its workers are killed."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        BACKGROUND_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    ok = False
    try:
        yield pool
        ok = True
    finally:
        procs = list((pool._processes or {}).values())
        pool.shutdown(wait=ok, cancel_futures=True)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


@contextlib.contextmanager
def _contenders(n: int):
    """``n`` processes that spin on the host's CPUs until the context ends
    (``--contend``)."""
    procs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
             for _ in range(n)]
    try:
        yield
    finally:
        for p in procs:
            p.kill()
            p.wait()


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--contend", type=int, default=0,
                        help="processes spinning on the CPUs beside the run")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with _contenders(args.contend), _background() as pool:
        if args.contend:
            print(f"beside {args.contend} processes spinning on the "
                  f"host's {os.cpu_count()} CPUs", flush=True)
        return _main(pool)


def _main(pool) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    print(f"SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz (max): INT32 rate "
          f"{INT32_LANES * SM_CLOCK_HZ:.4g} operations/s", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    kernels.library()
    print(f"kernels built and loaded in {kernels.build_seconds:.2f} s",
          flush=True)

    rows = _timed(check_kernels, dev)
    cpu_ref = pool.submit(cpu_sweeps)
    dry_jobs = submit_dry_jobs(pool)
    _timed(check_p0_equivalence, dev)
    curve_counts, wall, curves = _timed(run_main_path, dev)
    _timed(check_against_cpu, dev)
    _timed(profile_main_path, dev)
    serve = _timed(run_serving, dev)
    _timed(check_serving_p0, dev, serve)
    _timed(check_serving_against_cpu, dev)
    _timed(profile_serving, dev, serve)
    sched = _timed(run_scheduled, dev, curves)
    sched_profile = _timed(profile_scheduled, dev)
    fault = _timed(run_fault_curves_phase, dev, curves)
    fault_profile = _timed(profile_fault_curves, dev)
    faulty = _timed(run_faulty_serving, dev, serve)
    faulty_profile = _timed(profile_faulty_serving, dev, serve)
    _timed(check_new_paths_against_cpu, dev)
    swept = _timed(run_sweep_phase, dev, cpu_ref)
    dp = _timed(run_dp_phase, dev)
    dp_profile = _timed(profile_dp, dev)
    train = _timed(run_train_phase, dev)
    train_profile = _timed(profile_train, dev)
    hook = _timed(run_hook_phase, dev)
    _timed(check_sampling_against_cpu, dev)
    moe_train = _timed(run_moe_train_phase, dev)
    moe_serve = _timed(run_moe_serving, dev)
    wide = _timed(run_wide_configs, dev)
    _timed(check_moe_against_cpu, dev)
    xlstm_train = _timed(run_xlstm_train_phase, dev)
    xlstm_serve = _timed(run_xlstm_serving, dev)
    jamba = _timed(run_jamba_serving, dev)
    _timed(check_recurrent_against_cpu, dev)
    whisper_train = _timed(run_whisper_train_phase, dev)
    whisper_serve = _timed(run_whisper_serving, dev,
                           whisper_train.pop("values"))
    pixtral = _timed(run_pixtral_phase, dev)
    _timed(check_encdec_against_cpu, dev)
    ranks = _timed(run_ranks_phase, dev, curves, swept, dp)
    tp = _timed(run_tp_phase, dev, train)
    tpm = _timed(run_tp_models_phase, dev)
    dry = _timed(run_dryrun_phase, dev, tp, tpm, dry_jobs)
    analysis = _timed(run_analysis_phase, dev, train)
    examples = _timed(run_examples_phase, dev)
    split = _timed(run_split_phase, dev, train)

    line = []
    keep = ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "ms_source")
    flash_keep = keep + ("max_row_rel_err", "kv_heads")
    for name in kernels.KERNELS:
        # the curves' kernels timed at the main path's first depth (bits=8),
        # with their serving-shape timing beside; flash at the prefill shape;
        # the tie-routed backward at the LM train site, its only path; a
        # kernel's other forms (off the main paths) under "forms"
        if name == "flash_attention.fwd":
            rec = dict(rows[(name, "serve")])
            rec["moe"] = {at: {k: r[k] for k in flash_keep}
                          for at, r in rows[(name, "moe")].items()}
            rec["jamba"] = {k: rows[(name, "jamba")][k] for k in flash_keep}
            rec["encdec"] = {at: {k: r[k] for k in flash_keep + ("causal",)}
                             for at, r in rows[(name, "encdec")].items()}
        elif name == "maxpool.ties_bwd":
            rec = dict(rows[(name, "train")])
            rec["moe"] = {k: rows[(name, "moe")][k] for k in keep}
            rec["xlstm"] = {k: rows[(name, "xlstm")][k]
                            for k in keep + ("l2",)}
            for site in ("whisper", "pixtral"):
                rec[site] = {k: rows[(name, site)][k] for k in keep
                             + ("l2",) if k in rows[(name, site)]}
        else:
            rec = dict(rows[(name, 8)])
            srv = rows.get((name, "serve"))
            if srv is not None:
                rec["serve"] = {k: srv[k] for k in keep + ("dtype",)}
            swp = rows.get((name, "sweep"))
            if swp is not None:
                rec["sweep"] = {k: swp[k] for k in keep + ("bits",)}
            trn = rows.get((name, "train"))
            if trn is not None:
                rec["train"] = {k: trn[k] for k in keep + ("dtype",
                                                           "outputs")}
                win = rows[(name + "[winner]", "train")]
                rec["train"]["winner_form"] = {k: win[k] for k in keep}
            for site in ("moe", "xlstm", "jamba", "whisper", "pixtral",
                         "whisper tick", "pixtral tick"):
                r = rows.get((name, site))
                if r is not None:
                    rec[site] = {k: r[k] for k in keep + ("dtype", "outputs",
                                                          "l2") if k in r}
            forms = {case[len(name) + 1:-1]: {
                "curves": {k: r[k] for k in keep},
                "serve": {k: rows[(case, "serve")][k] for k in keep}}
                for (case, at), r in rows.items()
                if at == 8 and case.startswith(name + "[")}
            if forms:
                rec["forms"] = forms
        by_path = {"run_curves": curve_counts[name],
                   "serve": serve["counts"][name],
                   "scheduled_curves": sched["counts"][name],
                   "fault_curves": sum(fault[k]["counts"][name]
                                       for k in ("stale", "zero_fill")),
                   "faulty_serve": sum(faulty[k]["counts"][name]
                                       for k in ("retry", "stale")),
                   "sweep": swept["counts"][name],
                   "dp_curves": dp["counts"][name],
                   "train": train["counts"][name],
                   "serve_restored": train["serve_counts"][name],
                   "train_channel": hook["counts"][name],
                   "moe_train": moe_train["counts"][name],
                   "moe_serve": moe_serve["counts"][name],
                   "wide_configs": wide["counts"][name],
                   "xlstm_train": xlstm_train["counts"][name],
                   "xlstm_serve": xlstm_serve["ocs"]["counts"][name],
                   "xlstm_faulty_serve": xlstm_serve["retry"]["counts"][name],
                   "jamba_serve": jamba["counts"][name],
                   "whisper_train": whisper_train["counts"][name],
                   "whisper_serve": whisper_serve["counts"][name],
                   "pixtral_serve": pixtral["counts"][name],
                   "pixtral_train": pixtral["train_counts"][name],
                   "ranks_nccl_curves": ranks["nccl_counts"][name],
                   "ranks_curves": ranks["counts"]["curves"][name],
                   "ranks_sweep": ranks["counts"]["sweep"][name],
                   "ranks_dp": ranks["counts"]["dp"][name],
                   "tp_train": tp["counts"]["train"][name],
                   "tp_serve": tp["counts"]["serve"][name],
                   "tp_models_train": tpm["counts"]["train"][name],
                   "tp_models_serve": tpm["counts"]["serve"][name],
                   "analysis": analysis["counts"][name],
                   "remat": analysis["remat_counts"][name],
                   "examples": examples["counts"][name],
                   "split_cache_serve": sum(
                       split["counts"][k][name]
                       for k in ("boundary", "long", "rows")),
                   "zero_train": split["counts"]["zero"][name]}
        line.append(dict(rec, launches=sum(by_path.values()),
                         launches_by_path=by_path))
    print(f"run_curves wall seconds: {wall}", flush=True)
    print(f"serve wall seconds: {serve['wall']} ({serve['ticks']} ticks, "
          f"{serve['tokens']} tokens); {smi}", flush=True)
    print(f"scheduled curves wall seconds: {sched['wall']} adaptive "
          f"({sched['switches']} depth switches), {sched['fixed_wall']} "
          f"FixedBits(8); 10-step profile {sched_profile}", flush=True)
    print("fault curves wall seconds: " + ", ".join(
        f"{k} {v['wall']}" for k, v in fault.items())
        + f"; 10-step profile {fault_profile}", flush=True)
    print(f"faulty decode tick profile {faulty_profile}", flush=True)
    print(f"sweep wall seconds: {swept['wall']} full grid on the card "
          f"({swept['cpu_wall']} on the CPU), {swept['bench_wall']} "
          f"bench_comm sweeps; dp curves wall seconds: {dp['wall']}; "
          f"10-step profile {dp_profile}; {smi}", flush=True)
    print("faulty serve: " + "; ".join(
        f"{k} {v['wall']} s, {v['ticks']} ticks, {v['outage']} outage, "
        f"{v['held']} held, {v['degraded']} degraded tokens, "
        f"{v['retry_ticks']} retry ticks" for k, v in faulty.items()),
        flush=True)
    print(f"train wall seconds: {train['wall']} ({TRAIN_STEPS} steps, "
          f"checkpoints included), {train['resumed_wall']} relaunched; peak "
          f"device memory {train['peak']} bytes; 5-step profile "
          f"{train_profile}; serving from the checkpoint "
          f"{train['serve_wall']} s; channel hook {hook['wall']} s, "
          f"profile {hook['profile']}; {smi}",
          flush=True)
    moe_prof = {k: moe_train[k] for k in ("wall_ms", "device_ms", "idle",
                                          "kernels", "adamw_ms")}
    print(f"MoE ({QWEN3}, full width, {MOE_LAYERS} layers): train "
          f"{moe_train['wall']} s for {MOE_STEPS} steps, profile "
          f"{moe_prof}, peak device memory {moe_train['peak']} bytes; serve "
          f"{moe_serve['wall']} s ({moe_serve['ticks']} ticks, "
          f"{moe_serve['tokens']} tokens), decode tick profile "
          f"{moe_serve['profile']}; one-layer configs serve walls "
          f"{wide['walls']}; {smi}", flush=True)
    xlstm_prof = {k: xlstm_train[k] for k in ("wall_ms", "device_ms",
                                              "idle", "kernels")}
    print(f"recurrent ({XLSTM}, full width and depth): train "
          f"{xlstm_train['wall']} s for {XLSTM_STEPS} steps of {XLSTM_BATCH} "
          f"x {TRAIN_SEQ} tokens, profile {xlstm_prof}, peak device memory "
          f"{xlstm_train['peak']} bytes; serve {xlstm_serve['ocs']['wall']} "
          f"s ({xlstm_serve['ocs']['ticks']} ticks), under retry(2) "
          f"{xlstm_serve['retry']['wall']} s ({xlstm_serve['retry']['ticks']}"
          f" ticks, {xlstm_serve['retry']['retry_ticks']} retry ticks), "
          f"decode tick profile {xlstm_serve['profile']}, serving peak "
          f"device memory {xlstm_serve['peak']} bytes; {JAMBA} one period "
          f"({jamba['params']} parameters) serve {jamba['wall']} s, decode "
          f"tick profile {jamba['profile']}, peak device memory "
          f"{jamba['peak']} bytes; {smi}", flush=True)
    whisper_prof = {k: whisper_train[k] for k in ("wall_ms", "device_ms",
                                                  "idle", "kernels")}
    print(f"encoder-decoder ({WHISPER}, full width and depth): train "
          f"{whisper_train['wall']} s for {WHISPER_STEPS} steps of "
          f"{WHISPER_BATCH} x {WHISPER_SEQ}, profile {whisper_prof}, peak "
          f"device memory {whisper_train['peak']} bytes; serve "
          f"{whisper_serve['wall']} s ({whisper_serve['ticks']} ticks, "
          f"{whisper_serve['tick_ms']} ms a tick, prefill "
          f"{whisper_serve['prefill_s']} s), decode tick profile "
          f"{whisper_serve['profile']}; {PIXTRAL} ({pixtral['params']} "
          f"parameters) serve {pixtral['wall']} s ({pixtral['tick_ms']} ms a "
          f"tick, prefill {pixtral['prefill_s']} s), decode tick profile "
          f"{pixtral['profile']}, init peak {pixtral['init_peak']} bytes "
          f"({pixtral['init_base']} allocated before it), "
          f"serving peak {pixtral['serve_peak']} bytes; train "
          f"{PIXTRAL_TRAIN_LAYERS} layers ({pixtral['train_params']} "
          f"parameters) {pixtral['train_wall']} s for "
          f"{PIXTRAL_TRAIN_STEPS} steps, peak {pixtral['train_peak']} "
          f"bytes; {smi}", flush=True)
    print(f"ranks: one NCCL rank run_curves {ranks['nccl_wall']:.3f} s; "
          f"{RANKS} gloo ranks on cuda:0, walls by rank "
          f"{ranks['walls']}, spawn to join {ranks['spawn_wall']:.3f} s; "
          f"{smi}", flush=True)
    print(f"tp: (1 x {TP_RANKS}) mesh of gloo ranks on cuda:0, walls by "
          f"rank {tp['walls']}, tokens bitwise the one-device run: "
          f"{tp['same_tokens']}, spawn to join {tp['spawn_wall']:.3f} s; "
          f"{smi}", flush=True)
    print(f"tp models: (1 x {TP_RANKS}) mesh of gloo ranks on cuda:0, walls "
          f"by rank {tpm['walls']}, spawn to join {tpm['spawn_wall']:.3f} s; "
          f"{smi}", flush=True)
    mem = dry["memory"]
    print(f"dry-run: fake argument bytes {mem['fake_args']} against "
          f"{mem['requested']} requested, {mem['allocated']} allocated; fake "
          f"peak {mem['fake_peak']} against {mem['real_peak']} "
          f"({mem['peak_ratio']:.4f}); t_compute {mem['t_compute_ms']:.3f} "
          f"ms, t_memory {mem['t_memory_ms']:.3f} ms against "
          f"{mem['busy_ms']:.3f} device busy ms a step; {smi}", flush=True)
    print(f"analysis: {analysis['wall']:.3f} s in process, remat "
          f"{analysis['remat']}; examples wall seconds "
          f"{examples['walls']}; {smi}", flush=True)
    print(f"split placements: (2 x 1) mesh of gloo ranks on cuda:0, "
          f"walls by rank {split['walls']} (one device "
          f"{split['one_walls']}; ticks {split['ticks']}), cache bytes a "
          f"rank {split['cache_bytes']}, equal to the one-device run "
          f"{split['same']}, zero walls {split['zero_walls']}, spawn to "
          f"join {split['spawn_wall']:.3f} s; {smi}", flush=True)
    print(f"phase wall seconds: {_PHASE_SECONDS}", flush=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
