#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, with no result line):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build every kernel under ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, all at once) into the git-ignored ``build/``
   directory;
3. hold each kernel, and the backward kernels of flash attention,
   ``gmm`` and SSD (phase 11's path), against its plain PyTorch version
   on the card (the main paths' shapes, the sweeps of ``tests/test_kernels.py``, ragged
   lengths and edge cases; for flash attention, flash-decoding, SSD and
   ``gmm`` and the flash and SSD backward, which of each one's two
   kernels, tensor-core or FMA, each call took) and time kernel, plain
   version and a one-call library yardstick (for SSD, the FMA kernel on
   f32 beside the tensor-core one on bf16; for the flash and SSD
   backward, the FMA kernel that the bf16 tensor-core one replaced);
   and flash, decode and SSD at the shapes of phases 5d-5f (head dim
   160, D 96 / Dv 64 with v a view, cross-attention over 8 frames, N 64)
   beside SDPA;
4. the simulation path: ``run_scenario`` at full width (250 nodes, 200
   replicas per app, 8 seeds x 32 trials; MAIN_J requests, cut from 1000
   to keep the whole run under 10 minutes) on baseline,
   stale-predictions, churn, cold-start, drift-fallback (the closed-loop
   fleet under drift), the four capacity-plane scenarios (overload-ramp,
   flash-crowd-autoscale, scale-to-zero-idle, spot-preemption: waste,
   shed rate and the autoscaler's telemetry printed), gray-failure and
   staleness-storm with the four default policies and the oracle, and
   the client plane's three scenarios (correlated-outage, retry-storm,
   breaker-saves-retry-storm) at their registry shape with 12 seeds x 8
   trials, one pass a policy (goodput, timeout, fail-fast and shed
   rates, attempts per request, wasted work, ms a step), counting kernel
   launches; then, outside the launch count, the launches a step of each
   client pass, a traced pass at bench_telemetry.py's LARGE shape cut to
   TRACE_J requests (least_conn and perf_aware untraced and at
   sample_every 16 and 1: step-time overhead and the trace's sum rule),
   and profiled passes (device busy share, largest kernels and host ops,
   the host's waits on the device): full width cut to PROFILE_J
   requests, and retry-storm's perf_aware at its registry width over its
   first RETRY_STORM_PROFILE_J requests; baseline's passes replay the
   loop from CUDA graphs;
4b. the compiled mode: baseline at full width and MAIN_J, perf_aware and
   least_conn, stepped eagerly against ``prepare_compiled``'s closure
   (the loop captured in CUDA graphs once, then replayed): ms and kernel
   and launch calls a step of each, the capture's seconds, every summary
   stat of graph and eager (equal, asserted), a second closure served by
   the loop cache (a hit, asserted); then ``fleet_throughput`` at the
   reference's full width (250 nodes, 5 x 200 replicas, 4 trials) over
   FLEET_J requests: events/s, ms a step, mean and p99 RTT, peak memory;
   the same stats under one seed and other stats under another, and its
   graph equal to the same steps run eagerly;
5. the serving path: ``ServingEngine`` with qwen2-vl-7b at full width
   (28 layers, bf16, random weights from a seeded generator), 3 waves of
   8 requests (prompts of 256-1024 tokens, 32 new tokens each), counting
   the attention kernels' launches (every flash call on the tensor-core
   kernel); then a profiled prefill and decode step outside the count,
   and 32 decode steps of the same weights from an int8 ``init_cache``
   (the decode kernel's launches counted);
5b. the Mamba2 serving path: ``ServingEngine`` with mamba2-1.3b at full
   width (48 layers, bf16, random weights), the first 2 of those waves
   (cut to keep the run near 10 minutes) with each
   wave's longest prompt lengthened to the next multiple of the SSD
   chunk (256), counting the SSD kernel's launches (every one on the
   tensor cores); then a profiled prefill and decode step outside the
   count;
5c. the MoE serving path: ``ServingEngine`` with qwen3-moe-30b-a3b at
   full width (48 layers, 128 experts top-8, bf16, random weights, ~61
   GB), the first 2 waves of phase 5, counting the grouped-matmul kernel's
   launches (three per layer and step) beside the attention kernels';
   then a profiled prefill and decode step outside the count;
5d-5f. the rest of the catalogue through the same engine at full width,
   the 3 waves of phase 5 (Zamba2's lengthened as in 5b), each wave's launches
   asserted, then a profiled prefill and decode step: zamba2-2.7b (54
   Mamba2 layers and a shared attention block every 6, head dim 160, its
   LoRA b matrices seeded nonzero), minicpm3-4b (62 layers of MLA) and
   seamless-m4t-medium (12 + 12 layers, zero encoder frames);
6. CUDA against the CPU: the campaign at a mid shape (summary stats
   and the client plane's stats within 1e-5 relative on every cell, the
   capacity plane's telemetry and the timeout counts equal; a traced
   baseline at sample_every 1 and 16 with equal NaN masks and rows
   within 1e-5) and the six serving paths at their smoke configs in f32
   (logits within 1e-4 relative, identical tokens; Zamba2 with nonzero
   LoRA, seamless's encoder on normal frames), the int8 cache decoded
   from ``init_cache``, and a train step at TRAIN_PARITY_ARCHS' six f32
   smoke configs;
7. the paper's Fig. 11 at the reference's benchmark setting
   (``SimConfig(n_trials=200, n_requests=300)``, 76 runs of the core:
   accuracy, replicas per app and heterogeneity sweeps, four policies
   against the oracle), each series and sweep's wall seconds printed
   beside the EXPERIMENTS.md rows; the accuracy sweep held against the
   CPU at 32 trials (rtol 1e-5, atol 1e-4 percentage points);
8. the prediction plane at the full campaign's width: 1000 predictors
   (5 apps x 200 replicas on 250 nodes, all nine zoo families, 4
   metrics over 5 s windows on one store scraped every 200 ms, seeded
   parameters in the reference's shapes), ``predict_all`` on the card
   against the CPU plane (1e-5 relative, 1e-4 for the recurrent and
   convolutional families), its wall ms, dispatches, each bucket's
   device call and the state / feature shares per prediction;
9. (run right after phase 5, on its qwen2-vl-7b weights) the router:
   ``MorpheusRouter`` over three full-width replicas sharing the
   weights (max_batch 4, max_seq 2048, slowdowns 0, 0.02 and 0.08 s a
   decode step, wall clock), 24 requests of 256-1024 tokens and 8 new
   tokens each through ``route`` + ``drain`` under round_robin, random,
   least_conn, perf_aware on a knowledge base seeded from one wave per
   replica and perf_aware on plane-served predictors (one a replica);
   each pass's mean and p95 RTT, routing shares, route() host us a
   request, plane dispatches a route and each wave's launches (the
   flash kernel once a layer and the decode kernel once a layer a step,
   no other kernel, asserted); one ``predict_all`` a route on the
   plane pass and the largest share to the fast replica under the
   seeded knowledge base asserted, each replica's seeded RTT printed
   before it; then one scenario per mirrored plane
   (hedged perf_aware with predictors, capacity with admission,
   resilience with a breaker) at deepseek-67b's smoke config in f32 on
   the card against the CPU under a simulated clock: picks, counts,
   RTTs, tokens, registry and ledger equal, trace rows NaN-equal;
10. predictor training on the card: the lifecycle (``PredictionManager``:
   workload, collection, correlations, selection, training, the plane's
   sweep) on the three nodes of ``benchmarks/fixture.py`` at 294 metrics
   a store (4 cycles of 240 s), one plane sweep over every trained
   predictor, an ``OnlineAdapter`` a node fed 240 s more with the plane's
   predictions and retraining on the lifecycle's 240 s cadence, the
   segment sum's launches counted (the trees' split search and MIC's
   counts), a swap a node and no skipped candidate; the nine zoo
   families fitted at n = 10,000 (fit s, RMSE against the mean's and the
   reference's readings, predict us); node 1's lifecycle at 39 metrics
   and every family at n = 1,000 on the card against the CPU; phase 3
   holds the segment sum at the trees' and MIC's shapes beside its
   simulation shapes;
11. LM training at full width: qwen3-moe-30b-a3b (d_model 2048, 32/4
   heads, 128 experts top-8, vocab 151936; its 48 layers cut to 2, bf16,
   remat full) through ``make_train_state`` / ``make_train_step`` on
   B 4 x S 1024 tokens from the prefetching ``SyntheticLMData``
   iterator: 2 warm-up and 4 measured steps (loss, grad norm, step ms,
   tokens/s, peak GB), each step's launches asserted (flash forward 2L,
   its backward L, ``gmm`` forward 6L, its backward 3L: remat runs each
   layer's forward again in the backward pass; every flash call on the
   tensor cores), one step profiled (device time by kernel and by
   wrapper, a call's kernels summed under its wrapper's name); then
   qwen2-vl-7b's dense path at full width (2 layers, one step);
   mamba2-1.3b at full width and depth (48 layers, MAMBA_TRAIN's steps;
   SSD forward 2L and its backward L, all on the tensor cores); zamba2-2.7b at
   full width, HYBRID_TRAIN_LAYERS layers (two shared-block calls, flash
   at head dim 160), one step; phase 3 holds the three backward kernels
   (flash attention's, ``gmm``'s, SSD's) against their plain versions at
   these shapes, and phase 6 a train step at six f32 smoke configs on the
   card against the CPU.  Each phase's end is printed in seconds into the
   run;
12. the launchers and the multi-device layer (its own main path: the
   counts are reset just before each launcher and read just after):
   (a) ``launch.train.run`` on mamba2-1.3b at full width cut to
   CHECKPOINT_LAYERS layers, B 4 x S 1024, one card: 4 steps with a
   checkpoint every 2, then a second call to 6 steps, which resumes at
   step 4 from a state equal to the saved one bit for bit (the whole
   train state through ``Checkpointer`` and back onto the card), the
   SSD launches of the 6 steps asserted; (b) the FSDP step with 2
   microbatches on a one-rank NCCL group, mesh (1, 1) data x model, two
   steps from (a)'s state beside two runs of the single-device step (the
   first loss equal bit for bit; master, m, v and params within 4x the
   single-device step's own run-to-run drift: its atomic sums are not
   repeatable on the card); (c) the int8 compressed
   all-reduce over a one-rank ``pod`` axis on a gradient of that state
   (mean and residual within one scale); (d) ``launch.serve.run`` with
   qwen2-vl-7b at full width, 3 replicas, 24 requests of LAUNCH_PROMPT
   tokens, perf_aware under the simulated clock: every request finished,
   every flash call on the tensor cores and every decode call on
   ``mma``; (e) tensor parallelism over the model axis (its own main
   path: the counts reset just before the bf16 step and read just
   after, each kernel's launches and its variant asserted against the
   step's count): the TP step's code path on a one-rank NCCL group, mesh
   (1, 1) data x model, with qwen3-moe-30b-a3b at full width,
   TP_TRAIN_LAYERS layer, bf16, the FSDP step with 2 microbatches handed
   the single-device step's gradients (microbatches, params and the TP
   forward's loss equal bit for bit, master / m / v within STATE_TOL,
   the peak printed), and, in a window of their own, the TP path's
   gradients against the single-device ones at the f32 smoke configs of
   TP_PARITY_ARCHS (their FMA launches asserted); then flash attention
   and ``gmm``, forward
   and backward, at a TP rank's local full-width shapes
   (TP_LOCAL_FLASH, TP_LOCAL_GMM) against their plain versions, timed
   beside them and their bounds; (f) serving under tensor parallelism
   (its own main path: the counts reset just before the waves and read
   just after, each kernel's launches and variant asserted against the
   count predicted from the configs): on a one-rank NCCL group, mesh
   (1, 1) data x model, a wave (prefill and TP_SERVE_STEPS greedy decode
   steps into a TP_SERVE_CACHE-row cache, ``testing.tp_serve_parity``)
   of qwen2-vl-7b at full width cut to TP_SERVE_LAYERS layers, bf16,
   phase 5's first 8 prompts, and of qwen3-moe-30b-a3b at full width cut
   to TP_SERVE_MOE_LAYERS layers, each under the prefill / decode rules
   beside the single-device wave: tokens equal and logits and cache bit
   for bit, then TP_SERVE_ROUNDS interleaved waves of each path timing a
   decode step (median and range), the NCCL flight recorder's setting
   (the caller's: ``nccl_recorder``) and the peak printed; then
   the decode kernel's log-sum-exp at the serving shape and at the
   blocks of tp 4 and 8 cut from that cache, merged by their
   log-sum-exps, against the plain version and the whole-cache call,
   timed beside SDPA at the block shape; (g) tensor parallelism for MLA
   and the Mamba2 families (its own main path: the counts reset just
   before its steps and waves and read just after, each kernel's
   launches and variant asserted against the count predicted from the
   configs, nothing outside them): on a one-rank NCCL group, mesh
   (1, 1) data x model, minicpm3-4b, mamba2-1.3b and zamba2-2.7b at
   full width cut to TP_LATENT_SSM's depths (Zamba2's LoRA seeded
   nonzero), bf16, one TP train step handed the single-device step's
   gradients and one wave (prefill into TP_SERVE_CACHE rows,
   TP_SERVE_STEPS greedy steps) beside one device, all bit for bit;
   then the SSD kernel and its backward at the heads of a TP rank
   (TP_LOCAL_SSD; once with dt sliced from every head's), flash
   attention forward and backward at Zamba2's and MLA's local heads
   (TP_LOCAL_LATENT_FLASH) and the decode kernel with ``lse`` on a
   Zamba2 rank's cache block (TP_LOCAL_DECODE), against their plain
   versions, timed beside them, SDPA and their bounds; (h) tensor
   parallelism for the encoder-decoder family (its own main path: the
   counts reset just before its step and read just after its wave, each
   kernel's launches and variant asserted against the count predicted
   from the config, nothing outside them): on a one-rank NCCL group,
   mesh (1, 1) data x model, seamless-m4t-medium at full width, bf16,
   one TP train step (TP_ENCDEC_TRAIN_LAYERS encoder and decoder layers,
   phase 11's B x S, as many nonzero encoder frames) handed the
   single-device step's gradients and one wave at full depth
   (TP_ENCDEC_FRAMES nonzero frames, phase 5's first prompts prefilled
   into TP_SERVE_CACHE rows, TP_SERVE_STEPS greedy steps) beside one
   device, all bit for bit; then flash attention forward and backward,
   non-causal, at a tp TP_LOCAL_ENCDEC rank's encoder heads and its
   cross-attention (Sq != Skv), and the decode kernel with ``lse`` on a
   read-only cross block, against their plain versions, timed beside
   them, SDPA and their bounds.  Phases 12g (a) and 12h (a) print both
   train steps' gradient norms and clip scales as f32 hex, and on a
   mismatch each gradient leaf's sum of squares on both sides and the
   first leaf that differs, before the check fails;
13. the dry-run on the card (its own main path: the counts reset just
   before each cell and read just after): in a child process (``python3
   chip_smoke.py --dryrun-child OUT``: the fake process group is never
   the default group of a process that runs NCCL), rank 0 of a fake
   256-rank group on the (16, 16) production mesh runs
   ``launch.dryrun_lib.run_cell`` on DRYRUN_CELLS at full width, the
   real step at the rank's local shapes on the card, collectives called
   on the fake group; each cell's memory (the arguments and the card's
   own peak a rank), flops, bytes and collective bytes by op type
   printed, every launch asserted on its kernel's tensor-core variant;
   qwen3-moe-235b-a22b's train cell at depth 1 and 2 in its production
   FSDP layout (DRYRUN_FSDP: each layer's weights gathered inside its
   body), its temp difference printed beside one layer's weights as the
   step gathers them;
   then each kernel at the shapes those cells gave it (recorded on the
   way) against its plain version, timed beside it, its library call
   and its bound (``kernels/*.py::work``);
14. simcore's trial-axis sharding and the analysis linter (its own main
   path: the counts reset just before the sharded campaign and read just
   after): ``run_scenario`` on stale-predictions and churn at phase 6's
   mid shape over a one-rank NCCL group (the shard path: the block, the
   all-gather, the cut), every stat equal bit for bit to the run without
   a group and the segment sum launched as often; the pad / block / cut
   path at world 4 over 6 trials, each block run on the card in turn,
   equal to the single-device run; ``python -m repro_torch.analysis`` in
   a child process (exit 0); the step audit on CUDA tensors equal to the
   CPU's (``python3 chip_smoke.py --audit-child OUT``) for every
   distinct step;
15. a ``kernels`` JSON line, the card's line, then the result line.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the
#: FP64 / FP32 rates outside the tensor cores and the dense bf16 rate
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"torch.float64": 34e12, "torch.float32": 67e12,
              "torch.bfloat16": 989e12}

LARGE = dict(n_nodes=250, n_replicas_per_app=200, n_requests=1000)
LARGE_SEEDS, LARGE_TRIALS = tuple(range(8)), 32
#: the depth of phase 4's full-width scenarios (the reference's 1000, cut
#: to keep the whole run, phases 5d-5f and 10 included, near 560 s on a
#: slow host)
MAIN_J = 200
#: the waves of phases 5b and 5c (the other serving paths take WAVES),
#: cut for the same reason
CUT_WAVES = 2
#: the requests of phase 4's profiled retry-storm pass: the registry's
#: 450 took 95 s under the profiler, cut to 150 (the ramp and the
#: collapse) for phase 11, then to 100 (34.1 s at 150) to keep the run
#: under ~600 s with phase 11's Mamba2 training: the collapse past the
#: 25 s timeouts is in it
RETRY_STORM_PROFILE_J = 100
#: the requests of phase 4's five profiled full-width passes (100 before;
#: the five took ~60 s, mostly the profiler's own processing, which grows
#: with the steps): the launches a step and the busy share are per step
PROFILE_J = 50
#: the requests of phase 4's traced pass (bench_telemetry.py's LARGE
#: cell has 1000; 22.7 s at 1000): the overhead a step and the sum rule
#: do not depend on the length
TRACE_J = 500
#: the fleet mode's requests in phase 4b (the reference's default is 1M,
#: bench_simcore.py's benchmark row 50 k): cut so that the phase stays
#: near 20 s of the ~600 s run; events/s and ms a step do not depend on
#: the length once a few graph blocks have run
FLEET_J = 20_000
MID = dict(n_nodes=60, n_replicas_per_app=50, n_requests=200)
MID_SEEDS, MID_TRIALS = tuple(range(4)), 16
CAPACITY_SCENARIOS = ("overload-ramp", "flash-crowd-autoscale",
                      "scale-to-zero-idle", "spot-preemption")
MAIN_SCENARIOS = ("baseline", "stale-predictions", "churn", "cold-start",
                  "drift-fallback") + CAPACITY_SCENARIOS \
    + ("gray-failure", "staleness-storm")
#: the client plane's scenarios at their registry shape (5 apps x 6
#: replicas, J = 300 or 450: the collapse is calibrated at this size)
#: with bench_resilience.py's 12 seeds x 8 trials
CLIENT_SCENARIOS = ("correlated-outage", "retry-storm",
                    "breaker-saves-retry-storm")
CLIENT_SEEDS = tuple(range(12))
POLICIES = ("perf_aware", "least_conn", "round_robin", "random", "oracle")
KERNEL_SCENARIOS = ("stale-predictions", "churn", "staleness-storm",
                    "correlated-outage")
#: card against the CPU at MID (the client plane's scenarios are held
#: at their registry shape instead: phase 4's own passes)
PARITY_SCENARIOS = ("stale-predictions", "churn", "cold-start",
                    "drift-fallback") + CAPACITY_SCENARIOS \
    + ("gray-failure", "staleness-storm", "baseline", "baseline@1",
       "baseline@16")
PARITY_RTOL = 1e-5
#: the capacity plane's integer telemetry, equal on the card and the CPU
TELEMETRY = ("decisions", "scale_ups", "scale_downs", "wakeups",
             "active_final", "routed_inactive")

#: phase 7: the paper's Fig. 11 at the reference's benchmark setting
#: (benchmarks/bench_load_balancing.py:19-45), four policies
FIG11 = dict(n_trials=200, n_requests=300)
FIG11_ACCURACY = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
FIG11_REPLICAS = (1, 2, 4, 8)
FIG11_HETEROGENEITY = (0.0, 0.3, 0.6, 1.0)
FIG11_PARITY_TRIALS = 32
#: phase 8: the prediction plane at the full campaign's width (phase 4:
#: 250 nodes, 5 apps x 200 replicas), K = 4 metrics over 5 s windows
PLANE = dict(nodes=250, apps=5, replicas=200, k=4, window_s=5.0)
#: phase 9: the router over three qwen2-vl-7b replicas at full width,
#: examples/serve_cluster.py's heterogeneity (s a decode step)
ROUTER_ENGINE = dict(max_batch=4, max_seq=2048)
ROUTER_SLOWDOWNS = (0.0, 0.02, 0.08)
ROUTER_REQUESTS, ROUTER_NEW_TOKENS = 24, 8
ROUTER_PASSES = ("round_robin", "random", "least_conn", "perf_aware",
                 "perf_aware+plane")

#: the serving path: qwen2-vl-7b at full width, 3 waves of 8 requests
#: phase 10: predictor training at full width on the reference's benchmark
#: fixture's three nodes (``benchmarks/fixture.py:27-45``) with the paper's
#: 294-metric surface (15 informative + 279 noise metrics), the zoo at
#: Table 2's top tier (10 metrics of a 5 s window: 120 features, 25
#: points), and node 1's lifecycle at 39 metrics on the card and the CPU
TRAIN = dict(nodes=3, noise_metrics=279, metrics=294, cycles=4,
             cycle_s=240.0, adapt_step_s=20.0,
             zoo_n=10_000, zoo_d=120, zoo_k=10, zoo_w=25,
             parity=dict(n_noise_metrics=24, n_cycles=3))
#: the reference zoo's held-out RMSE at phase 10's top tier, and the
#: mean's, from ``experiments/zoo_top_tier_reference.py`` (JAX on the
#: CPU): one reading for the families without random state, which the
#: port's fits hold to 1e-3 relative; five initial draws (seeds 0-4) for
#: the others.  Torch cannot replay jax's draws, so the port's one draw is
#: held below ZOO_DRAW_MARGIN x the reference's worst draw and below the
#: mean's RMSE
ZOO_REF_RMSE = {
    "lr": (0.086392,), "svm": (0.591987,), "xgb": (0.017612,),
    "rf": (0.114053,),
    "fnn": (0.091720, 0.077116, 0.088856, 0.087706, 0.096473),
    "rnn": (0.080754, 0.044992, 0.083617, 0.085002, 0.079626),
    "lstm": (0.022734, 0.016252, 0.071359, 0.020885, 0.016295),
    "gru": (0.009216, 0.009548, 0.017886, 0.009529, 0.015490),
    "cnn": (0.143755, 0.134591, 0.126618, 0.129621, 0.142436)}
ZOO_REF_MEAN = {False: 0.193985, True: 0.160062}
ZOO_DRAW_MARGIN = 1.5
ARCH = "qwen2-vl-7b"
SERVE = dict(max_batch=8, max_seq=2048)
WAVES, NEW_TOKENS, PROMPT_LEN = 3, 32, (256, 1024)
ATTN_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
SERVE_PARITY_RTOL = 1e-4

#: the Mamba2 serving path: mamba2-1.3b at full width, the same waves
MAMBA_ARCH = "mamba2-1.3b"
SSD_TOL = {"torch.float32": 2e-4, "torch.bfloat16": 4e-2}

#: the MoE serving path: qwen3-moe-30b-a3b at full width, the same waves
MOE_ARCH = "qwen3-moe-30b-a3b"
GMM_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}

#: the rest of the catalogue served at full width (phases 5d, 5e, 5f):
#: Zamba2's Mamba2 backbone with its shared attention block (head dim
#: 160), MLA and the encoder-decoder; the int8 KV cache on phase 5's
#: qwen2-vl-7b weights
HYBRID_ARCH = "zamba2-2.7b"
MLA_ARCH = "minicpm3-4b"
ENCDEC_ARCH = "seamless-m4t-medium"
#: phase 11: training at full width, depth cut to fit the f32 master and
#: Adam moments on one card (qwen3-moe-30b-a3b: 48 -> 2 layers, ~1.9 B
#: parameters; qwen2-vl-7b's dense path: 28 -> 2 layers, one step);
#: mamba2-1.3b at full depth (48 layers, 1.34 B parameters)
LM_TRAIN = dict(batch=4, seq=1024, layers=2, steps=4, warmup=2)
MAMBA_TRAIN = dict(steps=3, warmup=2)
#: zamba2-2.7b's depth in phase 11 (54 layers, a shared block every 6):
#: two groups, so the shared block runs twice, one step
HYBRID_TRAIN_LAYERS = 12
#: phase 12's train launcher: mamba2-1.3b at full width, 48 -> 4 layers
#: (2.9 GB of train state, every leaf kind: bf16 params, f32 ones, f32
#: master, m, v, step), checkpointed and restored bit for bit.  The whole
#: 26.17 GB qwen3-moe-30b-a3b state took 95.6 s at ~0.6 GB/s through
#: np.savez on an H100 host
CHECKPOINT_LAYERS = 4
#: phase 12's serve launcher: qwen2-vl-7b's prompts, its 256-position
#: vision stub and 8 text tokens, in a 320-row cache
LAUNCH_PROMPT, LAUNCH_MAX_SEQ = 264, 320
#: phase 6: a train step on the card against the CPU at the f32 smoke
#: configs
#: phase 12e: the tensor-parallel step's depth at full width (two f32
#: master / moment states of qwen3-moe-30b-a3b are held beside the step:
#: ~35 GB at one layer, ~52 GB at two)
TP_TRAIN_LAYERS = 1
#: phase 12e (a): the f32 smoke configs whose tensor-parallel gradients
#: are held to the single-device ones on the card
TP_PARITY_ARCHS = ("deepseek-67b", "qwen2-vl-7b", "qwen3-moe-30b-a3b")
#: phase 12e (b): (arch, tp) of the flash shapes a TP rank runs, and the
#: model axis of qwen3-moe-30b-a3b's local experts
TP_LOCAL_FLASH = (("qwen3-moe-30b-a3b", 4), ("mistral-large-123b", 8))
TP_LOCAL_GMM = 4
#: phase 12f: the tensor-parallel serving waves' cache, greedy steps and
#: depths at full width: qwen2-vl-7b 28 -> 4 layers (its full depth's
#: waves took 35 of 43 s on a slow host: cut to keep the run under ~600 s
#: with phase 13), the MoE arch 48 -> 2; and the model axes whose
#: sequence-parallel cache blocks the decode kernel is held at
TP_SERVE_CACHE, TP_SERVE_STEPS = 2048, 32
TP_SERVE_LAYERS, TP_SERVE_MOE_LAYERS = 4, 2
TP_SERVE_BLOCKS = (4, 8)
#: phase 12f (a): the timed waves of each path after the parity waves,
#: interleaved (``testing.tp_serve_parity``'s ``rounds``)
TP_SERVE_ROUNDS = 3
#: phase 12g (a): MLA and the Mamba2 families on the tensor-parallel path
#: at full width, bf16, their depth cut: (arch, layers); zamba2-2.7b's 6
#: are one group with its shared block
TP_LATENT_SSM = (("minicpm3-4b", 2), ("mamba2-1.3b", 4), ("zamba2-2.7b", 6))
#: phase 12g (b): (arch, tp) of the SSD shapes a TP rank runs (its heads
#: of mamba2-1.3b's 64 and zamba2-2.7b's 80), and of the flash shapes
#: (Zamba2's shared block, 32 heads of 160; MLA's 40 heads, D 96 / Dv
#: 64), and the model axis of the Zamba2 decode block (B 8 x the
#: TP_SERVE_CACHE-row cache's block, every one of its 32 heads)
TP_LOCAL_SSD = (("mamba2-1.3b", 4), ("zamba2-2.7b", 8))
TP_LOCAL_LATENT_FLASH = (("zamba2-2.7b", 4), ("minicpm3-4b", 4))
TP_LOCAL_DECODE = 4
#: phase 12h (a): seamless-m4t-medium's train step on the tensor-parallel
#: path at full width, its depth cut 12 + 12 -> 4 + 4 encoder and decoder
#: layers (two f32 states beside the step); its wave at full depth reads
#: TP_ENCDEC_FRAMES encoder frames
TP_ENCDEC_TRAIN_LAYERS = 4
TP_ENCDEC_FRAMES = 512
#: phase 12h (b): the model axis of the encoder's and the
#: cross-attention's local heads (16 -> 4; the cross-attention's keys
#: TP_ENCDEC_FRAMES rows), and the cross block the decode kernel reads
#: (B 8 x 128 rows, all 16 heads: TP_ENCDEC_FRAMES / 4)
TP_LOCAL_ENCDEC = 4
#: phase 13: the dry-run's cells, each run by ``launch.dryrun_lib.
#: run_cell`` as rank 0 of the fake (16, 16) production group at full
#: width: (arch, shape, full depth, the depth-1 and depth-2 runs).  The MoE
#: and Mamba2 train cells at depth 1 and 2 (flash and ``gmm`` forward and
#: backward on a rank's 2 of 32 heads and 8 of 128 experts; SSD and its
#: backward on 4 of 64 heads), qwen2-vl-7b's decode at full depth (the
#: decode kernel with ``lse`` on the rank's 2048-row ``kv_seq`` block of 8
#: sequences), and qwen3-moe-235b-a22b's FSDP train cell at depth 1 and 2
#: (each layer's weights gathered over data inside its body; flash and
#: ``gmm`` forward and backward on 4 of 64 heads and 8 of 128 experts at
#: D 4096, F 1536)
DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k", False, True),
                ("qwen2-vl-7b", "decode_32k", True, False),
                ("mamba2-1.3b", "train_4k", False, True),
                ("qwen3-moe-235b-a22b", "train_4k", False, True))
#: the phase 13 cells whose depth-1 and depth-2 runs keep the production
#: cell's FSDP layout (``dryrun_lib.run_cell(fsdp=True)``; by the
#: reference's rule a cut depth's few parameters would make them ZeRO-1)
DRYRUN_FSDP = {("qwen3-moe-235b-a22b", "train_4k")}
#: each phase 13 cell's kernels and the tensor-core variant every launch
#: takes
DRYRUN_KERNELS = {
    ("qwen3-moe-30b-a3b", "train_4k"): {
        "flash_attention": "tc", "flash_attention_bwd": "tc",
        "gmm": "wgmma", "gmm_bwd": "wgmma"},
    ("qwen3-moe-235b-a22b", "train_4k"): {
        "flash_attention": "tc", "flash_attention_bwd": "tc",
        "gmm": "wgmma", "gmm_bwd": "wgmma"},
    ("qwen2-vl-7b", "decode_32k"): {"decode_attention": "mma"},
    ("mamba2-1.3b", "train_4k"): {"ssd": "tc", "ssd_bwd": "tc"}}
DRYRUN_CHILD_TIMEOUT = 240
#: phase 14 (a): the campaign sharded over a one-rank NCCL group at
#: phase 6's mid shape; (b) the dispatch's pad / block / cut path at
#: world 4 over T = 6 trials, each block run on the card in turn
SHARD_SCENARIOS = ("stale-predictions", "churn")
PAD_WORLD, PAD_T = 4, 6
PAD_CASES = (("baseline", "perf_aware"), ("stale-predictions", "perf_aware"),
             ("retry-storm", "perf_aware"))
#: phase 14 (c) and (d): the linter and the step audit's CPU half, each
#: in a child process started when the phase starts
ANALYSIS_CHILD_TIMEOUT = 240
TRAIN_PARITY_ARCHS = ("qwen2-vl-7b", "qwen3-moe-30b-a3b", "minicpm3-4b",
                      "seamless-m4t-medium", "mamba2-1.3b", "zamba2-2.7b")
#: the SSD backward kernel against its plain version, relative to the
#: largest value (tests/test_torch_cuda.py's): f32 2e-4, bf16 1e-2
SSD_BWD_TOL = {"torch.float32": 2e-4, "torch.bfloat16": 1e-2}


def wave_prompts(vocab: int):
    """The serving waves' prompts, seeded: WAVES x max_batch token
    arrays of lengths drawn in PROMPT_LEN."""
    import numpy as np
    rng = np.random.default_rng(0)
    n = WAVES * SERVE["max_batch"]
    lens = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=n)
    prompts = [rng.integers(0, vocab, size=int(m)).astype(np.int32)
               for m in lens]
    B = SERVE["max_batch"]
    return [prompts[w * B:(w + 1) * B] for w in range(WAVES)]


def mamba_waves(vocab: int, chunk: int):
    """The serving waves' prompts with each wave's longest prompt
    lengthened to the next multiple of ``chunk`` by seeded tokens: the
    reference's Mamba2 prefill takes a padded length longer than the
    chunk only as a multiple of it."""
    import numpy as np
    rng = np.random.default_rng(1)
    waves = []
    for prompts in wave_prompts(vocab):
        i = max(range(len(prompts)), key=lambda j: len(prompts[j]))
        n = len(prompts[i])
        extra = rng.integers(0, vocab, size=-n % chunk).astype(np.int32)
        waves.append([np.concatenate([extra, p]) if j == i else p
                      for j, p in enumerate(prompts)])
    return waves


def nccl_recorder() -> str:
    """The NCCL flight recorder's setting the NCCL phases run under: the
    environment's ``TORCH_FR_BUFFER_SIZE`` (read when the first NCCL group
    is made; 0 turns the recorder off), which this script leaves as the
    caller set it."""
    v = os.environ.get("TORCH_FR_BUFFER_SIZE")
    return "as it comes" if v is None else f"TORCH_FR_BUFFER_SIZE={v}"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A ptxas entry name without its namespace and parameters, e.g.
    ``flash_fwd_tc<128, 4, 2, 3>`` (``c++filt`` where it is installed)."""
    import shutil
    if shutil.which("c++filt") is None:
        return mangled
    out = subprocess.run(["c++filt", mangled], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = out.replace("(anonymous namespace)::", "").split("(")[0]
    return out.removeprefix("void ").split("::")[-1] or mangled


def _median_event_ms(run, inner: int, repeats: int) -> float:
    import torch
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def call_ms(fn, repeats: int = 11, inner: int = 50) -> float:
    """Time of one eager call, host work included: median over
    ``repeats`` of the mean of ``inner`` back-to-back calls, by CUDA
    events, after a warm-up."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _median_event_ms(run, inner, repeats)


def device_ms(fn, repeats: int = 11, inner: int = 50) -> float:
    """Device time of one call: ``inner`` calls captured into one CUDA
    graph, replayed ``repeats`` times, median of the mean by CUDA
    events.  Replaying takes the host out of the measurement."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, inner, repeats)


def check_segment_sum(dev) -> dict:
    """Hold the segment-sum kernel against its plain version; time it at
    the main path's shape.  Returns its ``kernels`` entry (launches are
    filled in from the main-path run)."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_sum import (launch_floor, segment_sum,
                                                 segment_sum_plain)

    rng = np.random.default_rng(0)

    def unaligned_copy(x):
        """A copy of ``x`` whose base is 8 bytes past 16-byte alignment."""
        off = 8 // x.element_size()
        y = torch.empty(x.numel() + off, dtype=x.dtype, device=dev)[off:]
        return y.view(x.shape).copy_(x)

    def case(T, R, B, dtype, lo=0, hi=None, mask=False, unaligned=False):
        ids = rng.integers(lo, B if hi is None else hi, size=(T, R))
        vals = (rng.random((T, R)) < 0.5).astype(float) if mask \
            else rng.standard_normal((T, R))
        v = torch.as_tensor(vals, dtype=dtype, device=dev)
        i = torch.as_tensor(ids.astype(np.int32), device=dev)
        if unaligned:
            v, i = unaligned_copy(v), unaligned_copy(i)
            assert v.data_ptr() % 16 == 8 and i.data_ptr() % 16 == 8
        got = segment_sum(v, i, B)
        torch.cuda.synchronize()
        want = segment_sum_plain(v, i, B)
        return v, i, got, want

    def path_case(T, R, N, A):
        """simcore's recount: a 0/1 f64 busy mask (T, R) keyed by
        node·A + app into B = N·A bins; the sums must be exact."""
        node_of = rng.integers(0, N, size=(T, R))
        na_key = (node_of * A + np.repeat(np.arange(A), R // A)[None, :])
        busy = torch.as_tensor((rng.random((T, R)) < 0.5).astype(float),
                               device=dev)
        ids = torch.as_tensor(na_key.astype(np.int32), device=dev)
        got = segment_sum(busy, ids, N * A)
        want = segment_sum_plain(busy, ids, N * A)
        err = float((got - want).abs().max())
        assert err == 0.0, f"0/1 mask ({T},{R})->{N * A} not exact: {err}"
        print(f"segment_sum path shape ({T},{R})->{N * A} f64 0/1 mask: "
              f"max_abs_err {err}")
        return busy, ids, err

    # the main path's shapes: the full-width scenarios' (T, R) = (256,
    # 1000) into N·A = 1250 bins, and the correlated outage's resync at
    # its registry shape, (96, 30) into 6 x 5 = 30 bins
    T, R, N, A = 256, 1000, LARGE["n_nodes"], 5
    B = N * A
    busy, ids, path_err = path_case(T, R, N, A)
    path_case(8 * len(CLIENT_SEEDS), 30, 6, 5)

    # each load and store path of the kernel: 16-byte loads (the path
    # shape), scalar loads (R % 4 != 0, an unaligned base), a scalar
    # head / tail of the stores (odd B), bin tiles (B past 48 KB of
    # histograms), more than one pass of loads a thread, f32
    checks = [
        ((256, 1000, 1250, torch.float64), dict(), 1e-12),
        ((256, 1000, 1250, torch.float32), dict(), 1e-5),
        ((256, 1001, 1250, torch.float64), dict(), 1e-12),
        ((256, 1001, 1250, torch.float64), dict(mask=True), 0.0),
        ((256, 1000, 1251, torch.float64), dict(), 1e-12),
        ((256, 1000, 1251, torch.float32), dict(mask=True), 0.0),
        ((4, 1000, 6145, torch.float64), dict(), 1e-12),   # 2 bin tiles
        ((4, 1000, 6145, torch.float64), dict(mask=True), 0.0),
        ((4, 5000, 10000, torch.float64), dict(), 1e-12),  # 3 bin tiles
        ((4, 5000, 20000, torch.float32), dict(), 1e-5),   # 3 bin tiles
        ((3, 8000, 1250, torch.float64), dict(), 1e-12),   # 2 load passes
        ((37, 1000, 999, torch.float64), dict(unaligned=True), 1e-12),
        ((37, 1000, 999, torch.float32), dict(unaligned=True, mask=True),
         0.0),
    ]
    for shape in ((1, 1, 1), (3, 50, 20), (8, 128, 128), (16, 300, 60)):
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            checks.append((shape + (dtype,), dict(), tol))
            checks.append((shape + (dtype,), dict(mask=True), 0.0))
            checks.append((shape + (dtype,),
                           dict(lo=-5, hi=shape[2] + 5), tol))
    for (t, r, b, dtype), kw, tol in checks:
        _, _, g, w = case(t, r, b, dtype, **kw)
        err = float((g - w).abs().max()) if g.numel() else 0.0
        scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
        assert err <= tol * scale, \
            f"segment_sum ({t},{r},{b}) {dtype} {kw}: err {err} > {tol}"
        print(f"segment_sum ({t},{r})->{b} {str(dtype)[6:]} {kw or ''}: "
              f"max_abs_err {err:.3e} (tol {tol} x {scale:.3g})")

    ids64 = ids.long()
    timed = {
        "kernel": lambda: segment_sum(busy, ids, B),
        "plain": lambda: segment_sum_plain(busy, ids, B),
        "library": lambda: torch.zeros((T, B), dtype=busy.dtype,
                                       device=dev).scatter_add_(1, ids64,
                                                                busy)}
    # the launch floor: an empty kernel with the same grid, block and
    # shared memory, timed by the same graph replay
    timed["launch floor"] = lambda: launch_floor(busy, ids, B)
    dev_ms = {k: device_ms(f) for k, f in timed.items()}
    eager_ms = {k: call_ms(timed[k]) for k in ("kernel", "plain", "library")}
    print("segment_sum device time per call (CUDA graph replay): "
          + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in dev_ms.items()))
    print("segment_sum eager call time, host included: "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in eager_ms.items()))
    ms, plain_ms, library_ms = (dev_ms[k]
                                for k in ("kernel", "plain", "library"))
    from repro_torch.kernels.segment_sum import work
    bound_ms, bound_by = _bound(*work(busy, ids, B), busy.dtype)
    return {"name": "segment_sum", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
            "replaces": "src/repro/kernels/segment_sum.py:58",
            "launches": 0, "max_abs_err": path_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "launch_floor_ms": dev_ms["launch floor"]}


def check_segment_sum_training(dev) -> dict:
    """Hold the segment sum at predictor training's shapes: a tree's split
    search, (240, 10,000) f64 -> 32 bins at Table 2's top tier (d = 120
    count rows, exact, over 120 residual rows, 1e-12 relative), with
    R % 4 != 0 (the scalar loads) and R = 10,000 (more than one load pass
    a thread) beside it; MIC's joint counts, (m, n) f32 ones -> bx * by,
    exact, at the lifecycle's 294 metrics and its dataset sizes.  Times
    the tree shape by graph replay against its bound and ``scatter_add_``.
    Returns the entries it adds to the kernel's line."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain

    rng = np.random.default_rng(23)

    def tree_case(d, n, B):
        ids = torch.as_tensor(np.tile(rng.integers(0, B, (d, n)), (2, 1)),
                              dtype=torch.int32, device=dev)
        mask = (rng.random(n) < 0.6).astype(float)
        res = rng.standard_normal(n).astype(np.float32).astype(float)
        v = torch.as_tensor(np.concatenate([np.tile(mask, (d, 1)),
                                            np.tile(mask * res, (d, 1))]),
                            device=dev)
        got = segment_sum(v, ids, B)
        want = segment_sum_plain(v, ids, B)
        assert torch.equal(got[:d], want[:d]), f"tree counts ({d},{n})"
        err = float((got[d:] - want[d:]).abs().max())
        scale = max(float(want[d:].abs().max()), 1.0)
        assert err <= 1e-12 * scale, f"tree sums ({d},{n}): {err}"
        print(f"segment_sum tree shape ({2 * d},{n})->{B} f64: counts "
              f"exact, sums max_abs_err {err:.3e} (tol 1e-12 x "
              f"{scale:.3g})")
        return v, ids, err

    v, ids, err = tree_case(120, 10_000, 32)
    # R % 4 != 0 at the top tier and, at the lifecycle's own widths (k up
    # to 60 metrics x 12 features), a full training's 80 % split and a
    # re-training's whole dataset
    for d, n in ((120, 8_001), (120, 10_001), (12, 133), (720, 55),
                 (720, 101)):
        tree_case(d, n, 32)
    for m, n, B in ((294, 214, 9), (294, 137, 64), (294, 600, 144),
                    (39, 61, 4)):
        i = torch.as_tensor(rng.integers(0, B, (m, n)), dtype=torch.int32,
                            device=dev)
        ones = torch.ones((m, n), device=dev)
        assert torch.equal(segment_sum(ones, i, B),
                           segment_sum_plain(ones, i, B)), (m, n, B)
        print(f"segment_sum MIC shape ({m},{n})->{B} f32 ones: exact")
    T, R, B = v.shape[0], v.shape[1], 32
    ids64 = ids.long()
    timed = {
        "kernel": lambda: segment_sum(v, ids, B),
        "plain": lambda: segment_sum_plain(v, ids, B),
        "library": lambda: torch.zeros((T, B), dtype=v.dtype,
                                       device=dev).scatter_add_(1, ids64, v)}
    dev_ms = {k: device_ms(f) for k, f in timed.items()}
    print(f"segment_sum tree shape ({T},{R})->{B} device time per call "
          f"(CUDA graph replay): " + ", ".join(
              f"{k} {ms * 1e3:.3f} us" for k, ms in dev_ms.items()))
    from repro_torch.kernels.segment_sum import work
    bound_ms, bound_by = _bound(*work(v, ids, B), v.dtype)
    return {"tree_shape": [T, R, B], "tree_max_abs_err": err,
            "tree_ms": dev_ms["kernel"], "tree_plain_ms": dev_ms["plain"],
            "tree_library_ms": dev_ms["library"], "tree_bound_ms": bound_ms,
            "tree_bound_by": bound_by}


def _randn(shape, dtype, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _attn_err(got, want, dtype) -> float:
    """Fail unless ``got`` is within the dtype's tolerance of ``want``;
    returns the largest absolute difference."""
    import torch
    tol = ATTN_TOL[str(dtype)]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return float((got.float() - want.float()).abs().max())


def _bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _timed(name: str, timed: dict, inner: int) -> dict:
    dev_ms = {k: device_ms(f, repeats=7, inner=inner)
              for k, f in timed.items()}
    print(f"{name} device time per call (CUDA graph replay): "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in dev_ms.items()))
    return dev_ms


def check_flash(dev, S: int) -> dict:
    """Hold the flash-attention kernels against their plain version (the
    serving paths' prefill shapes at padded length ``S``, the sweep of
    tests/test_kernels.py, ragged lengths, head dims 256 and 40, q, k, v
    as views of one fused tensor), asserting which kernel each call took;
    time them at the path shape.  Returns the ``kernels`` entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    def counts():
        return flash_attention.tc_launches, flash_attention.fma_launches

    def checked(q, k, v, causal, variant, label):
        before = counts()
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == ((1, 0) if variant == "tc" else (0, 1)), \
            f"flash {label}: took {moved} (tc, fma) launches, not {variant}"
        err = _attn_err(got, flash_attention_plain(q, k, v, causal),
                        q.dtype)
        print(f"flash {label} {str(q.dtype)[6:]} causal={causal} "
              f"[{variant}]: max_abs_err {err:.3e} "
              f"(tol {ATTN_TOL[str(q.dtype)]})")
        return err

    def case(B, Sq, H, KV, D, dtype, causal, seed=0):
        q = _randn((B, Sq, H, D), dtype, dev, seed)
        k = _randn((B, Sq, KV, D), dtype, dev, seed + 1)
        v = _randn((B, Sq, KV, D), dtype, dev, seed + 2)
        variant = "tc" if dtype == torch.bfloat16 and D % 16 == 0 \
            and H // KV <= 128 else "fma"
        err = checked(q, k, v, causal, variant, f"({B},{Sq},{H}/{KV},{D})")
        return q, k, v, err

    B, H, KV, D = SERVE["max_batch"], 28, 4, 128
    q, k, v, path_err = case(B, S, H, KV, D, torch.bfloat16, True)
    for shape in ((1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 128, 8, 1, 16),
                  (1, 777, 28, 4, 128), (2, 1000, 8, 2, 64),
                  (1, 300, 4, 2, 256), (3, 100, 6, 3, 16),
                  (B, 910, 32, 4, 128), (2, 200, 6, 2, 40)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                case(*shape, dtype, causal, seed=3)
    # phase 9's prefill waves: 1 to max_batch rows padded to at most the
    # longest prompt
    for b in range(1, ROUTER_ENGINE["max_batch"] + 1):
        for s in (PROMPT_LEN[0] + 1, 700, PROMPT_LEN[1]):
            case(b, s, H, KV, D, torch.bfloat16, True, seed=20 + b)
    # q, k, v as views of one fused (B, S, H + 2 KV, D) tensor: aligned
    # rows take the tensor cores; one element off, the FMA kernel
    n = 2 * 300 * (H + 2 * KV) * D
    for off, variant in ((0, "tc"), (1, "fma")):
        qkv = _randn((n + off,), torch.bfloat16, dev, 5)[off:].view(
            2, 300, H + 2 * KV, D)
        for causal in (True, False):
            checked(qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:],
                    causal, variant, f"fused qkv views, offset {off}")

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timed = {
        "kernel": lambda: flash_attention(q, k, v, causal=True),
        "plain": lambda: flash_attention_plain(q, k, v, True),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)}
    lib = timed["library"]().transpose(1, 2)
    print(f"flash library (SDPA) vs kernel at the path shape: max_abs_diff "
          f"{float((lib.float() - flash_attention(q, k, v).float()).abs().max()):.3e}")
    dev_ms = _timed("flash_attention", timed, inner=10)
    from repro_torch.kernels.flash_attention import work
    nbytes, ops = work(q, k, v, True)
    bound_ms, bound_by = _bound(nbytes, ops, q.dtype)
    print(f"flash at the path shape ({B},{S},{H}/{KV},{D}) bf16 causal "
          f"[tc]: {ops / 1e9:.2f} GFLOP, {ops / dev_ms['kernel'] / 1e9:.1f} "
          f"TFLOP/s, {bound_ms / dev_ms['kernel'] * 100:.1f} % of the "
          f"{bound_ms * 1e3:.2f} us bound ({bound_by}); SDPA "
          f"{ops / dev_ms['library'] / 1e9:.1f} TFLOP/s, kernel / SDPA "
          f"{dev_ms['kernel'] / dev_ms['library']:.3f}")
    # the FMA kernel on the same values, q one element off its 16-byte
    # alignment: the kernel this path took before the tensor-core one
    qf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(
        q.shape).copy_(q)
    checked(qf, k, v, True, "fma", f"({B},{S},{H}/{KV},{D}), q misaligned")
    fma_ms = device_ms(lambda: flash_attention(qf, k, v, causal=True),
                       repeats=5, inner=3)
    print(f"flash FMA kernel at the path shape: {fma_ms * 1e3:.2f} us, "
          f"{ops / fma_ms / 1e9:.1f} TFLOP/s; the tensor-core kernel is "
          f"{fma_ms / dev_ms['kernel']:.1f}x faster")
    del qf
    # the MoE path's shape (32 heads over 4, G = 8) at its first wave's
    # padded length, kernel against SDPA
    Sm, Hm = 910, 32
    qm = _randn((B, Sm, Hm, D), torch.bfloat16, dev, 11)
    km, vm = (_randn((B, Sm, KV, D), torch.bfloat16, dev, 12 + i)
              for i in range(2))
    qmt, kmt, vmt = (t.transpose(1, 2) for t in (qm, km, vm))
    moe_ms = _timed("flash_attention (8,910,32/4,128)", {
        "kernel": lambda: flash_attention(qm, km, vm, causal=True),
        "library": lambda: F.scaled_dot_product_attention(
            qmt, kmt, vmt, is_causal=True, enable_gqa=True)}, inner=10)
    ops_m = work(qm, km, vm, True)[1]
    print(f"flash at (8,910,32/4,128) bf16 causal [tc]: "
          f"{ops_m / moe_ms['kernel'] / 1e9:.1f} TFLOP/s, SDPA "
          f"{ops_m / moe_ms['library'] / 1e9:.1f} TFLOP/s")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "variant": "tc",
            "launches": 0, "max_abs_err": path_err, "ms": dev_ms["kernel"],
            "plain_ms": dev_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": dev_ms["library"]}


def check_decode(dev, plen: int) -> dict:
    """Hold the flash-decoding kernel against its plain version (the
    serving path's decode shape, mid-wave at kv_len = plen + 16 of a
    max_seq cache, the sweep of tests/test_kernels.py, every kv_len from
    1 to S, ragged S, head dim 256); time it at the path shape.  Returns
    its ``kernels`` entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)

    def counts():
        return (decode_attention.launches, decode_attention.mma_launches,
                decode_attention.fma_launches)

    def case(B, S, H, KV, D, dtype, lens, seed=0):
        q = _randn((B, 1, H, D), dtype, dev, seed)
        k = _randn((B, S, KV, D), dtype, dev, seed + 1)
        v = _randn((B, S, KV, D), dtype, dev, seed + 2)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        variant = "mma" if dtype == torch.bfloat16 and D % 16 == 0 \
            and H // KV <= 16 else "fma"
        before = counts()
        got = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == (1, int(variant == "mma"), int(variant == "fma")), \
            f"decode took {moved} (all, mma, fma) launches, not one {variant}"
        live = lens > 0
        assert torch.count_nonzero(got[~live]) == 0, "kv_len 0 not zeros"
        err = _attn_err(got[live], decode_attention_plain(
            q[live], k[live], v[live], lens[live]), dtype)
        print(f"decode ({B},{S},{H}/{KV},{D}) {str(dtype)[6:]} kv_len "
              f"{int(lens.min())}..{int(lens.max())} [{variant}]: "
              f"max_abs_err {err:.3e} (tol {ATTN_TOL[str(dtype)]})")
        return q, k, v, lens, err

    B, S, H, KV, D = SERVE["max_batch"], SERVE["max_seq"], 28, 4, 128
    kv = plen + NEW_TOKENS // 2
    q, k, v, lens, path_err = case(B, S, H, KV, D, torch.bfloat16, [kv] * B)
    for (b, s, h, g, d) in ((2, 128, 4, 4, 32), (1, 256, 8, 2, 64),
                            (3, 64, 8, 1, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            sweep = [min((i + 1) * (s // 2), s) for i in range(b)]
            case(b, s, h, g, d, dtype, sweep, seed=5)
            case(b, s, h, g, d, dtype, [1] * b, seed=5)
            case(b, s, h, g, d, dtype, [s] * b, seed=5)
    for dtype in (torch.float32, torch.bfloat16):
        case(100, 100, 4, 2, 32, dtype, list(range(1, 101)), seed=7)
        case(4, 777, 28, 4, 128, dtype, [1, 64, 65, 777], seed=7)
        case(2, 300, 8, 1, 256, dtype, [299, 300], seed=7)
        # every kv_len from 1 to S at the path's heads, one row each
        case(300, 300, H, KV, D, dtype, list(range(1, 301)), seed=9)
        # one (batch, kv head) pair: ~2 x 132 splits, so lengths below
        # the split count leave most splits empty; kv_len 0 gives zeros
        case(18, 4096, 7, 1, D, dtype, list(range(18)), seed=9)
        case(3, 256, H, KV, D, dtype, [0, 256, 0], seed=9)
    # phase 9's decode waves: 1 to max_batch rows of a max_seq cache take
    # more splits a (batch, kv head) than the path shape above, at kv_len
    # from 1 through the waves' lengths to max_seq, equal and ragged
    from repro_torch.kernels import decode_attention as decode_mod
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    RB, RS = ROUTER_ENGINE["max_batch"], ROUTER_ENGINE["max_seq"]
    splits = {b: decode_mod._splits(b, KV, RS, n_sm)
              for b in range(1, RB + 1)}
    print(f"decode: phase 9's waves take {splits} splits (B: splits)")
    for b in splits:
        for n in (1, PROMPT_LEN[0] + 1, 700, PROMPT_LEN[1] + ROUTER_NEW_TOKENS,
                  RS):
            case(b, RS, H, KV, D, torch.bfloat16, [n] * b, seed=20 + b)
        case(b, RS, H, KV, D, torch.bfloat16, [1, 513, 1030, RS][:b],
             seed=30 + b)
    # two CUDA-graph replays give the same bits (each call's last CTAs
    # reset their ticket counters)
    ragged = torch.tensor([kv, 1, 7, 64, 65, S, 500, 999], dtype=torch.int32,
                          device=dev)
    eager = decode_attention(q, k, v, ragged)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = decode_attention(q, k, v, ragged)
    outs = []
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        outs.append(replayed.clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], eager), \
        "decode: CUDA-graph replays differ"
    print("decode: two CUDA-graph replays and the eager call bit-identical")

    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timed = {
        "kernel": lambda: decode_attention(q, k, v, lens),
        "plain": lambda: decode_attention_plain(q, k, v, lens),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)}
    lib = timed["library"]().transpose(1, 2)
    print(f"decode library (SDPA) vs kernel at the path shape: "
          f"max_abs_diff {float((lib.float() - decode_attention(q, k, v, lens).float()).abs().max()):.3e}")
    dev_ms = _timed("decode_attention", timed, inner=50)
    # the split rule (every CTA resident at once, two an SM) against
    # other split counts at the path shape, by swapping the rule; every
    # count's output is held against the plain version too
    rule = decode_mod._splits
    picked = rule(B, KV, S, n_sm)
    want = decode_attention_plain(q, k, v, lens)
    swept, errs = {}, {}
    try:
        for n in sorted({4, 6, picked, picked + 1, 12, 16, 32, 64}):
            decode_mod._splits = lambda *_, n=n: n
            errs[n] = _attn_err(decode_attention(q, k, v, lens), want,
                                q.dtype)
            swept[n] = device_ms(lambda: decode_attention(q, k, v, lens),
                                 repeats=7, inner=50)
    finally:
        decode_mod._splits = rule
    print(f"decode split sweep at the path shape (the rule picks {picked}): "
          + ", ".join(f"{n}: {t * 1e3:.2f} us (err {errs[n]:.1e})"
                      for n, t in swept.items()))
    # one call is one kernel on the device (the combine is folded in).
    # A trace that holds no device event at all is the tracer missing
    # the card, not a kernel-free call: trace again, up to three times
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        if events:
            break
        print(f"decode: trace {attempt + 1} recorded no device event")
    ran = {e.key: e.count for e in events if not e.key.startswith("Mem")}
    assert sum(ran.values()) == 1, f"decode ran {ran}, not one kernel"
    print(f"decode: one call ran one kernel on the device: {ran}")
    from repro_torch.kernels.decode_attention import work
    nbytes, ops = work(q, k, v, int(lens.sum()))
    bound_ms, bound_by = _bound(nbytes, ops, q.dtype)
    print(f"decode at the path shape ({B},{S},{H}/{KV},{D}) bf16 kv_len "
          f"{kv} [mma]: {nbytes / dev_ms['kernel'] / 1e6:.1f} GB/s, "
          f"{bound_ms / dev_ms['kernel'] * 100:.1f} % of the "
          f"{bound_ms * 1e3:.2f} us bound ({bound_by}); kernel / SDPA "
          f"{dev_ms['kernel'] / dev_ms['library']:.3f}")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:65",
            "variant": "mma", "launches": 0, "max_abs_err": path_err,
            "ms": dev_ms["kernel"],
            "plain_ms": dev_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": dev_ms["library"]}


def check_ssd(dev, L: int) -> dict:
    """Hold the SSD kernels against their plain version (the Mamba2 path's
    prefill shape at padded length ``L``, the sweep of
    tests/test_kernels.py, one partial chunk, G = 2, a chunk that is no
    multiple of 64, zamba2-2.7b's N = 64, and the strong decay A = -16,
    dt = 0.1, where exp of the upper triangle overflows), asserting which
    kernel each call took; time the tensor-core kernel on the path's bf16
    inputs and the FMA kernel on the same values in f32.  Returns the
    ``kernels`` entry (launches are filled in from the main-path run)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd import ssd, ssd_plain

    def counts():
        return ssd.launches, ssd.tc_launches, ssd.fma_launches

    def checked(args, chunk, variant, label):
        before = counts()
        y, state = ssd(*args, chunk=chunk)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == (1, int(variant == "tc"), int(variant == "fma")), \
            f"ssd {label}: took {moved} (all, tc, fma) launches, not {variant}"
        assert bool(torch.isfinite(y).all() & torch.isfinite(state).all()), \
            f"ssd {label}: not finite"
        want_y, want_state = ssd_plain(*args, chunk)
        tol = SSD_TOL[str(args[0].dtype)]
        torch.testing.assert_close(y, want_y, rtol=tol, atol=tol)
        torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
        err = max(float((y - want_y).abs().max()),
                  float((state - want_state).abs().max()))
        print(f"ssd {label} {str(args[0].dtype)[6:]} [{variant}]: finite, "
              f"max_abs_err {err:.3e} (tol {tol})")
        return err

    def case(B, L, H, P, G, N, chunk, dtype, strong=False, seed=0):
        x = _randn((B, L, H, P), dtype, dev, seed)
        Bm = _randn((B, L, G, N), dtype, dev, seed + 1)
        Cm = _randn((B, L, G, N), dtype, dev, seed + 2)
        if strong:
            dt = torch.full((B, L, H), 0.1, device=dev)
            A = torch.full((H,), -16.0, device=dev)
        else:
            dt = F.softplus(_randn((B, L, H), torch.float32, dev, seed + 3))
            A = -_randn((H,), torch.float32, dev, seed + 4).exp()
        # the tensor cores take bf16 with P, N multiples of 8, chunks <= 256
        variant = "tc" if dtype == torch.bfloat16 and P % 8 == 0 \
            and N % 8 == 0 and min(chunk, L) <= 256 else "fma"
        args = (x, dt, A, Bm, Cm)
        label = (f"({B},{L},{H},{P}) G={G} N={N} chunk {chunk}"
                 f"{' A=-16 dt=0.1' if strong else ''}")
        return args, checked(args, chunk, variant, label)

    s = get_config(MAMBA_ARCH).ssm
    d_model = get_config(MAMBA_ARCH).d_model
    B, H, P, G, N, Q = (SERVE["max_batch"], s.n_heads(d_model), s.head_dim,
                        s.n_groups, s.d_state, s.chunk_size)
    args, path_err = case(B, L, H, P, G, N, Q, torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((1, 64, 2, 8, 1, 4, 16), (2, 128, 4, 16, 2, 8, 32),
                      (1, 256, 8, 32, 1, 16, 64),     # tests/test_kernels.py
                      (2, 40, 4, 16, 1, 16, 256),     # L < chunk
                      (2, 512, 8, 64, 2, 128, 256),   # G = 2
                      (2, 200, 4, 64, 2, 128, 100),   # chunk not 64k
                      (2, 512, 8, 64, 1, 64, 256),    # zamba2-2.7b's P, N
                      (1, 64, 8, 16, 1, 16, 32)):     # the smoke configs'
            case(*shape, dtype, seed=5)
        case(1, 512, 8, 64, 1, 128, 256, dtype, strong=True, seed=6)
    case(B, 200, H, P, G, N, Q, torch.bfloat16, seed=7)   # one partial chunk
    # the FMA kernel on the path's bf16 values, x one element off its
    # 16-byte alignment: what the rounding of the tensor-core kernel costs
    x, dt, A, Bm, Cm = args
    xm = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(
        x.shape).copy_(x)
    fma_err = checked((xm, dt, A, Bm, Cm), Q, "fma",
                      f"({B},{L},{H},{P}) G={G} N={N}, x misaligned")
    del xm
    f32_args = (x.float(), dt, A, Bm.float(), Cm.float())
    f32_err = checked(f32_args, Q, "fma", f"({B},{L},{H},{P}) G={G} N={N}")

    timed = {"kernel": lambda: ssd(*args, chunk=Q),
             "plain": lambda: ssd_plain(*args, chunk=Q)}
    dev_ms = _timed("ssd", timed, inner=10)
    fma_ms = device_ms(lambda: ssd(*f32_args, chunk=Q), repeats=5, inner=3)
    nbytes, ops = ssd_work(args, Q)
    bound_ms, bound_by = _bound(nbytes, ops, x.dtype)
    fma_bound, fma_by = _bound(ssd_work(f32_args, Q)[0], ops, torch.float32)
    ms = dev_ms["kernel"]
    print(f"ssd at the path shape ({B},{L},{H},{P}) G={G} N={N} chunk {Q} "
          f"bf16 [tc]: {ms * 1e3:.2f} us, {ops / 1e9:.2f} GFLOP counted "
          f"({ops / ms / 1e9:.1f} TFLOP/s), {nbytes / 1e6:.1f} MB "
          f"({nbytes / ms / 1e6:.1f} GB/s), {bound_ms / ms * 100:.1f} % "
          f"of the {bound_ms * 1e3:.2f} us bound ({bound_by}); max_abs_err "
          f"{path_err:.3e}, the FMA kernel's on the same bf16 inputs "
          f"{fma_err:.3e}")
    print(f"ssd FMA kernel at the path shape in f32: {fma_ms * 1e3:.2f} us, "
          f"{fma_bound / fma_ms * 100:.1f} % of its {fma_bound * 1e3:.2f} us "
          f"bound ({fma_by}), max_abs_err {f32_err:.3e}; the tensor-core "
          f"kernel is {fma_ms / ms:.1f}x faster")
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:78",
            "variant": "tc", "launches": 0, "tc_launches": 0,
            "fma_launches": 0, "max_abs_err": path_err, "ms": ms,
            "plain_ms": dev_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "fma": {"dtype": "float32", "ms": fma_ms, "bound_ms": fma_bound,
                    "bound_by": fma_by, "max_abs_err": f32_err,
                    "max_abs_err_bf16_inputs": fma_err}}


def ssd_work(args, Q: int) -> tuple:
    """The bytes and operations of one SSD call on ``args`` (x, dt, A, Bm,
    Cm) at chunk ``Q`` (``kernels/ssd.py::work``)."""
    from repro_torch.kernels.ssd import work
    return work(args[0], args[3], Q)


def check_catalogue_shapes(dev, hybrid_len: int, plen: int) -> dict:
    """Hold flash, flash-decoding and SSD against their plain versions at
    the shapes the rest of the catalogue gives them (Zamba2's shared block
    at head dim 160 and padded prompt ``hybrid_len``, its N = 64 scan;
    MLA's prefill at D 96 / Dv 64 with v a view of the expanded latent;
    seamless's cross-attention over 8 encoder frames, in prefill and
    decode; MLA's and seamless's prompts padded to ``plen``), asserting
    the tensor-core variant; time kernel, plain version and SDPA (SSD: no
    library call).  Returns name -> list of per-shape entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention import work as decode_work
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import work as flash_work
    from repro_torch.kernels.ssd import ssd, ssd_plain
    wrappers = {"flash_attention": flash_attention,
                "decode_attention": decode_attention, "ssd": ssd}
    bf16 = torch.bfloat16
    B = SERVE["max_batch"]
    out = {n: [] for n in wrappers}

    def entry(name, label, variant, run, plain, library, nbytes, ops, err):
        k = wrappers[name]
        before = getattr(k, f"{variant}_launches")
        run()
        torch.cuda.synchronize()
        assert getattr(k, f"{variant}_launches") == before + 1, \
            f"{name} {label} missed the {variant} kernel"
        timed = {"kernel": run, "plain": plain}
        if library is not None:
            timed["library"] = library
        ms = _timed(f"{name} {label}", timed, inner=10)
        bound_ms, bound_by = _bound(nbytes, ops, bf16)
        lib = ("" if library is None else
               f", SDPA {ms['library'] * 1e3:.2f} us (kernel / SDPA "
               f"{ms['kernel'] / ms['library']:.3f})")
        print(f"{name} {label} bf16 [{variant}]: max_abs_err {err:.3e}, "
              f"{ms['kernel'] * 1e3:.2f} us, {bound_ms / ms['kernel'] * 100:.1f}"
              f" % of the {bound_ms * 1e3:.2f} us bound ({bound_by}){lib}")
        out[name].append({"shape": label, "variant": variant,
                          "max_abs_err": err, "ms": ms["kernel"],
                          "plain_ms": ms["plain"], "bound_ms": bound_ms,
                          "bound_by": bound_by,
                          "library_ms": ms.get("library")})

    def flash_case(label, q, k, v, causal):
        err = _attn_err(flash_attention(q, k, v, causal=causal),
                        flash_attention_plain(q, k, v, causal), bf16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        entry("flash_attention", label, "tc",
              lambda: flash_attention(q, k, v, causal=causal),
              lambda: flash_attention_plain(q, k, v, causal),
              lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal),
              *flash_work(q, k, v, causal), err)

    def decode_case(label, S, H, D, kv):
        q = _randn((B, 1, H, D), bf16, dev, 40)
        k, v = (_randn((B, S, H, D), bf16, dev, 41 + i) for i in range(2))
        lens = torch.full((B,), kv, dtype=torch.int32, device=dev)
        err = _attn_err(decode_attention(q, k, v, lens),
                        decode_attention_plain(q, k, v, lens), bf16)
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        entry("decode_attention", label, "mma",
              lambda: decode_attention(q, k, v, lens),
              lambda: decode_attention_plain(q, k, v, lens),
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, attn_mask=mask[:, None, None, :]),
              *decode_work(q, k, v, B * kv), err)

    hyb = get_config(HYBRID_ARCH)
    Hh, Dh = hyb.hybrid.shared_num_heads, hyb.head_dim
    flash_case(f"({B},{hybrid_len},{Hh}/{Hh},{Dh}) causal",
               *(_randn((B, hybrid_len, Hh, Dh), bf16, dev, 30 + i)
                 for i in range(3)), True)
    mla = get_config(MLA_ARCH)
    m, Hm = mla.mla, mla.num_heads
    Dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    kv = _randn((B, plen, Hm, m.qk_nope_head_dim + m.v_head_dim), bf16,
                dev, 34)
    flash_case(f"({B},{plen},{Hm}/{Hm},{Dq}/{m.v_head_dim}) causal, v a "
               f"view", _randn((B, plen, Hm, Dq), bf16, dev, 35),
               _randn((B, plen, Hm, Dq), bf16, dev, 36),
               kv[..., m.qk_nope_head_dim:], True)
    enc = get_config(ENCDEC_ARCH)
    He, De, Se = enc.num_heads, enc.head_dim, 8
    flash_case(f"({B},{plen}->{Se},{He}/{He},{De}) cross",
               _randn((B, plen, He, De), bf16, dev, 37),
               *(_randn((B, Se, He, De), bf16, dev, 38 + i)
                 for i in range(2)), False)
    decode_case(f"({B},{SERVE['max_seq']},{Hh}/{Hh},{Dh}) kv_len "
                f"{hybrid_len + NEW_TOKENS // 2}", SERVE["max_seq"], Hh, Dh,
                hybrid_len + NEW_TOKENS // 2)
    decode_case(f"({B},{Se},{He}/{He},{De}) cross kv_len {Se}", Se, He, De,
                Se)
    s = hyb.ssm
    H, P, N, Q = s.n_heads(hyb.d_model), s.head_dim, s.d_state, s.chunk_size
    args = (_randn((B, hybrid_len, H, P), bf16, dev, 50),
            F.softplus(_randn((B, hybrid_len, H), torch.float32, dev, 51)),
            -_randn((H,), torch.float32, dev, 52).exp(),
            _randn((B, hybrid_len, s.n_groups, N), bf16, dev, 53),
            _randn((B, hybrid_len, s.n_groups, N), bf16, dev, 54))
    y, state = ssd(*args, chunk=Q)
    want_y, want_state = ssd_plain(*args, Q)
    tol = SSD_TOL[str(bf16)]
    torch.testing.assert_close(y, want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
    err = max(float((y - want_y).abs().max()),
              float((state - want_state).abs().max()))
    entry("ssd", f"({B},{hybrid_len},{H},{P}) G={s.n_groups} N={N} chunk "
          f"{Q}", "tc", lambda: ssd(*args, chunk=Q),
          lambda: ssd_plain(*args, Q), None, *ssd_work(args, Q), err)
    return out


def moe_path_rows(cfg, plens) -> tuple:
    """The grouped matmul's C (= G * cap) at each wave's prefill (B =
    max_batch tokens of each padded length) and at a decode step (B
    tokens), from the MoE layer's own group and capacity rules."""
    from repro_torch.models.moe import capacity, dispatch_groups
    m, B = cfg.moe, SERVE["max_batch"]

    def rows(T):
        G = dispatch_groups(T, m.num_groups)
        return G * capacity(T // G, m.top_k, m.num_experts,
                            m.capacity_factor)
    return [rows(B * n) for n in plens], rows(B)


def check_gmm(dev, prefill_cs, decode_c: int) -> dict:
    """Hold the grouped-matmul kernel against its plain version (the MoE
    path's prefill and decode shapes in both orientations, wi/wg (D -> F)
    and wo (F -> D), bf16; the sweep of tests/test_kernels.py and ragged
    C = 1, 5, 100 in f32 and bf16); time kernel, plain version and
    ``torch.bmm`` at the largest prefill C and at the decode C.  Returns
    its ``kernels`` entry (the prefill shape's numbers)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gmm import gmm, gmm_plain
    from repro_torch.kernels.gmm import work as gmm_work

    def counts():
        return gmm.launches, gmm.wgmma_launches, gmm.fma_launches

    def case(E, C, D, F, dtype, seed=0, scale=1.0):
        x = _randn((E, C, D), dtype, dev, seed)
        w = (_randn((E, D, F), torch.float32, dev, seed + 1) * scale) \
            .to(dtype)
        variant = "wgmma" if dtype == torch.bfloat16 else "fma"
        before = counts()
        got = gmm(x, w)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == (1, int(variant == "wgmma"), int(variant == "fma")), \
            f"gmm took {moved} (all, wgmma, fma) launches, not {variant}"
        want = gmm_plain(x, w)
        tol = GMM_TOL[str(dtype)]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        err = float((got.float() - want.float()).abs().max())
        print(f"gmm ({E},{C},{D})x({D},{F}) {str(dtype)[6:]} [{variant}]: "
              f"max_abs_err {err:.3e} (rtol = atol = {tol})")
        return x, w, err

    cfg = get_config(MOE_ARCH)
    E, D, Fd = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    big = max(prefill_cs)
    path = {}
    for C in sorted(set(prefill_cs)) + [decode_c]:
        for d, f in ((D, Fd), (Fd, D)):
            # the weights at the model's scale (d^-1/2), outputs O(1)
            path[C, d] = case(E, C, d, f, torch.bfloat16, seed=C,
                              scale=d ** -0.5)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 64, 32, 48), (4, 128, 64, 64), (1, 32, 16, 128),
                      (3, 1, 32, 48), (2, 5, 64, 16), (4, 100, 48, 80)):
            case(*shape, dtype, seed=3)
    # row counts on both sides of the decode operand swap (C <= 16) and of
    # the 128-row tile edge, at both widths, one expert and all of them
    for e in (1, E):
        for d, f in ((D, Fd), (Fd, D)):
            for C in (1, 4, 5, 100, 112, 128, 576, 608, 624, 625):
                case(e, C, d, f, torch.bfloat16, seed=7, scale=d ** -0.5)

    entries = {}
    for C in (big, decode_c):
        x, w, _ = path[C, D]
        timed = {"kernel": lambda: gmm(x, w),
                 "plain": lambda: gmm_plain(x, w),
                 "library": lambda: torch.bmm(x, w)}
        lib = float((timed["library"]().float() - gmm(x, w).float())
                    .abs().max())
        print(f"gmm library (torch.bmm) vs kernel at C = {C}: max_abs_diff "
              f"{lib:.3e}")
        dev_ms = _timed(f"gmm C={C}", timed, inner=10)
        nbytes, ops = gmm_work(x, w)
        bound_ms, bound_by = _bound(nbytes, ops, x.dtype)
        print(f"gmm C={C}: bound {bound_ms * 1e3:.2f} us ({bound_by}), "
              f"{ops / dev_ms['kernel'] / 1e9:.1f} TFLOP/s, "
              f"{nbytes / dev_ms['kernel'] / 1e6:.1f} GB/s")
        entries[C] = dict(ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=dev_ms["library"])
        print(f"gmm C={C}: kernel / torch.bmm "
              f"{dev_ms['kernel'] / dev_ms['library']:.3f}")
    return {"name": "gmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:49",
            "variant": "wgmma", "launches": 0,
            "max_abs_err": path[big, D][2], **entries[big],
            "decode": {"C": decode_c, "max_abs_err": path[decode_c, D][2],
                       **entries[decode_c]}}


def _rel_err(got, want, dtype, label, tols=None) -> float:
    """Fail unless ``got`` is within the dtype's tolerance (``tols``,
    ATTN_TOL by default) of ``want``, as the largest absolute difference
    over the largest absolute value of ``want``; returns the largest
    absolute difference."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = (tols or ATTN_TOL)[str(dtype)]
    assert diff <= tol * max(scale, 1e-30), \
        f"{label}: max_abs_err {diff:.3e} over {scale:.3e} > {tol}"
    return diff


def _earlier_kernel(module, fn, variant: str = "fma"):
    """``fn`` with ``module``'s backward wrapper routed to the kernel that
    its bf16 tensor-core kernel replaced (``_bwd_variant`` answering
    ``variant``: flash attention's and SSD's FMA kernels, ``gmm``'s
    ``"mma"``), timed in the same call beside it."""
    def run():
        chosen = module._bwd_variant
        module._bwd_variant = lambda *args, **kw: variant
        try:
            return fn()
        finally:
            module._bwd_variant = chosen
    return run


def check_backward(dev) -> list:
    """Hold the backward kernels against their plain versions: flash
    attention's at the training shape (4, 1024, 32/4, 128) bf16 causal,
    MLA's (4, 1024, 40/40, 96/64, v a view) causal and a cross shape
    (4, 1024 -> 8, 16/16, 64), the smoke configs' widths and ragged
    lengths in f32 and bf16; ``gmm``'s at the training shape (128, 320,
    2048) x (128, 2048, 768) in both orientations and a ragged sweep,
    each call asserted on its kernel (bf16 ``wgmma``, f32 ``fma``).
    Each is timed (device ms by CUDA-graph replay) beside its plain
    version and a library call: SDPA's backward alone (``torch.autograd.
    grad`` on a graph built once, eager, CUDA events: its autograd runs on
    the forward's stream, which a capture cannot take) and two
    ``torch.bmm``.  Flash attention's bf16 tensor-core kernel is timed
    beside the FMA kernel it replaced, ``gmm``'s (both orientations)
    beside its mma.sync kernel (``earlier_ms``).  Returns the two
    ``kernels`` entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import (
        _flash_forward, flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels import gmm as gmm_mod
    from repro_torch.kernels.gmm import gmm_bwd, gmm_bwd_plain

    def flash_case(B, Sq, Skv, H, KV, D, Dv, dtype, causal, seed=0,
                   v_view=False):
        q = _randn((B, Sq, H, D), dtype, dev, seed)
        k = _randn((B, Skv, KV, D), dtype, dev, seed + 1)
        if v_view:    # MLA: v a view of the expanded latent, head stride
            kv = _randn((B, Skv, KV, D - 32 + Dv), dtype, dev, seed + 2)
            v = kv[..., D - 32:]
        else:
            v = _randn((B, Skv, KV, Dv), dtype, dev, seed + 2)
        do = _randn((B, Sq, H, Dv), dtype, dev, seed + 3)
        o, lse = _flash_forward(q, k, v, causal, True)
        before = flash_attention_bwd.launches
        variant = "tc" if dtype == torch.bfloat16 and D % 16 == 0 \
            and Dv % 16 == 0 else "fma"
        taken = getattr(flash_attention_bwd, f"{variant}_launches")
        got = flash_attention_bwd(q, k, v, o, do, lse, causal)
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches == before + 1
        assert getattr(flash_attention_bwd, f"{variant}_launches") \
            == taken + 1, f"flash bwd did not take its {variant} kernel"
        want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal)
        label = (f"flash bwd ({B},{Sq}->{Skv},{H}/{KV},{D}/{Dv}) "
                 f"{str(dtype)[6:]} causal={causal}")
        err = max(_rel_err(g, w, dtype, f"{label} d{n}")
                  for g, w, n in zip(got, want, "qkv"))
        print(f"{label}: max_abs_err {err:.3e} (tol "
              f"{ATTN_TOL[str(dtype)]} of the largest value)")
        return (q, k, v, o, do, lse), err

    bf16 = torch.bfloat16
    train, train_err = flash_case(4, 1024, 1024, 32, 4, 128, 128, bf16, True)
    flash_case(4, 1024, 1024, 40, 40, 96, 64, bf16, True, v_view=True)
    flash_case(4, 1024, 8, 16, 16, 64, 64, bf16, False)
    for dtype in (torch.float32, bf16):
        for shape in ((2, 32, 32, 4, 2, 16, 16, True),    # smoke widths
                      (2, 32, 32, 4, 2, 12, 12, True),
                      (2, 32, 32, 4, 4, 16, 8, True),
                      (2, 32, 8, 4, 4, 16, 16, False),
                      (1, 777, 777, 28, 4, 128, 128, True),
                      (2, 100, 100, 6, 3, 96, 64, True),
                      (1, 65, 65, 2, 1, 160, 160, True),
                      (1, 33, 40, 2, 2, 256, 256, False)):
            flash_case(*shape[:7], dtype, shape[7], seed=5)

    q, k, v, o, do, lse = train
    B, S, H, D = q.shape
    KV = k.shape[2]
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          enable_gqa=True)
    dot = do.transpose(1, 2)
    flash_ms = _timed("flash_attention_bwd (4,1024,32/4,128)", {
        "kernel": lambda: flash_attention_bwd(q, k, v, o, do, lse, True),
        "earlier (FMA) kernel": _earlier_kernel(
            fa, lambda: flash_attention_bwd(q, k, v, o, do, lse, True)),
        "plain": lambda: flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                   True)}, inner=5)
    flash_ms["library"] = call_ms(
        lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                    retain_graph=True), repeats=7, inner=10)
    print(f"flash_attention_bwd library (SDPA backward, eager) "
          f"{flash_ms['library'] * 1e3:.2f} us")
    nbytes, ops = fa.work(q, k, v, True, backward=True)
    bound_ms, bound_by = _bound(nbytes, ops, q.dtype)
    print(f"flash bwd at the training shape: {ops / 1e9:.1f} GFLOP, "
          f"{ops / flash_ms['kernel'] / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / flash_ms['kernel'] * 100:.1f} % of the "
          f"{bound_ms * 1e3:.2f} us bound ({bound_by}); SDPA backward "
          f"{ops / flash_ms['library'] / 1e9:.1f} TFLOP/s; the earlier FMA "
          f"kernel {flash_ms['earlier (FMA) kernel'] * 1e3:.2f} us")
    del sdpa, qt, kt, vt, train

    def gmm_case(E, C, D, F, dtype, seed=0):
        x = _randn((E, C, D), dtype, dev, seed) * D ** -0.25
        w = _randn((E, D, F), dtype, dev, seed + 1) * D ** -0.25
        dy = _randn((E, C, F), dtype, dev, seed + 2)
        variant = "wgmma" if dtype == bf16 else "fma"
        before = (gmm_bwd.launches, getattr(gmm_bwd, f"{variant}_launches"))
        got = gmm_bwd(x, w, dy)
        torch.cuda.synchronize()
        assert (gmm_bwd.launches, getattr(gmm_bwd, f"{variant}_launches")) \
            == (before[0] + 1, before[1] + 1), \
            f"gmm bwd did not take its {variant} kernel"
        want = gmm_bwd_plain(x, w, dy)
        label = f"gmm bwd ({E},{C},{D})x({D},{F}) {str(dtype)[6:]}"
        err = max(_rel_err(g, wt, dtype, f"{label} {n}")
                  for g, wt, n in zip(got, want, ("dx", "dw")))
        print(f"{label}: max_abs_err {err:.3e} (tol "
              f"{GMM_TOL[str(dtype)]} of the largest value)")
        return (x, w, dy), err

    from repro_torch.configs.base import get_config
    cfg = get_config(MOE_ARCH)
    E, Dm, Fd = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    C = train_gmm_rows(cfg)
    gtrain, gmm_err = gmm_case(E, C, Dm, Fd, bf16)
    gother, other_err = gmm_case(E, C, Fd, Dm, bf16, seed=1)
    for dtype in (torch.float32, bf16):
        for shape in ((4, 20, 48, 32), (3, 1, 32, 48), (2, 130, 256, 144),
                      (8, 4, 16, 16), (2, 64, 2048, 768), (3, 129, 48, 144),
                      (3, 65, 144, 48), (4, 624, 2048, 768)):
            gmm_case(*shape, dtype, seed=7)

    def gmm_timed(x, w, dy) -> dict:
        """The wgmma kernel beside the mma.sync kernel it replaced, the
        plain version and two torch.bmm; bound and rates printed."""
        E, C, D = x.shape
        F = w.shape[2]
        ms = _timed(f"gmm_bwd ({E},{C},{D})x({D},{F})", {
            "kernel": lambda: gmm_bwd(x, w, dy),
            "earlier (mma) kernel": _earlier_kernel(
                gmm_mod, lambda: gmm_bwd(x, w, dy), "mma"),
            "plain": lambda: gmm_bwd_plain(x, w, dy),
            "library": lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                torch.bmm(x.transpose(1, 2), dy))},
            inner=5)
        nbytes, ops = gmm_mod.work(x, w, backward=True)
        ms["bound"], ms["bound_by"] = _bound(nbytes, ops, x.dtype)
        print(f"gmm bwd ({E},{C},{D})x({D},{F}): {ops / 1e9:.1f} GFLOP, "
              f"{ops / ms['kernel'] / 1e9:.1f} TFLOP/s, "
              f"{ms['bound'] / ms['kernel'] * 100:.1f} % of the "
              f"{ms['bound'] * 1e3:.2f} us bound ({ms['bound_by']}); two "
              f"torch.bmm {ops / ms['library'] / 1e9:.1f} TFLOP/s; the "
              f"earlier mma.sync kernel "
              f"{ms['earlier (mma) kernel'] * 1e3:.2f} us")
        return ms

    gmm_ms = gmm_timed(*gtrain)
    other_ms = gmm_timed(*gother)
    return [
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:80",
         "backward_of": "flash_attention", "launches": 0,
         "max_abs_err": train_err, "ms": flash_ms["kernel"],
         "plain_ms": flash_ms["plain"], "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": flash_ms["library"],
         "earlier_ms": flash_ms["earlier (FMA) kernel"]},
        {"name": "gmm_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gmm_bwd.cu",
         "replaces": "src/repro/kernels/moe_gmm.py:49",
         "backward_of": "gmm", "variant": "wgmma", "launches": 0,
         "max_abs_err": gmm_err, "ms": gmm_ms["kernel"],
         "plain_ms": gmm_ms["plain"], "bound_ms": gmm_ms["bound"],
         "bound_by": gmm_ms["bound_by"], "library_ms": gmm_ms["library"],
         "earlier_ms": gmm_ms["earlier (mma) kernel"],
         "other_orientation": {
             "shape": [E, C, Fd, Dm], "max_abs_err": other_err,
             "ms": other_ms["kernel"], "plain_ms": other_ms["plain"],
             "bound_ms": other_ms["bound"], "bound_by": other_ms["bound_by"],
             "library_ms": other_ms["library"],
             "earlier_ms": other_ms["earlier (mma) kernel"]}}]


def ssd_bwd_work(args, Q: int, final: bool) -> tuple:
    """The bytes and operations of one SSD backward call on ``args`` (x,
    dt, A, Bm, Cm) at chunk ``Q``, dstate read when ``final``
    (``kernels/ssd.py::work``)."""
    from repro_torch.kernels.ssd import work
    return work(args[0], args[3], Q, backward=True, final=final)


def check_ssd_backward(dev) -> dict:
    """Hold the SSD backward kernel against its plain version on the
    card: at mamba2-1.3b's training shape (LM_TRAIN's B x S, 64 heads of
    64, N 128, chunk 256) and zamba2-2.7b's (80 heads, N 64) in bf16, with
    and without a final-state cotangent; G = 2 < H, f32, ragged chunks and
    the smoke widths; the strong decay (A -16, dt 0.1), outputs asserted
    finite.  Each call's per-chunk states from the forward kernel (the
    variant the model takes) are held to the plain version's first.  Time
    the kernels, the FMA kernel that the bf16 tensor-core ones replaced
    (``earlier_ms``) and the plain version at mamba2's shape beside the
    bound (no single PyTorch call computes it).  Returns the ``kernels``
    entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.kernels.ssd import (_ssd_forward, ssd_bwd,
                                         ssd_bwd_plain, ssd_plain)

    def case(B, L, H, P, G, N, chunk, dtype, strong=False, final=True,
             seed=0):
        x = _randn((B, L, H, P), dtype, dev, seed)
        Bm = _randn((B, L, G, N), dtype, dev, seed + 1)
        Cm = _randn((B, L, G, N), dtype, dev, seed + 2)
        if strong:
            dt = torch.full((B, L, H), 0.1, device=dev)
            A = torch.full((H,), -16.0, device=dev)
        else:
            dt = F.softplus(_randn((B, L, H), torch.float32, dev, seed + 3))
            A = -_randn((H,), torch.float32, dev, seed + 4).exp()
        dy = _randn((B, L, H, P), torch.float32, dev, seed + 5)
        dstate = _randn((B, H, P, N), torch.float32, dev, seed + 6) \
            if final else None
        args = (x, dt, A, Bm, Cm)
        _, _, states = _ssd_forward(*args, chunk, True)
        want_states = ssd_plain(*args, chunk, return_states=True)[2]
        tol = SSD_TOL[str(dtype)]
        torch.testing.assert_close(states, want_states, rtol=tol, atol=tol)
        before = ssd_bwd.launches
        variant = "tc" if dtype == torch.bfloat16 and P % 8 == 0 \
            and N % 8 == 0 and min(chunk, L) <= 256 else "fma"
        taken = getattr(ssd_bwd, f"{variant}_launches")
        got = ssd_bwd(*args, states, dy, dstate, chunk)
        torch.cuda.synchronize()
        assert ssd_bwd.launches == before + 1
        assert getattr(ssd_bwd, f"{variant}_launches") == taken + 1, \
            f"ssd bwd did not take its {variant} kernel"
        want = ssd_bwd_plain(*args, states, dy, dstate, chunk)
        label = (f"ssd bwd ({B},{L},{H},{P}) G={G} N={N} chunk {chunk} "
                 f"{str(dtype)[6:]}{' A=-16 dt=0.1' if strong else ''}"
                 f"{' dstate' if final else ''}")
        tol = SSD_BWD_TOL[str(dtype)]
        err, rel = 0.0, {}
        for g, w, n in zip(got, want, ("dx", "ddt", "dA", "dB", "dC")):
            assert bool(torch.isfinite(g).all()), f"{label} {n} not finite"
            diff = float((g.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            assert diff <= tol * max(scale, 1e-30), \
                f"{label} {n}: max_abs_err {diff:.3e} over {scale:.3e} > {tol}"
            err = max(err, diff)
            rel[n] = diff / max(scale, 1e-30)
        print(f"{label}: finite, max_abs_err {err:.3e}; of the largest "
              f"value (tol {tol}): " + ", ".join(
                  f"{n} {r:.1e}" for n, r in rel.items()))
        return (args, states, dy, dstate), err

    bf16 = torch.bfloat16
    mamba, hybrid = get_config(MAMBA_ARCH), get_config(HYBRID_ARCH)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]

    def shape_of(cfg):
        s = cfg.ssm
        return (B, S, s.n_heads(cfg.d_model), s.head_dim, s.n_groups,
                s.d_state, s.chunk_size)
    train, train_err = case(*shape_of(mamba), bf16, final=False)
    case(*shape_of(mamba), bf16, seed=1)
    case(*shape_of(hybrid), bf16, final=False, seed=2)
    for dtype in (torch.float32, bf16):
        for shape in ((1, 64, 2, 8, 1, 4, 16), (2, 40, 4, 16, 1, 16, 256),
                      (2, 200, 4, 64, 2, 128, 100),   # ragged tiles
                      (2, 512, 8, 64, 2, 128, 256),   # G = 2
                      (1, 64, 8, 16, 1, 16, 32)):     # the smoke configs'
            case(*shape, dtype, seed=5)
        case(1, 512, 8, 64, 1, 128, 256, dtype, strong=True, seed=6)
    args, states, dy, dstate = train
    Q = mamba.ssm.chunk_size
    dev_ms = _timed(f"ssd_bwd {tuple(args[0].shape)} N {args[3].shape[3]}",
                    {"kernel": lambda: ssd_bwd(*args, states, dy, None, Q),
                     "earlier (FMA) kernel": _earlier_kernel(
                         ssd_mod, lambda: ssd_bwd(*args, states, dy, None,
                                                  Q)),
                     "plain": lambda: ssd_bwd_plain(*args, states, dy, None,
                                                    Q)}, inner=3)
    nbytes, ops = ssd_bwd_work(args, Q, final=False)
    bound_ms, bound_by = _bound(nbytes, ops, args[0].dtype)
    ms = dev_ms["kernel"]
    print(f"ssd bwd at mamba2-1.3b's training shape: {ms * 1e3:.2f} us, "
          f"{ops / 1e9:.2f} GFLOP counted ({ops / ms / 1e9:.1f} TFLOP/s), "
          f"{nbytes / 1e6:.1f} MB ({nbytes / ms / 1e6:.1f} GB/s), "
          f"{bound_ms / ms * 100:.2f} % of the {bound_ms * 1e3:.2f} us bound "
          f"({bound_by}); plain {dev_ms['plain'] * 1e3:.2f} us; the earlier "
          f"FMA kernel {dev_ms['earlier (FMA) kernel'] * 1e3:.2f} us; no "
          f"single PyTorch call")
    return {"name": "ssd_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
            "replaces": "src/repro/kernels/ssd.py:78",
            "backward_of": "ssd", "launches": 0, "max_abs_err": train_err,
            "ms": ms, "plain_ms": dev_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "earlier_ms": dev_ms["earlier (FMA) kernel"]}


def train_gmm_rows(cfg) -> int:
    """C = G * cap of the MoE layer at phase 11's B x S tokens."""
    from repro_torch.models.moe import capacity, dispatch_groups
    m = cfg.moe
    T = LM_TRAIN["batch"] * LM_TRAIN["seq"]
    G = dispatch_groups(T, m.num_groups)
    return G * capacity(T // G, m.top_k, m.num_experts, m.capacity_factor)


def train_parity(dev) -> float:
    """Phase 6's training half: one train step (remat full) at each of
    TRAIN_PARITY_ARCHS' f32 smoke configs on the card against the CPU
    from the same parameters and batch (seamless on normal random
    frames): the loss, every gradient leaf (``testing.train_grads_drift``)
    and the step's grad norm.  Returns the worst drift."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.testing import (MOE_UPSTREAM_TOL, TRAIN_GRAD_TOL,
                                     train_step_parity)
    worst = 0.0
    for arch in TRAIN_PARITY_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", remat="full").resolve(tp=1)
        t0 = time.perf_counter()
        d = train_step_parity(cfg, TrainConfig(), dev)
        tol = MOE_UPSTREAM_TOL if cfg.moe is not None else TRAIN_GRAD_TOL
        assert d["loss"] < TRAIN_GRAD_TOL and d["grad_norm"] < tol, (arch, d)
        print(f"train parity {arch} (f32 smoke, cuda vs cpu): loss "
              f"{d['loss']:.2e}, grad norm {d['grad_norm']:.2e}, gradient "
              f"leaves {d['grads']:.2e} (worst of those held to "
              f"{TRAIN_GRAD_TOL}); {time.perf_counter() - t0:.1f} s")
        worst = max(worst, d["loss"], d["grads"])
    return worst


def _train_launches(cfg) -> dict:
    """The kernels a train step launches with remat full and L layers:
    each layer's (a Zamba2 group's) forward runs twice (forward, then
    again in the backward pass), each backward once.  A Mamba2 layer runs
    the SSD scan (on the tensor cores at full width), Zamba2's shared
    block flash attention once a group.  Every bf16 forward and backward
    of flash attention and SSD takes its tensor-core kernel (``.tc``),
    every ``gmm`` forward and backward its ``wgmma`` kernel.  An
    encoder-decoder runs flash attention once an encoder layer and twice
    a decoder layer (self, cross)."""
    L = cfg.num_layers
    if cfg.family == "encdec":
        n = cfg.enc_layers + 2 * L
        return {"flash_attention": 2 * n, "flash_attention.tc": 2 * n,
                "flash_attention_bwd": n, "flash_attention_bwd.tc": n}
    if cfg.family in ("ssm", "hybrid"):
        attn = L // cfg.hybrid.shared_every if cfg.family == "hybrid" else 0
        return {"flash_attention": 2 * attn, "flash_attention.tc": 2 * attn,
                "flash_attention_bwd": attn, "flash_attention_bwd.tc": attn,
                "ssd": 2 * L, "ssd.tc": 2 * L, "ssd_bwd": L,
                "ssd_bwd.tc": L}
    per_layer_gmm = 3 if cfg.moe is not None else 0
    return {"flash_attention": 2 * L, "flash_attention.tc": 2 * L,
            "flash_attention_bwd": L, "flash_attention_bwd.tc": L,
            "gmm": 2 * per_layer_gmm * L,
            "gmm.wgmma": 2 * per_layer_gmm * L,
            "gmm_bwd": per_layer_gmm * L,
            "gmm_bwd.wgmma": per_layer_gmm * L}


def _parity_launches(cfg, microbatches: int, steps: int) -> dict:
    """The kernels ``testing.sharded_step_parity`` launches in ``steps``
    steps of ``microbatches`` each: the single-device step's
    ``value_and_grad`` (:func:`_train_launches`) and the sharded step's
    forward alone (half the forward launches: with remat full the
    forward runs once without its backward) a microbatch."""
    fwd = ("flash_attention", "flash_attention.tc", "gmm", "gmm.wgmma",
           "ssd", "ssd.tc")
    n = microbatches * steps
    return {k: n * (v + v // 2 if k in fwd else v)
            for k, v in _train_launches(cfg).items()}


def free_card_memory() -> float:
    """Collect garbage, drop cuBLAS's workspaces (one is kept for each
    stream a library product ran on, and the timings and the predictor
    fits run on side streams) and the allocator's cache.  Returns the GB
    still allocated."""
    import torch
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def live_cuda_tensors(top: int = 12) -> str:
    """The largest CUDA tensors the collector can reach, a line each
    (GB, shape, dtype, the types of the objects that refer to it), and
    their total."""
    import torch
    seen, rows = set(), []
    for obj in gc.get_objects():
        try:
            if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                continue
        except Exception:  # noqa: BLE001 — proxies that refuse isinstance
            continue
        key = obj.untyped_storage().data_ptr()
        if key in seen:
            continue
        seen.add(key)
        nbytes = obj.untyped_storage().nbytes()
        refs = {type(r).__name__ for r in gc.get_referrers(obj)}
        rows.append((nbytes, tuple(obj.shape), str(obj.dtype), sorted(refs)))
    rows.sort(key=lambda r: -r[0])
    lines = [f"  {n / 1e9:.3f} GB {shape} {dt} held by {refs}"
             for n, shape, dt, refs in rows[:top]]
    total = sum(r[0] for r in rows)
    return "\n".join([f"{len(rows)} CUDA storages the collector reaches, "
                      f"{total / 1e9:.2f} GB"] + lines)


def train_full_width(dev, arch: str, layers: int, steps: int, warmup: int,
                     wrappers) -> dict:
    """Train ``arch`` at full width, its depth cut to ``layers``: bf16,
    remat full, B x S tokens from ``SyntheticLMData`` through the
    prefetching iterator, ``warmup`` steps then ``steps`` measured ones
    (loss, grad norm, step ms, tokens/s, peak GB each), every step's
    launches asserted (``_train_launches``), one more step profiled
    (device busy share, time by kernel).  Returns the launches of the
    measured steps."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
    from repro_torch.training.train_step import (make_train_state,
                                                 make_train_step)
    from repro_torch.tree import leaves_with_path
    t_run = time.perf_counter()
    gc.collect()
    before = torch.cuda.memory_allocated() / 1e9
    held = free_card_memory()
    free, total = torch.cuda.mem_get_info()
    print(f"train {arch}: {held:.2f} GB held by earlier phases ({before:.2f}"
          f" GB with cuBLAS's workspaces), {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB free")
    if held >= 1.0:
        print(live_cuda_tensors())
    assert held < 1.0, f"{held:.2f} GB still held before training {arch}"
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="bfloat16", remat="full").resolve(tp=1)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=warmup,
                       total_steps=100)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    t0 = time.perf_counter()
    state = make_train_state(cfg, tcfg, torch.Generator(dev).manual_seed(0),
                             dev)
    n_params = sum(x.numel() for _, x in leaves_with_path(state["params"]))
    torch.cuda.synchronize()
    print(f"train {arch}: {layers} of {get_config(arch).num_layers} layers, "
          f"{n_params} parameters, B {B} x S {S}, init "
          f"{time.perf_counter() - t0:.1f} s, state "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    step = make_train_step(cfg, tcfg)
    data = SyntheticLMData(cfg.vocab_size, seed=0)
    it = make_batch_iterator(data, B, S, seed=0, device=dev)
    expect = _train_launches(cfg)
    total = {}
    try:
        for i in range(warmup + steps):
            batch = next(it)
            reset_counts(wrappers)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = counts(wrappers)
            for n, c in got.items():
                assert c == expect.get(n, 0), \
                    f"train step {i}: {c} {n} launches, not " \
                    f"{expect.get(n, 0)}"
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            assert math.isfinite(loss) and math.isfinite(gnorm), (loss, gnorm)
            tag = "warm-up" if i < warmup else "measured"
            print(f"train {arch} step {i} ({tag}): loss {loss:.4f} aux "
                  f"{float(m['aux_loss']):.5f} grad_norm {gnorm:.4f} lr "
                  f"{float(m['lr']):.2e}, {dt * 1e3:.1f} ms, "
                  f"{B * S / dt:.0f} tokens/s, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            if i >= warmup:
                for n, c in got.items():
                    total[n] = total.get(n, 0) + c
        batch = next(it)
        _profiled(f"train step {arch} ({layers} layers, B {B} x S {S})",
                  lambda: step(state, batch))
    finally:
        it.close()
    print(f"train {arch}: launches a step {expect} (remat full: each "
          f"layer's or group's forward twice)")
    del state, it
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train {arch} ({layers} layers): {time.perf_counter() - t_run:.1f}"
          f" s in all")
    return total


def launch_train_phase(dev, wrappers, card: str) -> tuple:
    """Phase 12a: ``launch.train.run`` on mamba2-1.3b at full width,
    CHECKPOINT_LAYERS layers, B x S of LM_TRAIN: 4 steps with a checkpoint
    every 2, then a second call to 6 steps that resumes at step 4, its
    restored state held to the first call's final state bit for bit
    (dtype and device included); the 6 steps' launches asserted against
    phase 11's formula.  Returns (the launches, the config, the state
    after step 6)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.launch import train as ltrain
    from repro_torch.tree import leaves_with_path
    held = free_card_memory()
    assert held < 1.0, f"{held:.2f} GB still held before phase 12"
    cfg = dataclasses.replace(get_config(MAMBA_ARCH),
                              num_layers=CHECKPOINT_LAYERS, dtype="bfloat16",
                              remat="full").resolve(tp=1)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=100)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    path = os.path.join(ROOT, "build", "launch_train")
    shutil.rmtree(path, ignore_errors=True)

    def say(line):
        print(f"phase 12a {line}")

    kw = dict(batch=B, seq=S, ckpt_dir=path, ckpt_every=2, device=dev,
              log_every=1, out=say)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    first = ltrain.run(cfg, tcfg, steps=4, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    assert first["start"] == 0 and first["step"] == 4, first["step"]
    host = {p: x.to("cpu", copy=True)
            for p, x in leaves_with_path(first["state"])}
    nbytes = sum(x.numel() * x.element_size() for x in host.values())
    del first
    free_card_memory()
    seen = []

    def restored(step, state):
        seen.append((step, all(
            x.device.type == torch.device(dev).type
            and x.dtype == host[p].dtype and torch.equal(x.cpu(), host[p])
            for p, x in leaves_with_path(state))))

    t2 = time.perf_counter()
    second = ltrain.run(cfg, tcfg, steps=6, on_restore=restored, **kw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    got = counts(wrappers)
    assert seen == [(4, True)], f"phase 12a resume: {seen}"
    assert second["start"] == 4 and second["step"] == 6
    expect = {n: 6 * c for n, c in _train_launches(cfg).items()}
    for n, c in got.items():
        assert c == expect.get(n, 0), \
            f"phase 12a: {c} {n} launches in 6 steps, not {expect.get(n, 0)}"
    shutil.rmtree(path, ignore_errors=True)
    print(f"phase 12a launch.train {cfg.name} ({CHECKPOINT_LAYERS} layers, B "
          f"{B} x S {S}): 4 steps + checkpoints at 2 and 4 in "
          f"{t1 - t0:.1f} s; resumed at step 4 from a {nbytes / 1e9:.2f} GB "
          f"state equal to the saved one bit for bit, 2 steps + checkpoint "
          f"at 6 in {t3 - t2:.1f} s; launches {got} [{card}]")
    return got, cfg, second["state"]


def _drift_line(d: dict) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in d.items())


def launch_multi_device_phase(dev, cfg, state, card: str) -> None:
    """Phases 12b and 12c on a one-rank NCCL process group (joined
    through a file store): the FSDP step with 2 microbatches on a (1, 1)
    data x model mesh beside the single-device step, two steps from
    ``state``, the sharded step handed the single-device step's
    gradients (``testing.sharded_step_parity``: every microbatch and
    the params it ran on equal bit for bit, its loss equal bit for bit
    where the params are, master / m / v within STATE_TOL of each leaf's
    largest value and the params within one ulp of theirs; the
    single-device step writes ``state`` in place); then the int8
    compressed all-reduce over a (1, 1) pod x data mesh on the stepped
    ``state``'s gradient of one batch."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import make_compressed_allreduce
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.testing import STATE_TOL, sharded_step_parity
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import leaves, tree_map
    store = os.path.join(ROOT, "build", "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    it = make_batch_iterator(SyntheticLMData(cfg.vocab_size, seed=0), B, S,
                             seed=1, device=dev)
    batch = next(it)
    it.close()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        rules = make_rules(mesh, mode="train", fsdp=True)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=100, microbatches=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = sharded_step_parity(cfg, tcfg, rules, state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i, d in enumerate(steps):
            print(f"phase 12b FSDP step, 2 microbatches, one-rank NCCL mesh "
                  f"(1, 1), step {i + 1}, on the single-device step's "
                  f"gradients: drift from the single-device step "
                  f"{_drift_line(d['drift'])}; state equal bit for bit: "
                  f"{d['exact']}; microbatches, params and loss equal bit "
                  f"for bit: {d['batch_equal']}, {d['params_equal']}, "
                  f"{d['loss_equal']}")
        print(f"phase 12b: {t1 - t0:.1f} s for the two steps of each, NCCL "
              f"flight recorder {nccl_recorder()} [{card}]")
        for d in steps:
            assert d["batch_equal"], d
            assert d["loss_equal"] or not d["params_equal"], d
            for kind in ("master", "m", "v"):
                assert d["drift"][kind] <= STATE_TOL, (kind, d)
            assert d["drift"]["params"] <= 1.0, d
        assert steps[0]["params_equal"], steps
        grads = tree_map(lambda g: g.float(),
                         value_and_grad(cfg, state["params"], batch)[2])
        fn = make_compressed_allreduce(make_mesh((1, 1), ("pod", "data"),
                                                 dev), axis_name="pod")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, res = fn(grads, tree_map(torch.zeros_like, grads))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        worst_mean = worst_res = 0.0
        for g, m, r in zip(leaves(grads), leaves(mean), leaves(res)):
            scale = float(g.abs().max().clamp_min(1e-12)) / 127.0
            worst_mean = max(worst_mean, float((m - g).abs().max()) / scale)
            worst_res = max(worst_res, float(r.abs().max()) / scale)
        n = sum(g.numel() for g in leaves(grads))
        print(f"phase 12c compressed all-reduce over a one-rank pod axis, "
              f"{len(leaves(grads))} leaves, {n} elements: mean within "
              f"{worst_mean:.4f} scale of the input, residual within "
              f"{worst_res:.4f} scale; {(t1 - t0) * 1e3:.1f} ms [{card}]")
        assert worst_mean <= 1.0 + 1e-6 and worst_res <= 1.0 + 1e-6
        del grads, mean, res
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def _flash_work(q, k, v, causal: bool) -> tuple:
    """(forward bytes, forward ops, backward bytes, backward ops) of flash
    attention on q, k, v (``kernels/flash_attention.py::work``)."""
    from repro_torch.kernels.flash_attention import work
    return (*work(q, k, v, causal), *work(q, k, v, causal, backward=True))


def _flash_at(q, k, v, do, label: str, card: str,
              causal: bool = True) -> tuple:
    """Flash attention forward and backward (bf16, causal or not) on
    ``q``, ``k``, ``v`` with the cotangent ``do``: both on their
    tensor-core kernels,
    against the plain versions at ATTN_TOL, each timed (device ms by
    CUDA-graph replay; SDPA's backward eager, by CUDA events) beside its
    plain version, SDPA and its bound (:func:`_flash_work`), one line
    printed under ``label``.  Returns the (forward, backward) rows'
    measured fields for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _flash_forward, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain)
    bf16 = q.dtype
    before = (flash_attention.tc_launches, flash_attention_bwd.tc_launches)
    o = flash_attention(q, k, v, causal=causal)
    o2, lse = _flash_forward(q, k, v, causal, True)
    grads = flash_attention_bwd(q, k, v, o2, do, lse, causal)
    torch.cuda.synchronize()
    assert (flash_attention.tc_launches - before[0],
            flash_attention_bwd.tc_launches - before[1]) == (2, 1), \
        f"flash {label} missed its tensor-core kernels"
    err = _attn_err(o, flash_attention_plain(q, k, v, causal), bf16)
    want = flash_attention_bwd_plain(q, k, v, o2, do, lse, causal)
    err_b = max(_rel_err(g, w, bf16, f"flash bwd {label} d{n}")
                for g, w, n in zip(grads, want, "qkv"))
    del o, grads, want
    ms = {"fwd": device_ms(lambda: flash_attention(q, k, v, causal=causal),
                           repeats=7, inner=10),
          "fwd plain": device_ms(
              lambda: flash_attention_plain(q, k, v, causal), repeats=5,
              inner=3),
          "bwd": device_ms(
              lambda: flash_attention_bwd(q, k, v, o2, do, lse, causal),
              repeats=7, inner=5),
          "bwd plain": device_ms(
              lambda: flash_attention_bwd_plain(q, k, v, o2, do, lse,
                                                causal),
              repeats=5, inner=3)}
    qn, kn, vn = (t.transpose(1, 2) for t in (q, k, v))
    ms["fwd library"] = device_ms(
        lambda: F.scaled_dot_product_attention(
            qn, kn, vn, is_causal=causal, enable_gqa=True), repeats=7,
        inner=10)
    qt, kt, vt = (t.detach().requires_grad_() for t in (qn, kn, vn))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True)
    ms["bwd library"] = call_ms(
        lambda: torch.autograd.grad(sdpa, (qt, kt, vt), do.transpose(1, 2),
                                    retain_graph=True),
        repeats=7, inner=10)
    del sdpa, qt, kt, vt
    fbytes, fops, bbytes, bops = _flash_work(q, k, v, causal)
    fb, fby = _bound(fbytes, fops, bf16)
    bb, bby = _bound(bbytes, bops, bf16)
    print(f"{label}: forward max_abs_err {err:.3e}, "
          f"{ms['fwd'] * 1e3:.2f} us (plain {ms['fwd plain'] * 1e3:.2f} "
          f"us, SDPA {ms['fwd library'] * 1e3:.2f} us, bound "
          f"{fb * 1e3:.2f} us, {fby}); backward max_abs_err "
          f"{err_b:.3e} (tol {ATTN_TOL[str(bf16)]} of the largest), "
          f"{ms['bwd'] * 1e3:.2f} us (plain {ms['bwd plain'] * 1e3:.2f} "
          f"us, SDPA's backward {ms['bwd library'] * 1e3:.2f} us, bound "
          f"{bb * 1e3:.2f} us, {bby}) [{card}]")
    return ({"max_abs_err": err, "ms": ms["fwd"], "plain_ms": ms["fwd plain"],
             "bound_ms": fb, "bound_by": fby,
             "library_ms": ms["fwd library"]},
            {"max_abs_err": err_b, "ms": ms["bwd"],
             "plain_ms": ms["bwd plain"], "bound_ms": bb, "bound_by": bby,
             "library_ms": ms["bwd library"]})


def check_tp_local_kernels(dev, card: str) -> dict:
    """Phase 12e (b): the kernels of the tensor-parallel train step at a
    TP rank's local full-width shapes, against their plain versions at
    tests/test_torch_cuda.py's tolerances, each timed (device ms by
    CUDA-graph replay; SDPA's backward eager, by CUDA events) beside its
    plain version, a library call (SDPA, ``torch.bmm``) and its bound:
    flash attention forward and backward at qwen3-moe-30b-a3b's tp 4 (8 of 32
    q heads, the one kv head they read) and mistral-large-123b's tp 8 (12
    of 96, one of 8 kv heads), (4, 1024, H/1, 128) bf16 causal; ``gmm``
    forward and backward at qwen3-moe-30b-a3b's tp 4, 32 of 128 experts
    at phase 11's C rows.  Returns {kernel: [rows]} for the kernels
    line."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.attention import local_kv_heads
    bf16 = torch.bfloat16
    out = {"flash_attention": [], "flash_attention_bwd": [], "gmm": [],
           "gmm_bwd": []}
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    for arch, tp in TP_LOCAL_FLASH:
        cfg = get_config(arch).resolve(tp=tp)
        H = cfg.padded_heads // tp
        kv = local_kv_heads(H, cfg.padded_kv, tp, 0)
        KV, D = kv.stop - kv.start, cfg.head_dim
        q = _randn((B, S, H, D), bf16, dev, 40)
        k, v = (_randn((B, S, KV, D), bf16, dev, 41 + i) for i in range(2))
        do = _randn((B, S, H, D), bf16, dev, 43)
        fwd, bwd = _flash_at(q, k, v, do, f"phase 12e (b) flash ({B},{S},"
                             f"{H}/{KV},{D}) bf16 causal, {arch} tp {tp}",
                             card)
        row = {"shape": [B, S, H, KV, D], "arch": arch, "tp": tp}
        out["flash_attention"].append({**row, **fwd})
        out["flash_attention_bwd"].append({**row, **bwd})
        del q, k, v, do
    cfg = get_config(MOE_ARCH)
    E, Dm, Fd = cfg.moe.num_experts // TP_LOCAL_GMM, cfg.d_model, cfg.d_ff
    C = train_gmm_rows(cfg)
    fwd, bwd = _gmm_at(dev, (E, C, Dm), (E, Dm, Fd),
                       f"phase 12e (b) gmm ({E},{C},{Dm})x({E},{Dm},{Fd}) "
                       f"bf16, {MOE_ARCH} tp {TP_LOCAL_GMM}", card)
    row = {"shape": [E, C, Dm, Fd], "arch": MOE_ARCH, "tp": TP_LOCAL_GMM}
    out["gmm"].append({**row, **fwd})
    out["gmm_bwd"].append({**row, **bwd})
    return out


def _gmm_at(dev, xs, ws, label: str, card: str) -> tuple:
    """``gmm`` forward and backward (bf16) on x of shape ``xs`` and w of
    ``ws``: both on their ``wgmma`` kernels, against the plain versions at
    GMM_TOL, each timed (device ms by CUDA-graph replay) beside its plain
    version, ``torch.bmm`` and its bound (``kernels/gmm.py::work``), one
    line printed under ``label``.  Returns the (forward, backward) rows'
    measured fields for the kernels line."""
    import torch
    from repro_torch.kernels import gmm as gmm_mod
    from repro_torch.kernels.gmm import gmm, gmm_bwd, gmm_bwd_plain, gmm_plain
    bf16 = torch.bfloat16
    x = _randn(xs, bf16, dev, 50) * xs[2] ** -0.25
    w = _randn(ws, bf16, dev, 51) * xs[2] ** -0.25
    dy = _randn((xs[0], xs[1], ws[2]), bf16, dev, 52)
    before = (gmm.wgmma_launches, gmm_bwd.wgmma_launches)
    y = gmm(x, w)
    dx, dw = gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert (gmm.wgmma_launches - before[0],
            gmm_bwd.wgmma_launches - before[1]) == (1, 1), \
        f"gmm {label} missed its wgmma kernels"
    err = _rel_err(y, gmm_plain(x, w), bf16, f"gmm {label}")
    err_b = max(_rel_err(g, wt, bf16, f"gmm bwd {label} {n}")
                for g, wt, n in zip((dx, dw), gmm_bwd_plain(x, w, dy),
                                    ("dx", "dw")))
    ms = {"fwd": device_ms(lambda: gmm(x, w), repeats=7, inner=10),
          "fwd plain": device_ms(lambda: gmm_plain(x, w), repeats=5,
                                 inner=3),
          "bwd": device_ms(lambda: gmm_bwd(x, w, dy), repeats=7, inner=5),
          "bwd plain": device_ms(lambda: gmm_bwd_plain(x, w, dy), repeats=5,
                                 inner=3),
          "fwd library": device_ms(lambda: torch.bmm(x, w), repeats=7,
                                   inner=10),
          "bwd library": device_ms(
              lambda: (torch.bmm(dy, w.transpose(1, 2)),
                       torch.bmm(x.transpose(1, 2), dy)), repeats=7,
              inner=5)}
    fb, fby = _bound(*gmm_mod.work(x, w), bf16)
    bb, bby = _bound(*gmm_mod.work(x, w, backward=True), bf16)
    print(f"{label}: forward max_abs_err {err:.3e}, "
          f"{ms['fwd'] * 1e3:.2f} us (plain {ms['fwd plain'] * 1e3:.2f} us, "
          f"torch.bmm {ms['fwd library'] * 1e3:.2f} us, bound "
          f"{fb * 1e3:.2f} us, {fby}); backward max_abs_err {err_b:.3e} (tol "
          f"{GMM_TOL[str(bf16)]} of the largest), {ms['bwd'] * 1e3:.2f} us "
          f"(plain {ms['bwd plain'] * 1e3:.2f} us, two torch.bmm "
          f"{ms['bwd library'] * 1e3:.2f} us, bound {bb * 1e3:.2f} us, "
          f"{bby}) [{card}]")
    return ({"max_abs_err": err, "ms": ms["fwd"], "plain_ms": ms["fwd plain"],
             "bound_ms": fb, "bound_by": fby,
             "library_ms": ms["fwd library"]},
            {"max_abs_err": err_b, "ms": ms["bwd"],
             "plain_ms": ms["bwd plain"], "bound_ms": bb, "bound_by": bby,
             "library_ms": ms["bwd library"]})


def tensor_parallel_phase(dev, wrappers, card: str) -> tuple:
    """Phase 12e (a): the tensor-parallel train step's code path on a
    one-rank NCCL process group, a (1, 1) data x model mesh (every
    model-axis collective runs, over one-rank groups): qwen3-moe-30b-a3b
    at full width, bf16, TP_TRAIN_LAYERS layers, the FSDP step with 2
    microbatches on phase 11's B x S beside the single-device step, two
    steps, handed the single-device step's gradients
    (``testing.sharded_step_parity``, two states held): every
    microbatch, the params it ran on and the tensor-parallel forward's
    loss equal bit for bit, master / m / v within STATE_TOL, the params
    within one ulp.  The counts are reset just before those steps and
    read just after: every launch is the count ``_parity_launches``
    gives, on the tensor cores (``tc``, ``wgmma``).  Then, in a window of
    their own, ``value_and_grad`` on the tensor-parallel path against the
    single-device one at the f32 smoke configs of TP_PARITY_ARCHS
    (``testing.tp_grad_parity``: TRAIN_GRAD_TOL, MoE upstream
    MOE_UPSTREAM_TOL), each launch the FMA variant.  On one rank the
    model index is 0 and a rank holds every expert, vocabulary row and
    head, so the branches that only a model axis above 1 takes (the
    vocabulary mask, the kv-head slice, the expert mask) run on gloo in
    the CPU tests, not here.  Returns (the bf16 step's launches, the
    peak GB)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.testing import (MOE_UPSTREAM_TOL, STATE_TOL,
                                     TRAIN_GRAD_TOL, sharded_step_parity,
                                     tp_grad_parity)
    from repro_torch.training.train_step import make_train_state
    held = free_card_memory()
    assert held < 1.0, f"{held:.2f} GB still held before phase 12e"
    store = os.path.join(ROOT, "build", "nccl_store_tp")
    if os.path.exists(store):
        os.remove(store)
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=TP_TRAIN_LAYERS, dtype="bfloat16",
                              remat="full").resolve(tp=1)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=100,
                       microbatches=2)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    it = make_batch_iterator(SyntheticLMData(cfg.vocab_size, seed=0), B, S,
                             seed=2, device=dev)
    batch = next(it)
    it.close()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        rules = make_rules(mesh, mode="train", fsdp=True)
        state = make_train_state(cfg, tcfg,
                                 torch.Generator(dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps = sharded_step_parity(cfg, tcfg, rules, state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state
        free_card_memory()
        for i, d in enumerate(steps):
            print(f"phase 12e (a) {cfg.name} full width, {TP_TRAIN_LAYERS} "
                  f"layer(s), bf16, B {B} x S {S}, FSDP TP step, 2 "
                  f"microbatches, one-rank NCCL (1, 1) data x model, step "
                  f"{i + 1}, on the single-device step's gradients: drift "
                  f"{_drift_line(d['drift'])}; state equal bit for bit: "
                  f"{d['exact']}; microbatches, params and loss equal bit "
                  f"for bit: {d['batch_equal']}, {d['params_equal']}, "
                  f"{d['loss_equal']}")
        print(f"phase 12e (a): {t1 - t0:.1f} s for the two steps of each, "
              f"peak {peak:.2f} GB on the card, NCCL flight recorder "
              f"{nccl_recorder()} [{card}]")
        for d in steps:
            assert d["batch_equal"] and d["params_equal"] \
                and d["loss_equal"], d
            for kind in ("master", "m", "v"):
                assert d["drift"][kind] <= STATE_TOL, (kind, d)
            assert d["drift"]["params"] <= 1.0, d
        expect = _parity_launches(cfg, tcfg.microbatches, len(steps))
        for n, c in got.items():
            assert c == expect.get(n, 0), \
                f"phase 12e (a): {c} {n} launches, not {expect.get(n, 0)}"
        print(f"phase 12e (a) launches in the bf16 steps, as counted: "
              f"{ {n: c for n, c in got.items() if c} }")
        reset_counts(wrappers)
        expect = {}
        for arch in TP_PARITY_ARCHS:
            small = dataclasses.replace(get_config(arch, smoke=True),
                                        dtype="float32",
                                        remat="full").resolve(tp=1)
            # two passes of value_and_grad (with rules and without), every
            # kernel on its FMA variant
            for n, c in _train_launches(small).items():
                n = n.replace(".tc", ".fma").replace(".wgmma", ".fma")
                expect[n] = expect.get(n, 0) + 2 * c
            t0 = time.perf_counter()
            d = tp_grad_parity(small, rules, dev)
            moe = "" if small.moe is None \
                else f", upstream of the MoE layer {MOE_UPSTREAM_TOL}"
            assert d["loss"] < TRAIN_GRAD_TOL, (arch, d)
            print(f"phase 12e (a) value_and_grad {arch} (f32 smoke), the "
                  f"tensor-parallel path against the single-device one on "
                  f"the card: loss {d['loss']:.2e}, gradient leaves "
                  f"{d['grads']:.2e} (held to {TRAIN_GRAD_TOL}{moe}); "
                  f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        for n, c in counts(wrappers).items():
            assert c == expect.get(n, 0), \
                f"phase 12e (a) f32: {c} {n} launches, not {expect.get(n, 0)}"
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    return got, peak


def tp_serve_phase(dev, wrappers, card: str) -> tuple:
    """Phase 12f (a): serving under tensor parallelism on a one-rank NCCL
    group, mesh (1, 1) data x model (every model-axis collective of the
    path runs, over one-rank groups): a wave of qwen2-vl-7b at full
    width and TP_SERVE_LAYERS layers, bf16, phase 5's first 8 prompts
    (left-padded, the vision stub zero), and one of qwen3-moe-30b-a3b at
    TP_SERVE_MOE_LAYERS layers,
    each a prefill into a TP_SERVE_CACHE-row cache and TP_SERVE_STEPS
    greedy steps under ``rules_for(cfg, mesh, "prefill" | "decode")``
    beside the single-device wave (``testing.tp_serve_parity``): tokens
    equal, logits and the cache bit for bit; then TP_SERVE_ROUNDS more
    waves of each path, interleaved, time a decode step (the median and
    the range printed).  The counts are reset just before the waves and
    read just after: each wave launches flash once a layer, decode once
    a layer and step, ``gmm`` three times a layer and forward, all on
    the tensor cores.  On one rank the model index
    is 0 and a rank's block is the whole cache, so the branches that
    only a model axis above 1 takes (the row's owner, the empty blocks,
    the vocabulary gather) run on gloo in the CPU tests, not here.
    Returns (the launches, the peak GB)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.testing import tp_serve_parity
    held = free_card_memory()
    assert held < 1.0, f"{held:.2f} GB still held before phase 12f"
    store = os.path.join(ROOT, "build", "nccl_store_tp_serve")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    expect, got, peak = {}, {}, 0.0
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        for arch, layers in ((ARCH, TP_SERVE_LAYERS),
                             (MOE_ARCH, TP_SERVE_MOE_LAYERS)):
            cfg = dataclasses.replace(get_config(arch), num_layers=layers)
            cfg = cfg.resolve(tp=1, dp=1)
            prompts = wave_prompts(cfg.vocab_size)[0]
            batch = _batch(cfg, prompts, dev)
            params = model.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            L, n = cfg.num_layers, TP_SERVE_STEPS
            # both paths, 1 + TP_SERVE_ROUNDS waves each
            for k, c in _serve_launches(cfg, n).items():
                expect[k] = expect.get(k, 0) + 2 * (1 + TP_SERVE_ROUNDS) * c
            t0 = time.perf_counter()
            d = tp_serve_parity(cfg, mesh, params, batch, TP_SERVE_CACHE, n,
                                rounds=TP_SERVE_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del params
            free_card_memory()
            ms = d["decode_ms"]
            print(f"phase 12f (a) {cfg.name} full width, {L} layers, bf16, "
                  f"{len(prompts)} prompts padded to "
                  f"{batch['tokens'].shape[1]}, cache {TP_SERVE_CACHE}, "
                  f"{n} greedy steps, one-rank NCCL (1, 1) data x model: "
                  f"tokens equal {d['tokens_equal']}, logits bit for bit "
                  f"{d['logits_exact']} (max diff / max |logit| "
                  f"{d['logits']:.3e}), cache bit for bit "
                  f"{d['cache_exact']}; decode ms a step, median (range) "
                  f"of {TP_SERVE_ROUNDS} interleaved warm waves: TP path "
                  f"{_median_range(ms['tp'])}, single-device "
                  f"{_median_range(ms['single'])}, NCCL flight recorder "
                  f"{nccl_recorder()}; {wall:.1f} s for all "
                  f"{2 * (1 + TP_SERVE_ROUNDS)} waves [{card}]")
            assert d["tokens_equal"] and d["logits_exact"] \
                and d["cache_exact"], d
        torch.cuda.synchronize()
        got = counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    _assert_launches(got, expect, "phase 12f (a)")
    print(f"phase 12f (a) launches, predicted {expect}, counted "
          f"{ {n: c for n, c in got.items() if c} }; peak {peak:.2f} GB "
          f"[{card}]")
    return got, peak


def _median_range(xs) -> str:
    """``median (least-most)`` of a list of milliseconds."""
    import statistics
    return (f"{statistics.median(xs):.2f} ({min(xs):.2f}-{max(xs):.2f}) "
            f"ms")


def _merge_blocks(outs, lses):
    """Plain flash-decoding combine of per-block attentions (each (B, 1,
    H, Dv)) by their log-sum-exps (each (B, H) f32): the formula of
    ``parallel.sharding.combine_over_model`` over a list, not ranks."""
    import torch
    lse = torch.stack(lses)
    M = lse.amax(0)
    M = torch.where(torch.isfinite(M), M, 0.0)
    w = torch.exp(lse - M)[:, :, None, :, None]
    num = (torch.stack([o.float() for o in outs]) * w).sum(0)
    return (num / w.sum(0).clamp_min(1e-30)).to(outs[0].dtype)


def check_decode_lse(dev, card: str) -> dict:
    """Phase 12f (b): the decode kernel's log-sum-exp output at the
    serving shape (SERVE's B x max_seq cache, 28 / 4 heads, D 128, bf16,
    kv_len 1018) and f32 beside it: ``lse`` against the plain version,
    ``out`` bit for bit with and without it; then the cache cut into the
    sequence-parallel blocks of tp in TP_SERVE_BLOCKS, each block's call
    against the plain version and the blocks merged by their
    log-sum-exps against the whole-cache call.  Timed by CUDA-graph
    replay: the whole-cache call without and with ``lse``, one block
    call (the first, all of its rows valid) and SDPA with a length mask
    at the block shape.  Returns the numbers for the ``kernels`` line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    B, S, H, KV, D = SERVE["max_batch"], SERVE["max_seq"], 28, 4, 128
    n_kv = 1018
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((B, 1, H, D), dtype, dev, 61)
        k = _randn((B, S, KV, D), dtype, dev, 62)
        v = _randn((B, S, KV, D), dtype, dev, 63)
        lens = torch.full((B,), n_kv, dtype=torch.int32, device=dev)
        before = (decode_attention.launches, decode_attention.mma_launches)
        whole, lse = decode_attention(q, k, v, lens, return_lse=True)
        bare = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert decode_attention.launches == before[0] + 2
        mma = dtype == torch.bfloat16
        assert decode_attention.mma_launches == before[1] + 2 * mma
        assert torch.equal(whole, bare), "decode: out changed with lse"
        p_out, p_lse = decode_attention_plain(q, k, v, lens, return_lse=True)
        err = _attn_err(whole, p_out, dtype)
        lse_err = float((lse - p_lse).abs().max())
        assert lse_err <= ATTN_TOL[str(dtype)], ("lse", dtype, lse_err)
        line = [f"out {err:.3e}, lse {lse_err:.3e}"]
        for tp in TP_SERVE_BLOCKS:
            n = S // tp
            outs, lses = [], []
            for r in range(tp):
                kl = (lens - r * n).clamp(0, n).to(torch.int32)
                o, l_ = decode_attention(q, k[:, r * n:(r + 1) * n],
                                         v[:, r * n:(r + 1) * n], kl,
                                         return_lse=True)
                po, pl = decode_attention_plain(
                    q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], kl,
                    return_lse=True)
                live = kl > 0
                if live.any():
                    _attn_err(o[live], po[live], dtype)
                assert torch.equal(torch.isinf(l_), torch.isinf(pl))
                fin = torch.isfinite(pl)
                if fin.any():
                    assert float((l_[fin] - pl[fin]).abs().max()) \
                        <= ATTN_TOL[str(dtype)], ("block lse", tp, r)
                outs.append(o)
                lses.append(l_)
            merged = _merge_blocks(outs, lses)
            m_err = _attn_err(merged, whole, dtype)
            line.append(f"tp {tp} blocks merged vs whole {m_err:.3e}")
        print(f"phase 12f (b) decode lse ({B},{S},{H}/{KV},{D}) "
              f"{str(dtype)[6:]} kv_len {n_kv} "
              f"[{'mma' if mma else 'fma'}]: " + "; ".join(line)
              + f" (tol {ATTN_TOL[str(dtype)]})")
        if not mma:
            continue
        n = S // TP_SERVE_BLOCKS[0]
        kb, vb = k[:, :n], v[:, :n]
        kl = (lens.clamp(0, n)).to(torch.int32)
        mask = (torch.arange(n, device=dev)[None, :] < kl[:, None])
        mask = mask[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kb, vb))
        dev_ms = _timed("decode_attention lse", {
            "whole": lambda: decode_attention(q, k, v, lens),
            "whole_lse": lambda: decode_attention(q, k, v, lens,
                                                  return_lse=True),
            "block_lse": lambda: decode_attention(q, kb, vb, kl,
                                                  return_lse=True),
            "block_plain": lambda: decode_attention_plain(
                q, kb, vb, kl, return_lse=True),
            "block_sdpa": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)}, inner=50)
        used = int(kl.sum())
        nbytes = 2 * (q.numel() + used * KV * 2 * D + B * H * D) \
            + 4 * (B + B * H)
        bound_ms, bound_by = _bound(nbytes, 2 * H * used * 2 * D, dtype)
        print(f"phase 12f (b) decode at the serving shape: "
              f"{dev_ms['whole'] * 1e3:.2f} us, with lse "
              f"{dev_ms['whole_lse'] * 1e3:.2f} us; the tp "
              f"{TP_SERVE_BLOCKS[0]} block ({B},{n},{H}/{KV},{D}) kv_len "
              f"{n}: {dev_ms['block_lse'] * 1e3:.2f} us with lse (plain "
              f"{dev_ms['block_plain'] * 1e3:.2f} us, SDPA "
              f"{dev_ms['block_sdpa'] * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.2f} us, {bound_by}) [{card}]")
        out = {"ms": dev_ms["whole"], "lse_ms": dev_ms["whole_lse"],
               "block_ms": dev_ms["block_lse"],
               "block_plain_ms": dev_ms["block_plain"],
               "block_library_ms": dev_ms["block_sdpa"],
               "block_bound_ms": bound_ms, "block_bound_by": bound_by,
               "block_shape": [B, n, H, KV, D]}
    return out


def _serve_launches(cfg, steps: int) -> dict:
    """The kernels one serving wave launches (a prefill and ``steps``
    greedy decode steps), each on its tensor-core variant: flash once a
    layer's prefill (a Zamba2 group's shared block), SSD once a Mamba2
    layer's prefill, the decode kernel once a step of a GQA layer or a
    shared block (MLA and Mamba2 decode in PyTorch ops, no kernel),
    ``gmm`` three times a MoE layer's forward; an encoder-decoder's
    flash once an encoder layer and twice a decoder layer's prefill, its
    decode kernel twice a decoder layer's step (self, cross)."""
    L = cfg.num_layers
    if cfg.family == "encdec":
        out = {"flash_attention": cfg.enc_layers + 2 * L,
               "decode_attention": 2 * L * steps}
    elif cfg.family in ("ssm", "hybrid"):
        attn = L // cfg.hybrid.shared_every if cfg.family == "hybrid" else 0
        out = {"ssd": L, "flash_attention": attn,
               "decode_attention": attn * steps}
    else:
        out = {"flash_attention": L,
               "decode_attention": 0 if cfg.mla is not None else L * steps,
               "gmm": 3 * L * (steps + 1) if cfg.moe is not None else 0}
    variant = {"ssd": "tc", "flash_attention": "tc", "decode_attention": "mma",
               "gmm": "wgmma"}
    for k in list(out):
        out[f"{k}.{variant[k]}"] = out[k]
    return {k: v for k, v in out.items() if v}


def _norms_line(label: str, d: dict, card: str) -> None:
    """Print a one-rank TP train check's gradient norms and clip scales
    (single-device, TP) as f32 hex, and where the state or the norms
    differ each gradient leaf's sum of squares on both sides and the
    first leaf that differs (``testing.sharded_step_parity``; ROADMAP
    Queue 3 item 30), before the caller's check fails."""
    print(f"{label} grad norm single / TP {' / '.join(d['norms'])}, clip "
          f"scale {' / '.join(d['clip_scales'])} (f32 hex) [{card}]")
    if "leaf_sq" in d:
        print(f"{label} MISMATCH: first differing sum of squares "
              f"{d['first_sq_leaf']}, first differing state leaf "
              f"{d['first_state_leaf']}; each leaf's sum of squares "
              f"single / TP (f32 hex):")
        for leaf, (a, b) in d["leaf_sq"].items():
            print(f"{label}   {leaf} {a} / {b}{'' if a == b else ' *'}")


def _assert_launches(got: dict, expect: dict, label: str) -> None:
    """Every count of ``expect`` (``counts``' keys, variants included)
    launched exactly, and nothing else."""
    wrong = {n: (got.get(n, 0), c) for n, c in expect.items()
             if got.get(n, 0) != c}
    assert not wrong, f"{label}: (counted, predicted) {wrong}"
    stray = {n: c for n, c in got.items() if c and n not in expect}
    assert not stray, f"{label}: launches outside the path {stray}"


def tp_latent_ssm_phase(dev, wrappers, card: str) -> tuple:
    """Phase 12g (a): tensor parallelism for MLA and the Mamba2 families
    on a one-rank NCCL group, mesh (1, 1) data x model (every model-axis
    collective of the paths runs, over one-rank groups, the gated norm's
    sum over ``ssm_inner`` among them), at full width, bf16, the depth of
    TP_LATENT_SSM (zamba2-2.7b's LoRA seeded nonzero): for each arch one
    train step, remat full, on phase 11's B x S, the TP step handed the
    single-device step's gradients (``testing.sharded_step_parity``: the
    state, the microbatch, the params and the TP forward's loss equal bit
    for bit); then one serving wave, a prefill of phase 5's first wave
    (Mamba2's longest prompt lengthened to a multiple of the chunk) into a
    TP_SERVE_CACHE-row cache and TP_SERVE_STEPS greedy steps, on the TP
    path beside one device (``testing.tp_serve_parity``: tokens, logits
    and cache bit for bit).  The counts are reset just before the first
    step and read just after the last wave: each kernel's launches the
    count predicted from the configs (``_parity_launches``,
    ``_serve_launches``), all on the tensor cores (``tc``, ``mma``), none
    outside them.  On one rank the model index is 0 and a rank holds
    every head, channel and vocabulary row, so the branches that only a
    model axis above 1 takes run on gloo in the CPU tests.  Returns (the
    launches, the peak GB)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.testing import (STATE_TOL, seed_lora,
                                     sharded_step_parity, tp_serve_parity)
    from repro_torch.training.train_step import make_train_state
    held = free_card_memory()
    assert held < 1.0, f"{held:.2f} GB still held before phase 12g"
    store = os.path.join(ROOT, "build", "nccl_store_tp_latent")
    if os.path.exists(store):
        os.remove(store)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    expect, got, peak = {}, {}, 0.0
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        rules = make_rules(mesh, mode="train", fsdp=False)
        torch.cuda.synchronize()
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        for arch, layers in TP_LATENT_SSM:
            cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                      dtype="bfloat16",
                                      remat="full").resolve(tp=1, dp=1)
            tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                               total_steps=100)
            it = make_batch_iterator(SyntheticLMData(cfg.vocab_size, seed=0),
                                     B, S, seed=2, device=dev)
            batch = next(it)
            it.close()
            state = make_train_state(cfg, tcfg,
                                     torch.Generator(dev).manual_seed(0), dev)
            if cfg.family == "hybrid":
                seed_lora(state["params"], cfg)
                for n in ("qb", "ib"):
                    state["opt"]["master"]["lora"][n].copy_(
                        state["params"]["lora"][n])
            t0 = time.perf_counter()
            d = sharded_step_parity(cfg, tcfg, rules, state, batch,
                                    steps=1)[0]
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            _norms_line(f"phase 12g (a) {cfg.name}", d, card)
            del state
            free_card_memory()
            for n, c in _parity_launches(cfg, 1, 1).items():
                expect[n] = expect.get(n, 0) + c
            params = model.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            if cfg.family == "hybrid":
                seed_lora(params, cfg)
            prompts = (mamba_waves(cfg.vocab_size, cfg.ssm.chunk_size)
                       if cfg.ssm is not None
                       else wave_prompts(cfg.vocab_size))[0]
            wave = _batch(cfg, prompts, dev)
            t0 = time.perf_counter()
            w = tp_serve_parity(cfg, mesh, params, wave, TP_SERVE_CACHE,
                                TP_SERVE_STEPS)
            torch.cuda.synchronize()
            t_serve = time.perf_counter() - t0
            del params
            free_card_memory()
            for n, c in _serve_launches(cfg, TP_SERVE_STEPS).items():
                expect[n] = expect.get(n, 0) + 2 * c
            print(f"phase 12g (a) {cfg.name} full width, {layers} layers, "
                  f"bf16: TP train step (one-rank NCCL (1, 1) data x model, "
                  f"B {B} x S {S}, on the single-device step's gradients) "
                  f"drift {_drift_line(d['drift'])}, state bit for bit "
                  f"{d['exact']}, microbatch / params / loss bit for bit "
                  f"{d['batch_equal']} / {d['params_equal']} / "
                  f"{d['loss_equal']}, {t_train:.1f} s; TP wave of "
                  f"{len(prompts)} prompts padded to "
                  f"{wave['tokens'].shape[1]}, cache {TP_SERVE_CACHE}, "
                  f"{TP_SERVE_STEPS} greedy steps: tokens equal "
                  f"{w['tokens_equal']}, logits bit for bit "
                  f"{w['logits_exact']}, cache bit for bit "
                  f"{w['cache_exact']}, {t_serve:.1f} s for both paths "
                  f"[{card}]")
            assert d["exact"] and d["batch_equal"] and d["params_equal"] \
                and d["loss_equal"], (arch, d)
            for kind in ("master", "m", "v"):
                assert d["drift"][kind] <= STATE_TOL, (arch, kind, d)
            assert w["tokens_equal"] and w["logits_exact"] \
                and w["cache_exact"], (arch, w)
        torch.cuda.synchronize()
        got = counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    _assert_launches(got, expect, "phase 12g (a)")
    print(f"phase 12g (a) launches, predicted {expect}, counted "
          f"{ {n: c for n, c in got.items() if c} }; peak {peak:.2f} GB "
          f"[{card}]")
    return got, peak


def _ssd_at(dev, xs, G: int, N: int, Q: int, label: str, card: str,
            heads: int = 0) -> tuple:
    """The SSD forward and backward (bf16 x, B and C, f32 dt and dy) on x
    of shape ``xs`` (B, L, H, P) with ``G`` groups of state size ``N`` at
    chunk ``Q``: both on their tensor-core kernels, against the plain
    versions at SSD_TOL / SSD_BWD_TOL (with ``heads`` > H, once more with
    dt a strided view of a ``heads``-wide one: the kernels read it in
    place), each timed (device ms by CUDA-graph replay) beside its plain
    version and its bound (``kernels/ssd.py::work``; no single PyTorch
    call computes it), one line printed under ``label``.  Returns the
    (forward, backward) rows' measured fields for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import (_ssd_forward, ssd, ssd_bwd,
                                         ssd_bwd_plain, ssd_plain)
    bf16 = torch.bfloat16
    B, S, H, P = xs
    Hw = max(heads, H)
    x = _randn((B, S, H, P), bf16, dev, 70)
    Bm = _randn((B, S, G, N), bf16, dev, 71)
    Cm = _randn((B, S, G, N), bf16, dev, 72)
    dt_all = F.softplus(_randn((B, S, Hw), torch.float32, dev, 73))
    A = -_randn((H,), torch.float32, dev, 74).exp()
    dy = _randn((B, S, H, P), torch.float32, dev, 75)
    errs = {}
    cases = [("", dt_all[..., :H].contiguous())]
    if Hw > H:
        cases.append((" dt sliced", dt_all[..., Hw - H:]))
    for tag, dt in cases:
        args = (x, dt, A, Bm, Cm)
        before = (ssd.tc_launches, ssd_bwd.tc_launches)
        y, state, states = _ssd_forward(*args, Q, True)
        grads = ssd_bwd(*args, states, dy, None, Q)
        torch.cuda.synchronize()
        assert (ssd.tc_launches - before[0],
                ssd_bwd.tc_launches - before[1]) == (1, 1), \
            f"ssd at {label}{tag} missed its tensor-core kernels"
        want_y, want_state = ssd_plain(*args, Q)
        tol = SSD_TOL[str(bf16)]
        torch.testing.assert_close(y, want_y, rtol=tol, atol=tol)
        torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
        err = max(float((y - want_y).abs().max()),
                  float((state - want_state).abs().max()))
        want = ssd_bwd_plain(*args, states, dy, None, Q)
        err_b = max(_rel_err(g, w, bf16, f"ssd bwd {label}{tag} {n}",
                             SSD_BWD_TOL)
                    for g, w, n in zip(grads, want,
                                       ("dx", "ddt", "dA", "dB", "dC")))
        errs[tag] = (err, err_b)
        del y, state, grads, want
    args = (x, dt_all[..., :H].contiguous(), A, Bm, Cm)
    _, _, states = _ssd_forward(*args, Q, True)
    ms = _timed(label, {
        "fwd": lambda: ssd(*args, chunk=Q),
        "fwd plain": lambda: ssd_plain(*args, Q),
        "bwd": lambda: ssd_bwd(*args, states, dy, None, Q),
        "bwd plain": lambda: ssd_bwd_plain(*args, states, dy, None, Q)},
        inner=3)
    fb, fby = _bound(*ssd_work(args, Q), bf16)
    bb, bby = _bound(*ssd_bwd_work(args, Q, final=False), bf16)
    err, err_b = errs[""]
    sliced = (f" (dt sliced {errs[' dt sliced'][0]:.3e})" if Hw > H else "",
              f" (dt sliced {errs[' dt sliced'][1]:.3e})" if Hw > H else "")
    print(f"{label}: forward max_abs_err {err:.3e}{sliced[0]}, "
          f"{ms['fwd'] * 1e3:.2f} us (plain {ms['fwd plain'] * 1e3:.2f} "
          f"us, bound {fb * 1e3:.2f} us, {fby}); backward max_abs_err "
          f"{err_b:.3e}{sliced[1]} (tol {SSD_BWD_TOL[str(bf16)]} of the "
          f"largest), {ms['bwd'] * 1e3:.2f} us "
          f"(plain {ms['bwd plain'] * 1e3:.2f} us, bound "
          f"{bb * 1e3:.2f} us, {bby}); no single PyTorch call [{card}]")
    return ({"max_abs_err": err, "ms": ms["fwd"], "plain_ms": ms["fwd plain"],
             "bound_ms": fb, "bound_by": fby, "library_ms": None},
            {"max_abs_err": err_b, "ms": ms["bwd"],
             "plain_ms": ms["bwd plain"], "bound_ms": bb, "bound_by": bby,
             "library_ms": None})


def check_tp_latent_ssm_kernels(dev, card: str) -> dict:
    """Phase 12g (b): the kernels of the MLA and Mamba2 tensor-parallel
    paths at a TP rank's local full-width shapes, bf16, against their
    plain versions at tests/test_torch_cuda.py's tolerances, each timed
    (device ms by CUDA-graph replay; SDPA's backward eager, by CUDA
    events) beside its plain version, a library call where one computes
    the same function (SDPA) and its bound: the SSD forward and backward
    on the heads of TP_LOCAL_SSD at phase 11's B x S, chunk 256 (and once
    with dt sliced from every head's, as a strided view: the kernel reads
    it in place); flash attention forward and backward at TP_LOCAL_LATENT_
    FLASH (Zamba2's shared block, D 160; MLA's D 96 / Dv 64 with v a view
    of the expanded latent); the decode kernel with ``lse`` on a Zamba2
    rank's block of the TP_SERVE_CACHE-row cache at tp TP_LOCAL_DECODE.
    Every call takes its tensor-core kernel.  Returns {kernel: [rows]}
    for the kernels line."""
    import torch
    from repro_torch.configs.base import get_config
    bf16 = torch.bfloat16
    out = {k: [] for k in ("ssd", "ssd_bwd", "flash_attention",
                           "flash_attention_bwd", "decode_attention")}
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    for arch, tp in TP_LOCAL_SSD:
        cfg = get_config(arch)
        s = cfg.ssm
        Hw = s.n_heads(cfg.d_model)
        H, P, N, Q = Hw // tp, s.head_dim, s.d_state, s.chunk_size
        fwd, bwd = _ssd_at(dev, (B, S, H, P), 1, N, Q,
                           f"phase 12g (b) ssd ({B},{S},{H},{P}) N {N} chunk "
                           f"{Q} bf16, {arch} tp {tp}", card, heads=Hw)
        row = {"shape": [B, S, H, P, N], "arch": arch, "tp": tp}
        out["ssd"].append({**row, **fwd})
        out["ssd_bwd"].append({**row, **bwd})
    for arch, tp in TP_LOCAL_LATENT_FLASH:
        cfg = get_config(arch).resolve(tp=tp)
        if cfg.mla is not None:
            m = cfg.mla
            H = cfg.padded_heads // tp
            D, Dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
            q = _randn((B, S, H, D), bf16, dev, 80)
            k = _randn((B, S, H, D), bf16, dev, 81)
            # v a view of the expanded latent, as mla_fwd reads it
            v = _randn((B, S, H, m.qk_nope_head_dim + Dv), bf16, dev,
                       82)[..., m.qk_nope_head_dim:]
            kvh = H
        else:
            hb = cfg.hybrid
            H, kvh = hb.shared_num_heads // tp, hb.shared_kv_heads // tp
            D = Dv = cfg.head_dim
            q = _randn((B, S, H, D), bf16, dev, 80)
            k, v = (_randn((B, S, kvh, D), bf16, dev, 81 + i)
                    for i in range(2))
        do = _randn((B, S, H, Dv), bf16, dev, 83)
        fwd, bwd = _flash_at(
            q, k, v, do, f"phase 12g (b) flash ({B},{S},{H}/{kvh},{D}"
            f"{'' if D == Dv else f'/{Dv}'}) bf16 causal, {arch} tp {tp}",
            card)
        row = {"shape": [B, S, H, kvh, D, Dv], "arch": arch, "tp": tp}
        out["flash_attention"].append({**row, **fwd})
        out["flash_attention_bwd"].append({**row, **bwd})
        del q, k, v, do
    cfg = get_config(HYBRID_ARCH)
    hb = cfg.hybrid
    Bd, n = SERVE["max_batch"], TP_SERVE_CACHE // TP_LOCAL_DECODE
    # one full block, one a third full, one empty (a row still in an
    # earlier rank's block), the rest at random lengths
    lens = [n, n // 3, 0] + [int(t) for t in torch.randint(
        1, n + 1, (Bd - 3,), generator=torch.Generator().manual_seed(9))]
    out["decode_attention"].append(_decode_lse_at(
        dev, (Bd, n, hb.shared_num_heads, hb.shared_kv_heads, cfg.head_dim),
        lens, 90, f"phase 12g (b) decode lse, {HYBRID_ARCH} tp "
        f"{TP_LOCAL_DECODE} block", card))
    out["decode_attention"][-1].update(arch=HYBRID_ARCH, tp=TP_LOCAL_DECODE)
    return out


def _decode_lse_at(dev, shape, lens, seed: int, label: str,
                   card: str) -> dict:
    """The decode kernel with ``lse`` on a rank's block of a cache, bf16,
    q (B, 1, H, D) over k / v (B, n, KV, D) of ``shape`` = (B, n, H, KV,
    D) with ``lens`` valid rows a sequence (0: an empty block, whose
    ``lse`` is -inf): on its ``mma`` kernel, against the plain version at
    ATTN_TOL on the live rows, timed (device ms by CUDA-graph replay)
    beside it, SDPA with the length mask and its bound (the valid rows
    read once), one line printed under ``label``.  Returns the row's
    measured fields for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    bf16 = torch.bfloat16
    Bd, n, H, KV, D = shape
    q = _randn((Bd, 1, H, D), bf16, dev, seed)
    k = _randn((Bd, n, KV, D), bf16, dev, seed + 1)
    v = _randn((Bd, n, KV, D), bf16, dev, seed + 2)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = decode_attention.mma_launches
    o, lse = decode_attention(q, k, v, lens, return_lse=True)
    torch.cuda.synchronize()
    assert decode_attention.mma_launches == before + 1, \
        f"{label} missed its mma kernel"
    po, pl = decode_attention_plain(q, k, v, lens, return_lse=True)
    live = lens > 0
    err = _attn_err(o[live], po[live], bf16)
    assert torch.equal(torch.isinf(lse), torch.isinf(pl))
    fin = torch.isfinite(pl)
    lse_err = float((lse[fin] - pl[fin]).abs().max())
    assert lse_err <= ATTN_TOL[str(bf16)], ("lse", lse_err)
    mask = (torch.arange(n, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = _timed(label, {
        "kernel": lambda: decode_attention(q, k, v, lens, return_lse=True),
        "plain": lambda: decode_attention_plain(q, k, v, lens,
                                                return_lse=True),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)}, inner=50)
    from repro_torch.kernels.decode_attention import work
    bound_ms, bound_by = _bound(*work(q, k, v, int(lens.sum()), lse=True),
                                bf16)
    print(f"{label} ({Bd},{n},{H}/{KV},{D}) bf16, kv_len {lens.tolist()}: "
          f"out max_abs_err {err:.3e}, lse {lse_err:.3e} (tol "
          f"{ATTN_TOL[str(bf16)]}), {ms['kernel'] * 1e3:.2f} us (plain "
          f"{ms['plain'] * 1e3:.2f} us, SDPA {ms['sdpa'] * 1e3:.2f} us, "
          f"bound {bound_ms * 1e3:.2f} us, {bound_by}) [{card}]")
    return {"shape": list(shape), "max_abs_err": max(err, lse_err),
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": ms["sdpa"]}


def tp_encdec_phase(dev, wrappers, card: str) -> tuple:
    """Phase 12h (a): tensor parallelism for the encoder-decoder family on
    a one-rank NCCL group, mesh (1, 1) data x model (every model-axis
    collective of the path runs, over one-rank groups: the frames' block,
    the encoder output's gather, the read-only cross block's merge), with
    seamless-m4t-medium at full width, bf16: one train step, remat full,
    at TP_ENCDEC_TRAIN_LAYERS encoder and decoder layers on phase 11's B
    x S and as many nonzero encoder frames, the TP step handed the
    single-device step's gradients (``testing.sharded_step_parity``: the
    state, the microbatch, the params and the TP forward's loss equal bit
    for bit, the norms printed, :func:`_norms_line`); then one wave at
    full depth, phase 5's first prompts and TP_ENCDEC_FRAMES nonzero
    frames prefilled into a TP_SERVE_CACHE-row cache and TP_SERVE_STEPS
    greedy steps, on the TP path beside one device
    (``testing.tp_serve_parity``: tokens, logits and cache bit for bit).
    The counts are reset just before the step and read just after the
    wave: each kernel's launches the count predicted from the config
    (``_parity_launches``, ``_serve_launches``), all on the tensor cores
    (``tc``, ``mma``), none outside them.  Returns (the launches, the
    peak GB)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.testing import (STATE_TOL, sharded_step_parity,
                                     tp_serve_parity)
    from repro_torch.training.train_step import make_train_state
    held = free_card_memory()
    assert held < 1.0, f"{held:.2f} GB still held before phase 12h"
    store = os.path.join(ROOT, "build", "nccl_store_tp_encdec")
    if os.path.exists(store):
        os.remove(store)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    expect, got, peak = {}, {}, 0.0
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        rules = make_rules(mesh, mode="train", fsdp=False)
        full = dataclasses.replace(get_config(ENCDEC_ARCH), dtype="bfloat16",
                                   remat="full").resolve(tp=1, dp=1)
        cfg = dataclasses.replace(full, num_layers=TP_ENCDEC_TRAIN_LAYERS,
                                  enc_layers=TP_ENCDEC_TRAIN_LAYERS)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=100)
        it = make_batch_iterator(SyntheticLMData(cfg.vocab_size, seed=0),
                                 B, S, seed=2, device=dev)
        batch = next(it)
        it.close()
        batch["enc_frames"] = _randn((B, S, cfg.d_model), torch.bfloat16,
                                     dev, 100)
        torch.cuda.synchronize()
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(cfg, tcfg,
                                 torch.Generator(dev).manual_seed(0), dev)
        t0 = time.perf_counter()
        d = sharded_step_parity(cfg, tcfg, rules, state, batch, steps=1)[0]
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        _norms_line(f"phase 12h (a) {cfg.name}", d, card)
        del state, batch
        free_card_memory()
        for n, c in _parity_launches(cfg, 1, 1).items():
            expect[n] = expect.get(n, 0) + c
        params = model.init_params(
            full, torch.Generator(device=dev).manual_seed(0), device=dev)
        prompts = wave_prompts(full.vocab_size)[0]
        wave = _batch(full, prompts, dev)
        wave["enc_frames"] = _randn((len(prompts), TP_ENCDEC_FRAMES,
                                     full.d_model), torch.bfloat16, dev, 101)
        t0 = time.perf_counter()
        w = tp_serve_parity(full, mesh, params, wave, TP_SERVE_CACHE,
                            TP_SERVE_STEPS)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        del params
        free_card_memory()
        for n, c in _serve_launches(full, TP_SERVE_STEPS).items():
            expect[n] = expect.get(n, 0) + 2 * c
        print(f"phase 12h (a) {full.name} full width, bf16: TP train step "
              f"({TP_ENCDEC_TRAIN_LAYERS} + {TP_ENCDEC_TRAIN_LAYERS} of "
              f"{full.enc_layers} + {full.num_layers} layers, one-rank "
              f"NCCL (1, 1) data x model, B {B} x S {S}, {S} frames, on "
              f"the single-device step's gradients) drift "
              f"{_drift_line(d['drift'])}, state bit for bit {d['exact']}, "
              f"microbatch / params / loss bit for bit {d['batch_equal']} "
              f"/ {d['params_equal']} / {d['loss_equal']}, {t_train:.1f} "
              f"s; TP wave at full depth of {len(prompts)} prompts padded "
              f"to {wave['tokens'].shape[1]}, {TP_ENCDEC_FRAMES} frames, "
              f"cache {TP_SERVE_CACHE}, {TP_SERVE_STEPS} greedy steps: "
              f"tokens equal {w['tokens_equal']}, logits bit for bit "
              f"{w['logits_exact']}, cache bit for bit {w['cache_exact']}, "
              f"{t_serve:.1f} s for both paths [{card}]")
        assert d["exact"] and d["batch_equal"] and d["params_equal"] \
            and d["loss_equal"], d
        for kind in ("master", "m", "v"):
            assert d["drift"][kind] <= STATE_TOL, (kind, d)
        assert w["tokens_equal"] and w["logits_exact"] \
            and w["cache_exact"], w
        torch.cuda.synchronize()
        got = counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    _assert_launches(got, expect, "phase 12h (a)")
    print(f"phase 12h (a) launches, predicted {expect}, counted "
          f"{ {n: c for n, c in got.items() if c} }; peak {peak:.2f} GB "
          f"[{card}]")
    return got, peak


def check_tp_encdec_kernels(dev, card: str) -> dict:
    """Phase 12h (b): the kernels of the encoder-decoder's tensor-parallel
    path at a tp TP_LOCAL_ENCDEC rank's local full-width shapes, bf16,
    against their plain versions at tests/test_torch_cuda.py's
    tolerances, each timed (device ms by CUDA-graph replay; SDPA's
    backward eager, by CUDA events) beside its plain version, SDPA and
    its bound: flash attention forward and backward, non-causal, at the
    encoder's heads over phase 11's B x S frames and at the
    cross-attention's (q over S tokens, k / v over TP_ENCDEC_FRAMES
    frames); the decode kernel with ``lse`` on a read-only cross block
    (B 8 x TP_ENCDEC_FRAMES / TP_LOCAL_ENCDEC rows, every head, every row
    valid).  Every call takes its tensor-core kernel.  Returns {kernel:
    [rows]} for the kernels line."""
    import torch
    from repro_torch.configs.base import get_config
    bf16 = torch.bfloat16
    out = {k: [] for k in ("flash_attention", "flash_attention_bwd",
                           "decode_attention")}
    cfg = get_config(ENCDEC_ARCH).resolve(tp=TP_LOCAL_ENCDEC)
    tp, D = TP_LOCAL_ENCDEC, cfg.head_dim
    H, KV = cfg.padded_heads // tp, cfg.padded_kv // tp
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    for what, Skv in (("encoder", S), ("cross", TP_ENCDEC_FRAMES)):
        q = _randn((B, S, H, D), bf16, dev, 110)
        k, v = (_randn((B, Skv, KV, D), bf16, dev, 111 + i)
                for i in range(2))
        do = _randn((B, S, H, D), bf16, dev, 113)
        fwd, bwd = _flash_at(
            q, k, v, do, f"phase 12h (b) flash {what} q ({B},{S},{H},{D}) "
            f"k/v ({B},{Skv},{KV},{D}) bf16 non-causal, {ENCDEC_ARCH} tp "
            f"{tp}", card, causal=False)
        row = {"shape": [B, S, Skv, H, KV, D], "arch": ENCDEC_ARCH,
               "tp": tp, "what": what}
        out["flash_attention"].append({**row, **fwd})
        out["flash_attention_bwd"].append({**row, **bwd})
        del q, k, v, do
    Bd, n = SERVE["max_batch"], TP_ENCDEC_FRAMES // tp
    row = _decode_lse_at(
        dev, (Bd, n, cfg.padded_heads, cfg.padded_kv, D), [n] * Bd, 120,
        f"phase 12h (b) decode lse, {ENCDEC_ARCH} tp {tp} read-only cross "
        f"block", card)
    out["decode_attention"].append({**row, "arch": ENCDEC_ARCH, "tp": tp,
                                    "what": "cross block"})
    return out


def launch_serve_phase(dev, wrappers, card: str) -> dict:
    """Phase 12d: ``launch.serve.run`` with qwen2-vl-7b at full width
    (random bf16 weights from a seeded generator), 3 replicas, 24
    requests of LAUNCH_PROMPT tokens, perf_aware, under the launcher's
    simulated clock: every request finished, every flash call on the
    tensor cores and every decode call on ``mma``.  Returns the
    launches."""
    import math
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as lserve
    from repro_torch.models import model as M
    held = free_card_memory()
    assert held < 1.0, f"{held:.2f} GB still held before phase 12d"
    cfg = get_config(ARCH).resolve(tp=1)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    reset_counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lserve.run(cfg, params, replicas=3, requests=24,
                     policy="perf_aware", prompt_len=LAUNCH_PROMPT,
                     max_seq=LAUNCH_MAX_SEQ, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = counts(wrappers)
    rtts = [r for r in res["rtts"].tolist()]
    assert len(rtts) == 24 and all(r is not None and math.isfinite(r)
                                   and r >= 0 for r in rtts), rtts
    assert got["flash_attention"] > 0 and \
        got["flash_attention.tc"] == got["flash_attention"], got
    assert got["decode_attention"] > 0 and \
        got["decode_attention.mma"] == got["decode_attention"], got
    print(f"phase 12d launch.serve {cfg.name} (full width, bf16), 3 "
          f"replicas, 24 requests of {LAUNCH_PROMPT} tokens, perf_aware: "
          f"mean_rtt {res['mean_rtt']:.3f} s p95 {res['p95']:.3f} s "
          f"(simulated clock), shares "
          f"{' '.join(f'{x:.3f}' for x in res['shares'])}; every request "
          f"finished; {got['flash_attention']} flash calls all tc, "
          f"{got['decode_attention']} decode calls all mma; "
          f"{t1 - t0:.1f} s wall [{card}]")
    del params, res
    free_card_memory()
    return got


def _record_kernel_shapes() -> dict:
    """Wrap the models' forward kernels to record the distinct shapes each
    is called with (the backward kernels take the same): {"flash": {(q,
    k, v, causal)}, "decode": {(q, k, lens)}, "gmm": {(x, w)}, "ssd":
    {(x, B, chunk)}}."""
    from repro_torch.models import attention as A, hybrid, moe, ssm
    seen = {"flash": set(), "decode": set(), "gmm": set(), "ssd": set()}
    flash, decode, gmm, ssd = (A.flash_attention, A.decode_attention,
                               moe.gmm, ssm.ssd)

    def rec_flash(q, k, v, causal=True):
        seen["flash"].add((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                           causal))
        return flash(q, k, v, causal=causal)

    def rec_decode(q, k, v, kv_len, **kw):
        seen["decode"].add((tuple(q.shape), tuple(k.shape),
                            tuple(kv_len.tolist())))
        return decode(q, k, v, kv_len, **kw)

    def rec_gmm(x, w):
        seen["gmm"].add((tuple(x.shape), tuple(w.shape)))
        return gmm(x, w)

    def rec_ssd(x, dt, A_, Bm, Cm, chunk=256):
        seen["ssd"].add((tuple(x.shape), tuple(Bm.shape), chunk))
        return ssd(x, dt, A_, Bm, Cm, chunk=chunk)

    A.flash_attention = hybrid.flash_attention = rec_flash
    A.decode_attention = rec_decode
    moe.gmm, ssm.ssd = rec_gmm, rec_ssd
    return seen


def _dryrun_line(rec: dict, card: str) -> None:
    """A phase 13 record's memory, flops, bytes and collectives, one line
    a run."""
    gb = 1e9
    for tag in ("", "_L1", "_L2"):
        cost = rec.get("cost_full" if not tag else f"cost{tag}")
        if cost is None:
            continue
        mem = rec["memory" if not tag else f"memory{tag}"]
        coll = rec["collectives_full" if not tag else f"collectives{tag}"]
        depth = "full depth" if not tag else f"depth {tag[-1]}"
        ops = ", ".join(f"{op} {b / gb:.4f} GB x{coll['_counts'][op]}"
                        for op, b in sorted(coll.items())
                        if not op.startswith("_"))
        print(f"phase 13 {rec['arch']} {rec['shape']} {rec['mesh']} rank "
              f"{rec['rank']}, {depth}: arguments "
              f"{mem['argument_size_in_bytes'] / gb:.3f} GB, temp "
              f"{mem['temp_size_in_bytes'] / gb:.3f} GB, output "
              f"{mem['output_size_in_bytes'] / gb:.3f} GB (alias "
              f"{mem['alias_size_in_bytes'] / gb:.3f}); "
              f"{cost['flops'] / 1e12:.3f} TFLOP, "
              f"{cost['bytes accessed'] / gb:.2f} GB accessed; collectives "
              f"{coll['_total'] / gb:.4f} GB: {ops} [{card}]")


def layer_gather_bytes(arch: str, shape: str) -> tuple:
    """(one layer's weights as a (16, 16) rank's FSDP train step gathers
    them inside the layer's body, bytes: each layer-gathered leaf's model
    block whole over data; the layer-gathered leaves)
    (``training.train_step.layer_gathered``)."""
    import math
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun_lib import production_shape
    from repro_torch.launch.specs import rules_for
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import AbstractMesh
    from repro_torch.training.train_step import (layer_gathered,
                                                 state_shardings)
    from repro_torch.tree import leaves_with_path
    mesh = AbstractMesh(*production_shape(False))
    cfg = get_config(arch).resolve(tp=16, dp=16)
    rules = rules_for(cfg, mesh, "train" if "train" in shape else shape)
    lay = layer_gathered(cfg, rules)
    p_sh = dict(leaves_with_path(state_shardings(cfg, rules)["params"]))
    total = 0
    for path, x in leaves_with_path(M.init_params(cfg, torch.Generator(),
                                                  "meta")):
        if path in lay:
            block = p_sh[path].without(rules.batch_axes).shard_shape(
                tuple(x.shape))
            total += math.prod(block[lay[path].k:]) * x.element_size()
    return total, len(lay)


def _layer_memory_line(rec: dict, card: str) -> None:
    """A depth-1 and depth-2 record's temp(L2) - temp(L1), beside one
    layer's weights as the FSDP step gathers them (:func:
    `layer_gather_bytes`): a gather of whole stacks would put the
    difference at that size or more."""
    gb = 1e9
    d = (rec["memory_L2"]["temp_size_in_bytes"]
         - rec["memory_L1"]["temp_size_in_bytes"])
    layer, n = layer_gather_bytes(rec["arch"], rec["shape"])
    print(f"phase 13 {rec['arch']} {rec['shape']}: temp(L2) - temp(L1) "
          f"{d / gb:.3f} GB beside one layer's gathered weights "
          f"{layer / gb:.3f} GB ({n} layer-gathered leaves) [{card}]")


def dryrun_child(out: str) -> None:
    """Phase 13's child process: DRYRUN_CELLS through ``dryrun_lib.
    run_cell`` (rank 0 of the fake (16, 16) group), each cell's launches
    counted by variant (the counts reset just before the cell, read just
    after), then each kernel at the shapes the cells gave it against its
    plain version, timed; writes {"cells", "launches", "kernels"} to
    ``out``."""
    import torch
    from repro_torch.launch import dryrun_lib
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    wrappers = _kernel_wrappers()
    seen = _record_kernel_shapes()
    cells, launches = [], []
    for arch, shape, full, extrapolate in DRYRUN_CELLS:
        reset_counts(wrappers)
        t0 = time.perf_counter()
        rec = dryrun_lib.run_cell(
            arch, shape, False, extrapolate=extrapolate, verbose=False,
            full=full, fsdp=True if (arch, shape) in DRYRUN_FSDP else None)
        got = {n: c for n, c in counts(wrappers).items() if c}
        rec["wall_s"] = time.perf_counter() - t0
        _dryrun_line(rec, card)
        if (arch, shape) in DRYRUN_FSDP:
            _layer_memory_line(rec, card)
        print(f"phase 13 {arch} {shape}: {rec['wall_s']:.1f} s, launches "
              f"{got} [{card}]")
        cells.append(rec)
        launches.append(got)
    rows = {k: [] for k in ("flash_attention", "flash_attention_bwd",
                            "decode_attention", "gmm", "gmm_bwd", "ssd",
                            "ssd_bwd")}
    bf16 = torch.bfloat16
    for qs, ks, vs, causal in sorted(seen["flash"]):
        q = _randn(qs, bf16, dev, 90)
        k, v = _randn(ks, bf16, dev, 91), _randn(vs, bf16, dev, 92)
        do = _randn((*qs[:3], vs[3]), bf16, dev, 93)
        fwd, bwd = _flash_at(q, k, v, do, f"phase 13 flash {qs}/{ks[2]} "
                             f"bf16 causal={causal}", card, causal)
        rows["flash_attention"].append({"shape": [qs, ks, vs], **fwd})
        rows["flash_attention_bwd"].append({"shape": [qs, ks, vs], **bwd})
        del q, k, v, do
    for qs, ks, lens in sorted(seen["decode"]):
        Bd, n, KV, D = ks
        rows["decode_attention"].append({"shape": [qs, ks], **_decode_lse_at(
            dev, (Bd, n, qs[2], KV, D), list(lens), 94,
            "phase 13 decode lse", card)})
    for xs, ws in sorted(seen["gmm"]):
        fwd, bwd = _gmm_at(dev, xs, ws, f"phase 13 gmm {xs}x{ws} bf16", card)
        rows["gmm"].append({"shape": [xs, ws], **fwd})
        rows["gmm_bwd"].append({"shape": [xs, ws], **bwd})
    for xs, bs, chunk in sorted(seen["ssd"]):
        fwd, bwd = _ssd_at(dev, xs, bs[2], bs[3], chunk,
                           f"phase 13 ssd {xs} G {bs[2]} N {bs[3]} chunk "
                           f"{chunk} bf16", card)
        rows["ssd"].append({"shape": [xs, bs], **fwd})
        rows["ssd_bwd"].append({"shape": [xs, bs], **bwd})
    with open(out, "w") as f:
        json.dump({"cells": cells, "launches": launches, "kernels": rows}, f)


def dryrun_phase(card: str) -> tuple:
    """Phase 13: :func:`dryrun_child` in a child process, its output
    passed on; every cell's kernels launched on their tensor-core
    variants (DRYRUN_KERNELS) and nothing else.  Returns (the launches
    summed over the cells, the kernel rows)."""
    out = os.path.join(ROOT, "build", "dryrun_phase13.json")
    if os.path.exists(out):
        os.remove(out)
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--dryrun-child", out], cwd=ROOT, text=True,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       timeout=DRYRUN_CHILD_TIMEOUT)
    print(p.stdout, end="")
    assert p.returncode == 0, f"phase 13's child failed: rc {p.returncode}"
    with open(out) as f:
        got = json.load(f)
    total = {}
    for (arch, shape, _, _), rec, n in zip(DRYRUN_CELLS, got["cells"],
                                           got["launches"]):
        assert rec["status"] == "ok", f"phase 13 {arch} {shape}: {rec}"
        want = DRYRUN_KERNELS[arch, shape]
        for name, variant in want.items():
            assert n.get(name, 0) > 0, \
                f"phase 13 {arch} {shape}: {name} never launched"
            assert n.get(f"{name}.{variant}", 0) == n[name], \
                f"phase 13 {arch} {shape}: {name} launched {n[name]} " \
                f"times, {n.get(f'{name}.{variant}', 0)} on {variant}"
        extra = {k for k in n if "." not in k} - set(want)
        assert not extra, f"phase 13 {arch} {shape}: {extra} launched"
        for name in want:
            total[name] = total.get(name, 0) + n[name]
    return total, got["kernels"]


def sync_cost_us(dev) -> float:
    """Cost of one host sync (a completion fold's read):
    ``bool(mask.any())`` on a (256, 1000) bool mask, CUDA launch and
    device-to-host copy included."""
    import torch
    mask = torch.zeros((256, 1000), dtype=torch.bool, device=dev)
    for _ in range(20):
        bool(mask.any())
    n = 500
    t0 = time.perf_counter()
    for _ in range(n):
        bool(mask.any())
    return (time.perf_counter() - t0) / n * 1e6


def profile_pass(scenario: str, policy: str, n_requests: int,
                 seeds=LARGE_SEEDS, n_trials=LARGE_TRIALS,
                 shape=LARGE) -> None:
    """One pass of ``policy`` on ``scenario`` (by default at full width),
    cut to ``n_requests`` requests, under torch.profiler: kernel
    launches per step, the device's busy share of the request loop
    (kernel time only: the setup's host-to-device copies are left out),
    and the largest kernels and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.campaign import run_scenario
    kw = dict(shape, n_requests=n_requests)
    # a warm-up pass at the same shape: a graphable cell captures its
    # loop here, and the profiled pass replays it
    run_scenario(scenario, policies=(policy,), include_oracle=False,
                 seeds=seeds, n_trials=n_trials, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_scenario(scenario, policies=(policy,),
                           include_oracle=False, seeds=seeds,
                           n_trials=n_trials, **kw)
    loop_s = res[policy].loop_s
    events = prof.key_averages()
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    kernels = [e for e in on_device if not e.key.startswith("Mem")]
    kern_us = sum(e.self_device_time_total for e in kernels)
    n_kern = sum(e.count for e in kernels)
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch"))
    T = len(seeds) * n_trials
    print(f"profile {scenario}/{policy} ({n_requests} requests, T = {T}, "
          f"{'full width' if shape == LARGE else 'registry shape'}, "
          f"profiler on, {res[policy].backend}): loop {loop_s:.3f} s, "
          f"{n_kern / n_requests:.0f} kernels and "
          f"{launches / n_requests:.1f} launch calls a step, kernels "
          f"busy {kern_us / 1e6:.4f} s = {kern_us / 1e6 / loop_s * 100:.1f}"
          f" % of the loop (the pass's set-up and summary kernels "
          f"included)")
    # every wait of the host on the device goes through the runtime
    # API, a library's own included: the core's count of its syncs is
    # held against the profiler's
    syncs = sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize"))
    print(f"profile {scenario}/{policy}: {syncs} host waits on the device "
          f"in the pass (set-up copies and results included), "
          f"{res[policy].host_syncs} counted by the core's completion folds, "
          f"{res[policy].n_fallback} fallback routings")
    if kern_us == 0:
        print("profile: no device time recorded (not measured)")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:9.2f} ms  "
              f"{e.count:7d} x  {e.key[:80]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:9.2f} ms  "
              f"{e.count:7d} x  {e.key[:80]}")


def launches_per_step(scenario: str, policy: str, n_requests: int,
                      **kw) -> float:
    """Kernels a step of one pass cut to ``n_requests`` requests ran on
    the device, counted by torch.profiler tracing the device alone (the
    set-up copies left out; the host's ops are not recorded, which keeps
    the count cheap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.campaign import run_scenario
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_scenario(scenario, policies=(policy,), include_oracle=False,
                     n_requests=n_requests, **kw)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and not e.key.startswith("Mem")) / n_requests


def sum_rule_err(trace) -> float:
    """Largest |signed sum of the decomposition - response| over the
    served rows of a trace block."""
    import numpy as np
    from repro_torch.core.telemetry import (COMPONENTS, DISP_SERVED,
                                            TRACE_IDX)
    data = trace["data"]
    comp = sum(data[..., TRACE_IDX[c]] for c in COMPONENTS
               if c != "hedge_s") - data[..., TRACE_IDX["hedge_s"]]
    served = data[..., TRACE_IDX["disposition"]] == DISP_SERVED
    err = np.abs(comp - data[..., TRACE_IDX["response"]])[served]
    return float(err.max()) if err.size else 0.0


def client_passes(per_scen: dict) -> dict:
    """The client plane's scenarios at their registry shape, one pass a
    policy (segment-sum launches counted per pass into ``per_scen``);
    returns (scenario, policy) -> PolicyResult."""
    from repro_torch.core.campaign import (RESILIENCE_STATS, SUMMARY_STATS,
                                           run_scenario)
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.kernels.segment_sum import segment_sum
    out = {}
    for scen in CLIENT_SCENARIOS:
        J = get_scenario(scen).n_requests
        t0 = time.perf_counter()
        for pol in POLICIES:
            before = segment_sum.launches
            res = run_scenario(scen, policies=(pol,), include_oracle=False,
                               seeds=CLIENT_SEEDS)
            per_scen[scen, pol] = segment_sum.launches - before
            finite_stats(res, SUMMARY_STATS + RESILIENCE_STATS)
            r = out[scen, pol] = res[pol]
            n_tmo = int(r.per_seed["timeouts"].sum())
            print(f"  {scen}/{pol}: goodput {r.stat('goodput'):.4f} timeout "
                  f"{r.stat('timeout_rate'):.4f} (fail-fast "
                  f"{r.stat('fail_fast_rate'):.4f}, {n_tmo} requests) "
                  f"breaker trips {int(r.per_seed['trips'].sum())} shed "
                  f"{r.stat('shed_rate'):.4f} attempts/req "
                  f"{r.stat('attempts_per_req'):.4f} wasted work "
                  f"{r.stat('wasted_work_s'):.1f} s; loop {r.loop_s:.2f} s "
                  f"= {r.loop_s / J * 1e3:.2f} ms/step, host syncs "
                  f"{r.host_syncs}, segment_sum {per_scen[scen, pol]}")
        print(f"{scen}: T = {len(CLIENT_SEEDS) * 8}, J = {J}, "
              f"{time.perf_counter() - t0:.1f} s for the 5 passes")
    return out


def client_parity(client: dict) -> float:
    """The client plane at its registry shape: phase 4's card passes
    (``client``, from :func:`client_passes`) against the CPU on the same
    inputs, where the retries, backoff, breaker trips and fail-fast
    attempts all happen.  Returns the worst relative drift."""
    import numpy as np
    from repro_torch.core.campaign import (RESILIENCE_STATS, SUMMARY_STATS,
                                           run_scenario)
    worst = 0.0
    t0 = time.perf_counter()
    for scen in CLIENT_SCENARIOS:
        for pol in POLICIES:
            a = client[scen, pol]
            b = run_scenario(scen, policies=(pol,), include_oracle=False,
                             seeds=CLIENT_SEEDS, device="cpu")[pol]
            for k in ("timeouts", "trips"):
                np.testing.assert_array_equal(
                    a.per_seed[k], b.per_seed[k],
                    err_msg=f"{scen}/{pol} {k}")
            for k in SUMMARY_STATS + RESILIENCE_STATS + ("hedged",
                                                         "fallback"):
                x = np.asarray(a.per_seed[k], float)
                y = np.asarray(b.per_seed[k], float)
                np.testing.assert_allclose(x, y, rtol=PARITY_RTOL, atol=1e-7,
                                           err_msg=f"{scen}/{pol}/{k}")
                d = np.abs(x - y) / np.maximum(np.abs(y), 1e-9)
                worst = max(worst, float(d.max()))
        n_tmo = int(client[scen, "perf_aware"].per_seed["timeouts"].sum())
        n_ff = sum(float(client[scen, pol].per_seed["fail_fast_rate"].sum())
                   for pol in POLICIES)
        n_trips = sum(int(client[scen, pol].per_seed["trips"].sum())
                      for pol in POLICIES)
        print(f"parity {scen} (registry shape, T = "
              f"{8 * len(CLIENT_SEEDS)}): perf_aware timed-out requests "
              f"{n_tmo}; over the 5 policies fail-fast rate sum "
              f"{n_ff:.4f}, breaker trips {n_trips}")
        assert n_tmo > 0, f"{scen}: no request timed out"
        if scen != "retry-storm":
            # the breaker scenarios trip breakers and fail fast
            assert n_trips > 0 and n_ff > 0, (scen, n_trips, n_ff)
    print(f"parity client plane: cpu {time.perf_counter() - t0:.1f} s")
    return worst


def traced_pass(T_seeds, n_trials) -> None:
    """bench_telemetry.py's LARGE cell (baseline, cut to TRACE_J
    requests) untraced and traced at
    sample_every 16 and 1, least_conn and perf_aware, on one stacked
    cluster: each pass's loop time, the overhead against the untraced
    pass in the same call, the sum rule and the trace's shape."""
    from dataclasses import replace
    from repro_torch.core import simcore
    from repro_torch.core.campaign import stack_clusters
    from repro_torch.core.rng import rng_seed
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.core.simulator import _build_cluster
    from repro_torch.core.telemetry import TraceConfig
    spec = get_scenario("baseline")
    shape = dict(LARGE, n_requests=TRACE_J)
    cfgs = [spec.compile(seed=s, n_trials=n_trials, **shape)
            for s in T_seeds]
    stacked = stack_clusters([_build_cluster(c) for c in cfgs])
    blocks = [(rng_seed(c.seed, "policy"), c.n_trials) for c in cfgs]
    J = TRACE_J
    for pol in ("least_conn", "perf_aware"):
        loop = {}
        for k in (None, 16, 1, None):
            c = stacked if k is None else replace(
                stacked, cfg=replace(stacked.cfg, trace=TraceConfig(k)))
            # eagerly, traced or not: the untraced baseline would
            # otherwise replay from a CUDA graph (phase 4b)
            out = simcore.run_compiled(c, pol, seed_blocks=blocks,
                                       eager=True)
            loop.setdefault(k, []).append(out["loop_s"])
            if k is not None:
                tr = out["trace"]
                err = sum_rule_err(tr)
                want = (stacked.cfg.n_trials, -(-J // k), 12)
                assert tr["data"].shape == want, tr["data"].shape
                assert err < 1e-6, f"trace sum rule {err} at k = {k}"
                print(f"  traced {pol} k={k}: loop {out['loop_s']:.3f} s "
                      f"= {out['loop_s'] / J * 1e3:.3f} ms/step, sum-rule "
                      f"error {err:.3e}, trace {tr['data'].shape}")
        base = min(loop[None])
        print(f"trace overhead {pol} (T = {stacked.cfg.n_trials}, R = "
              f"{len(stacked.app_of)}, J = {J}): untraced "
              f"{base / J * 1e3:.3f} ms/step (two passes "
              f"{', '.join(f'{x:.3f}' for x in loop[None])} s), k=16 "
              f"x{loop[16][0] / base:.3f}, k=1 x{loop[1][0] / base:.3f}")


def _summary_drift(a: dict, b: dict) -> float:
    """The largest relative difference between two ``run_compiled``
    summaries over every stat (timings and labels left out; NaN masks
    must match); the stats that differ are printed."""
    import numpy as np
    worst = 0.0
    assert set(a) == set(b), set(a) ^ set(b)
    for k, v in b.items():
        if k in ("loop_s", "capture_s", "backend", "device",
                 "simcore_backend"):
            continue
        if isinstance(v, dict):
            worst = max(worst, _summary_drift(a[k], v))
            continue
        x, y = np.asarray(a[k], float), np.asarray(v, float)
        assert x.shape == y.shape, k
        assert (np.isnan(x) == np.isnan(y)).all(), k
        x, y = np.nan_to_num(x), np.nan_to_num(y)
        d = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
        if d.size and d.max() > 0:
            i = int(d.argmax())
            print(f"  {k} differs: relative {d.max():.3e} at {i} "
                  f"({x.flat[i]!r} against {y.flat[i]!r})")
            worst = max(worst, float(d.max()))
    return worst


def _step_launches(fn, J: int) -> tuple:
    """(kernels the device ran, kernel and graph launch calls of the
    host) a step of one call of ``fn``, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sum(e.count for e in events
                  if str(e.device_type).endswith("CUDA")
                  and not e.key.startswith("Mem"))
    calls = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch"))
    return kernels / J, calls / J


def compiled_mode() -> None:
    """Phase 4b: the simulation core's compiled mode.  Baseline at phase
    4's full width and depth (MAIN_J), perf_aware and least_conn: an
    eager pass against ``prepare_compiled``'s closure (its first call
    captures the loop in CUDA graphs, every call replays), ms and
    launches a step, the capture's seconds, graph against eager on every
    summary stat, a second closure served by the cache; then
    ``fleet_throughput`` at the reference's full width (250 nodes, 5 x
    200 replicas, 4 trials) over FLEET_J requests: events/s, ms a step,
    RTTs, peak memory, the same stats under one seed and other stats
    under another, and its graph against the same steps run eagerly."""
    import numpy as np
    import torch
    from repro_torch.core import simcore
    from repro_torch.core.campaign import stack_clusters
    from repro_torch.core.rng import rng_seed
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.core.simulator import _build_cluster
    t_phase = time.perf_counter()
    spec = get_scenario("baseline")
    cfgs = [spec.compile(seed=s, n_trials=LARGE_TRIALS,
                         **dict(LARGE, n_requests=MAIN_J))
            for s in LARGE_SEEDS]
    stacked = stack_clusters([_build_cluster(c) for c in cfgs])
    blocks = [(rng_seed(c.seed, "policy"), c.n_trials) for c in cfgs]
    J = MAIN_J
    # phase 4's baseline passes captured these loops: drop them, so that
    # the capture is timed here
    simcore.clear_cache()
    saved = 0.0
    for pol in ("perf_aware", "least_conn"):
        # two eager passes, the faster one timed
        eager = min((simcore.run_compiled(stacked, pol, seed_blocks=blocks,
                                          eager=True) for _ in range(2)),
                    key=lambda r: r["loop_s"])
        misses = simcore.cache_stats()["misses"]
        run = simcore.prepare_compiled(stacked, pol, seed_blocks=blocks)
        first = run()                     # captures, then replays
        second = run()
        hits = simcore.cache_stats()["hits"]
        third = simcore.prepare_compiled(stacked, pol, seed_blocks=blocks)()
        stats = simcore.cache_stats()
        assert stats["misses"] == misses + 1 and stats["hits"] == hits + 1, \
            stats
        assert eager["backend"] == "eager" and all(
            r["backend"] == "graph" for r in (first, second, third))
        assert first["capture_s"] > 0 and second["capture_s"] == 0 \
            and third["capture_s"] == 0
        assert eager["host_syncs"] == first["host_syncs"] == 0
        drift = _summary_drift(first, eager)
        assert drift <= 1e-12, f"baseline/{pol}: graph vs eager {drift}"
        rerun = (_summary_drift(second, first),
                 _summary_drift(third, first))
        assert rerun == (0, 0), f"baseline/{pol}: reruns {rerun}"
        e_k, e_calls = _step_launches(
            lambda: simcore.run_compiled(stacked, pol, seed_blocks=blocks,
                                         eager=True), J)
        g_k, g_calls = _step_launches(run, J)
        e_ms = eager["loop_s"] / J * 1e3
        g_ms = min(second["loop_s"], third["loop_s"]) / J * 1e3
        saved += eager["loop_s"] - first["loop_s"] - first["capture_s"]
        print(f"compiled baseline/{pol} (T = {stacked.cfg.n_trials}, R = "
              f"{len(stacked.app_of)}, J = {J}): eager {e_ms:.4f} ms/step "
              f"({e_k:.1f} kernels, {e_calls:.1f} launch calls a step), "
              f"graph {g_ms:.4f} ms/step ({g_k:.1f} kernels, "
              f"{g_calls:.3f} launch calls a step), x{e_ms / g_ms:.2f}; "
              f"capture {first['capture_s']:.3f} s, first replay "
              f"{first['loop_s']:.3f} s; graph vs eager drift "
              f"{drift:.3e}; {stats}")
    print(f"phase 4's baseline passes take the graph: a first pass of "
          f"perf_aware and least_conn, capture included, saves "
          f"{saved:.2f} s against eager")
    # the fleet mode at the reference's full width, its peak memory with
    # nothing else cached
    simcore.clear_cache()
    t_fleet = time.perf_counter()
    runs = []
    for seed in (0, 0, 1):
        torch.cuda.reset_peak_memory_stats()
        eps, st = simcore.fleet_throughput(n_requests=FLEET_J, seed=seed)
        peak = torch.cuda.max_memory_allocated() / 2**30
        vals = [st[k] for k in ("mean_rtt", "p99_rtt", "wall_s",
                                "events_per_s")]
        assert st["backend"] == "graph" and np.isfinite(vals).all(), st
        print(f"fleet seed {seed} ({FLEET_J} requests x {st['n_trials']} "
              f"trials x {st['n_replicas']} replicas): {eps:.0f} events/s,"
              f" {st['loop_s'] / FLEET_J * 1e3:.4f} ms/step, capture "
              f"{st['capture_s']:.3f} s, wall {st['wall_s']:.2f} s, mean "
              f"RTT {st['mean_rtt']:.4f}, p99 {st['p99_rtt']:.4f}, peak "
              f"{peak:.3f} GiB, backend {st['backend']}")
        runs.append(st)
    for k in ("mean_rtt", "p99_rtt"):
        assert runs[0][k] == runs[1][k], (k, runs[0][k], runs[1][k])
        assert runs[2][k] != runs[0][k], (k, runs[2][k])
    # the graph's noise: every replay advances the generator as the same
    # steps run eagerly do
    kw = dict(n_requests=2000, n_nodes=250, n_replicas_per_app=200,
              n_apps=5, n_trials=4, policy="perf_aware", seed=0,
              arrival_rate=2000.0, noise_seed=7, device="cuda")
    g_st, g_resp = simcore._fleet(**kw)
    e_st, e_resp = simcore._fleet(eager=True, **kw)
    assert g_st["backend"] == "graph" and e_st["backend"] == "eager"
    assert np.array_equal(g_resp, e_resp), \
        np.abs(g_resp - e_resp).max()
    print(f"fleet graph vs eager at 2000 requests: equal responses; eager "
          f"{e_st['loop_s'] / 2000 * 1e3:.4f} ms/step, graph "
          f"{g_st['loop_s'] / 2000 * 1e3:.4f} ms/step; fleet part "
          f"{time.perf_counter() - t_fleet:.1f} s")
    simcore.clear_cache()
    print(f"phase 4b: {time.perf_counter() - t_phase:.1f} s")


def _kernel_wrappers() -> dict:
    """name -> wrapper of every kernel of the port, each with its
    ``launches`` count."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.gmm import gmm, gmm_bwd
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    return {"segment_sum": segment_sum, "flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssd": ssd, "gmm": gmm,
            "flash_attention_bwd": flash_attention_bwd, "gmm_bwd": gmm_bwd,
            "ssd_bwd": ssd_bwd}


#: wrapper -> its counters by variant, beside ``launches``
VARIANT_COUNTERS = {"flash_attention": ("tc", "fma"),
                    "decode_attention": ("mma", "fma"),
                    "ssd": ("tc", "fma"),
                    "gmm": ("wgmma", "fma"),
                    "flash_attention_bwd": ("tc", "fma"),
                    "gmm_bwd": ("wgmma", "fma"),
                    "ssd_bwd": ("tc", "fma")}

#: wrapper -> the CUDA kernels (function names) its launches run, for
#: the profiles' device time by wrapper
KERNEL_NAMES = {"segment_sum": ("segment_sum_rows",),
                "flash_attention": ("flash_fwd", "flash_fwd_tc"),
                "decode_attention": ("decode_fma", "decode_mma"),
                "ssd": ("ssd_fwd", "ssd_tc"),
                "gmm": ("gmm_f32_kernel", "gmm_wgmma", "gmm_wgmma_swap"),
                "flash_attention_bwd": ("bwd_delta", "flash_bwd",
                                        "flash_bwd_tc"),
                "gmm_bwd": ("gemm", "gemm_bf16", "gmm_bwd_wgmma"),
                "ssd_bwd": ("ssd_bwd", "ssd_bwd_u", "ssd_bwd_scan",
                            "ssd_bwd_tc", "ssd_bwd_finish")}


def kernel_wrapper(key: str):
    """The wrapper whose kernel a profiler event ``key`` (a demangled
    signature, e.g. ``void (anonymous namespace)::tc::flash_bwd_tc<128>(
    ...)``) names, or None."""
    import re
    m = re.search(r"::(\w+)\s*[<(]", key)
    if m is None:
        return None
    for wrapper, names in KERNEL_NAMES.items():
        if m.group(1) in names:
            return wrapper
    return None


def counts(kernels) -> dict:
    """Each wrapper's ``launches``, and its launches by variant as
    ``<name>.<variant>`` (e.g. ``flash_attention.tc``)."""
    out = {n: k.launches for n, k in kernels.items()}
    for n, variants in VARIANT_COUNTERS.items():
        for v in variants:
            out[f"{n}.{v}"] = getattr(kernels[n], f"{v}_launches")
    return out


def reset_counts(kernels) -> None:
    for n, k in kernels.items():
        k.launches = 0
        for v in VARIANT_COUNTERS.get(n, ()):
            setattr(k, f"{v}_launches", 0)


def _batch(cfg, prompts, dev) -> dict:
    """The engine's left-padded wave batch (with the zero vision stub of
    a ``vlm`` and the zero encoder frames of an ``encdec``)."""
    import numpy as np
    import torch
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (len(prompts), cfg.num_frontend_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    if cfg.family == "encdec":
        from repro_torch.serving.engine import ENC_FRAMES
        batch["enc_frames"] = torch.zeros(
            (len(prompts), ENC_FRAMES, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    return batch


def serve_full_width(dev, arch: str, waves, per_wave, edit=None) -> dict:
    """A serving path at full width: ``arch``'s weights from the port's
    own ``init_params`` with a seeded generator on the card (then
    ``edit(params, cfg)`` where given), ``waves`` of requests through
    ``ServingEngine``.  Checks tokens and logits, and that each wave
    launched each kernel of ``per_wave`` (name -> launches per wave, from
    the config) that many times and no other kernel.  Returns the launch
    counts, the engine and the first wave's prompts."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config(arch).resolve(tp=1)
    expect = per_wave(cfg)
    L, V = cfg.num_layers, cfg.vocab_size
    held = torch.cuda.memory_allocated()
    assert held < 1e9, f"{held / 1e9:.2f} GB still held before {arch}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if edit is not None:
        edit(params, cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve {cfg.name}: {L} layers, {n_params} parameters "
          f"({cfg.param_count()} by param_count), init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    eng = ServingEngine(cfg, params, device=dev, **SERVE)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    spent = {}

    def checked(name, fn):
        """``fn`` timed to its end on the card (the engine waits for its
        tokens right after anyway), its logits checked on the card."""
        def run(*args):
            nonlocal finite
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            finite = finite & torch.isfinite(logits[:, :V]).all()
            return logits, cache
        return run

    eng._prefill = checked("prefill", eng._prefill)
    eng._decode = checked("decode", eng._decode)
    kernels = _kernel_wrappers()
    reset_counts(kernels)
    for w, prompts in enumerate(waves):
        before = counts(kernels)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=w * len(prompts) + i, tokens=p,
                               max_new_tokens=NEW_TOKENS))
        spent.clear()
        t0 = time.perf_counter()
        done = eng.step_wave()
        wall = time.perf_counter() - t0
        got = {n: c - before[n] for n, c in counts(kernels).items()}
        for n, count in got.items():
            assert count == expect.get(n, 0), \
                f"wave {w}: {count} {n} launches, not {expect.get(n, 0)}"
        out = np.stack([r.output for r in done])
        assert out.shape == (len(prompts), NEW_TOKENS), out.shape
        assert ((out >= 0) & (out < V)).all(), "token outside the vocab"
        plen = max(len(p) for p in prompts)
        print(f"wave {w}: padded prompt {plen}, prefill "
              f"{spent['prefill'] * 1e3:.1f} ms, decode "
              f"{spent['decode'] / (NEW_TOKENS - 1) * 1e3:.2f} ms/step, "
              f"{out.size / wall:.1f} tokens/s, wall {wall:.3f} s, launches "
              + " ".join(f"{n} {c}" for n, c in got.items() if c))
        print(f"  rtt s: " + " ".join(f"{r.rtt:.3f}" for r in done))
    assert bool(finite), "a logit is not finite"
    launches = counts(kernels)
    print(f"{cfg.name} serving path launches: {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {"launches": launches, "engine": eng, "prompts": waves[0]}


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _profiled(label: str, fn):
    """Run ``fn`` once unprofiled and once under torch.profiler, each to
    its end on the card; print the wall times, the kernels and launch
    calls, the device's busy share of the profiled run, the largest
    kernels and the device time by wrapper (``KERNEL_NAMES``), and fail
    if a wrapper launched in the profiled run but none of its kernels
    was timed.  Returns ``fn``'s last result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    wrappers = _kernel_wrappers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        before = {n: k.launches for n, k in wrappers.items()}
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        step = time.perf_counter() - t0
        moved = [n for n, k in wrappers.items() if k.launches != before[n]]
    events = prof.key_averages()
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    kernels = [e for e in on_device if not e.key.startswith("Mem")]
    kern_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    print(f"profile {label}: {unprofiled * 1e3:.2f} ms unprofiled, "
          f"{step * 1e3:.2f} ms profiled; {n_kernels} kernels on the device, "
          f"{launches} launch calls; kernels busy {kern_us / 1e3:.2f} ms = "
          f"{kern_us / 1e6 / step * 100:.1f} % of the profiled run")
    if kern_us == 0:
        print("profile: no device time recorded (not measured)")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d} x  {e.key[:90]}")
    by_wrapper = {}
    for e in kernels:
        w = kernel_wrapper(e.key)
        if w is not None:
            us, n = by_wrapper.get(w, (0.0, 0))
            by_wrapper[w] = (us + e.self_device_time_total, n + e.count)
    if by_wrapper:
        print(f"profile {label}: device time by wrapper (every kernel of a "
              f"call under its wrapper's name): " + ", ".join(
                  f"{w} {us / 1e3:.3f} ms ({n} kernels)" for w, (us, n) in
                  sorted(by_wrapper.items(), key=lambda kv: -kv[1][0])))
    if kern_us > 0:
        silent = [n for n in moved if by_wrapper.get(n, (0.0, 0))[0] <= 0]
        assert not silent, (f"profile {label}: {silent} launched, but no "
                            f"kernel of theirs was timed (KERNEL_NAMES)")
    return out


def profile_serving(eng, prompts) -> None:
    """A prefill of the first wave's prompts and then the second decode
    step after it, at full width, each under torch.profiler after an
    unprofiled run of the same call (see :func:`_profiled`)."""
    from repro_torch.models import model
    cfg = eng.cfg
    batch = _batch(cfg, prompts, eng.device)
    plen = batch["tokens"].shape[1]
    logits, cache = _profiled(
        f"{cfg.name} prefill (B={len(prompts)}, padded prompt {plen})",
        lambda: model.prefill(eng.params, cfg, batch, cache_len=eng.max_seq))
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    logits, cache = model.decode_step(eng.params, cfg, cache, tok)
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    # both runs of the step write the same cache row (attention) or update
    # the state in place (Mamba2); the step's work is the same
    _profiled(f"{cfg.name} decode step (B={len(prompts)}, prompt {plen})",
              lambda: model.decode_step(eng.params, cfg, cache, tok))


def serving_parity(dev, arch: str, S: int, lengths, max_seq: int,
                   edit=None) -> None:
    """A serving path on CUDA and on the CPU at ``arch``'s smoke config in
    f32 (after ``edit(params, cfg)`` where given): prefill of ``S``
    tokens (an ``encdec`` model's encoder on seeded normal frames) and 4
    decode steps' logits within SERVE_PARITY_RTOL of the largest value,
    identical greedy tokens, and an engine wave (prompts of ``lengths``)
    with identical outputs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    if edit is not None:
        edit(params, cfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(4, S)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["enc_frames"] = torch.as_tensor(rng.standard_normal(
            (4, 8, cfg.d_model)).astype(np.float32))
    runs = {}
    for name in ("cuda", "cpu"):
        p = _to(params, name)
        batch = {"tokens": torch.as_tensor(toks, device=name),
                 **{k: v.to(name) for k, v in extra.items()}}
        logits, cache = model.prefill(p, cfg, batch, cache_len=S + 8)
        seq = [logits.cpu()]
        for _ in range(4):
            tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            logits, cache = model.decode_step(p, cfg, cache, tok)
            seq.append(logits.cpu())
        runs[name] = seq
    worst = 0.0
    for a, b in zip(runs["cuda"], runs["cpu"]):
        V = cfg.vocab_size
        rel = float((a[:, :V] - b[:, :V]).abs().max() / b[:, :V].abs().max())
        worst = max(worst, rel)
        assert rel <= SERVE_PARITY_RTOL, f"logits differ by {rel}"
        assert torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1))
    outs = {}
    for name in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params, device=name, max_batch=len(lengths),
                            max_seq=max_seq)
        for i, n in enumerate(lengths):
            eng.submit(Request(rid=i, tokens=toks[i, :n],
                               max_new_tokens=6))
        outs[name] = [r.output for r in eng.step_wave()]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(a, b)
    print(f"serving parity cuda vs cpu ({cfg.name}, f32): worst logit "
          f"drift {worst:.3e} of the largest (limit {SERVE_PARITY_RTOL}), "
          f"greedy tokens identical")


def int8_parity(arch: str, steps: int = 6) -> None:
    """The int8 KV cache on CUDA and on the CPU at ``arch``'s smoke config
    in f32: ``steps`` decode steps from ``init_cache``, logits within
    SERVE_PARITY_RTOL of the largest value, identical greedy tokens; the
    int8 rows within one step of each other (a projection's last-bit
    drift can flip a rounding tie) and the scales within 1e-5."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              kv_cache_dtype="int8").resolve(tp=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tok0 = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(4, 1))
    runs = {}
    for name in ("cuda", "cpu"):
        p = _to(params, name)
        cache = model.init_cache(cfg, 4, 16, device=name)
        tok = torch.as_tensor(tok0, device=name)
        seq = []
        for _ in range(steps):
            logits, cache = model.decode_step(p, cfg, cache, tok)
            tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            seq.append(logits.cpu())
        runs[name] = seq, {k: v.cpu() for k, v in cache.items()}
    V, worst = cfg.vocab_size, 0.0
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        rel = float((a[:, :V] - b[:, :V]).abs().max() / b[:, :V].abs().max())
        worst = max(worst, rel)
        assert rel <= SERVE_PARITY_RTOL, f"int8 logits differ by {rel}"
        assert torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1))
    got, want = runs["cuda"][1], runs["cpu"][1]
    flips = 0
    for k in ("k", "v"):
        assert got[k].dtype == torch.int8
        d = (got[k].int() - want[k].int()).abs()
        assert int(d.max()) <= 1, f"int8 {k} rows differ by {int(d.max())}"
        flips += int(d.count_nonzero())
    for k in ("k_scale", "v_scale"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
    print(f"int8 KV parity cuda vs cpu ({cfg.name}, f32, {steps} steps "
          f"from init_cache): worst logit drift {worst:.3e}, {flips} of "
          f"{2 * got['k'].numel()} int8 entries one step apart, greedy "
          f"tokens identical")


def int8_pass(dev, params) -> dict:
    """The int8 KV cache at full width on phase 5's qwen2-vl-7b weights:
    NEW_TOKENS greedy decode steps of max_batch rows from an int8
    ``init_cache`` of max_seq rows (the engine refuses int8: a wave's
    prefill leaves no scales, as the reference's).  Counts the kernels'
    launches from 0 (the decode kernel's one a layer a step, all
    ``mma``, and no other kernel), checks the
    logits finite and every written row's scales positive; returns the
    launches and the ms a step (a host clock around work that ends in a
    synchronise)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config(ARCH),
                              kv_cache_dtype="int8").resolve(tp=1)
    B, S, V, L = SERVE["max_batch"], SERVE["max_seq"], cfg.vocab_size, \
        cfg.num_layers
    cache = model.init_cache(cfg, B, S, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    tok = torch.randint(0, V, (B, 1), generator=g, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    kernels = _kernel_wrappers()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        logits, cache = model.decode_step(params, cfg, cache, tok)
        finite = finite & torch.isfinite(logits[:, :V]).all()
        tok = logits[:, :V].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / NEW_TOKENS * 1e3
    got = counts(kernels)
    launches = got["decode_attention"]
    want = {"decode_attention": L * NEW_TOKENS,
            "decode_attention.mma": L * NEW_TOKENS}
    assert all(c == want.get(n, 0) for n, c in got.items()), got
    assert bool(finite), "an int8-cache logit is not finite"
    assert cache["k"].dtype == torch.int8
    written = (cache["k_scale"][:, :, :NEW_TOKENS],
               cache["v_scale"][:, :, :NEW_TOKENS])
    assert all(bool((w > 0).all()) for w in written), "a scale is not > 0"
    assert not cache["k_scale"][:, :, NEW_TOKENS:].any()
    print(f"int8 KV pass ({cfg.name} full width, B={B}, cache {S} rows, "
          f"{NEW_TOKENS} steps from init_cache): {ms:.2f} ms/step, decode "
          f"launches {launches} (all mma); cache "
          f"{sum(t.numel() * t.element_size() for t in cache.values()) / 1e9:.3f}"
          f" GB")
    return {"launches": launches, "ms_per_step": ms}


def _route_pass(dev, cfg, params, name, prompts, seed_prompts, wrappers):
    """One phase 9 pass: three full-width replicas sharing ``params``
    behind a ``MorpheusRouter`` (wall clock), every prompt routed, then
    drained.  Returns the RTTs, the routed replicas, the per-wave launch
    counts, route() host seconds (submit excluded), plane dispatches and
    ``predict_all`` calls."""
    import numpy as np
    from repro_torch.monitoring.metrics import SimClock
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router import MorpheusRouter
    from repro_torch.testing import make_store, make_trained_predictor

    clock = SimClock(simulated=False)
    engines = [ServingEngine(cfg, params, device=dev, node=f"node-{i}",
                             slowdown=s, clock=clock, seed=i,
                             **ROUTER_ENGINE)
               for i, s in enumerate(ROUTER_SLOWDOWNS)]
    waves, submit_s = [], [0.0]
    for eng in engines:
        def step(orig=eng.step_wave, node=eng.node):
            before = counts(wrappers)
            out = orig()
            if out:
                waves.append((node, len(out), {
                    n: c - before[n] for n, c in counts(wrappers).items()}))
            return out

        def submit(req, orig=eng.submit):
            t0 = time.perf_counter()
            orig(req)
            submit_s[0] += time.perf_counter() - t0
        eng.step_wave, eng.submit = step, submit
    policy, _, plane = name.partition("+")
    predictors = None
    if plane:
        predictors = {e.node: make_trained_predictor(
            "serve", make_store(seed=i), "lr", seed=500 + i, node=e.node,
            device=dev) for i, e in enumerate(engines)}
    router = MorpheusRouter(engines, policy=policy, seed=0,
                            predictors=predictors, device=dev)
    seeded = []
    if policy == "perf_aware" and not plane:
        # the knowledge base from one observed wave per replica, as
        # examples/serve_cluster.py seeds it
        for eng, p in zip(engines, seed_prompts):
            eng.submit(Request(rid=-1, tokens=p,
                               max_new_tokens=ROUTER_NEW_TOKENS))
            done = eng.step_wave()
            router.kb.put("serve", eng.node, clock.now(), done[0].rtt)
            seeded.append((len(p), done[0].rtt))
    calls = [0]
    predict_all = router.plane.predict_all

    def counted(keys=None):
        calls[0] += 1
        return predict_all(keys)
    router.plane.predict_all = counted
    reqs = [Request(rid=i, tokens=p, max_new_tokens=ROUTER_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    submit_s[0] = 0.0
    route_s = 0.0
    for r in reqs:
        t0 = time.perf_counter()
        router.route(r)
        route_s += time.perf_counter() - t0
    route_s -= submit_s[0]
    done = router.drain()
    assert len(done) == len(reqs), (len(done), len(reqs))
    for r in reqs:
        assert r.output is not None and len(r.output) == ROUTER_NEW_TOKENS
        assert ((r.output >= 0) & (r.output < cfg.vocab_size)).all()
    return {"rtts": np.array([r.rtt for r in reqs]), "seeded": seeded,
            "routed": list(router.routed), "waves": waves,
            "route_us": route_s / len(reqs) * 1e6,
            "dispatches": router.plane.dispatches, "calls": calls[0]}


def router_full_width(dev, params, wrappers) -> dict:
    """Phase 9: the router at full width over three qwen2-vl-7b replicas
    sharing phase 5's weights, ROUTER_REQUESTS requests of PROMPT_LEN
    tokens and ROUTER_NEW_TOKENS new tokens each under every pass of
    ROUTER_PASSES, then the router's three card-against-CPU scenarios at
    deepseek-67b's smoke config in f32.  Returns the kernels' launches
    of the passes (read before the comparison)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.testing import (ROUTER_SCENARIOS,
                                     assert_router_runs_equal,
                                     router_scenario)

    cfg = get_config(ARCH).resolve(tp=1)
    L = cfg.num_layers
    per_wave = {"flash_attention": L, "flash_attention.tc": L,
                "decode_attention": L * (ROUTER_NEW_TOKENS - 1),
                "decode_attention.mma": L * (ROUTER_NEW_TOKENS - 1)}
    rng = np.random.default_rng(2)
    lens = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1,
                        size=ROUTER_REQUESTS + len(ROUTER_SLOWDOWNS))
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    seed_prompts, prompts = prompts[:3], prompts[3:]
    t_start = time.perf_counter()
    reset_counts(wrappers)
    runs = {}
    for name in ROUTER_PASSES:
        t0 = time.perf_counter()
        run = runs[name] = _route_pass(dev, cfg, params, name, prompts,
                                       seed_prompts, wrappers)
        for w, (node, B, got) in enumerate(run["waves"]):
            for n, c in got.items():
                assert c == per_wave.get(n, 0), \
                    f"{name} wave {w} ({node}, B={B}): {c} {n} launches, " \
                    f"not {per_wave.get(n, 0)}"
        rtts, routed = run["rtts"], run["routed"]
        share = [routed.count(i) / len(routed) for i in range(3)]
        routes = len(routed)
        print(f"router {name}: mean RTT {rtts.mean():.4f} s, p95 "
              f"{np.percentile(rtts, 95):.4f} s, shares fast "
              f"{share[0]:.3f} med {share[1]:.3f} slow {share[2]:.3f}; "
              f"route() {run['route_us']:.1f} us a request (submit "
              f"excluded); {run['dispatches'] / routes:.2f} plane "
              f"dispatches and {run['calls'] / routes:.2f} predict_all a "
              f"route; {len(run['waves'])} waves, wall "
              f"{time.perf_counter() - t0:.1f} s")
        print("  waves (node, B, flash, decode): " + "; ".join(
            f"{node} {B} {got['flash_attention.tc']} "
            f"{got['decode_attention.mma']}"
            for node, B, got in run["waves"]))
        if name == "perf_aware+plane":
            assert run["calls"] == routes, (run["calls"], routes)
            assert run["dispatches"] == routes, (run["dispatches"], routes)
        if name == "perf_aware":
            # the knowledge base's seeds: a wall-clock wave a replica
            print("  knowledge-base seeds (prompt tokens, RTT s): "
                  + ", ".join(f"{tag} {n} {rtt:.4f}" for tag, (n, rtt) in
                              zip(("fast", "med", "slow"), run["seeded"])))
            assert share[0] == max(share), \
                f"KB-seeded perf_aware gave the fast replica {share}"
    launches = counts(wrappers)
    n_waves = sum(len(r["waves"]) for r in runs.values())
    assert launches["flash_attention"] == L * n_waves > 0
    print(f"phase 9 router passes: {time.perf_counter() - t_start:.1f} s, "
          f"{n_waves} waves, launches {launches}")
    # card against CPU, one scenario per mirrored plane (SimClock)
    small = dataclasses.replace(get_config("deepseek-67b", smoke=True),
                                dtype="float32").resolve(tp=1)
    p = model.init_params(small, torch.Generator().manual_seed(0),
                          device="cpu")
    for name in ROUTER_SCENARIOS:
        t0 = time.perf_counter()
        got = router_scenario(name, small, _to(p, dev), dev)
        t1 = time.perf_counter()
        want = router_scenario(name, small, p, "cpu")
        assert_router_runs_equal(got, want)
        print(f"router parity {name} (deepseek-67b smoke, f32): cuda "
              f"{t1 - t0:.2f} s, cpu {time.perf_counter() - t1:.2f} s; "
              f"{len(got['routed'])} picks, {len(got['hedged'])} hedged, "
              f"{got['shed']} shed, {got['retries']} retries, "
              f"{got['timeouts']} timeouts, trips {got['trips']}: equal")
    return launches


def _ineff_row(series) -> str:
    return ", ".join(f"{x:g}: {r['inefficiency_pct']:.4f}%"
                     for x, r in series)


def fig11_sweeps(wrappers) -> None:
    """Phase 7: the paper's Fig. 11 at the reference's benchmark setting
    (bench_load_balancing.py: 200 trials x 300 requests), every point a
    policy pass and an oracle pass of the batched core on the card; the
    accuracy sweep held against the CPU at 32 trials."""
    import dataclasses

    import numpy as np
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.sweeps import (sweep_accuracy,
                                         sweep_heterogeneity,
                                         sweep_replicas)
    base = SimConfig(**FIG11)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    acc = sweep_accuracy(base, FIG11_ACCURACY)
    t1 = time.perf_counter()
    rep = sweep_replicas(base, FIG11_REPLICAS)
    t2 = time.perf_counter()
    het = sweep_heterogeneity(base, FIG11_HETEROGENEITY)
    t3 = time.perf_counter()
    launched = counts(wrappers)
    runs = 2 * (len(acc) + sum(len(v) for v in (*rep.values(),
                                                 *het.values())))
    print(f"fig11 ({FIG11['n_trials']} trials x {FIG11['n_requests']} "
          f"requests, {runs} runs of the core): accuracy {t1 - t0:.2f} s, "
          f"replicas {t2 - t1:.2f} s, heterogeneity {t3 - t2:.2f} s; "
          f"kernel launches {launched['segment_sum']} segment_sum")
    print(f"  fig11.1 perf_aware vs accuracy: {_ineff_row(acc)}")
    for pol, series in rep.items():
        print(f"  fig11.2/3 {pol} vs replicas: " + ", ".join(
            f"{c}: {r['inefficiency_pct']:.4f}% / waste "
            f"{r['resource_waste_pct']:.4f}%" for c, r in series))
    for pol, series in het.items():
        print(f"  fig11.4 {pol} vs heterogeneity: {_ineff_row(series)}")
    for series in (acc, *rep.values(), *het.values()):
        for _, r in series:
            assert all(np.isfinite(v) for v in r.values()), r
    assert all(n == 0 for k, n in launched.items() if k != "segment_sum"), \
        f"the sweeps launched a model kernel: {launched}"
    # the three EXPERIMENTS.md rows, beside the reference's readings
    a = dict(acc)
    print(f"  EXPERIMENTS.md fig11-1 (reference 8.0% -> 0.9% -> 0.0%): "
          f"p=0 {a[0.0]['inefficiency_pct']:.4f}% -> p=0.8 "
          f"{a[0.8]['inefficiency_pct']:.4f}% -> p=1.0 "
          f"{a[1.0]['inefficiency_pct']:.4f}%")
    at8 = {pol: dict(series)[8] for pol, series in rep.items()}
    print("  EXPERIMENTS.md fig11-2/3 at 8 replicas (reference rr/random "
          "21%/44% ineff/waste vs perf_aware 2.9%/6.8%): " + ", ".join(
              f"{pol} {r['inefficiency_pct']:.4f}%/"
              f"{r['resource_waste_pct']:.4f}%" for pol, r in at8.items()))
    h1 = {pol: dict(series)[1.0] for pol, series in het.items()}
    print(f"  EXPERIMENTS.md fig11-4 at h=1.0 (reference rr 27% vs "
          f"perf_aware ~0%): round_robin "
          f"{h1['round_robin']['inefficiency_pct']:.4f}%, perf_aware "
          f"{h1['perf_aware']['inefficiency_pct']:.4f}%")
    # one replica per app (one candidate, the oracle's) and perfect
    # predictions route as the oracle does: 0 up to the rounding of the
    # passes' RTT paths on the card
    k1 = max(abs(v) for series in rep.values()
             for v in dict(series)[1].values())
    print(f"  K = 1 (every policy) and p = 1.0: largest |%| "
          f"{max(k1, abs(a[1.0]['inefficiency_pct'])):.3e}")
    assert k1 < 1e-9 and abs(a[1.0]["inefficiency_pct"]) < 1e-9, (rep, a)
    assert at8["perf_aware"]["inefficiency_pct"] \
        < at8["round_robin"]["inefficiency_pct"], at8
    # the accuracy sweep, card against the CPU (K = 1 ran above)
    small = dataclasses.replace(base, n_trials=FIG11_PARITY_TRIALS)
    t0 = time.perf_counter()
    on_gpu = sweep_accuracy(small, FIG11_ACCURACY, device="cuda")
    t1 = time.perf_counter()
    on_cpu = sweep_accuracy(small, FIG11_ACCURACY, device="cpu")
    t2 = time.perf_counter()
    worst = 0.0
    for (p, g), (_, c) in zip(on_gpu, on_cpu):
        for k, v in c.items():
            np.testing.assert_allclose(g[k], v, rtol=PARITY_RTOL,
                                       atol=1e-4, err_msg=f"p={p} {k}")
            worst = max(worst, abs(g[k] - v))
    print(f"fig11 accuracy sweep at {FIG11_PARITY_TRIALS} trials, cuda "
          f"{t1 - t0:.2f} s vs cpu {t2 - t1:.2f} s: worst difference "
          f"{worst:.3e} pp (limit rtol {PARITY_RTOL}, atol 1e-4 pp)")


def _plane_fleet():
    """The 1000-predictor fleet of phase 8: 5 apps x 200 replicas, each
    app's replicas on distinct nodes of 250, every predictor reading 4
    of its node's 10 metrics over 5 s windows, families in turn; the
    store scraped every 200 ms for 80 s."""
    import numpy as np
    from repro_torch.core import zoo
    from repro_torch.core.simulator import APPS
    from repro_torch.testing import make_store, random_artifact
    n_nodes, per_app, n_metrics = PLANE["nodes"], PLANE["replicas"], 10
    names = [[f"node{n:03d}/m{i:02d}" for i in range(n_metrics)]
             for n in range(n_nodes)]
    store = make_store(seed=0, names=[m for ns in names for m in ns])
    rng = np.random.default_rng(1)
    arts = []
    for a, app in enumerate(tuple(APPS)[:PLANE["apps"]]):
        for j in range(per_app):
            node = (a * (n_nodes // PLANE["apps"]) + j) % n_nodes
            pick = np.sort(rng.choice(n_metrics, PLANE["k"], replace=False))
            i = len(arts)
            arts.append(random_artifact(
                app, f"node{node:03d}", zoo.ALL_MODELS[i % 9],
                [names[node][m] for m in pick],
                window_s=PLANE["window_s"], seed=i))
    return store, arts


def prediction_plane_fleet(wrappers) -> None:
    """Phase 8: the prediction plane at the full campaign's width, on the
    card, held against the CPU plane on the same artifacts."""
    import numpy as np
    import torch
    from repro_torch.core import zoo
    from repro_torch.core.prediction_plane import (PredictionPlane,
                                                   _bucket_predict)
    t0 = time.perf_counter()
    store, arts = _plane_fleet()
    gpu, cpu = PredictionPlane(), PredictionPlane(device="cpu")
    for art in arts:
        gpu.register(art, store)
        cpu.register(art, store)
    buckets = gpu.buckets()
    print(f"plane fleet: {len(arts)} predictors, {len(buckets)} buckets "
          f"(" + ", ".join(f"{b.family} {len(b.keys)}+{b.pad}"
                           for b in buckets)
          + f"), built in {time.perf_counter() - t0:.2f} s")
    reset_counts(wrappers)
    gpu.predict_all()                         # warm-up
    d0, walls = gpu.dispatches, []
    for _ in range(11):
        t = time.perf_counter()
        got = gpu.predict_all()
        walls.append(time.perf_counter() - t)
    launched = counts(wrappers)
    per_call = (gpu.dispatches - d0) / 11
    assert per_call == len(buckets), (per_call, len(buckets))
    assert all(n == 0 for n in launched.values()), \
        f"the plane launched a kernel: {launched}"
    t = time.perf_counter()
    want = cpu.predict_all()
    cpu_ms = (time.perf_counter() - t) * 1e3
    assert set(got) == set(want) and len(got) == len(arts)
    worst = {}
    for key, rec in want.items():
        fam = gpu._entries[key].artifact.family
        rtol = 1e-4 if fam in zoo.SEQ_MODELS else 1e-5
        assert np.isfinite(got[key].rtt_pred), key
        np.testing.assert_allclose(got[key].rtt_pred, rec.rtt_pred,
                                   rtol=rtol, err_msg=f"{key} {fam}")
        d = abs(got[key].rtt_pred - rec.rtt_pred) / abs(rec.rtt_pred)
        worst[fam] = max(worst.get(fam, 0.0), d)
    print(f"plane predict_all on the card: {statistics.median(walls) * 1e3:.3f}"
          f" ms median of 11 ({min(walls) * 1e3:.3f}-{max(walls) * 1e3:.3f})"
          f", {per_call:.0f} dispatches a call, "
          f"{statistics.median(walls) / len(arts) * 1e6:.2f} us a "
          f"prediction (predicted RTTs {min(r.rtt_pred for r in want.values()):.3f}-"
          f"{max(r.rtt_pred for r in want.values()):.3f} s); the CPU plane "
          f"{cpu_ms:.3f} ms; card vs CPU worst "
          f"relative difference by family: " + ", ".join(
              f"{f} {d:.2e}" for f, d in worst.items()))
    # one bucket's device call: windows in, predictions out
    state = gpu._gather_state(gpu.keys())
    for b in buckets:
        k = gpu._entries[b.keys[0]].artifact.k
        windows = np.zeros((len(b.keys) + b.pad, k, b.w_pts), np.float32)
        for i, key in enumerate(b.keys):
            windows[i] = state[key][0]

        def call():
            return _bucket_predict(
                b.family, b.sequential, b.params,
                torch.from_numpy(windows).to(gpu.device), b.lo, b.hi,
                b.y_lo, b.y_hi).cpu()
        call()
        ms = []
        for _ in range(11):
            t = time.perf_counter()
            call()
            ms.append((time.perf_counter() - t) * 1e3)
        print(f"  bucket {b.family} ({windows.shape}): "
              f"{statistics.median(ms):.3f} ms median of 11")
    recs = list(got.values())
    share = np.array([r.t_wall_state / r.t_wall_prediction for r in recs])
    print(f"  per prediction: t_wall_state median "
          f"{np.median([r.t_wall_state for r in recs]) * 1e6:.3f} us, "
          f"t_wall_feature median "
          f"{np.median([r.t_wall_feature for r in recs]) * 1e6:.3f} us; "
          f"state share {np.median(share) * 100:.2f} %, feature + "
          f"inference share {(1 - np.median(share)) * 100:.2f} %")


def _observe_windows(node, w_s) -> dict:
    """A completed task's monitoring windows, as the manager's callback
    reads them."""
    return {w: node.store.query_window(node.store.names, w, fast=True)[0]
            for w in w_s}


def predictor_training(dev, wrappers) -> int:
    """Phase 10: predictor training on the card.  1) The lifecycle at full
    width on the three nodes of the reference's benchmark fixture (294
    metrics a store), one plane sweep over every trained predictor, and an
    ``OnlineAdapter`` a manager fed 240 s more with the plane's
    predictions; 2) the zoo's nine families at Table 2's top tier (n =
    10,000); 3) a lifecycle and every family on the card against the CPU.
    Returns the segment sum's launches in 1)."""
    import resource

    import numpy as np
    import torch
    from repro_torch.core import selection, zoo
    from repro_torch.core.prediction_plane import PredictionPlane
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.testing import (FIT_RTOL, assert_fits_equal,
                                     assert_lifecycles_equal, run_lifecycle,
                                     zoo_data)
    t_phase = time.perf_counter()
    skipped0 = selection.select_model.skipped
    reset_counts(wrappers)
    runs = []
    for i in range(TRAIN["nodes"]):
        launches0 = segment_sum.launches
        t0 = time.perf_counter()
        node, mgr, hist = run_lifecycle(
            i, dev, n_noise_metrics=TRAIN["noise_metrics"],
            n_cycles=TRAIN["cycles"], cycle_s=TRAIN["cycle_s"])
        wall = time.perf_counter() - t0
        runs.append((node, mgr))
        assert len(node.store.names) == TRAIN["metrics"], \
            len(node.store.names)
        trained = [p for p in mgr.predictors.values()
                   if p.choice is not None]
        print(f"training {node.node} (factor {node.node_factor}): "
              f"{len(trained)} of {len(mgr.predictors)} predictors "
              f"trained, {len(node.store.names)} metrics, "
              f"{len(node.completed)} tasks, {wall:.2f} s; segment_sum "
              f"launches {segment_sum.launches - launches0}; seconds: "
              + ", ".join(f"{k} {v:.3f}"
                          for k, v in mgr.timer.summary().items()))
        for (app, _), p in mgr.predictors.items():
            sel = p.selected
            line = (f"  {app:10s} dataset {len(p.dataset):4d} (seen "
                    f"{p.dataset.n_seen})")
            if p.choice is not None:
                line += (f": window {sel.window_s:g} s, {sel.method}, "
                         f"k {len(sel.metric_idx)}, {p.choice.name}, "
                         f"normalized RMSE {p.choice.rmse:.4f}, full "
                         f"{p.full_trainings} / re-trainings "
                         f"{p.retrainings}")
                assert np.isfinite(p.choice.rmse) and p.choice.rmse < 1.0
            print(line)
    training_launches = segment_sum.launches
    launched = counts(wrappers)
    assert training_launches > 0, "training never launched segment_sum"
    assert all(n == 0 for k, n in launched.items()
               if not k.startswith("segment_sum")), \
        f"training launched a model kernel: {launched}"
    n_trained = sum(p.choice is not None for _, m in runs
                    for p in m.predictors.values())
    assert n_trained >= TRAIN["nodes"], n_trained
    # one sweep of one plane over every trained predictor
    plane = PredictionPlane(device=dev)
    for _, mgr in runs:
        for p in mgr.predictors.values():
            plane.register_predictor(p)
    t0 = time.perf_counter()
    recs = plane.predict_all()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    assert len(recs) == n_trained and all(
        np.isfinite(r.rtt_pred) and r.rtt_pred > 0 for r in recs.values())
    print(f"plane sweep over the {n_trained} trained predictors: "
          f"{sweep_ms:.3f} ms, {len(plane.buckets())} buckets")
    # the retrain loop: 240 s more, each completed task observed with
    # the plane's prediction (refreshed every 20 s), retraining on the
    # lifecycle's cadence (one collection cycle, at the end)
    for node, mgr in runs:
        adapter = mgr.online_adapter(retrain_every_s=TRAIN["cycle_s"])
        latest = {}

        def on_complete(task, node=node, adapter=adapter, latest=latest):
            adapter.observe(task.app, node.node, task.rtt,
                            _observe_windows(node, selection.WINDOWS_S),
                            predicted=latest.get(task.app))
        adapter.maybe_retrain(node.clock.now())           # arm
        t0 = time.perf_counter()
        for _ in range(int(TRAIN["cycle_s"] // TRAIN["adapt_step_s"])):
            latest.clear()
            latest.update({a: r.rtt_pred for (a, _), r in
                           mgr.plane.predict_all().items()})
            node.run(TRAIN["adapt_step_s"], on_complete=on_complete)
            adapter.maybe_retrain(node.clock.now())
        print(f"  {node.node} online adapter: {len(adapter.swaps)} "
              f"swaps in {time.perf_counter() - t0:.2f} s; accuracy "
              + ", ".join(f"{a} {adapter.accuracy(a, n):.3f}"
                          for (a, n) in adapter.predictors))
        # the retrain loop swapped a re-trained artifact into the plane,
        # and the plane serves each swapped predictor's newest version
        assert adapter.swaps, f"{node.node}: no artifact swapped"
        for key in {k for _, k, _ in adapter.swaps}:
            assert mgr.plane._entries[key].artifact.version == \
                mgr.predictors[key].artifact_version, key
    stored = sum(w.nbytes for _, m in runs for p in m.predictors.values()
                 for pay in p.dataset.payloads() for w in pay.values())
    print(f"phase 10 lifecycle: {stored / 2**30:.3f} GiB of stored windows, "
          f"peak host RSS of the process "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} "
          f"GiB, {time.perf_counter() - t_phase:.1f} s")

    # 2) the zoo at Table 2's top tier: all nine families at n = 10,000
    n = TRAIN["zoo_n"]
    X, y, Xs, ys = zoo_data(n + n // 5, TRAIN["zoo_d"], TRAIN["zoo_k"],
                            TRAIN["zoo_w"], seed=0)
    for fam, cls in zoo.FIT_CLASSES.items():
        seq = cls.sequential
        Xa, ya = (Xs, ys) if seq else (X, y)
        launches0 = segment_sum.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = cls(device=dev).fit(Xa[:n], ya[:n])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        pred = model.predict(Xa[n:]).cpu().numpy()
        rmse = float(np.sqrt(np.mean((pred - ya[n:]) ** 2)))
        base = float(np.sqrt(np.mean((ya[n:].mean() - ya[n:]) ** 2)))
        model.predict(Xa[n:n + 1]).cpu()
        us = []
        for _ in range(21):
            t0 = time.perf_counter()
            model.predict(Xa[n:n + 1]).cpu()
            us.append((time.perf_counter() - t0) * 1e6)
        print(f"zoo {fam} at n {n} ({Xa.shape[1:]}): fit {fit_s:.3f} s, RMSE "
              f"{rmse:.4f} against the mean's {base:.4f}, predict "
              f"{statistics.median(us):.1f} us (median of 21); segment_sum "
              f"launches {segment_sum.launches - launches0}")
        assert np.isfinite(pred).all(), fam
        # the same data as the reference's readings, then its bars
        want = ZOO_REF_RMSE[fam]
        assert abs(base - ZOO_REF_MEAN[seq]) <= 1e-5 * base, (fam, base)
        if len(want) == 1:
            assert abs(rmse - want[0]) <= 1e-3 * want[0], (fam, rmse, want)
        else:
            assert rmse < min(ZOO_DRAW_MARGIN * max(want), base), \
                (fam, rmse, want, base)

    # 3) the card against the CPU: a lifecycle, then every family from the
    # same initial parameters at n = 1,000 and 30 epochs
    t0 = time.perf_counter()
    on_card = run_lifecycle(0, dev, **TRAIN["parity"])
    t1 = time.perf_counter()
    on_cpu = run_lifecycle(0, "cpu", **TRAIN["parity"])
    t2 = time.perf_counter()
    n_par = assert_lifecycles_equal(on_card, on_cpu)
    print(f"training parity, {on_card[0].node} at "
          f"{len(on_card[0].store.names)} metrics: {n_par} trained, "
          f"datasets, selections, families and counts equal, RMSEs and "
          f"plane predictions within 1e-4 (card {t1 - t0:.2f} s, CPU "
          f"{t2 - t1:.2f} s)")
    X, y, Xs, ys = zoo_data(1000, TRAIN["zoo_d"], TRAIN["zoo_k"],
                            TRAIN["zoo_w"], seed=1)
    for fam, cls in zoo.FIT_CLASSES.items():
        seq = cls.sequential
        kw = {"epochs": 30} if fam in FIT_RTOL and fam != "svm" else {}
        fits = [cls(device=d, **kw).fit(Xs if seq else X, ys if seq else y)
                for d in (dev, "cpu")]
        assert_fits_equal(*fits, rtol=FIT_RTOL.get(fam, 1e-4))
    print("training parity: the nine families at n 1000 (30 epochs where "
          "they descend), card against CPU within " + ", ".join(
              f"{f} {t:g}" for f, t in FIT_RTOL.items())
          + ", trees by column and bin")
    skipped = selection.select_model.skipped - skipped0
    assert skipped == 0, f"{skipped} candidates skipped"
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s, skipped "
          f"candidates {skipped}")
    return training_launches


def audit_child(out: str) -> None:
    """Phase 14 (d)'s child process: the step audit's record of every
    distinct step on the CPU (``testing.step_records``), written to
    ``out``."""
    from repro_torch.testing import step_records
    t0 = time.perf_counter()
    recs = step_records("cpu")
    with open(out, "w") as f:
        json.dump({"records": recs, "seconds": time.perf_counter() - t0}, f)


def _per_seed_equal(got: dict, want: dict, label: str) -> None:
    import numpy as np
    assert set(got) == set(want), label
    for pol in want:
        a, b = got[pol], want[pol]
        assert a.n_hedged == b.n_hedged and a.n_fallback == b.n_fallback, \
            f"{label}/{pol}"
        for k in b.per_seed:
            np.testing.assert_array_equal(a.per_seed[k], b.per_seed[k],
                                          err_msg=f"{label}/{pol}/{k}")
        assert a.inefficiency_pct == b.inefficiency_pct, f"{label}/{pol}"


def shard_phase(wrappers, card: str) -> int:
    """Phase 14: simcore's trial-axis sharding and the analysis linter.

    (c) and (d)'s CPU half start first, in child processes: ``python -m
    repro_torch.analysis --format json`` (exit 0 asserted, its counts
    printed) and ``python3 chip_smoke.py --audit-child OUT``.  (a) On a
    one-rank NCCL group (joined through a file store, as phase 12b),
    ``run_scenario`` on SHARD_SCENARIOS at phase 6's mid shape for the
    four default policies and the oracle: ``simcore_backend == "shard"``
    and every stat equal bit for bit to the run without a group, the
    segment sum launched as often (the counts reset just before the
    group's runs and read just after: the phase's main path).  (b) The
    pad / block / cut path at world PAD_WORLD over PAD_T trials
    (``testing.blocks_summary``) on PAD_CASES, equal to the single-device
    run.  (d) The step audit on CUDA tensors equal to the CPU child's:
    every distinct step's ops, kernel calls and findings.  Returns the
    segment sum's launches in (a)'s group runs."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import simcore
    from repro_torch.core.campaign import (RESILIENCE_STATS, SUMMARY_STATS,
                                           run_scenario)
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.core.simulator import _build_cluster
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.testing import blocks_summary, step_records
    t_phase = time.perf_counter()
    audit_out = os.path.join(ROOT, "build", "audit_phase14.json")
    if os.path.exists(audit_out):
        os.remove(audit_out)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    linter = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--format", "json"],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    auditor = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--audit-child",
         audit_out], cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        # (a) the campaign over a one-rank NCCL group
        store = os.path.join(ROOT, "build", "nccl_store_shard")
        if os.path.exists(store):
            os.remove(store)
        kw = dict(seeds=MID_SEEDS, n_trials=MID_TRIALS, **MID)
        single, n_single = {}, 0
        for scen in SHARD_SCENARIOS:
            before = segment_sum.launches
            single[scen] = run_scenario(scen, device="cuda", **kw)
            n_single += segment_sum.launches - before
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1)
        try:
            sharded, secs = {}, {}
            reset_counts(wrappers)
            for scen in SHARD_SCENARIOS:
                t0 = time.perf_counter()
                sharded[scen] = run_scenario(scen, device="cuda",
                                             group=dist.group.WORLD, **kw)
                secs[scen] = time.perf_counter() - t0
            got = {n: c for n, c in counts(wrappers).items() if c}
        finally:
            dist.destroy_process_group()
            if os.path.exists(store):
                os.remove(store)
        n_shard = got.get("segment_sum", 0)
        for scen in SHARD_SCENARIOS:
            for pol, r in sharded[scen].items():
                assert (r.simcore_backend, r.ranks) == ("shard", 1), \
                    f"phase 14 (a) {scen}/{pol}: {r.simcore_backend}"
                assert single[scen][pol].simcore_backend == "single"
            _per_seed_equal(sharded[scen], single[scen], f"phase 14 (a) {scen}")
            print(f"phase 14 (a) {scen} sharded over a one-rank NCCL group "
                  f"(T = {len(MID_SEEDS) * MID_TRIALS}, R = "
                  f"{MID['n_replicas_per_app'] * 5}, J = {MID['n_requests']},"
                  f" {len(sharded[scen])} policies): {secs[scen]:.2f} s, "
                  f"every stat equal to the run without a group [{card}]")
        assert n_shard == n_single > 0, \
            f"phase 14 (a): segment sum {n_shard} launches sharded, " \
            f"{n_single} without a group"
        assert set(got) == {"segment_sum"}, f"phase 14 (a) launched {got}"
        print(f"phase 14 (a) launches {got}, {n_single} without a group; "
              f"NCCL flight recorder {nccl_recorder()}")
        # (b) the pad / block / cut path at world 4 on the card
        for scen, pol in PAD_CASES:
            cluster = _build_cluster(get_scenario(scen).compile(
                seed=0, n_trials=PAD_T, **MID))
            t0 = time.perf_counter()
            summary, n = blocks_summary(cluster, pol, PAD_WORLD, "cuda")
            t1 = time.perf_counter()
            want = simcore.run_compiled(cluster, pol, device="cuda")
            assert n == PAD_WORLD
            for k in SUMMARY_STATS + RESILIENCE_STATS:
                np.testing.assert_array_equal(summary[k], want[k],
                                              err_msg=f"phase 14 (b) {scen} {k}")
            np.testing.assert_array_equal(summary["chosen"], want["chosen"])
            assert summary["n_timeouts"] == want["n_timeouts"]
            print(f"phase 14 (b) {scen}/{pol}: T = {PAD_T} padded to "
                  f"{-(-PAD_T // PAD_WORLD) * PAD_WORLD}, {n} blocks run in "
                  f"turn ({want['backend']}) in {t1 - t0:.2f} s, cut back: "
                  f"equal to the single-device run [{card}]")
        simcore.clear_cache()
        # (d) the step audit on the card against the CPU child's
        t0 = time.perf_counter()
        on_card = step_records("cuda")
        t1 = time.perf_counter()
        out, _ = auditor.communicate(timeout=ANALYSIS_CHILD_TIMEOUT)
        assert auditor.returncode == 0, \
            f"phase 14 (d)'s child failed: rc {auditor.returncode}\n{out}"
        with open(audit_out) as f:
            child = json.load(f)
        on_cpu = child["records"]
        assert list(on_card) == list(on_cpu), "phase 14 (d): the statics"
        for label in on_cpu:
            assert on_card[label] == on_cpu[label], \
                f"phase 14 (d) {label}: card {on_card[label]} cpu " \
                f"{on_cpu[label]}"
        n_ops = sum(sum(r["ops"].values()) for r in on_cpu.values())
        n_find = sum(len(r["findings"]) for r in on_cpu.values())
        print(f"phase 14 (d) step audit on the card: {len(on_card)} statics, "
              f"{n_ops} ops and kernel calls, {n_find} findings (before the "
              f"baseline), equal to the CPU's; card {t1 - t0:.1f} s, CPU "
              f"child {child['seconds']:.1f} s [{card}]")
        # (c) the linter
        out, err = linter.communicate(timeout=ANALYSIS_CHILD_TIMEOUT)
        assert linter.returncode == 0, \
            f"phase 14 (c): the linter exited {linter.returncode}\n{out}{err}"
        report = json.loads(out)
        assert report["ok"] and report["counts"]["gating"] == 0, report
        print(f"phase 14 (c) python -m repro_torch.analysis: rc 0, counts "
              f"{report['counts']}")
    finally:
        for p in (linter, auditor):
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return n_shard


def finite_stats(res, stats) -> None:
    import numpy as np
    for pol, r in res.items():
        for k in stats:
            v = np.asarray(r.per_seed[k], float)
            assert np.isfinite(v).all(), f"{r.scenario}/{pol}/{k}: {v}"
        if r.inefficiency_pct is not None:
            assert np.isfinite(r.inefficiency_pct), f"{r.scenario}/{pol}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.core.campaign import SUMMARY_STATS, run_scenario
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.testing import seed_lora

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind} x{count}")

    # phase 2: build every kernel
    t0 = time.perf_counter()
    libs = kbuild.build()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        entry = ""
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line or "C75" in line:
                print(f"  {name} {entry}: {line.strip()}")
            # ptxas's C7512 / C7518 remarks: the wgmmas were serialised
            assert not ("C7512" in line or "C7518" in line), \
                f"{name} {entry}: wgmma serialised: {line.strip()}"
            # the gmm and SSD tensor-core kernels hold their accumulators
            # in registers: a spill would put them in local memory
            if (name == "gmm" or "ssd_tc" in entry) \
                    and "spill stores" in line:
                assert line.split("bytes spill stores")[0].split(",")[-1] \
                    .strip() == "0", f"{name} {entry} spills: {line.strip()}"

    # phase 3: kernels against their plain versions, timed, at the main
    # paths' shapes (the serving waves' padded prompt lengths)
    from repro_torch.configs.base import get_config
    plens = [max(len(p) for p in w)
             for w in wave_prompts(get_config(ARCH).vocab_size)]
    mamba = get_config(MAMBA_ARCH)
    waves_ssm = mamba_waves(mamba.vocab_size, mamba.ssm.chunk_size)
    ssm_len = max(len(p) for w in waves_ssm for p in w)
    moe_prefill_cs, moe_decode_c = moe_path_rows(get_config(MOE_ARCH),
                                                 plens)
    print(f"gmm path rows: prefill C {moe_prefill_cs} (padded prompts "
          f"{plens}), decode C {moe_decode_c}")
    hybrid = get_config(HYBRID_ARCH)
    waves_hybrid = mamba_waves(hybrid.vocab_size, hybrid.ssm.chunk_size)
    hybrid_len = max(len(p) for w in waves_hybrid for p in w)
    kernels = [check_segment_sum(dev), check_flash(dev, max(plens)),
               check_decode(dev, max(plens)), check_ssd(dev, ssm_len),
               check_gmm(dev, moe_prefill_cs, moe_decode_c)]
    kernels[0].update(check_segment_sum_training(dev))
    # the rest of the catalogue's shapes (phases 5d-5f)
    catalogue = check_catalogue_shapes(dev, hybrid_len, max(plens))
    for k in kernels[1:4]:
        k["catalogue_shapes"] = catalogue[k["name"]]
    # the backward kernels (phase 11's path)
    kernels += check_backward(dev)
    kernels.append(check_ssd_backward(dev))
    for k in kernels:
        lib = "no library call" if k["library_ms"] is None \
            else f"{k['library_ms'] * 1e3:.2f} us library"
        print(f"{k['name']}: {k['ms'] * 1e3:.2f} us kernel, "
              f"{k['plain_ms'] * 1e3:.2f} us plain, {lib}, "
              f"bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']})")
    sync_us = sync_cost_us(dev)
    print(f"host sync (bool(mask.any()) on (256, 1000)): {sync_us:.1f} us")
    print(f"phase 3 done: {time.perf_counter() - t_start:.1f} s into the run")

    # phase 4: the simulation path at full width
    wrappers = _kernel_wrappers()
    reset_counts(wrappers)
    per_scen = {}
    torch.cuda.reset_peak_memory_stats()
    for scen in MAIN_SCENARIOS:
        before = segment_sum.launches
        t0 = time.perf_counter()
        res = run_scenario(scen, seeds=LARGE_SEEDS, n_trials=LARGE_TRIALS,
                           **dict(LARGE, n_requests=MAIN_J))
        total = time.perf_counter() - t0
        per_scen[scen] = segment_sum.launches - before
        finite_stats(res, SUMMARY_STATS)
        J = MAIN_J
        print(f"{scen}: {total:.1f} s total (build + 5 passes), "
              f"segment_sum launches {per_scen[scen]}")
        for pol, r in res.items():
            ineff = "" if r.inefficiency_pct is None \
                else f" ineff {r.inefficiency_pct:.2f}%"
            fb = f" fallback {r.n_fallback}" if r.n_fallback else ""
            print(f"  {scen}/{pol} ({r.backend}): wall {r.wall_s:.2f} s, "
                  f"loop {r.loop_s:.2f} s = {r.loop_s / J * 1e6:.0f} us/step, "
                  f"host syncs {r.host_syncs} (~{r.host_syncs * sync_us / 1e6:.2f} s), "
                  f"mean_rtt {r.stat('mean_rtt'):.4f} p99_rtt "
                  f"{r.stat('p99_rtt'):.4f}{ineff}{fb}")
            if r.telemetry is not None:
                tm = r.telemetry
                assert tm["routed_inactive"] == 0, \
                    f"{scen}/{pol} routed onto a drained replica"
                print(f"    waste {r.stat('waste'):.4f} shed_rate "
                      f"{r.stat('shed_rate'):.5f} slo_violation_s "
                      f"{r.stat('slo_violation_s'):.1f}; epochs "
                      f"{tm['decisions']}, scale-ups "
                      f"{int(tm['scale_ups'].sum())}, scale-downs "
                      f"{int(tm['scale_downs'].sum())}, wakeups "
                      f"{int(tm['wakeups'].sum())}, active at the end "
                      f"{int(tm['active_final'].sum())}, mean util "
                      f"{float(tm['mean_util'].mean()):.3f}")
        if scen == "baseline":
            pa, rr = res["perf_aware"].stat("mean_rtt"), \
                res["round_robin"].stat("mean_rtt")
            assert pa < rr, f"baseline perf_aware {pa} >= round_robin {rr}"
    # the client plane at its registry shape
    print(f"phase 4 full width: {time.perf_counter() - t_start:.1f} s into "
          f"the run")
    client = client_passes(per_scen)
    main_launches = segment_sum.launches
    for scen in CLIENT_SCENARIOS:
        per_scen[scen] = sum(per_scen[scen, pol] for pol in POLICIES)
    print("correlated-outage segment_sum launches (the outage's resync): "
          + ", ".join(f"{pol} {per_scen['correlated-outage', pol]}"
                      for pol in POLICIES))
    assert per_scen["correlated-outage", "perf_aware"] > 0 \
        and per_scen["correlated-outage", "oracle"] > 0, \
        "the correlated outage's resync never launched the segment sum"
    for scen in KERNEL_SCENARIOS:
        assert per_scen[scen] > 0, f"segment_sum never launched on {scen}"
    # the storm: retries amplify the load (attempts), breakers and
    # admission keep more requests served
    storm, saved = (client[s, "perf_aware"] for s in CLIENT_SCENARIOS[1:])
    assert storm.stat("attempts_per_req") > 1.5, \
        storm.stat("attempts_per_req")
    assert saved.stat("goodput") > storm.stat("goodput") + 0.1, \
        (saved.stat("goodput"), storm.stat("goodput"))
    assert all(k.launches == 0 for n, k in wrappers.items()
               if n != "segment_sum"), "the simulation launched a model kernel"
    kernels[0]["simulation_launches"] = main_launches
    kernels[0]["launches"] = main_launches
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")

    # where the loop's time goes (not part of the main-path count)
    profile_pass("stale-predictions", "perf_aware", PROFILE_J)
    profile_pass("stale-predictions", "least_conn", PROFILE_J)
    profile_pass("drift-fallback", "perf_aware", PROFILE_J)
    # the capacity plane: perf_aware folds a prediction a step,
    # least_conn the completions at each epoch (one host read an epoch)
    profile_pass("spot-preemption", "perf_aware", PROFILE_J)
    profile_pass("spot-preemption", "least_conn", PROFILE_J)
    # the client plane: launches a step of perf_aware's and
    # least_conn's passes (cut to 30 requests), the retry storm's
    # perf_aware profiled at its registry width over its first
    # RETRY_STORM_PROFILE_J requests (the ramp and the collapse past the
    # 25 s timeouts), and the trace's overhead at LARGE
    t0 = time.perf_counter()
    for scen in CLIENT_SCENARIOS:
        per_step = {pol: launches_per_step(scen, pol, 30, seeds=CLIENT_SEEDS)
                    for pol in ("perf_aware", "least_conn")}
        print(f"{scen} launches/step: " + ", ".join(
            f"{pol} {n:.1f}" for pol, n in per_step.items()))
    t1 = time.perf_counter()
    profile_pass("retry-storm", "perf_aware", RETRY_STORM_PROFILE_J,
                 seeds=CLIENT_SEEDS, n_trials=8, shape={})
    t2 = time.perf_counter()
    traced_pass(LARGE_SEEDS, LARGE_TRIALS)
    print(f"client launch counts {t1 - t0:.1f} s, retry-storm profile "
          f"{t2 - t1:.1f} s, traced pass {time.perf_counter() - t2:.1f} s; "
          f"{time.perf_counter() - t_start:.1f} s into the run")

    print(f"phase 4 done: {time.perf_counter() - t_start:.1f} s into the run")
    # phase 4b: the compiled mode (CUDA graphs, the cache, the fleet mode)
    compiled_mode()
    print(f"phase 4b done: {time.perf_counter() - t_start:.1f} s into the "
          f"run")
    # phase 5: the serving path at full width (each wave: the flash
    # kernel once per layer, the decode kernel once per layer and step)
    served = serve_full_width(
        dev, ARCH, wave_prompts(get_config(ARCH).vocab_size),
        lambda cfg: {"flash_attention": cfg.num_layers,
                     "flash_attention.tc": cfg.num_layers,
                     "decode_attention": cfg.num_layers * (NEW_TOKENS - 1),
                     "decode_attention.mma":
                         cfg.num_layers * (NEW_TOKENS - 1)})
    for k in kernels[1:3]:
        k["launches"] = served["launches"][k["name"]]
        assert k["launches"] > 0, f"{k['name']} never launched"
    profile_serving(served["engine"], served["prompts"])
    # phase 5's int8 pass: decode from an int8 cache on these weights
    kernels[2]["launches"] += int8_pass(dev, served["engine"].params)[
        "launches"]
    # phase 9: the router over three replicas sharing these weights
    print(f"phase 5 serving done: {time.perf_counter() - t_start:.1f} s "
          f"into the run")
    routed = router_full_width(dev, served["engine"].params, wrappers)
    for k in kernels[1:3]:
        k["launches"] += routed[k["name"]]
    print(f"phase 9 done: {time.perf_counter() - t_start:.1f} s into the run")
    del served
    # phase 9's counting wrappers made reference cycles through its
    # engines, which hold the weights
    gc.collect()
    torch.cuda.empty_cache()

    # phase 5b: the Mamba2 serving path at full width (each wave: the SSD
    # kernel once per layer, in prefill, every call on the tensor cores)
    served = serve_full_width(dev, MAMBA_ARCH, waves_ssm[:CUT_WAVES],
                              lambda cfg: {"ssd": cfg.num_layers,
                                           "ssd.tc": cfg.num_layers})
    kernels[3].update(launches=served["launches"]["ssd"],
                      tc_launches=served["launches"]["ssd.tc"],
                      fma_launches=served["launches"]["ssd.fma"])
    assert kernels[3]["launches"] > 0, "ssd never launched"
    assert kernels[3]["tc_launches"] == kernels[3]["launches"], \
        "an ssd call of the Mamba2 waves missed the tensor cores"
    profile_serving(served["engine"], served["prompts"])
    del served
    torch.cuda.empty_cache()

    # phase 5c: the MoE serving path at full width (each wave: three
    # grouped matmuls per layer in prefill and in each decode step, and
    # the attention kernels as in phase 5)
    served = serve_full_width(
        dev, MOE_ARCH,
        wave_prompts(get_config(MOE_ARCH).vocab_size)[:CUT_WAVES],
        lambda cfg: {"gmm": 3 * cfg.num_layers * NEW_TOKENS,
                     "gmm.wgmma": 3 * cfg.num_layers * NEW_TOKENS,
                     "flash_attention": cfg.num_layers,
                     "flash_attention.tc": cfg.num_layers,
                     "decode_attention": cfg.num_layers * (NEW_TOKENS - 1),
                     "decode_attention.mma":
                         cfg.num_layers * (NEW_TOKENS - 1)})
    kernels[4]["launches"] = served["launches"]["gmm"]
    assert kernels[4]["launches"] > 0, "gmm never launched"
    profile_serving(served["engine"], served["prompts"])
    del served
    torch.cuda.empty_cache()

    # phases 5d-5f: the rest of the catalogue at full width.  5d, Zamba2
    # (its LoRA b matrices seeded nonzero): each wave the SSD kernel once a
    # layer, flash once a group (head dim 160) and the decode kernel once
    # a group a step; 5e, MLA: flash once a layer (D 96 / Dv 64), decode
    # in PyTorch ops (the reference's absorbed form); 5f, the
    # encoder-decoder: flash once an encoder layer and twice a decoder
    # layer, the decode kernel twice a decoder layer a step
    def per_wave(flash, decode, ssd=0):
        counts = {"flash_attention": flash, "flash_attention.tc": flash,
                  "decode_attention": decode * (NEW_TOKENS - 1),
                  "decode_attention.mma": decode * (NEW_TOKENS - 1)}
        return {**counts, "ssd": ssd, "ssd.tc": ssd}

    def groups(cfg):
        return cfg.num_layers // cfg.hybrid.shared_every

    catalogue_paths = (
        (HYBRID_ARCH, waves_hybrid,
         lambda cfg: per_wave(groups(cfg), groups(cfg), cfg.num_layers),
         seed_lora),
        (MLA_ARCH, wave_prompts(get_config(MLA_ARCH).vocab_size),
         lambda cfg: per_wave(cfg.num_layers, 0), None),
        (ENCDEC_ARCH, wave_prompts(get_config(ENCDEC_ARCH).vocab_size),
         lambda cfg: per_wave(cfg.enc_layers + 2 * cfg.num_layers,
                              2 * cfg.num_layers), None))
    for arch, waves, expect, edit in catalogue_paths:
        served = serve_full_width(dev, arch, waves, expect, edit=edit)
        for k in kernels[1:4]:
            k["launches"] += served["launches"][k["name"]]
        kernels[3]["tc_launches"] += served["launches"]["ssd.tc"]
        profile_serving(served["engine"], served["prompts"])
        del served
        torch.cuda.empty_cache()
        print(f"{arch} done: {time.perf_counter() - t_start:.1f} s into the "
              f"run")

    # phase 6: CUDA against the CPU: the campaign at the mid shape
    print(f"phase 5 done: {time.perf_counter() - t_start:.1f} s into the run")
    from repro_torch.core.campaign import RESILIENCE_STATS
    from repro_torch.core.telemetry import TraceConfig
    worst = 0.0
    for scen in PARITY_SCENARIOS:
        kw = dict(seeds=MID_SEEDS, n_trials=MID_TRIALS, **MID)
        if "@" in scen:
            scen, k = scen.split("@")
            kw["trace"] = TraceConfig(sample_every=int(k))
        t0 = time.perf_counter()
        on_gpu = run_scenario(scen, device="cuda", **kw)
        t1 = time.perf_counter()
        on_cpu = run_scenario(scen, device="cpu", **kw)
        t2 = time.perf_counter()
        for pol in on_cpu:
            a, b = on_gpu[pol], on_cpu[pol]
            assert a.n_hedged == b.n_hedged, f"{scen}/{pol} n_hedged"
            assert a.n_fallback == b.n_fallback, f"{scen}/{pol} n_fallback"
            assert (a.telemetry is None) == (b.telemetry is None)
            for k in TELEMETRY if b.telemetry is not None else ():
                np.testing.assert_array_equal(
                    a.telemetry[k], b.telemetry[k],
                    err_msg=f"{scen}/{pol} telemetry {k}")
            np.testing.assert_array_equal(
                a.per_seed["timeouts"], b.per_seed["timeouts"],
                err_msg=f"{scen}/{pol} timeouts")
            assert (a.trace is None) == (b.trace is None) \
                == ("trace" not in kw)
            if b.trace is not None:
                x, y = a.trace["data"], b.trace["data"]
                np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
                np.testing.assert_allclose(
                    np.nan_to_num(x), np.nan_to_num(y), rtol=PARITY_RTOL,
                    atol=1e-7, err_msg=f"{scen}/{pol} trace")
                assert sum_rule_err(a.trace) < 1e-6
            for k in SUMMARY_STATS + RESILIENCE_STATS + ("hedged",
                                                         "fallback"):
                x = np.asarray(a.per_seed[k], float)
                y = np.asarray(b.per_seed[k], float)
                np.testing.assert_allclose(x, y, rtol=PARITY_RTOL, atol=1e-7,
                                           err_msg=f"{scen}/{pol}/{k}")
                d = np.abs(x - y) / np.maximum(np.abs(y), 1e-9)
                worst = max(worst, float(d.max()))
            if b.inefficiency_pct is not None:
                np.testing.assert_allclose(
                    a.inefficiency_pct, b.inefficiency_pct,
                    rtol=PARITY_RTOL, atol=1e-7,
                    err_msg=f"{scen}/{pol}/inefficiency_pct")
        n_tmo = int(on_cpu["perf_aware"].per_seed["timeouts"].sum())
        print(f"parity {scen}{' traced' if 'trace' in kw else ''} (mid "
              f"shape): cuda {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s, "
              f"timed-out requests {n_tmo} (perf_aware)")
    worst = max(worst, client_parity(client))
    print(f"parity cuda vs cpu: worst relative drift {worst:.3e} "
          f"(limit {PARITY_RTOL})")
    serving_parity(dev, ARCH, S=24, lengths=(9, 13, 17, 21), max_seq=32)
    serving_parity(dev, MAMBA_ARCH, S=64, lengths=(9, 40, 64, 17),
                   max_seq=96)
    serving_parity(dev, MOE_ARCH, S=24, lengths=(9, 13, 17, 21), max_seq=32)
    serving_parity(dev, HYBRID_ARCH, S=64, lengths=(9, 40, 64, 17),
                   max_seq=96, edit=seed_lora)
    serving_parity(dev, MLA_ARCH, S=24, lengths=(9, 13, 17, 21), max_seq=32)
    serving_parity(dev, ENCDEC_ARCH, S=24, lengths=(9, 13, 17, 21),
                   max_seq=32)
    int8_parity(ARCH)
    # phase 6's training half: a train step on the card against the CPU
    print(f"train parity: worst drift {train_parity(dev):.3e}")

    # phase 7: the paper's Fig. 11 sweeps on the card
    print(f"phase 6 done: {time.perf_counter() - t_start:.1f} s into the run")
    fig11_sweeps(wrappers)
    # the sweeps' captured loops hold card memory the later phases need
    from repro_torch.core import simcore
    print(f"fig11 loop cache: {simcore.cache_stats()}")
    simcore.clear_cache()
    # phase 8: the prediction plane at the full campaign's width
    print(f"phase 7 done: {time.perf_counter() - t_start:.1f} s into the run")
    prediction_plane_fleet(wrappers)
    # phase 10: predictor training on the card (its own main path: the
    # counts are reset just before its lifecycles and read just after)
    print(f"phase 8 done: {time.perf_counter() - t_start:.1f} s into the run")
    training = predictor_training(dev, wrappers)
    kernels[0]["training_launches"] = training
    kernels[0]["launches"] += training

    # phase 11: LM training at full width (its own main path: the counts
    # are reset just before each step and read just after)
    print(f"phase 10 done: {time.perf_counter() - t_start:.1f} s into the "
          f"run")
    runs = [train_full_width(dev, MOE_ARCH, LM_TRAIN["layers"],
                             LM_TRAIN["steps"], LM_TRAIN["warmup"],
                             wrappers),
            train_full_width(dev, ARCH, LM_TRAIN["layers"], 1, 1, wrappers),
            train_full_width(dev, MAMBA_ARCH,
                             get_config(MAMBA_ARCH).num_layers,
                             MAMBA_TRAIN["steps"], MAMBA_TRAIN["warmup"],
                             wrappers),
            train_full_width(dev, HYBRID_ARCH, HYBRID_TRAIN_LAYERS, 1, 1,
                             wrappers)]
    by_name = {k["name"]: k for k in kernels}
    for name in ("flash_attention", "gmm", "ssd", "flash_attention_bwd",
                 "gmm_bwd", "ssd_bwd"):
        n = sum(r.get(name, 0) for r in runs)
        assert n > 0, f"{name} never launched in phase 11"
        by_name[name]["training_launches"] = n
        by_name[name]["launches"] += n

    # phase 12: the launchers and the multi-device layer (their own main
    # path: the counts are reset just before each launcher, read after)
    print(f"phase 11 done: {time.perf_counter() - t_start:.1f} s into the "
          f"run")
    t_phase = time.perf_counter()
    train_got, mcfg, mstate = launch_train_phase(dev, wrappers, card)
    launch_multi_device_phase(dev, mcfg, mstate, card)
    del mstate
    serve_got = launch_serve_phase(dev, wrappers, card)
    for name in ("ssd", "ssd_bwd", "flash_attention", "decode_attention"):
        n = train_got.get(name, 0) + serve_got.get(name, 0)
        assert n > 0, f"{name} never launched in phase 12"
        by_name[name]["launcher_launches"] = n
        by_name[name]["launches"] += n
    # phase 12e: tensor parallelism over the model axis (its own main
    # path: the counts are reset just before and read just after)
    t0 = time.perf_counter()
    tp_got, tp_peak = tensor_parallel_phase(dev, wrappers, card)
    for name in ("flash_attention", "flash_attention_bwd", "gmm", "gmm_bwd"):
        n = tp_got.get(name, 0)
        assert n > 0, f"{name} never launched in phase 12e"
        by_name[name]["tp_launches"] = n
        by_name[name]["launches"] += n
    for name, rows in check_tp_local_kernels(dev, card).items():
        by_name[name]["tp_local_shapes"] = rows
    print(f"phase 12e: {time.perf_counter() - t0:.1f} s (peak "
          f"{tp_peak:.2f} GB); launches {tp_got} [{card}]")
    # phase 12f: serving under tensor parallelism (its own main path: the
    # counts are reset just before its waves and read just after)
    t0 = time.perf_counter()
    serve_tp_got, serve_tp_peak = tp_serve_phase(dev, wrappers, card)
    for name in ("flash_attention", "decode_attention", "gmm"):
        n = serve_tp_got.get(name, 0)
        assert n > 0, f"{name} never launched in phase 12f"
        by_name[name]["tp_serve_launches"] = n
        by_name[name]["launches"] += n
    by_name["decode_attention"]["lse"] = check_decode_lse(dev, card)
    print(f"phase 12f: {time.perf_counter() - t0:.1f} s (peak "
          f"{serve_tp_peak:.2f} GB) [{card}]")
    # phase 12g: tensor parallelism for MLA and the Mamba2 families (its
    # own main path: the counts are reset just before its steps and waves
    # and read just after)
    t0 = time.perf_counter()
    latent_got, latent_peak = tp_latent_ssm_phase(dev, wrappers, card)
    for name in ("ssd", "ssd_bwd", "flash_attention", "flash_attention_bwd",
                 "decode_attention"):
        n = latent_got.get(name, 0)
        assert n > 0, f"{name} never launched in phase 12g"
        by_name[name]["tp_latent_ssm_launches"] = n
        by_name[name]["launches"] += n
    for name, rows in check_tp_latent_ssm_kernels(dev, card).items():
        by_name[name].setdefault("tp_local_shapes", []).extend(rows)
    print(f"phase 12g: {time.perf_counter() - t0:.1f} s (peak "
          f"{latent_peak:.2f} GB) [{card}]")
    # phase 12h: tensor parallelism for the encoder-decoder family (its
    # own main path: the counts are reset just before its step and read
    # just after its wave)
    t0 = time.perf_counter()
    encdec_got, encdec_peak = tp_encdec_phase(dev, wrappers, card)
    for name in ("flash_attention", "flash_attention_bwd",
                 "decode_attention"):
        n = encdec_got.get(name, 0)
        assert n > 0, f"{name} never launched in phase 12h"
        by_name[name]["tp_encdec_launches"] = n
        by_name[name]["launches"] += n
    for name, rows in check_tp_encdec_kernels(dev, card).items():
        by_name[name].setdefault("tp_local_shapes", []).extend(rows)
    print(f"phase 12h: {time.perf_counter() - t0:.1f} s (peak "
          f"{encdec_peak:.2f} GB) [{card}]")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s [{card}]")
    # phase 13: the dry-run on the card, in a child process (its own main
    # path: the child resets the counts just before each cell and reads
    # them just after)
    t0 = time.perf_counter()
    dry_got, dry_rows = dryrun_phase(card)
    for name, n in dry_got.items():
        by_name[name]["dryrun_launches"] = n
        by_name[name]["launches"] += n
        by_name[name]["dryrun_shapes"] = dry_rows[name]
    print(f"phase 13: {time.perf_counter() - t0:.1f} s; launches "
          f"{dry_got} [{card}]")
    # phase 14: simcore's trial-axis sharding and the analysis linter (its
    # own main path: the counts are reset just before the sharded
    # campaign and read just after)
    n = shard_phase(wrappers, card)
    kernels[0]["shard_launches"] = n
    kernels[0]["launches"] += n

    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s, "
          f"the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-child"]:
        dryrun_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--audit-child"]:
        audit_child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
