"""Drive the PyTorch port on one NVIDIA card (H100, sm_90a) and check it.

    python3 chip_smoke.py

from the repository root.  It needs a CUDA card, ``nvcc`` and the sources
under ``src/``; without a card it exits non-zero before printing anything
else.  Phases (every mismatch raises, so any failure exits non-zero):

  1. the card's name and power limit; build the CUDA kernels.
  2. each kernel against its plain PyTorch version on the card: both
     variants x 8 policies x deadline off/on, at K=100 (S=5) and K=10^4
     (S=5, S=50) with G=4 grid points, at the shapes of the sweeps below
     (the legacy kernel at G=24, K=100; the sampled kernel at G=8, K=10^4
     and at ``metro-congestion``'s G=1, K=10^5, C=10^4 with the per-cell
     congestion multiplier on the mean throughput), at K = 999 (C = 100,
     G=3) and at the kernel's shape boundaries C = 255, 256, 257, 1025
     (K=10^4, S=5 and S=50).  States are warmed by 20 plain rounds.
     Selections and flags exact; state and round times within rtol 1e-6.
     The [t] lines time each kernel at its sweep's shape and at S=50, the
     shape boundaries and metro-congestion's C=10^4 (CUDA events and
     torch.profiler's device time, beside the plain version and the
     bound).
  3. ``sweep("paper-baseline")`` at K=100: 8 policies x eta (1.0, 1.5, 1.9)
     x 8 seeds x 500 rounds through the legacy kernel (its draws through
     the threefry kernel, as in every sweep below).
  4. the streamed-sampling path at K=10^4 (8 policies x 8 seeds x 500
     rounds) and ``flaky-clients`` with a round deadline.
  5. ``metro-congestion`` at K=10^5 (C=10^4 candidates): 8 policies x 1
     seed x 100 rounds.
  6. the FedAvg-combine kernel against its plain version on the card, f32
     and bf16, at (G, C, N) = (1, 5, N_cnn), (1, 100, N_cnn), (2, 5, N_cnn),
     (1, 3, 1), (1, 10, 24593) and, with G=3, N = 1, 3, 5, 7 (mod 8), with
     some zero weights (N_cnn = 4,583,146, the paper CNN), and on tensors
     whose data pointer is one element off 16 bytes: max abs error 0
     (torch.equal); at N_cnn timed (CUDA events and torch.profiler's
     device time) beside the plain version, the bound and one library
     call (f32 einsum; bf16 a matmul of the bf16 rows by the weights
     rounded to bf16, fp32 accumulation); the aggregation guard around it
     on a NaN row and a huge-norm row against the plain path on the CPU.
  7. the learning-coupled rounds on the card (both kernels, cuDNN conv, TF32
     off) against the CPU (plain path) on the same CPU-made draws, at a
     small CNN with BatchNorm off and on: selections exact, round times
     within rtol 1e-5, the global model after round 1 within a stated
     relative L2.
  8. ``fl.engine.accuracy_sweep`` at full width (the paper CNN, K=100, S=5,
     E=5, B=50, 50k/10k images): 8 policies x 1 seed x 2 rounds with the
     selected cohort; ``elementwise_ucb`` with the all-K cohort for 2 rounds
     (selections and round times equal to the selected run's); flaky-clients
     with a deadline for 3 rounds; a torch.profiler breakdown of one
     policy's round.
  9. the local top-S kernel against its plain version (bitwise, NaN
     included) at the shapes phase 10 gives it, (G, P, C, S) =
     (8, 4, 10^3, 5) and (2, 8, 10^5, 5), and at (1, 8, 10^5, 5),
     (2, 2, 4096, 64), (2, 8, 10^5, 64), a ragged C = 100,001 and rows of
     10^6, 1,851,392 and 28,573,696 (the wrapper's longest) whose chunks
     stream past shared memory, with tied scores, NaN, -inf valid entries,
     a live -inf at index 0 and all-invalid rows; each shape's plan
     (cluster size, threads, staged keys) logged and the "path" shapes
     timed beside torch.topk on the masked scores; the UCB-score kernel
     against its plain version (bitwise, or within UCB_MAX_ULP) at
     (G, K) = (8, 10^4), (1, 10^6) and the ragged (3, 10^4 + 1) and
     (3, 2 * 10^5 + 1) with never-selected arms, timed, and on data
     pointers off 16 bytes; its wrapper refusing n_sel on another device;
     ``select_naive`` through the kernel on a learning state against the
     plain score and the policy formula.
 10. the client-sharded segmented sweep: paper-baseline at K=10^4 over
     P=4 blocks (8 policies x 8 seeds x 100 rounds) against the flat fused
     and unfused sweeps, flaky-clients with a deadline against the flat
     fused sweep, paper-baseline at K=10^6 (C=10^5) over P=8 blocks
     (8 x 2 x 20) against the flat unfused sweep (kernel #2 refuses
     C=10^5): round times (and flags) bitwise equal; state bytes per
     block, the draw against the round, a torch.profiler breakdown.
 11. the hierarchical rounds on the card against the CPU from the same
     seeds, each drawing on its own device (metro-congestion, K=10^5, 10 of
     100 cells with 1000 and with 300 candidates each, 8 policies x 10
     rounds): cell
     selections, candidates, selections and cell counts equal, round
     times and cell sums within rtol 1e-5; the hierarchical sweep at
     K=10^5 (10 of 100 cells, 1000 candidates each) beside phase 5's flat
     rate; paper-baseline (one cell, so the flat path) with
     hierarchy="cells" bitwise equal to the flat sweep.
 12. the LM slice: the attention kernels against their plain version —
     the bfloat16 tensor-core kernel (wgmma on TMA-fed K/V tiles) at
     smollm-135m's prefill shapes (B, S, KV, G, dh) = (4, 4096, 3, 3, 64)
     and (1, 32768, 3, 3, 64), causal, at qwen3-1.7b's dh = 128 (1, 2048,
     8, 2, 128) causal and full, and at ragged shapes for dh 32, 64 and 128,
     causal and full, Sq and Skv no multiple of its 64-key tile and not
     always equal; the float32 kernel (3xTF32 wgmma on TMA-fed split K/V
     tiles), first its products on one tile against float64 at dh 32, 64
     and 128 (TILE_CHECK_MAX_REL), then at (4, 4096, 3, 3, 64), qwen3's
     (1, 2048, 8, 2, 128) and ragged shapes at dh 32, 64 and 128, causal and
     full, Sq and Skv not always equal (f32 rtol 2e-5 / atol 1e-5, bf16
     rtol 1e-2 / atol 1e-4: one bf16 step of the output), each case timed
     beside its plain version, scaled_dot_product_attention and its bound
     (the type's tensor-core rate: bf16, or tf32 for float32; the f32
     kernel's split pass's device time too); reduced
     smollm-135m at S = 1024 on the card against the CPU (f32 and bf16:
     prefill logits, 8 decode steps, the KV cache; each prefill launches its
     dtype's variant once per layer and the other never);
     ``launch/serve.py`` at smollm-135m's full width (4 x 4096 prompt
     tokens, 32 greedy steps): prefill ms, decode tok/s, peak memory,
     exactly 30 launches of the bf16 tensor-core kernel and none of the
     float32 one, finite logits, and a profile of one prefill; the diurnal
     multiplier card against CPU, bitwise.
 13. the griffin slice: the RG-LRU scan kernel against its plain version
     at the full-width prefill's (B, T, W) = (4, 4096, 4096) f32, (2, 2048,
     4096) bf16, a long (1, 16384, 4096) f32 and a ragged (3, 1000, 1000)
     f32 (f32 bitwise, bf16 within one output step), timed beside its plain
     version and its bound; reduced recurrentgemma-9b at S = 1024 (window
     32) on the card against the CPU (f32 and bf16: prefill logits and
     states, 4 decode steps), one kernel launch per recurrent layer;
     ``launch/serve.py`` at recurrentgemma-9b's full width (38 layers,
     9,396,088,832 float32 parameters, 4 x 4096 prompt tokens, 16 greedy
     steps): exactly 26 scan launches and no attention-kernel launch per
     prefill, finite logits, prefill ms, decode tok/s, peak memory, and
     profiles of one prefill and one decode step.
 14. the async serving slice: (a) ``sim.async_engine.serve`` at
     paper-baseline, K=10^4 (n_req 1000, 32 slots, cohorts and FedBuff
     batches of 5, Poisson arrivals), 200 ticks of naive_ucb,
     elementwise_ucb and flaky-clients with a deadline, on the card and on
     the CPU from the same CPU-made draws: selections and counters exact,
     times and state within rtol 1e-5, the UCB-score kernel launched once
     a tick under naive_ucb and never otherwise; (b)
     ``launch/serve_fl.run_serving`` on the card at K=10^4, 1500 ticks in
     segments of 500 through the checkpoint manager, stopped after 2
     segments and re-invoked, bitwise the uninterrupted run; ticks/s and a
     torch.profiler trace of one segment; (c)
     ``fl.engine.async_accuracy_run`` at full width (the paper CNN, K=100,
     E=5, B=50, the default AsyncConfig), 6 ticks: one FedAvg-combine
     launch per aggregating tick, seconds a tick, peak memory, finite
     accuracy.
 15. the training slice: (a) one loss and gradient of reduced smollm-135m
     (f32 and bf16 compute) and reduced recurrentgemma-9b (f32) at S = 1100
     through the kernels' autograd Functions against the plain route on
     the same card tensors: every gradient finite, non-zero where the
     plain one is, within GRAD_LIMIT (relative L2), the attention kernel
     launched once a layer and the scan twice a recurrent layer (forward,
     and backward on reversed inputs); (b) ``launch.steps.make_train_step``
     at smollm-135m's full width, AdamW (lr 3e-4, weight decay 0.1), 4 x
     4096 tokens (train_4k's S; its global batch of 256 cut to one card's
     4), remat on: one warm-up and 3 timed steps, seconds a step, tokens/s,
     peak memory, 60 bf16 attention launches a step, finite losses, and a
     profile of one step; (c) ``launch.train --arch cifar-cnn`` at full
     width (K=100, 50k/10k images, E=5, B=50), 3 rounds checkpointed every
     round, then resumed from round 2: selections, elapsed time and
     parameters bitwise the straight run's (and again with ``--fast``,
     whose weights stay finite), one FedAvg-combine launch a round; (d)
     ``launch.train`` with reduced smollm-135m (2 rounds) and
     recurrentgemma-9b (1 round) on the card and the CPU: every loss within
     LM_LOSS_RTOL on the same batches; (e) ``launch.train --arch none`` on
     the card and the CPU: the same lines.
 16. the moe, vlm, xlstm and encdec families: (a) the bf16 attention
     kernel at their full-width prefill shapes, (B, S, KV, G, dh) = (4,
     4096, 8, 4, 128) and (4, 4096, 8, 7, 128) causal (phi3.5-moe,
     llava-next-34b), (4, 4096, 16, 1, 64) full and causal and the
     cross-attention's (4, 1100 queries, 4096 frames) (seamless-m4t-medium),
     the f32 kernel at G = 7 and the cross shape, against the plain version
     under phase 12's gates and timed; (b) the five reduced configs
     (phi3.5-moe, kimi-k2, llava, xlstm, seamless) at S = 1024 on the card
     against the CPU in f32 and bf16 (FAMILY_TOL; moe on the CPU's expert
     choices, the card's own differing only at near ties), attention
     launches a prefill exactly n_layers (moe, vlm), n_enc + 2 n_dec
     (encdec) and 0 (xlstm); (c) ``launch/serve.py`` at full width, batch
     4, prompt 4096, 16 greedy steps: phi3.5-moe and llava-next-34b on 8
     layers (their float32 weights outgrow the card whole),
     seamless-m4t-medium and xlstm-1.3b whole; exactly 8, 8, 36 and 0
     attention launches a prefill, finite logits, the parameter count,
     prefill ms, decode tok/s, peak memory, profiles of one prefill and one
     decode step (xlstm: one mLSTM and one sLSTM block timed).
 17. several devices, inside a NCCL process group of world size 1 on
     cuda:0 (set up and torn down by the phase; the card's one rank holds
     every shard, its collectives run through NCCL): (a)
     ``sweep(shard="grid", devices=4)`` at phase 4a's config cut to 100
     rounds (paper-baseline, K=10^4, 8 policies x 8 seeds), bitwise the
     flat sweep with its 800 launches of the sampled round kernel; (b)
     ``sweep(shard="clients", devices=8)`` at phase 10's K=10^6 (C=10^5, 8
     x 2 x 20) through the collective shard sum and gather, bitwise the
     one-process segmented sweep with its 40 top-S launches; (c)
     ``chunk_rounds=25`` at (a)'s config, and ``accuracy_sweep`` at phase
     8's full width (2 policies x 2 rounds) with ``chunk_rounds=1`` and with
     ``shard="clients", devices=4``, each bitwise the plain run (cuDNN
     deterministic, TF32 off), one FedAvg-combine launch per (policy,
     round); (d) ``distributed.fl_parallel.make_fl_round`` at smollm-135m's
     full width (phase 15b's dtype and attention route), 4 cohorts, SGD, 2
     local steps of 2 x 1024 tokens (batch and sequence cut, nothing else):
     for every compress mode the combine of one set of trained cohorts
     against a float64 recomputation of the same combine on the card
     (COHORT_TOL), and a timed round with its launches (the bf16 attention
     kernel twice a layer a step, FedAvg once a round but under int8_psum).
     Rounds/s of (a) and (b), seconds a cohort round and peak memory.
 18. the LM stack over a device mesh: (a) the attention kernels at a query
     offset — the bf16 kernel at smollm-135m's (4, 4096, 3, 3, 64) and
     llava's (4, 4096, 8, 7, 128), the f32 kernel at (4, 4096, 3, 3, 64),
     causal, the q rows split into P = 2, 4, 16 slices each launched with
     q_offset = p·S/P (as each model rank of a context-parallel prefill
     launches it): the slices concatenated bitwise the unsplit launch, each
     against the plain version at its offset (FLASH_TOL), ms per slice
     beside its bound; (b) inside a NCCL process group of world size 1,
     ``launch/serve.py --mesh 1x1`` at smollm-135m's full width (phase 12's
     4 x 4096 prompt, 32 greedy steps) through the model-parallel route:
     prefill logits, last logits and tokens bitwise phase 12's one-process
     run, 30 bf16 attention launches, the route's collectives counted; (c)
     llava-next-34b on 8 layers, prefill only, one process and then
     ``--mesh 1x1`` (context-parallel: 8 launches at q_offset 0): prefill
     logits bitwise; (d) ``fl.engine.run_host_reference`` on phase 7's small
     CNN, 3 rounds of two policies, card against CPU on the same inputs:
     selections equal, round times rtol 1e-5, the final model within phase
     7's relative L2, one FedAvg-combine launch a round.
 19. training over a (data, model) mesh, inside a NCCL process group of
     world size 1 (every collective and every backward collective runs
     through NCCL over a group of one): (a) phase 15b's recipe (smollm-135m
     full width, AdamW lr 3e-4 wd 0.1, 4 x 4096, remat) through
     ``launch/steps.make_train_step(..., mp=)`` on a 1 x 1 mesh, 1 + 3
     steps, each step's loss, every updated parameter and both AdamW
     moments bitwise the one-process step on the same weights and batch,
     60 bf16 attention launches a step, seconds a step and the collectives
     a step beside the one-process step's; the mesh step refuses CPU
     tensors in the NCCL group; (b) phase 17d's cohort round (4 cohorts x
     2 SGD steps of 2 x 1024 tokens, weights (1, 0, 2, 1)) through
     ``make_fl_round(..., mesh, stacked_specs)`` at model size 1, every
     compress mode bitwise the round without a mesh on the same inputs,
     with 480 bf16 attention launches a round and one FedAvg-combine launch
     (none under int8_psum).
 20. the sweeps' random numbers, JAX's Threefry streams: (a) the threefry
     kernel bitwise its plain version at the sweeps' shapes (keys x
     counters 8 x 100, 16 x 100, 24 x 100, 8 x 10^4, 8 x 2000, 2 x 10^6,
     and a 2 x 2.5 * 10^5 slice at counter 5 * 10^5): bits, key pairs,
     uniforms on [0, 1) and [10, 100); split of 24 keys into 500; fold_in
     of cell ids on the device; the uniforms and the split timed (CUDA
     events) beside the plain version and the bound (written bytes over
     3.35 TB/s) and by the profiler's device time; (b) from the seeds
     alone, no replay: the rounds of flaky-clients with a deadline (legacy
     K=100, streamed K=2000, 8 policies x 4 grid points x 30 rounds) on the
     card and on the CPU, selections and flags equal, round times within
     RTOL; phases 3, 4a, 4b and 5 with their rounds cut (50, 25, 25, 10)
     on the card against the
     same sweeps on the CPU, flags equal, round times within RTOL, launches
     exact; (c) phase 17a's grid (20 rounds) and a client-sharded sweep at
     K=10^5 (8 blocks, 10 rounds) inside a NCCL group of world size 1,
     bitwise the one-process sweeps, with the values each drew.

Launch counts are zeroed before each sweep and read after it; each sweep
must launch its kernels once per (policy, round) (the local top-S once per
round of a score policy), the threefry kernel as ``threefry_launches``
counts its draws, and no other kernel.  The second-to-last line
is a JSON object with each kernel's launches, error against the plain
version and times (CUDA events, and torch.profiler's device time where
it recorded the kernel); the last line is the device summary.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
DEADLINE = 2500.0              # round deadline (s) of the fault runs
RTOL = 1e-6

CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {
    "bandit_round": dict(
        replaces="src/repro/kernels/bandit_round.py:289",
        source=CSRC + "bandit_round.cu"),
    "bandit_round_sampled": dict(
        replaces="src/repro/kernels/bandit_round.py:373",
        source=CSRC + "bandit_round.cu"),
    "fedavg_combine": dict(
        replaces="src/repro/kernels/fedavg.py:32",
        source=CSRC + "fedavg.cu"),
    "topk_slots": dict(
        replaces="src/repro/kernels/bandit_round.py:259",
        source=CSRC + "topk_slots.cu"),
    "ucb_score": dict(
        replaces="src/repro/kernels/ucb_score.py:39",
        source=CSRC + "ucb_score.cu"),
    "flash_attention": dict(           # float32, 3xTF32 wgmma + TMA
        replaces="src/repro/kernels/flash_attention.py:81",
        source=CSRC + "flash_attention.cu"),
    "flash_attention_wgmma": dict(     # bfloat16, wgmma + TMA (the prefill's)
        replaces="src/repro/kernels/flash_attention.py:81",
        source=CSRC + "flash_attention_sm90.cu"),
    "rg_lru_scan": dict(
        replaces="src/repro/kernels/rg_lru.py:49",
        source=CSRC + "rg_lru.cu"),
    # the port's own kernel: jax.random's threefry2x32, which the JAX
    # package leaves to XLA (no Pallas kernel behind it)
    "threefry": dict(
        replaces="none: jax/_src/prng.py threefry2x32 (XLA, no TPU kernel)",
        source=CSRC + "threefry.cu"),
}
SOURCES = ("bandit_round", "fedavg", "topk_slots", "ucb_score",
           "flash_attention", "flash_attention_sm90", "rg_lru", "threefry")
N_CNN = 4_583_146              # parameters of the paper CNN
FEDAVG_CASES = [(1, 5, N_CNN), (1, 100, N_CNN), (2, 5, N_CNN), (1, 3, 1),
                (1, 10, 8192 * 3 + 17), (3, 5, 8 * 4001 + 1),
                (3, 3, 8 * 3000 + 3), (3, 7, 8 * 2345 + 5),
                (3, 100, 8 * 1111 + 7)]
# cases whose data pointer is one element past a 16-byte boundary (a view
# of a larger buffer): the kernel's bulk copies must clamp the tensor's head
FEDAVG_OFFSET_CASES = [(1, 5, 8 * 3001 + 1), (2, 3, 1), (3, 4, 8 * 513 + 6),
                       (1, 17, 8 * 1001 + 3)]
# the small CNN of phase 7 and of tests/test_torch_fl_engine.py
SMALL_CNN = dict(image_size=8, channels=(8, 8), pool_after=(0,),
                 fc_units=(16,))
# phase 7's limits on the relative L2 distance of the card's global model
# from the CPU's after one round: summation orders of cuDNN and the CPU
# differ by ulps; train-mode BatchNorm amplifies them.  Read on an H100
# (700 W): 4.94e-8 with BatchNorm off, 3.84e-6 with it on; each limit is
# about 25 to 200 times its reading
CARD_VS_CPU_RL2 = {False: 1e-5, True: 1e-4}
# rounds of phase 8's runs, cut (never the width) to keep the script near
# 4 minutes: a round takes ~2.6 s on the card with the selected cohort and
# ~15 s with the all-K cohort
FL_ROUNDS = {"selected": 2, "all": 2, "flaky": 3}

# the round kernel's shape boundaries: about C / 4 threads in whole warps
# select (C = 256 fills two warps, 257 starts a third) and a block has at
# most 1024 threads, past which (C = 1025) each gathers two candidates
ROUND_EDGES = [(c, s) for c in (255, 256, 257, 1025) for s in (5, 50)]
# phase 2's cases, (scenario, G, K, S, C) by kernel: the sweeps' shapes
# (phases 3-5 drive each kernel at G=24, K=100 and G=8, K=10^4 and at
# metro-congestion's), K = 999 (the decay pass without float4s), then the
# block-size boundaries
PHASE2_CASES = {
    "bandit_round": [
        ("paper-baseline", 4, 100, 5, 10),
        ("paper-baseline", 4, 10_000, 5, 1_000),
        ("paper-baseline", 4, 10_000, 50, 1_000),
        ("paper-baseline", 24, 100, 5, 10),
        ("paper-baseline", 3, 999, 5, 100)]
    + [("paper-baseline", 4, 10_000, s, c) for c, s in ROUND_EDGES],
    "bandit_round_sampled": [
        ("paper-baseline", 4, 100, 5, 10),
        ("paper-baseline", 4, 10_000, 5, 1_000),
        ("paper-baseline", 4, 10_000, 50, 1_000),
        ("paper-baseline", 8, 10_000, 5, 1_000),
        ("metro-congestion", 1, 100_000, 5, 10_000),
        ("paper-baseline", 3, 999, 5, 100)]
    + [("paper-baseline", 4, 10_000, s, c) for c, s in ROUND_EDGES],
}
# further [t] shapes beside the main paths', (scenario, G, K, C, S): S = 50,
# the block-size boundaries and metro-congestion's C = 10^4
KERNEL_TIME_CASES = {
    "bandit_round": [("paper-baseline", 24, 100, 10, 50)]
    + [("paper-baseline", 8, 10_000, c, s) for c, s in ROUND_EDGES],
    "bandit_round_sampled": [("paper-baseline", 8, 10_000, 1_000, 50),
                             ("metro-congestion", 1, 100_000, 10_000, 5)]
    + [("paper-baseline", 8, 10_000, c, s) for c, s in ROUND_EDGES],
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def round_inputs(env, scen, g, k, c, s, policy, sampled, failure, gen):
    """One round's inputs on the card for a [g] grid (random draws from
    ``gen``); the mean throughput carries ``scen``'s per-cell congestion
    multiplier, as the sweep's rounds do.  With ``failure`` the fault
    probabilities are flaky-clients'."""
    from repro_torch.sim.engine import scenario_thr_mult
    from repro_torch.sim.scenarios import get_scenario
    dev = env.mean_theta.device
    cand = torch.rand((g, k), generator=gen, device=dev).topk(c).indices
    kw = dict(cand_idx=cand.sort(1).values.to(torch.int32).contiguous(),
              rand=(torch.rand((g, k), generator=gen, device=dev)
                    if policy == "random" else None),
              fault_u=(torch.rand((g, 3, s), generator=gen, device=dev)
                       if failure else None))
    normals = (torch.randn((g, scen.congestion_cells), generator=gen,
                           device=dev)
               if scen.congestion_cells > 0 and scen.congestion_sigma > 0.0
               else None)
    mult = scenario_thr_mult(scen, env.cell_id, normals, 1)
    theta = env.mean_theta.expand(g, k) if mult is None else (
        env.mean_theta * mult).expand(g, k)
    theta = theta.contiguous()
    gamma = env.mean_gamma.expand(g, k).contiguous()
    eta = torch.full((g,), 1.5, device=dev)
    if sampled:
        kw.update(u2=torch.rand((g, 2, c), generator=gen, device=dev),
                  theta_mu=theta, gamma_mu=gamma, n_samples=env.n_samples,
                  eta=eta, model_bits=146.4e6)
    else:
        from repro_torch.sim.engine import sample_times
        t_ud, t_ul = sample_times(
            env.n_samples, theta, gamma, eta, 146.4e6,
            torch.rand((g, k), generator=gen, device=dev),
            torch.rand((g, k), generator=gen, device=dev))
        kw.update(t_ud=t_ud.contiguous(), t_ul=t_ul.contiguous())
    fault = get_scenario("flaky-clients").fault.probs if failure else None
    return kw, fault


def call_round(fn, state, kw, policy, s, fault, sampled):
    from repro_torch.core import bandit
    common = dict(policy=policy, s_round=s, decay=bandit.policy_decay(policy),
                  fault=fault, deadline=DEADLINE if fault else None,
                  fault_u=kw["fault_u"])
    hyper = bandit.DEFAULT_HYPERS[policy]
    if sampled:
        return fn(state, kw["cand_idx"], kw["u2"], kw["rand"], kw["theta_mu"],
                  kw["gamma_mu"], kw["n_samples"], kw["eta"],
                  kw["model_bits"], hyper, **common)
    return fn(state, kw["cand_idx"], kw["t_ud"], kw["t_ul"], kw["rand"],
              hyper, **common)


def compare(out_k, out_p, where: str) -> float:
    """Selections and flags exact, state and round times within RTOL;
    returns the largest absolute float difference."""
    from repro_torch.core.bandit import STATE_FIELDS
    if not torch.equal(out_k[1], out_p[1]):
        raise AssertionError(f"{where}: selections differ\n{out_k[1]}\n"
                             f"{out_p[1]}")
    if len(out_p) == 4 and not torch.equal(out_k[3], out_p[3]):
        raise AssertionError(f"{where}: flags differ")
    pairs = [(out_k[2], out_p[2], "round_time")] + [
        (getattr(out_k[0], f), getattr(out_p[0], f), f)
        for f in STATE_FIELDS]
    worst = 0.0
    for a, b, name in pairs:
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0,
                                       msg=f"{where}: {name}")
            worst = max(worst, (a - b).abs().max().item())
        elif not torch.equal(a, b):
            raise AssertionError(f"{where}: {name} differs")
    return worst


def time_ms(fn, n: int, reps: int = 3) -> float:
    """ms per call: CUDA events around a run of ``n`` calls, the median of
    ``reps`` runs, after one warm-up call."""
    fn()
    runs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / n)
    return statistics.median(runs)


def launcher(sampled):
    from repro_torch.kernels import bandit_round as cuda_round
    return (cuda_round.bandit_round_sampled_launcher if sampled
            else cuda_round.bandit_round_launcher)


def profiled_kernel_ms(launch, n: int,
                       kernel: str = "bandit_round_kernel") -> float | None:
    """Device time per launch of ``kernel`` by torch.profiler, or None when
    the profiler records no launch of it.  Averaged over the launches the
    profiler recorded: on the card's machine it can drop some records
    (seen with launches of milliseconds after earlier profiled phases)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and kernel in e.key]
    count = sum(e.count for e in hits)
    total = sum(e.self_device_time_total for e in hits)
    return total / count / 1e3 if count else None


def bound(policy, g, k, c, s, sampled, failure):
    """Least time (ms) the card needs for one round: the bytes the round
    must move (each input read once, each output written once) over the
    memory rate, against its float operations over the float32 rate."""
    from repro_torch.core.bandit import HIST_WINDOW as W
    from repro_torch.core.bandit import POLICY_STATS, policy_decay, policy_kind
    decays = policy_decay(policy) != 1.0
    gathered = set(POLICY_STATS[policy])
    # per candidate: its index; its times (legacy) or its two uniforms and
    # three means (sampled); the random policy's uniform; the statistics the
    # policy scores (a ring-buffer sum reads W entries; discounted UCB's
    # disc_* are read by the decay pass below)
    per_cand = 4 + (20 if sampled else 8) + (4 if policy == "random" else 0)
    per_cand += sum(4 * W if col.startswith("hist_sum_") else 4
                    for col in gathered if not col.startswith("disc_"))
    # per selected row: read the counters and sums the gather did not; write
    # them, last_ud/ul and one ring slot of hist_ud/ul (disc_* rows are
    # written by the decay pass); n_fail read and written with failures on
    row = 4 * len({"n_sel", "sum_ud", "sum_ul", "sum_tinc", "hist_n"}
                  - gathered) + 4 * 9 + (8 if failure else 0)
    per_g = (c * per_cand + s * row
             + 8                                  # total, read and written
             + (8 + 2 * 4 * 3 * k if decays else 0)  # disc_total, decay pass
             + (4 if sampled else 0)              # eta
             + 4 * s + 4                          # sel, round_time
             + (4 * s + 12 * s if failure else 0))   # flags, fault_u
    nbytes = g * per_g
    # float ops: per candidate ~40 for the Eq. (8) draw (sampled), ~10 for
    # the score, and per selection step ~6 per candidate (greedy) or 1
    steps = 6 if policy_kind(policy) == "greedy" else 1
    ops = g * (c * ((40 if sampled else 0) + 10 + steps * s)
               + (3 * k if decays else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device_and_build() -> None:
    from repro_torch.kernels import _build
    log(card_name_and_power())
    names = SOURCES
    cached = [n for n in names if _build.library_path(n).exists()]
    t0 = time.perf_counter()
    _build.build(names)                  # one nvcc per source, in parallel
    for name in names:
        _build.load(name)
    log(f"[1] {', '.join(n + '.cu' for n in names)} built in "
        f"{time.perf_counter() - t0:.1f} s (cached: {cached or 'none'})")


def phase_kernels(results: dict) -> None:
    from repro_torch.core import bandit
    from repro_torch.kernels import bandit_round as cuda_round
    from repro_torch.kernels import ref
    from repro_torch.sim.engine import EnvArrays
    from repro_torch.sim.scenarios import get_scenario

    dev = torch.device("cuda")
    for sampled in (False, True):
        name = "bandit_round_sampled" if sampled else "bandit_round"
        kern = (cuda_round.bandit_round_sampled_cuda if sampled
                else cuda_round.bandit_round_cuda)
        plain = (ref.bandit_round_sampled_ref if sampled
                 else ref.bandit_round_ref)
        worst = 0.0
        for scen_name, g, k, s, c in PHASE2_CASES[name]:
            scen = get_scenario(scen_name)
            env = EnvArrays.from_scenario(
                scen, scen.build_env(k, np.random.default_rng(0)), dev)
            for policy in bandit.POLICY_NAMES:
                for failure in (False, True):
                    gen = torch.Generator(device=dev)
                    gen.manual_seed(k + s + g + 17 * failure)
                    state = bandit.BanditState.create(g, k, device=dev)
                    for _ in range(20):           # warm with plain rounds
                        kw, fault = round_inputs(env, scen, g, k, c, s,
                                                 policy, sampled, failure,
                                                 gen)
                        state = call_round(plain, state, kw, policy, s,
                                           fault, sampled)[0]
                    kw, fault = round_inputs(env, scen, g, k, c, s, policy,
                                             sampled, failure, gen)
                    out_p = call_round(plain, state.clone(), kw, policy, s,
                                       fault, sampled)
                    out_k = call_round(kern, state.clone(), kw, policy, s,
                                       fault, sampled)
                    torch.cuda.synchronize()
                    where = (f"{name} {scen_name} G={g} K={k} C={c} S={s} "
                             f"{policy} deadline={'on' if failure else 'off'}")
                    worst = max(worst, compare(out_k, out_p, where))
                    ms = time_ms(call_round(
                        launcher(sampled), state.clone(), kw, policy, s,
                        fault, sampled), 100)
                    pms = time_ms(lambda: call_round(
                        plain, state, kw, policy, s, fault, sampled), 3)
                    log(f"[2] {where}: match; kernel {ms:.4f} ms, "
                        f"plain {pms:.3f} ms")
        results[name]["max_abs_err"] = worst
        log(f"[2] {name}: all cases match (max abs err {worst:g})")


def kernel_times(results: dict, name: str, g: int, k: int, s: int,
                 c: int | None = None, scen_name: str = "paper-baseline",
                 record: bool = True) -> None:
    """Kernel (CUDA events and the profiler's device time), plain and bound
    times at a shape (mean over the 8 policies, which a sweep launches
    equally often); ``record`` keeps them as the kernel's results (the main
    path's shape).  C defaults to the sweeps' 10 % of K."""
    from repro_torch.core import bandit
    from repro_torch.kernels import bandit_round as cuda_round
    from repro_torch.kernels import ref
    from repro_torch.sim.engine import EnvArrays
    from repro_torch.sim.scenarios import get_scenario

    sampled = name == "bandit_round_sampled"
    plain = ref.bandit_round_sampled_ref if sampled else ref.bandit_round_ref
    dev = torch.device("cuda")
    c = math.ceil(0.1 * k) if c is None else c
    scen = get_scenario(scen_name)
    env = EnvArrays.from_scenario(
        scen, scen.build_env(k, np.random.default_rng(0)), dev)
    ms, pms, prof, bms, by = [], [], [], [], set()
    for policy in bandit.POLICY_NAMES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        kw, fault = round_inputs(env, scen, g, k, c, s, policy, sampled,
                                 False, gen)
        state = bandit.BanditState.create(g, k, device=dev)
        launch = call_round(launcher(sampled), state, kw, policy, s, fault,
                            sampled)
        for _ in range(20):                    # leave the cold start
            launch()
        ms.append(time_ms(launch, 200))
        prof.append(profiled_kernel_ms(launch, 50))
        pms.append(time_ms(lambda: call_round(plain, state, kw, policy, s,
                                              fault, sampled), 5))
        b, why = bound(policy, g, k, c, s, sampled, False)
        bms.append(b)
        by.add(why)
    seen = [m for m in prof if m is not None]
    r = dict(ms=statistics.fmean(ms), plain_ms=statistics.fmean(pms),
             device_ms=(statistics.fmean(seen) if len(seen) == len(prof)
                        else None),
             bound_ms=statistics.fmean(bms), bound_by="/".join(sorted(by)),
             shape=dict(g=g, k=k, c=c, s=s))
    if record:
        results[name].update(r)
    where = f"{name} {scen_name} G={g} K={k} C={c} S={s}"
    dev_txt = "none" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
    log(f"[t] {where}: kernel {r['ms']:.4f} ms (device time by "
        f"torch.profiler {dev_txt} ms), plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.6f} ms ({r['bound_by']}); per policy "
        + ", ".join(f"{p}={m:.4f}" for p, m in zip(bandit.POLICY_NAMES, ms)))
    log(f"[t] {where} device time per launch by torch.profiler: "
        + ", ".join(f"{p}={'none' if m is None else f'{m:.4f}'}"
                    for p, m in zip(bandit.POLICY_NAMES, prof)))


def more_kernel_times(results: dict) -> None:
    """[t] lines at KERNEL_TIME_CASES' shapes, beside the main paths'."""
    for name, cases in KERNEL_TIME_CASES.items():
        for scen_name, g, k, c, s in cases:
            kernel_times(results, name, g, k, s, c=c, scen_name=scen_name,
                         record=False)


def profile_sweep(label: str, **kw) -> None:
    """Where one policy's sweep spends its time: torch.profiler over the
    whole sweep, device time of the round kernel and of all other device
    work against the wall time (the rest is the device idle, waiting on
    the host).  The profiler's own cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import engine
    engine.sweep(**kw)                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.sweep(**kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.key, e.self_device_time_total)
              for e in prof.key_averages() if e.device_type == cuda]
    device_us = sum(t for _, t in events)
    kernel_us = sum(t for k, t in events if any(
        n in k for n in ("bandit_round_kernel", "topk_slots_kernel")))
    top = sorted(events, key=lambda e: -e[1])[:4]
    log(f"[{label}p] profiled sweep {kw.get('policies')} x "
        f"{kw.get('n_rounds')} rounds: wall {wall_us / 1e3:.1f} ms, device "
        f"busy {100 * device_us / wall_us:.1f}% (the repo's kernels "
        f"{100 * kernel_us / wall_us:.2f}%), idle "
        f"{100 * (1 - device_us / wall_us):.1f}%; top device ops "
        + ", ".join(f"{k[:40]}={t / 1e3:.2f} ms" for k, t in top))


def check_launches(label: str, expect: dict) -> dict:
    """The launch counts since the last reset; each kernel named in
    ``expect`` must have launched that often, every other kernel never."""
    counts = launch_counts()
    want = {**{k: 0 for k in counts}, **expect}
    if counts != want:
        raise AssertionError(f"[{label}] launches {counts} != {want}")
    return counts


RATES: dict[str, float] = {}   # rounds/s of the last sweep of each phase


def threefry_launches(scenario="paper-baseline", policies=None,
                      n_rounds: int = 500, n_clients: int = 100,
                      fluctuate: bool = True, deadline=None,
                      chunk_rounds=None, fast_sampling=None,
                      hierarchy: str = "flat", **_) -> int:
    """The threefry launches of one ``sweep`` (sim/engine.KeyStreams): one
    split of the seeds' keys into their roots; for each chunk table made
    (once, or once a policy and chunk when the run has several chunks) the
    round keys (1), the permutation's sort keys' keys (its sorting rounds,
    legacy path), the fault uniforms (fold_in, uniform: 2), the congestion
    normals (1) and the churn draws (split, uniform, randint's split and
    bits: 4); each round and policy, the candidates (1 streamed, the
    sorting rounds legacy, a hierarchical round's fold_in and uniforms 2)
    and the Eq. (8) uniforms (1); each round of the random policy its
    uniforms (1)."""
    from repro_torch.core import bandit, prng
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import get_scenario
    scen = get_scenario(scenario) if isinstance(scenario, str) else scenario
    pols = [p if isinstance(p, str) else p[0]
            for p in (policies or bandit.POLICY_NAMES)]
    cells = hierarchy == "cells" and scen.congestion_cells > 1
    fast = cells or engine.resolve_fast_sampling(fast_sampling, n_clients)
    n_chunks = n_rounds // (chunk_rounds or n_rounds)
    made = 1 if n_chunks == 1 else len(pols) * n_chunks
    tables = 1 + (0 if fast else prng.shuffle_rounds(n_clients))
    tables += 2 * (bandit.resolve_fault(scen.fault, deadline) is not None)
    tables += (scen.congestion_cells > 0 and scen.congestion_sigma > 0.0)
    tables += 4 * (scen.churn_prob > 0.0)
    cand = 2 if cells else (1 if fast else prng.shuffle_rounds(n_clients))
    per_round = len(pols) * (cand + bool(fluctuate)) + pols.count("random")
    return 1 + made * tables + n_rounds * per_round


def run_sweep(label: str, expect: dict, **kw):
    """One sweep on the card with the launch counts zeroed before and read
    after; each kernel must have launched exactly ``expect`` times, the
    threefry kernel ``threefry_launches`` times (the kernels not named
    there: never)."""
    from repro_torch.sim import engine
    expect = {"threefry": threefry_launches(**kw), **expect}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.sweep(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = check_launches(label, expect)
    p, e, s, r = res.round_times.shape
    if not (np.isfinite(res.round_times).all()
            and (res.round_times > 0).all()):
        raise AssertionError(f"{label}: non-finite or non-positive times")
    RATES[label] = p * r / wall
    log(f"[{label}] {p} policies x {e} eta x {s} seeds x {r} rounds in "
        f"{wall:.2f} s: {p * r / wall:.1f} rounds/s "
        f"({p * e * s * r / wall:.0f} grid-point rounds/s); launches "
        f"{counts}; values drawn {res.drawn}")
    return res, counts


def phase_paper_sweep(results: dict) -> None:
    from repro_torch.core import bandit
    res, counts = run_sweep(
        "3", {"bandit_round": 8 * 500, "bandit_round_sampled": 0},
        scenario="paper-baseline", etas=(1.0, 1.5, 1.9), seeds=8,
        n_rounds=500, n_clients=100)
    results["bandit_round"]["launches"] = counts["bandit_round"]
    results["threefry"]["launches"] = counts["threefry"]
    table = res.mean_elapsed()
    log("[3] mean elapsed (s) by policy, eta = " + ", ".join(
        f"{e}" for e in res.etas))
    for name, row in zip(res.policies, table):
        log(f"[3]   {name:16s} " + " ".join(f"{v:12.1f}" for v in row))
    if table.shape != (len(bandit.POLICY_NAMES), 3):
        raise AssertionError("[3] mean_elapsed shape")
    profile_sweep("3", scenario="paper-baseline", policies=("elementwise_ucb",),
                  etas=(1.0, 1.5, 1.9), seeds=8, n_rounds=100, n_clients=100)


def phase_fast_path(results: dict) -> None:
    _, counts = run_sweep(
        "4", {"bandit_round": 0, "bandit_round_sampled": 8 * 500},
        scenario="paper-baseline", etas=(1.5,), seeds=8, n_rounds=500,
        n_clients=10_000)
    results["bandit_round_sampled"]["launches"] = counts[
        "bandit_round_sampled"]
    res, _ = run_sweep(
        "4", {"bandit_round": 0, "bandit_round_sampled": 8 * 100},
        scenario="flaky-clients", etas=(1.5,), seeds=8, n_rounds=100,
        n_clients=10_000, deadline=DEADLINE)
    fc = res.fault_counts()
    total = {k: int(v.sum()) for k, v in fc.items()}
    parts = sum(total[k] for k in ("ok", "crashed", "churned",
                                   "deadline_missed", "corrupt"))
    if parts != total["dispatched"]:
        raise AssertionError(f"[4] fault counts do not partition: {total}")
    log(f"[4] flaky-clients deadline={DEADLINE} s fault counts: {total}")
    profile_sweep("4", scenario="paper-baseline", policies=("elementwise_ucb",),
                  etas=(1.5,), seeds=8, n_rounds=100, n_clients=10_000)


def phase_real_size() -> None:
    torch.cuda.reset_peak_memory_stats()
    run_sweep("5", {"bandit_round": 0, "bandit_round_sampled": 8 * 100},
              scenario="metro-congestion", etas=(1.5,), seeds=1,
              n_rounds=100, n_clients=100_000)
    log(f"[5] metro-congestion K=100000 C=10000: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    profile_sweep("5", scenario="metro-congestion",
                  policies=("elementwise_ucb",), etas=(1.5,), seeds=1,
                  n_rounds=100, n_clients=100_000)


# ---------------------------------------------------------------------------
# the learning-coupled slice: the FedAvg kernel and the accuracy sweep
# ---------------------------------------------------------------------------

def fedavg_bound(g: int, c: int, n: int, itemsize: int):
    """Least time (ms) of one combine: C input rows and one output row per
    grid point (plus the weights) over the memory rate, against its 2·C
    float operations per element over the float32 rate."""
    t_bytes = g * ((c + 1) * n * itemsize + 4 * c) / HBM_BYTES_PER_S * 1e3
    t_ops = g * 2 * c * n / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_fedavg_kernel(results: dict) -> None:
    from repro_torch.fl import engine as fl
    from repro_torch.kernels import fedavg as cuda_fedavg
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    worst = 0.0
    cases = [(g, c, n, 0) for g, c, n in FEDAVG_CASES] + [
        (g, c, n, 1) for g, c, n in FEDAVG_OFFSET_CASES]
    for dtype in (torch.float32, torch.bfloat16):
        for g, c, n, shift in cases:
            # shift = 1 puts the data pointer one element past the start of
            # its (16-byte aligned) buffer
            buf = torch.randn(shift + g * c * n, generator=gen,
                              device=dev).to(dtype)
            x = buf[shift:].view(g, c, n)
            w = torch.rand((g, c), generator=gen, device=dev)
            w[:, ::3] = 0.0                       # unselected clients
            w = w / w.sum(1, keepdim=True).clamp_min(1e-9)
            got = cuda_fedavg.fedavg_combine_cuda(x, w)
            want = ref.fedavg_combine_ref(x, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            where = (f"fedavg_combine {str(dtype)[6:]} G={g} C={c} N={n}"
                     + (f" (data pointer {x.data_ptr() % 16} bytes past 16)"
                        if shift else ""))
            if err != 0.0 or not torch.equal(got, want):
                raise AssertionError(f"[6] {where}: kernel differs from the "
                                     f"plain version (max abs err {err})")
            worst = max(worst, err)
            if n < N_CNN:
                log(f"[6] {where}: exact")
                continue
            def launch():
                return cuda_fedavg.fedavg_combine_cuda(x, w)
            ms = time_ms(launch, 100)
            dev_ms = profiled_kernel_ms(launch, 20, "fedavg_combine_kernel")
            pms = time_ms(lambda: ref.fedavg_combine_ref(x, w), 5)
            if dtype == torch.float32:
                lib = "einsum"
                lms = time_ms(lambda: torch.einsum("gcn,gc->gn", x, w), 100)
            else:
                # the weights rounded to bf16; cuBLAS accumulates in fp32
                lib = "matmul of bf16 rows by bf16-rounded weights (fp32 sum)"
                wb = w.to(dtype)[:, None, :]
                flags = torch.backends.cuda.matmul
                keep = flags.allow_bf16_reduced_precision_reduction
                flags.allow_bf16_reduced_precision_reduction = False
                lms = time_ms(lambda: torch.matmul(wb, x), 100)
                flags.allow_bf16_reduced_precision_reduction = keep
            bms, by = fedavg_bound(g, c, n, x.element_size())
            log(f"[6] {where}: exact; kernel {ms:.4f} ms (device time by "
                f"torch.profiler "
                f"{'none' if dev_ms is None else f'{dev_ms:.4f}'} ms), plain "
                f"{pms:.4f} ms, {lib} {lms:.4f} ms, bound {bms:.4f} ms "
                f"({by}), {100 * bms / ms:.1f}% of bound")
            if (dtype, g, c) == (torch.float32, 1, 5):   # the main path's
                results["fedavg_combine"].update(
                    ms=ms, device_ms=dev_ms, plain_ms=pms, library_ms=lms,
                    bound_ms=bms, bound_by=by, shape=dict(g=g, c=c, n=n))
    results["fedavg_combine"]["max_abs_err"] = worst

    # the aggregation guard around the kernel against the plain path
    rows = torch.randn((1, 5, N_CNN), generator=gen, device=dev)
    rows[0, 1, 17] = float("nan")
    rows[0, 3] *= 1e9
    w = torch.tensor([[3.0, 5.0, 2.0, 4.0, 6.0]], device=dev)
    avg, w_ok, rej = fl.masked_fedavg(rows.clone(), w, guard=True)
    avg_p, w_ok_p, rej_p = fl.masked_fedavg(rows.cpu(), w.cpu(), guard=True)
    if not (torch.equal(avg.cpu(), avg_p) and torch.equal(w_ok.cpu(), w_ok_p)
            and int(rej) == int(rej_p) == 2):
        raise AssertionError("[6] guarded combine: card and CPU differ")
    log("[6] guarded combine (a NaN row, a 1e9-scaled row; C=5, N=N_cnn): "
        "2 rows rejected, card equals CPU bitwise")


def _wrappers():
    from repro_torch.kernels import (bandit_round, fedavg, flash_attention,
                                     rg_lru, threefry, topk_slots, ucb_score)
    return (bandit_round, fedavg, topk_slots, ucb_score, flash_attention,
            rg_lru, threefry)


def reset_counts() -> None:
    for mod in _wrappers():
        mod.reset_launch_counts()


def launch_counts() -> dict:
    return {k: v for mod in _wrappers() for k, v in mod.launch_counts.items()}


def tf32_flags() -> str:
    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def phase_card_vs_cpu() -> None:
    """Three replayed rounds of two policies on the same CPU-made draws
    through the card and through the CPU, TF32 off."""
    from repro_torch.core import bandit
    from repro_torch.fl import engine as fl
    from repro_torch.models import cnn
    from repro_torch.sim import engine as sim
    from repro_torch.sim.scenarios import get_scenario
    from repro_torch.utils.trees import tree_bytes

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[7] {tf32_flags()}")
    scen = get_scenario("paper-baseline")
    try:
        for bn in (False, True):
            cfg = cnn.CnnConfig(batchnorm=bn, **SMALL_CNN)
            tasks = {dev: fl.make_cnn_task(
                scen, 12, cfg=cfg, n_train=600, n_test=400, eval_batch=200,
                max_samples=40, batch_size=10, device=dev)
                for dev in ("cpu", "cuda")}
            cap = tasks["cpu"].part_idx.shape[1]
            for policy in ("fedcs", "elementwise_ucb"):
                gens = sim.make_generators((0,), "cpu")
                draws = [(sim.draw_round_inputs(
                    gens, n_seeds=1, n_etas=1, k=12, n_req=6, s_round=3,
                    fast=False, fluctuate=True, policy=policy, scen=scen,
                    fault=None), fl.draw_orders(
                        gens["perm"], 1, tasks["cpu"].part_count, 2, cap))
                    for _ in range(3)]
                out = {}
                for dev, task in tasks.items():
                    moved = [(sim.RoundDraws(**{
                        f: None if getattr(d, f) is None
                        else getattr(d, f).to(dev)
                        for f in d.__dataclass_fields__}), o.to(dev))
                        for d, o in draws]
                    kw = dict(policy=policy, scen=scen, s_round=3,
                              hyper=bandit.DEFAULT_HYPERS[policy],
                              model_bits=8.0 * tree_bytes(task.params0),
                              epochs=2, batch_size=10, cohort="selected",
                              cfg=cfg)
                    eta = torch.tensor([1.5], device=dev)
                    reset_counts()
                    res = fl.run_fl_rounds(task, eta, moved, **kw)
                    counts = launch_counts()
                    one = fl.run_fl_rounds(task, eta, moved[:1], **kw)
                    out[dev] = (res, one["params"].cpu(), counts)
                (a, pa, ca), (b, pb, cb) = out["cuda"], out["cpu"]
                where = f"[7] BN {'on' if bn else 'off'} {policy}"
                if ca["bandit_round"] != 3 or ca["fedavg_combine"] != 3:
                    raise AssertionError(f"{where}: card launches {ca}")
                if not torch.equal(a["selected"].cpu(), b["selected"]):
                    raise AssertionError(f"{where}: selections differ")
                torch.testing.assert_close(a["round_times"].cpu(),
                                           b["round_times"], rtol=1e-5,
                                           atol=0)
                rt_diff = (a["round_times"].cpu() - b["round_times"]).abs() \
                    .max().item()
                rl2 = ((pa - pb).norm() / pb.norm()).item()
                if not rl2 < CARD_VS_CPU_RL2[bn]:
                    raise AssertionError(f"{where}: global model after round "
                                         f"1 at relative L2 {rl2:g}")
                log(f"{where}: selections equal, round times max abs diff "
                    f"{rt_diff:g} s, global model after round 1 at relative "
                    f"L2 {rl2:.3g} (limit {CARD_VS_CPU_RL2[bn]:g}); accuracy "
                    f"card {a['accuracy'].cpu().numpy().round(4).tolist()} "
                    f"cpu {b['accuracy'].numpy().round(4).tolist()}; card "
                    f"launches {ca}")
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def run_fl_sweep(label: str, expect: dict, **kw):
    """One accuracy sweep on the card with the launch counts zeroed before
    and read after; each kernel must have launched ``expect`` times."""
    from repro_torch.fl import engine as fl
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fl.accuracy_sweep(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = check_launches(label, expect)
    p, s, r = res.accuracy.shape
    if not (np.isfinite(res.accuracy).all()
            and np.isfinite(res.round_times).all()
            and ((res.accuracy >= 0) & (res.accuracy <= 1)).all()):
        raise AssertionError(f"[{label}] non-finite or out-of-range traces")
    log(f"[{label}] cohort={kw.get('cohort')} {p} policies x {s} seed x {r} "
        f"rounds in {wall:.2f} s: {wall / (p * r):.3f} s per round, "
        f"{p * r / wall:.3f} rounds/s; launches {counts}")
    return res, counts


def profile_fl_round(task, **kw) -> None:
    """Where one full-width round goes: torch.profiler over one policy's
    round, device time by kernel family and by engine range."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl import engine as fl
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fl.accuracy_sweep(task=task, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    # the engine's ranges also show as device-side annotations; count
    # kernels only
    events = [(e.key, e.self_device_time_total) for e in averages
              if e.device_type == cuda and not e.key.startswith("fl.")]
    device_us = sum(t for _, t in events)
    conv_us = sum(t for k, t in events if any(
        w in k.lower() for w in ("conv", "cudnn", "xmma", "implicit_gemm",
                                 "winograd", "fft")))
    fedavg_us = sum(t for k, t in events if "fedavg_combine" in k)
    round_us = sum(t for k, t in events if "bandit_round" in k)
    top = sorted(events, key=lambda e: -e[1])[:6]
    ranges = {e.key: e.cpu_time_total for e in averages
              if e.key.startswith("fl.") and e.device_type != cuda}
    log(f"[8p] profiled round ({kw.get('cohort')} cohort, "
        f"{kw.get('policies')}): wall {wall_us / 1e3:.1f} ms, device busy "
        f"{100 * device_us / wall_us:.1f}% (convolution kernels "
        f"{100 * conv_us / wall_us:.1f}%, fedavg_combine "
        f"{100 * fedavg_us / wall_us:.3f}%, bandit_round "
        f"{100 * round_us / wall_us:.4f}%), idle "
        f"{100 * (1 - device_us / wall_us):.1f}%")
    log("[8p] engine ranges, host ms (the device runs behind the host; a "
        "range ends when its last launch is queued, or at a sync): "
        + ", ".join(f"{k}={c / 1e3:.1f}" for k, c in sorted(ranges.items())))
    log("[8p] top device ops: " + ", ".join(
        f"{k[:60]}={t / 1e3:.1f} ms" for k, t in top))


def phase_fl_full_width(results: dict) -> None:
    """The full-width sweeps in float32 (TF32 off, as in phase 7 and as the
    JAX package computes); one side run at the end repeats a round with
    PyTorch's default flags (TF32 convolutions) for its time."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fl_full_width(results, saved)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def fl_full_width(results: dict, default_flags) -> None:
    from repro_torch.core import bandit
    from repro_torch.fl import engine as fl
    from repro_torch.models import cnn

    cfg = cnn.CnnConfig()
    t0 = time.perf_counter()
    task = fl.make_cnn_task("paper-baseline", 100, cfg=cfg, n_train=50_000,
                            n_test=10_000, batch_size=50, device="cuda")
    torch.cuda.synchronize()
    n_params = cnn.param_count(task.params0)
    if n_params != N_CNN:
        raise AssertionError(f"[8] the CNN has {n_params} parameters")
    log(f"[8] task: paper CNN ({n_params} parameters), K=100, shard cap "
        f"{task.part_idx.shape[1]}, 50000/10000 images, built in "
        f"{time.perf_counter() - t0:.1f} s; {tf32_flags()}")
    common = dict(task=task, cfg=cfg, n_clients=100, s_round=5,
                  frac_request=0.1, eta=1.5, epochs=5, batch_size=50,
                  device="cuda")
    p = len(bandit.POLICY_NAMES)
    r_sel, r_all, r_flaky = (FL_ROUNDS[k] for k in ("selected", "all",
                                                    "flaky"))
    torch.cuda.reset_peak_memory_stats()
    sel, counts = run_fl_sweep(
        "8", {"bandit_round": p * r_sel, "bandit_round_sampled": 0,
              "fedavg_combine": p * r_sel},
        seeds=1, n_rounds=r_sel, cohort="selected", **common)
    results["fedavg_combine"]["launches"] = counts["fedavg_combine"]
    log(f"[8] selected cohort peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("[8] accuracy@elapsed by round:")
    for name, acc, el in zip(sel.policies, sel.accuracy[:, 0],
                             sel.elapsed[:, 0]):
        log(f"[8]   {name:16s} " + " ".join(
            f"{a:.4f}@{e:.0f}s" for a, e in zip(acc, el)))

    torch.cuda.reset_peak_memory_stats()
    i = sel.policies.index("elementwise_ucb")
    all_k, _ = run_fl_sweep(
        "8", {"bandit_round": r_all, "bandit_round_sampled": 0,
              "fedavg_combine": r_all},
        policies=("elementwise_ucb",), seeds=1, n_rounds=r_all,
        cohort="all", **common)
    if not (np.array_equal(all_k.selected[0], sel.selected[i, :, :r_all])
            and np.array_equal(all_k.round_times[0],
                               sel.round_times[i, :, :r_all])):
        raise AssertionError("[8] the all-K cohort's selections or round "
                             "times differ from the selected cohort's")
    log(f"[8] all-K cohort: selections and round times equal the selected "
        f"cohort's; accuracy {all_k.accuracy[0, 0].round(4).tolist()} vs "
        f"{sel.accuracy[i, 0, :r_all].round(4).tolist()}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    flaky, _ = run_fl_sweep(
        "8", {"bandit_round": r_flaky, "bandit_round_sampled": 0,
              "fedavg_combine": r_flaky},
        scenario="flaky-clients", policies=("elementwise_ucb",), seeds=1,
        n_rounds=r_flaky, cohort="selected", deadline=DEADLINE, **common)
    fc = {k: int(v.sum()) for k, v in flaky.fault_counts().items()}
    if sum(fc[k] for k in ("ok", "crashed", "churned", "deadline_missed",
                           "corrupt")) != fc["dispatched"]:
        raise AssertionError(f"[8] fault counts do not partition: {fc}")
    log(f"[8] flaky-clients deadline={DEADLINE} s fault counts: {fc}")

    profile_fl_round(task, policies=("elementwise_ucb",), seeds=1,
                     n_rounds=1, cohort="selected", cfg=cfg, n_clients=100,
                     s_round=5, frac_request=0.1, eta=1.5, epochs=5,
                     batch_size=50, device="cuda")

    # the same first round with PyTorch's default flags (TF32 convolutions)
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = default_flags
    t0 = time.perf_counter()
    tf32 = fl.accuracy_sweep(policies=("elementwise_ucb",), seeds=1,
                             n_rounds=1, cohort="selected", **common)
    torch.cuda.synchronize()
    log(f"[8] with PyTorch's default flags ({tf32_flags()}): round 1 "
        f"accuracy {tf32.accuracy[0, 0, 0]:.4f} against "
        f"{sel.accuracy[i, 0, 0]:.4f} in float32, "
        f"{time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# the scale-out slice: the local top-S and UCB-score kernels, the
# client-sharded segmented sweep and the hierarchical sweep
# ---------------------------------------------------------------------------

# phase 9's top-S cases (G, P, C, S, kind); the first is the shape phase 10
# gives the kernel at K=10^4, the third its shape at K=10^6.  Every case is
# held bitwise against the plain version; the "path" ones are also timed.
# C = 100,001 is ragged at every chunk boundary of its 16-block cluster;
# rows of 10^6 and more split into chunks whose keys outgrow a block's
# shared memory, so the kernel streams their tails: 1,851,392 is PR 13's
# longest row, 28,573,696 the wrapper's (kernels/topk_slots.MAX_C), where
# a chunk stages no key at all and every entry streams
TOPK_CASES = [(8, 4, 1_000, 5, "path"), (1, 8, 100_000, 5, "path"),
              (2, 8, 100_000, 5, "path"), (2, 2, 4_096, 64, "path"),
              (1, 8, 100_001, 5, "path"), (1, 1, 1_000_000, 5, "path"),
              (2, 8, 100_000, 64, "path"), (1, 1, 1_851_392, 5, "path"),
              (1, 1, 28_573_696, 5, "path"), (1, 2, 28_573_696, 64, "nan"),
              (8, 4, 1_000, 5, "ties"), (2, 2, 4_096, 64, "edges"),
              (1, 8, 100_000, 5, "edges"), (8, 4, 1_000, 5, "nan"),
              (2, 8, 100_000, 5, "nan"), (2, 4, 1_000, 7, "inf0"),
              (1, 8, 100_000, 5, "inf0")]
# (G, K): select_naive's shape (the main path's, first), the JAX package's
# largest K, and ragged K whose rows 1 and 2 start off a 16-byte boundary:
# 10^4 + 1 and 2 * 10^5 + 1 (a partial last block in every row)
UCB_CASES = [(8, 10_000), (1, 1_000_000), (3, 10_001), (3, 200_001)]
# (G, K, sums offset, n_sel offset) in elements: data pointers off 16 bytes
# (views of a larger buffer), the two at the same and at different offsets
UCB_OFFSET_CASES = [(2, 4_099, 1, 1), (2, 300_001, 1, 1),
                    (2, 300_002, 1, 3), (1, 3, 2, 2)]
UCB_MAX_ULP = 2          # phase 9's limit on the score kernel's ulp gap


def topk_inputs(g, p, c, kind, gen, s=5):
    """[G, P, C] scores and validity on the card.  "path": uniform scores,
    each slot owned by one random shard and masked to -inf elsewhere, as
    the segmented round hands them over; "ties": four distinct values,
    unmasked; "edges": ties, -inf at valid entries, an all-invalid row and
    a row whose live scores are all -inf; "nan": uniform scores with 1 %
    NaN; "inf0": a live -inf at index 0 and about S / 2 live entries a
    row, so that the tail gives (-inf, 0)."""
    dev = torch.device("cuda")
    score = torch.rand((g, p, c), generator=gen, device=dev)
    owner = torch.randint(0, p, (g, 1, c), generator=gen, device=dev)
    valid = owner == torch.arange(p, device=dev).view(1, p, 1)
    if kind == "path":
        score = torch.where(valid, score, float("-inf"))
    elif kind == "nan":
        score[torch.rand((g, p, c), generator=gen, device=dev) < 0.01] = (
            float("nan"))
        valid = torch.rand((g, p, c), generator=gen, device=dev) < 0.7
    elif kind == "inf0":
        valid = torch.rand((g, p, c), generator=gen, device=dev) < s / (2 * c)
        score[..., 0] = float("-inf")
        valid[..., 0] = True
    else:
        score = (score * 4).floor() / 4
        valid = torch.rand((g, p, c), generator=gen, device=dev) < 0.7
    if kind == "edges":
        score[..., ::7] = float("-inf")
        valid[0, 0] = False
        score[-1, -1] = float("-inf")
    return score.contiguous(), valid.contiguous()


def topk_bound(rows: int, c: int, s: int):
    """Least time (ms) of one local top-S: each score (4 B) and validity
    byte read once, S (value, slot) pairs written, over the memory rate."""
    return (rows * (c * 5 + s * 8)) / HBM_BYTES_PER_S * 1e3, "bytes"


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two float32 tensors (NaN and -0.0 included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_topk_kernel(results: dict) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_slots as cuda_topk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    shapes = []
    for g, p, c, s, kind in TOPK_CASES:
        score, valid = topk_inputs(g, p, c, kind, gen, s)
        plan = cuda_topk.plan(g * p, c)
        vals, slots = cuda_topk.local_topk_cuda(score, valid, s)
        pv, ps = ref.local_topk_ref(score, valid, s)
        torch.cuda.synchronize()
        where = (f"topk_slots G={g} P={p} C={c} S={s} {kind} (cluster "
                 f"{plan.cluster} x {plan.threads} threads, chunk "
                 f"{plan.chunk}, {plan.staged} staged)")
        if not (torch.equal(slots, ps) and bits_equal(vals, pv)):
            raise AssertionError(f"[9] {where}: kernel differs from the plain "
                                 f"version")
        if kind != "path":
            log(f"[9] {where}: exact (exhausted steps "
                f"{int((slots < 0).sum())}, tail picks of entry 0 "
                f"{int(((slots == 0) & (vals == float('-inf'))).sum())})")
            continue
        masked = torch.where(valid, score, float("-inf"))
        lib = masked.topk(s, dim=-1)
        if not torch.equal(lib.values, vals):
            raise AssertionError(f"[9] {where}: torch.topk values differ")
        def launch():
            return cuda_topk.local_topk_cuda(score, valid, s)
        ms = time_ms(launch, 100)
        dev_ms = profiled_kernel_ms(launch, 50, "topk_slots_kernel")
        pms = time_ms(lambda: ref.local_topk_ref(score, valid, s), 3)
        lms = time_ms(lambda: masked.topk(s, dim=-1), 100)
        bms, by = topk_bound(g * p, c, s)
        log(f"[9] {where}: exact; kernel {ms:.4f} ms (device time by "
            f"torch.profiler {'none' if dev_ms is None else f'{dev_ms:.4f}'}"
            f" ms), plain {pms:.4f} ms, torch.topk {lms:.4f} ms, bound "
            f"{bms:.6f} ms ({by}), {100 * bms / ms:.1f}% of bound"
            f"{'' if ms <= lms else ' (SLOWER than torch.topk)'}")
        shapes.append(dict(g=g, p=p, c=c, s=s, cluster=plan.cluster, ms=ms,
                           device_ms=dev_ms, plain_ms=pms, library_ms=lms,
                           bound_ms=bms))
        if (g, p, c, s) == TOPK_CASES[0][:4]:
            results["topk_slots"].update(
                ms=ms, device_ms=dev_ms, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by=by, shape=dict(g=g, p=p, c=c, s=s))
    results["topk_slots"]["max_abs_err"] = 0.0
    results["topk_slots"]["shapes"] = shapes


def ucb_inputs(g, k, gen):
    dev = torch.device("cuda")
    n = torch.randint(0, 50, (g, k), generator=gen, device=dev,
                      dtype=torch.int32)
    n[torch.rand((g, k), generator=gen, device=dev) < 0.2] = 0
    sums = n.float() * (1.0 + 900.0 * torch.rand((g, k), generator=gen,
                                                 device=dev))
    return sums, n, n.sum(1, dtype=torch.int32)


def phase_ucb_kernel(results: dict) -> None:
    from repro_torch.core import bandit
    from repro_torch.kernels import ref
    from repro_torch.kernels import ucb_score as cuda_ucb
    from repro_torch.sim.engine import topk_lowest
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    worst_ulp, worst_abs = 0, 0.0

    def check(sums, n, total, where):
        nonlocal worst_ulp, worst_abs
        got = cuda_ucb.ucb_scores_cuda(sums, n, total, 1000.0)
        want = ref.ucb_scores_ref(sums, n, total, 1000.0)
        torch.cuda.synchronize()
        ulp = int((got.view(torch.int32).long()
                   - want.view(torch.int32).long()).abs().max())
        err = float((got - want).abs().max())
        if ulp > UCB_MAX_ULP or not torch.equal(got[n == 0], want[n == 0]):
            raise AssertionError(f"[9] {where}: kernel {ulp} ulp from the "
                                 f"plain version (limit {UCB_MAX_ULP})")
        worst_ulp, worst_abs = max(worst_ulp, ulp), max(worst_abs, err)
        return ulp, err

    for g, k, s_off, n_off in UCB_OFFSET_CASES:
        sums, n, total = ucb_inputs(g, k, gen)
        bs = torch.empty(g * k + s_off, device="cuda")
        bn = torch.empty(g * k + n_off, dtype=torch.int32, device="cuda")
        bs[s_off:], bn[n_off:] = sums.flatten(), n.flatten()
        ulp, _ = check(bs[s_off:].view(g, k), bn[n_off:].view(g, k), total,
                       f"ucb_score G={g} K={k} offsets {s_off}, {n_off}")
        log(f"[9] ucb_score G={g} K={k}, sums {s_off} and n_sel {n_off} "
            f"elements off 16 bytes: {ulp} ulp from the plain version")
    sums, n, total = ucb_inputs(2, 100, gen)
    try:
        cuda_ucb.ucb_scores_cuda(sums, n.cpu(), total)
    except ValueError as e:
        log(f"[9] ucb_score refuses n_sel on another device: {e}")
    else:
        raise AssertionError("[9] ucb_score took n_sel on the CPU")
    shapes = []
    for g, k in UCB_CASES:
        sums, n, total = ucb_inputs(g, k, gen)
        total[0] = 1                        # log max(total, 2) at the floor
        where = f"ucb_score G={g} K={k}"
        ulp, err = check(sums, n, total, where)
        def launch():
            return cuda_ucb.ucb_scores_cuda(sums, n, total, 1000.0)
        ms = time_ms(launch, 100)
        dev_ms = profiled_kernel_ms(launch, 50, "ucb_score_kernel")
        pms = time_ms(lambda: ref.ucb_scores_ref(sums, n, total, 1000.0), 10)
        bms = (g * (12 * k + 4)) / HBM_BYTES_PER_S * 1e3
        log(f"[9] {where}: {'bitwise equal' if ulp == 0 else f'{ulp} ulp'} "
            f"(max abs err {err:g}); kernel {ms:.4f} ms (device time by "
            f"torch.profiler {'none' if dev_ms is None else f'{dev_ms:.4f}'}"
            f" ms), plain {pms:.4f} ms, bound {bms:.6f} ms (bytes), "
            f"{100 * bms / ms:.1f}% of bound")
        shapes.append(dict(g=g, k=k, ms=ms, device_ms=dev_ms, plain_ms=pms,
                           bound_ms=bms))
        if (g, k) == UCB_CASES[0]:
            results["ucb_score"].update(ms=ms, device_ms=dev_ms,
                                        plain_ms=pms, bound_ms=bms,
                                        bound_by="bytes",
                                        shape=dict(g=g, k=k))
    results["ucb_score"].update(max_abs_err=worst_abs, shapes=shapes)

    # the main path: select_naive on a learning state, through the kernel,
    # against the policy formula and the plain score on the same state
    g, k, c, s, rounds = 8, 10_000, 1_000, 5, 20
    dev = torch.device("cuda")
    state = bandit.BanditState.create(g, k, device=dev)
    reset_counts()
    same = 0
    for _ in range(rounds):
        cands = topk_lowest(torch.rand((g, k), generator=gen, device=dev),
                            c).to(torch.int32)
        sel = bandit.select_naive(state, cands, s)            # the kernel
        launched = launch_counts()["ucb_score"]
        mask = bandit.candidate_mask(k, cands)
        plain = bandit._top_score(ref.ucb_scores_ref(
            state.sum_tinc, state.n_sel, state.total, 1000.0), mask, s)
        formula = bandit._select_with_rand("naive_ucb", state, mask, None,
                                           None, None, 1000.0, s)
        if launch_counts()["ucb_score"] != launched:
            raise AssertionError("[9] a comparison launched the kernel")
        if not (torch.equal(sel, plain) and torch.equal(sel, formula)):
            raise AssertionError("[9] select_naive: kernel route differs")
        same += 1
        tinc = 10.0 + 300.0 * torch.rand((g, s), generator=gen, device=dev)
        state = bandit.observe(state, sel, tinc, tinc, tinc)
    counts = check_launches("9", {"ucb_score": rounds})
    results["ucb_score"]["launches"] = counts["ucb_score"]
    # on the card every route of the index API scores through the kernel:
    # a tensor alpha and use_kernel=False too
    reset_counts()
    routes = (bandit.make_select_fn("naive_ucb", s)(
        state, mask, None, None, None, torch.tensor(1000.0, device=dev)),
        bandit.select_naive(state, cands, s, use_kernel=False))
    check_launches("9", {"ucb_score": len(routes)})
    want = bandit.select_naive(state, cands, s)
    if not all(torch.equal(r, want) for r in routes):
        raise AssertionError("[9] select_naive routes differ on the card")
    log(f"[9] select_naive G={g} K={k} C={c} S={s}, {rounds} rounds on a "
        f"learning state: selections through the kernel equal the plain "
        f"score's and the policy formula's in {same}/{rounds} rounds; "
        f"launches {counts['ucb_score']} (worst ulp gap {worst_ulp})")


def segmented_vs(label, seg, other, name, flags=False) -> None:
    same = np.array_equal(seg.round_times, other.round_times) and (
        not flags or np.array_equal(seg.flags, other.flags))
    if not same:
        d = np.abs(seg.round_times.astype(np.float64) - other.round_times)
        raise AssertionError(f"[{label}] segmented differs from {name}: max "
                             f"abs diff {d.max():g} s in {(d > 0).sum()} "
                             f"rounds")
    log(f"[{label}] segmented equals {name} bitwise (round times"
        f"{' and flags' if flags else ''})")


def time_draw_vs_round(label: str, **kw) -> None:
    """Host ms per round of the draw step and of the round itself (each
    ended by a synchronise), for one policy's sweep shape."""
    from repro_torch.core import bandit
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import get_scenario
    scen = get_scenario(kw["scenario"])
    k, p, rounds = kw["n_clients"], kw["shards"], kw["n_rounds"]
    n_req, cells = math.ceil(0.1 * k), kw.get("cells")
    dev = torch.device("cuda")
    env = engine.EnvArrays.from_scenario(
        scen, scen.build_env(k, np.random.default_rng(0)), dev)
    eta = torch.full((kw["seeds"],), 1.5, device=dev)
    draw_cells = None
    if cells:
        draw_cells = (cells[0], -(-k // scen.congestion_cells))
        n_req = cells[0] * cells[1]
    for policy in kw["policies"]:
        streams = engine.KeyStreams(range(kw["seeds"]), rounds, dev)
        runner = engine.RoundRunner(
            env, eta, policy=policy, scen=scen, s_round=5,
            hyper=bandit.DEFAULT_HYPERS[policy], model_bits=146.4e6,
            fast=True, shards=p, cells=cells)
        t_draw = t_round = 0.0
        for rnd in range(1, rounds + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = engine.draw_round_inputs(
                streams, rnd=rnd - 1, k=k, n_req=n_req, s_round=5,
                fast=True, fluctuate=True, policy=policy, scen=scen,
                fault=None, cells=draw_cells)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            runner.step(rnd, d)
            torch.cuda.synchronize()
            t_draw += t1 - t0
            t_round += time.perf_counter() - t1
        log(f"[{label}t] {policy} K={k} "
            f"{f'P={p}' if p else f'cells={cells}'} G={kw['seeds']}: draw "
            f"{1e3 * t_draw / rounds:.3f} ms, round "
            f"{1e3 * t_round / rounds:.3f} ms per round (host clock, "
            f"synchronised)")


def phase_segmented(results: dict) -> None:
    from repro_torch.distributed.sharding import bandit_state_bytes
    n_score = 2                            # naive_ucb and random rank scores
    base = dict(scenario="paper-baseline", etas=(1.5,), seeds=8,
                n_rounds=100, n_clients=10_000)
    seg, counts = run_sweep("10", {"topk_slots": n_score * 100},
                            shard="clients", devices=4, **base)
    results["topk_slots"]["launches"] = counts["topk_slots"]
    flat, _ = run_sweep("10", {"bandit_round_sampled": 8 * 100}, **base)
    segmented_vs("10", seg, flat, "the flat fused path (bandit_round_sampled)")
    unfused, _ = run_sweep("10", {}, fused=False, **base)
    segmented_vs("10", seg, unfused, "the flat unfused path")

    flaky = dict(base, scenario="flaky-clients", deadline=DEADLINE)
    seg, _ = run_sweep("10", {"topk_slots": n_score * 100}, shard="clients",
                       devices=4, **flaky)
    flat, _ = run_sweep("10", {"bandit_round_sampled": 8 * 100}, **flaky)
    segmented_vs("10", seg, flat, "the flat fused path, flaky-clients",
                 flags=True)

    big = dict(scenario="paper-baseline", etas=(1.5,), seeds=2, n_rounds=20,
               n_clients=1_000_000)
    torch.cuda.reset_peak_memory_stats()
    seg, _ = run_sweep("10", {"topk_slots": n_score * 20}, shard="clients",
                       devices=8, **big)
    seg_mib = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    unfused, _ = run_sweep("10", {}, fused=False, **big)
    flat_mib = torch.cuda.max_memory_allocated() / 2**20
    segmented_vs("10", seg, unfused, "the flat unfused path at K=10^6")
    block, whole = (bandit_state_bytes(1_000_000, 8),
                    bandit_state_bytes(1_000_000))
    log(f"[10] K=10^6 C=10^5 P=8: state per block {block} B per grid point "
        f"(unsharded {whole} B); peak device memory segmented {seg_mib:.1f} "
        f"MiB, flat unfused {flat_mib:.1f} MiB")
    time_draw_vs_round("10", scenario="paper-baseline", seeds=2, n_rounds=10,
                       n_clients=1_000_000, shards=8,
                       policies=("naive_ucb", "elementwise_ucb"))
    profile_sweep("10", scenario="paper-baseline", policies=("naive_ucb",),
                  etas=(1.5,), seeds=2, n_rounds=20, n_clients=1_000_000,
                  shard="clients", devices=8)


def check_hierarchy_against_cpu() -> None:
    """Hierarchical rounds from the same seeds' keys through the card and
    the CPU, each drawing on its own device (the per-cell uniforms from
    ``fold_in`` of the selected cell ids there): each round's cell
    selection, candidates (``select_cells``, ``hier_cell_uniforms`` and
    ``hier_cand_idx`` recomputed from the runner's aggregates, as its step
    computes them) and client selection equal, round times and the cell
    aggregates within rtol 1e-5.  ``n_req_cell`` below the cells'
    population makes the per-cell ranking choose."""
    from repro_torch.core import bandit
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import get_scenario

    scen = get_scenario("metro-congestion")
    k, rounds, n_cells = 100_000, 10, scen.congestion_cells
    m = -(-k // n_cells)
    env_np = scen.build_env(k, np.random.default_rng(0))
    for cells in ((10, 1000), (10, 300)):
        worst, n_req = 0.0, cells[0] * cells[1]
        for policy in bandit.POLICY_NAMES:
            out = {}
            for dev in ("cpu", "cuda"):
                streams = engine.KeyStreams((0, 1), rounds, dev)
                draws = [engine.draw_round_inputs(
                    streams, rnd=r, k=k, n_req=n_req, s_round=5, fast=True,
                    fluctuate=True, policy=policy, scen=scen, fault=None,
                    cells=(cells[0], m)) for r in range(rounds)]
                env = engine.EnvArrays.from_scenario(scen, env_np, dev)
                runner = engine.RoundRunner(
                    env, torch.tensor([1.5, 1.5], device=dev),
                    policy=policy, scen=scen, s_round=5,
                    hyper=bandit.DEFAULT_HYPERS[policy], model_bits=146.4e6,
                    fast=True, cells=cells)
                rec = {"cells": [], "cand": [], "sel": [], "rt": []}
                for rnd, d in enumerate(draws, start=1):
                    sel_c = bandit.select_cells(runner.cell_n,
                                                runner.cell_tinc, cells[0])
                    rec["cells"].append(sel_c.cpu())
                    rec["cand"].append(bandit.hier_cand_idx(
                        bandit.hier_cell_uniforms(d.cell_key, sel_c, m),
                        sel_c, k, n_cells, cells[1]).cpu())
                    sel, rt, _ = runner.step(rnd, d)
                    rec["sel"].append(sel.cpu())
                    rec["rt"].append(rt.cpu())
                out[dev] = ({n: torch.stack(v) for n, v in rec.items()},
                            runner.cell_n.cpu(), runner.cell_tinc.cpu())
            (a, an, at), (b, bn, bt) = out["cuda"], out["cpu"]
            where = f"[11] card vs CPU cells={cells} {policy}"
            for name in ("cells", "cand", "sel"):
                if not torch.equal(a[name], b[name]):
                    raise AssertionError(f"{where}: {name} differ")
            if not torch.equal(an, bn):
                raise AssertionError(f"{where}: cell counts differ")
            torch.testing.assert_close(a["rt"], b["rt"], rtol=1e-5, atol=0)
            torch.testing.assert_close(at, bt, rtol=1e-5, atol=0)
            worst = max(worst, (a["rt"] - b["rt"]).abs().max().item())
        log(f"[11] card vs CPU from the same seeds, metro-congestion K={k}, "
            f"(s_cells, n_req_cell)={cells}, 8 policies x 2 grid points x "
            f"{rounds} rounds: cell selections, candidates, selections and "
            f"cell counts equal, round times max abs diff {worst:g} s")


def phase_hierarchy() -> None:
    check_hierarchy_against_cpu()
    hier, _ = run_sweep("11", {"bandit_round_sampled": 8 * 100},
                        scenario="metro-congestion", etas=(1.5,), seeds=1,
                        n_rounds=100, n_clients=100_000, hierarchy="cells")
    flat = RATES.get("5")
    log(f"[11] metro-congestion K=100000 hierarchy=cells (10 of 100 cells, "
        f"1000 candidates each): {RATES['11']:.1f} rounds/s against the flat "
        f"path's {'not run' if flat is None else f'{flat:.1f}'} (phase 5)")
    time_draw_vs_round("11", scenario="metro-congestion", seeds=1,
                       n_rounds=20, n_clients=100_000, shards=None,
                       cells=(10, 1000), policies=("elementwise_ucb",))
    profile_sweep("11", scenario="metro-congestion",
                  policies=("elementwise_ucb",), etas=(1.5,), seeds=1,
                  n_rounds=100, n_clients=100_000, hierarchy="cells")
    base = dict(scenario="paper-baseline", etas=(1.5,), seeds=2, n_rounds=20,
                n_clients=10_000)
    cells, _ = run_sweep("11", {"bandit_round_sampled": 8 * 20},
                         hierarchy="cells", **base)
    flat, _ = run_sweep("11", {"bandit_round_sampled": 8 * 20}, **base)
    if not np.array_equal(cells.round_times, flat.round_times):
        raise AssertionError("[11] one cell: hierarchy='cells' differs from "
                             "the flat sweep")
    log("[11] paper-baseline (one cell) with hierarchy='cells' equals the "
        "flat sweep bitwise (the routing: one cell runs the flat path)")


# ---------------------------------------------------------------------------
# phase 12: the LM slice (attention kernel, prefill and decode)
# ---------------------------------------------------------------------------

BF16_TC_OPS_PER_S = 989e12     # H100 SXM bf16 dense tensor-core rate
TF32_TC_OPS_PER_S = 495e12     # H100 SXM tf32 dense tensor-core rate
# (B, Sq, Skv, KV, G, dh, causal, dtype): smollm-135m's prefill shapes (the
# main path's first), the main path's shape once more in float32,
# qwen3-1.7b's head width, ragged f32 cases at every head width, causal and
# full, Sq and Skv no multiple of the f32 kernel's 64- (32-) key tile and not
# always equal, and ragged bfloat16 cases for every head width the
# tensor-core kernel takes, causal and full, Sq and Skv no multiple of 64
# (its key tile) and not always equal
FLASH_CASES = [(4, 4096, 4096, 3, 3, 64, True, "bfloat16"),
               (4, 4096, 4096, 3, 3, 64, True, "float32"),
               (1, 32768, 32768, 3, 3, 64, True, "bfloat16"),
               (1, 2048, 2048, 8, 2, 128, True, "bfloat16"),
               (1, 2048, 2048, 8, 2, 128, False, "bfloat16"),
               (2, 1000, 1000, 1, 4, 64, True, "float32"),
               (2, 1000, 1000, 1, 4, 64, True, "bfloat16"),
               (2, 1000, 777, 1, 4, 64, False, "bfloat16"),
               (1, 1000, 600, 2, 3, 64, True, "bfloat16"),
               (1, 1500, 1500, 2, 3, 32, True, "bfloat16"),
               (1, 1100, 1300, 2, 3, 32, False, "bfloat16"),
               (2, 333, 333, 1, 3, 128, True, "bfloat16"),
               (1, 700, 900, 2, 2, 128, True, "bfloat16"),
               (1, 900, 700, 2, 2, 128, False, "bfloat16"),
               (1, 1100, 1300, 2, 3, 32, False, "float32"),
               (1, 1500, 1500, 2, 3, 32, True, "float32"),
               (2, 1000, 777, 1, 4, 64, False, "float32"),
               (1, 700, 900, 2, 2, 128, True, "float32"),
               (1, 900, 700, 2, 2, 128, False, "float32"),
               (1, 2048, 2048, 8, 2, 128, True, "float32")]
# the variant each dtype launches, and the kernel name torch.profiler shows
# (the float32 call also launches its split pass, F32_SPLIT_KERNEL, timed
# on its own)
FLASH_VARIANT = {"float32": ("flash_attention",
                             "flash_attention_3xtf32_kernel"),
                 "bfloat16": ("flash_attention_wgmma",
                              "flash_attention_wgmma_kernel")}
# kernel against its plain version.  float32: the JAX package's tolerance
# for its kernel (tests/test_kernels.py); both accumulate in float32 in
# other orders.  bfloat16: both compute in float32 and round once to
# bfloat16, so they differ by at most one bfloat16 step where the float32
# results straddle a rounding boundary, 2**-7 of the value at most; rtol
# 1e-2 holds that and atol 1e-4 only the values near 0.  Scaled to the
# output, not JAX's 2e-2 (chosen for S <= 256): a row that averages n
# randn values has |o| ~ sqrt(e / n), about 0.04 at S = 4096 and 0.015 at
# S = 32768, where an atol of 2e-2 would pass a dropped key tile
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=1e-5),
             "bfloat16": dict(rtol=1e-2, atol=1e-4)}
# card against CPU on the same parameters and prompts (the CPU tests'
# tolerances against the JAX package, tests/test_torch_lm.py): float32
# logits rtol 1e-5 / atol 1e-5 and cache atol 5e-5 (summation orders of
# cuBLAS, the kernel and the CPU differ by ulps); bfloat16 logits rtol
# 2e-2 / atol 3e-2, cache atol 0.1 (activations rounded to bfloat16 at
# every matmul, at other places)
LM_TOL = {"float32": (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-5, atol=5e-5)),
          "bfloat16": (dict(rtol=2e-2, atol=3e-2), dict(rtol=2e-2, atol=0.1))}
F32_SPLIT_KERNEL = "kv_split_tf32_kernel"
# the one-tile check of the float32 kernel's 3xTF32 products against
# float64 (flash_attention_tile_check): the largest error of S = A K^T and of
# O = S V over the largest value of the float64 product.  Three TF32
# products carry ~22 bits of each product (emulated: ~2.5e-7 at dh 64);
# one TF32 product reads ~3.4e-4 there.  Above 1e-6 the tensor cores would
# round their float32 sums coarser than float32 does
TILE_CHECK_MAX_REL = 1e-6
SERVE_ARGS = ["--arch", "smollm-135m", "--full", "--batch", "4",
              "--prompt-len", "4096", "--decode-steps", "32"]
SERVE_ONE: dict = {}    # phase 12's one-process serve, for phase 18 (b)


def flash_ops(b, sq, skv, kv, g, dh, causal) -> int:
    """4·dh float operations per (query row, visible key) pair — the keys
    j <= i when causal."""
    if causal:
        n = min(sq, skv)
        pairs = n * (n + 1) // 2 + (sq - n) * skv
    else:
        pairs = sq * skv
    return 4 * b * kv * g * pairs * dh


def flash_bound(b, sq, skv, kv, g, dh, causal, itemsize):
    """Least time (ms) of one attention forward: flash_ops over the type's
    tensor-core peak (bf16, or tf32 for float32: the fastest rate at which
    the card takes float32 products), against q and the output (Sq rows)
    and k, v (Skv rows) moved once over the memory rate.  The float32
    kernel issues three TF32 products for each of these (3xTF32): work of
    its design, not of the function, so it stays out of the bound."""
    ops = flash_ops(b, sq, skv, kv, g, dh, causal)
    rate = BF16_TC_OPS_PER_S if itemsize == 2 else TF32_TC_OPS_PER_S
    nbytes = itemsize * (2 * b * sq * kv * g * dh + 2 * b * skv * kv * dh)
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tile_check(lib, dh: int, seed: int = 0):
    """The float32 kernel's products on one tile, through ``lib``'s
    ``flash_attention_tile_check``: (error of S = A K^T, error of O = S V)
    against float64 products of the same float32 inputs (O's from the
    card's S), each over the float64 result's largest value."""
    import ctypes

    from repro_torch.kernels import flash_attention as cuda_flash
    fn = lib.flash_attention_tile_check
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bn = cuda_flash.F32_TILES[dh][1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    a, k, v = (torch.randn(64, dh, generator=gen, device="cuda")
               for _ in range(3))
    scratch = torch.empty(cuda_flash.f32_scratch_shape(1, 64, 1, dh),
                          device="cuda")
    s_out = torch.empty(64, bn, device="cuda")
    o_out = torch.empty(64, dh, device="cuda")
    err = fn(a.data_ptr(), k.data_ptr(), v.data_ptr(), scratch.data_ptr(),
             s_out.data_ptr(), o_out.data_ptr(), dh,
             torch._C._cuda_getCurrentRawStream(0))
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"tile check launch failed: CUDA error {err}")
    s64 = a.double() @ k[:bn].double().T
    o64 = s_out.double() @ v[:bn].double()
    return tuple(float((got.double() - want).abs().max() / want.abs().max())
                 for got, want in ((s_out, s64), (o_out, o64)))


def phase_flash_kernel(results: dict) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as cuda_flash
    # first, the float32 kernel's 3xTF32 products on one tile against
    # float64: its fragment layouts and the tensor cores' float32 sums
    lib = _build.load("flash_attention")
    for dh in cuda_flash.HEAD_DIMS:
        errs = tile_check(lib, dh)
        log(f"[12] one-tile 3xTF32 check dh {dh}: S = A K^T {errs[0]:.3g}, "
            f"O = S V {errs[1]:.3g} of the float64 product's largest value "
            f"(limit {TILE_CHECK_MAX_REL:g})")
        if max(errs) > TILE_CHECK_MAX_REL:
            raise AssertionError(f"[12] one-tile 3xTF32 check at dh {dh} "
                                 f"above {TILE_CHECK_MAX_REL:g}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for case in FLASH_CASES:
        flash_case(results, case, gen, "12")


def flash_case(results: dict, case: tuple, gen, tag: str) -> None:
    """One attention case (B, Sq, Skv, KV, G, dh, causal, dtype): the
    kernel against its plain version under FLASH_TOL, timed beside the
    plain version, SDPA and the bound; the main path's shape (smollm's
    (4, 4096, 3, 3, 64) causal) keeps its times in ``results``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as cuda_flash
    from repro_torch.kernels import ref
    b, sq, skv, kv, g, dh, causal, dtype = case
    name, kernel = FLASH_VARIANT[dtype]
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
               for shape in ((b, sq, kv, g, dh), (b, skv, kv, dh),
                             (b, skv, kv, dh)))
    before = cuda_flash.launch_counts[name]
    got = cuda_flash.flash_attention_cuda(q, k, v, causal)
    if cuda_flash.launch_counts[name] != before + 1:
        raise AssertionError(f"[{tag}] {dtype} input did not launch {name}")
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    where = (f"{name} (B, Sq, Skv, KV, G, dh)=({b}, {sq}, {skv}, {kv}, "
             f"{g}, {dh}) {'causal' if causal else 'full'} {dtype}")
    torch.testing.assert_close(got, want, **FLASH_TOL[dtype],
                               msg=f"[{tag}] {where}: kernel differs from "
                                   f"the plain version")
    res = results[name]
    res["max_abs_err"] = max(res.get("max_abs_err") or 0.0, err)
    n = 1 if b * sq * skv > 2 ** 28 else 5          # calls per timing

    def launch():
        return cuda_flash.flash_attention_cuda(q, k, v, causal)
    ms = time_ms(launch, n)
    dev_ms = profiled_kernel_ms(launch, max(n, 3), kernel)
    pms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal), 1)
    # SDPA's layout: [B, heads, S, dh], query head i on kv head i // G
    qs = q.permute(0, 2, 3, 1, 4).reshape(b, kv * g, sq, dh).contiguous()
    ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
    lms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=True), n)
    bms, by = flash_bound(b, sq, skv, kv, g, dh, causal, q.element_size())
    bounds = f"bound {bms:.4f} ms ({by}), {100 * bms / ms:.2f}% of bound"
    split_ms = None
    if dtype == "float32":
        # beside the bound, the same operations at the CUDA cores' float32
        # rate (the ceiling of a CUDA-core design) and the split pass's own
        # device time
        cc_ms = flash_ops(b, sq, skv, kv, g, dh, causal) \
            / FP32_OPS_PER_S * 1e3
        split_ms = profiled_kernel_ms(launch, max(n, 3), F32_SPLIT_KERNEL)
        split = "none" if split_ms is None else f"{split_ms:.4f}"
        bounds += (f"; the operations at the CUDA cores' float32 rate "
                   f"{cc_ms:.4f} ms; split pass {split} ms device time")
    log(f"[{tag}] {where}: max abs err {err:.3g} (rtol/atol "
        f"{FLASH_TOL[dtype]['rtol']}/{FLASH_TOL[dtype]['atol']}); kernel "
        f"{ms:.4f} ms (device time by torch.profiler "
        f"{'none' if dev_ms is None else f'{dev_ms:.4f}'} ms), plain "
        f"{pms:.4f} ms, SDPA {lms:.4f} ms, {bounds}")
    if (b, sq, kv, g, dh, causal) == (4, 4096, 3, 3, 64, True):
        res.update(ms=ms, device_ms=dev_ms, plain_ms=pms, library_ms=lms,
                   bound_ms=bms, bound_by=by,
                   shape=dict(b=b, s=sq, kv=kv, g=g, dh=dh))
        if dtype == "float32":
            res.update(split_device_ms=split_ms)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def greedy_picks(logits_c, logits_h, atol: float, where: str):
    """The CPU's greedy tokens from the last position of ``logits_h``, and
    whether the card's (``logits_c``) are the same; the card's pick must be
    the CPU's or tie it within ``atol``."""
    tok = logits_h[:, -1].argmax(-1).to(torch.int32)
    mine = logits_c[:, -1].argmax(-1).cpu()
    top = logits_h[:, -1].float().amax(-1)
    picked = logits_h[:, -1].float().gather(1, mine.long()[:, None])[:, 0]
    if not bool((picked >= top - atol).all()):
        raise AssertionError(f"{where}: the card picks {mine}, the CPU {tok}")
    return tok, int((mine == tok).all())


def phase_lm_card_vs_cpu(results: dict) -> None:
    """Reduced smollm-135m at S = 1024 (the kernel route) on the card and on
    the CPU from the same parameters and prompts: prefill logits, 8 decode
    steps fed the CPU's greedy tokens, and the KV cache.  Each prefill
    launches its dtype's attention variant once per layer and the other
    never; the float32 prefill is the float32 kernel's path."""
    import dataclasses

    from repro_torch.configs import smollm_135m
    from repro_torch.kernels import flash_attention as cuda_flash
    from repro_torch.models import transformer
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(smollm_135m.REDUCED,
                                  compute_dtype=getattr(torch, dtype))
        gen = torch.Generator()
        gen.manual_seed(3)
        cpu_params = transformer.init(gen, cfg)
        card_params = _to(cpu_params, "cuda")
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 1024))
        batch = {"tokens": torch.tensor(toks, dtype=torch.int32)}
        tol, ctol = LM_TOL[dtype]
        cuda_flash.reset_launch_counts()
        with torch.inference_mode():
            logits_c, cache_c, pos = transformer.prefill(
                card_params, _to(batch, "cuda"), cfg, max_len=1024 + 8)
            logits_h, cache_h, _ = transformer.prefill(cpu_params, batch, cfg,
                                                       max_len=1024 + 8)
            name = FLASH_VARIANT[dtype][0]
            want = {k: (cfg.n_layers if k == name else 0)
                    for k in cuda_flash.launch_counts}
            if cuda_flash.launch_counts != want:
                raise AssertionError(f"[12] reduced {dtype} prefill launched "
                                     f"{cuda_flash.launch_counts}, not "
                                     f"{want}")
            launched = cuda_flash.launch_counts[name]
            if dtype == "float32":
                results[name]["launches"] = launched
            torch.testing.assert_close(logits_c.cpu(), logits_h, **tol,
                                       msg=f"[12] {dtype} prefill logits")
            worst = (logits_c.cpu().float() - logits_h.float()).abs().max()
            same = 0
            for i in range(8):
                tok, agree = greedy_picks(logits_c, logits_h, tol["atol"],
                                          f"[12] {dtype} step {i}")
                same += agree
                logits_c, cache_c = transformer.decode_step(
                    card_params, cache_c, tok.cuda(), pos + i, cfg)
                logits_h, cache_h = transformer.decode_step(
                    cpu_params, cache_h, tok, pos + i, cfg)
                torch.testing.assert_close(logits_c.cpu(), logits_h, **tol,
                                           msg=f"[12] {dtype} decode {i}")
                worst = max(worst, (logits_c.cpu().float()
                                    - logits_h.float()).abs().max())
            for key in ("k", "v"):
                torch.testing.assert_close(cache_c[key].cpu(), cache_h[key],
                                           **ctol, msg=f"[12] {dtype} {key}")
        log(f"[12] reduced smollm-135m, S=1024, {dtype}: card equals CPU "
            f"within rtol/atol {tol['rtol']}/{tol['atol']} (max abs logit "
            f"err {float(worst):.3g}), greedy tokens equal in {same}/8 "
            f"steps, KV cache within atol {ctol['atol']}; {name} launches "
            f"{launched}")


def profile_device(label: str, fn, steps: int = 1, tag: str = "12p", *,
                   kernel: str, inference: bool = True, top_n: int = 5) -> None:
    """Where ``steps`` warm calls of ``fn`` spend their time (torch.profiler):
    wall time per call, device busy share (the part of it in device kernels
    whose name holds ``kernel``), device kernels per call and the top
    device operations; under ``torch.inference_mode`` unless ``inference``
    is False (a train step)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages() if e.device_type == cuda]
    device_us = sum(t for _, t, _ in events)
    kernel_us = sum(t for k, t, _ in events if kernel in k)
    kernels = sum(n for _, _, n in events)
    top = sorted(events, key=lambda e: -e[1])[:top_n]
    log(f"[{tag}] profiled {label}: wall {wall_us / 1e3 / steps:.1f} ms per "
        f"call, device busy {100 * device_us / wall_us:.1f}% ({kernel} "
        f"{100 * kernel_us / wall_us:.1f}%), idle "
        f"{100 * (1 - device_us / wall_us):.1f}%, {kernels / steps:.0f} "
        f"device operations per call; top device ops "
        + ", ".join(f"{k[:40]}={t / 1e3 / steps:.2f} ms" for k, t, _ in top))


def phase_serve(results: dict) -> None:
    """``launch/serve.py``'s main at smollm-135m's full width: one bfloat16
    prefill of 4 x 4096 tokens must launch the tensor-core attention kernel
    once per layer and the float32 one never."""
    from repro_torch.launch import serve
    from repro_torch.models.registry import build
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(SERVE_ARGS)
    counts = check_launches("12", {"flash_attention_wgmma": 30})
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in ("prefill_logits", "logits"):
        if not bool(torch.isfinite(out[name]).all()):
            raise AssertionError(f"[12] serve: {name} not finite")
    if out["tokens"].shape != (4, 33):
        raise AssertionError(f"[12] serve: tokens {out['tokens'].shape}")
    results["flash_attention_wgmma"]["launches"] = (
        counts["flash_attention_wgmma"])
    SERVE_ONE.update({k: out[k].cpu() if torch.is_tensor(out[k]) else out[k]
                      for k in ("tokens", "prefill_logits", "logits",
                                "prefill_ms", "tok_per_s")})
    log(f"[12] serve smollm-135m full width, batch 4, prompt 4096, 32 "
        f"decode steps: prefill {out['prefill_ms']:.1f} ms, decode "
        f"{out['tok_per_s']:.1f} tok/s ({out['decode_s'] * 1e3:.1f} ms), "
        f"peak device memory {peak:.2f} GiB; tensor-core attention kernel "
        f"launches {counts['flash_attention_wgmma']} (one per layer), float32 "
        f"kernel {counts['flash_attention']}; logits finite")
    api = build("smollm-135m", reduced=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = api.init(gen)
    batch = serve.make_batch(api, np.random.default_rng(0), 4, 4096, "cuda")
    max_len = 4096 + 32
    with torch.inference_mode():
        logits, cache, pos = api.prefill(params, batch, max_len=max_len)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
    profile_device("full-width prefill (4 x 4096)",
                   lambda: api.prefill(params, batch, max_len=max_len),
                   kernel="flash_attention_wgmma")
    profile_device("full-width decode step (batch 4, cache 4128)",
                   lambda: api.decode_step(params, cache, tok, pos), steps=4,
                   kernel="flash_attention_wgmma")


def phase_diurnal() -> None:
    """The diurnal multiplier of ``diurnal-drift`` for rounds 1..400 on the
    card against the CPU, bitwise."""
    from repro_torch.sim.engine import scenario_diurnal_mult
    from repro_torch.sim.scenarios import get_scenario
    scen = get_scenario("diurnal-drift")
    rounds = torch.arange(1, 401, dtype=torch.int32)
    card = scenario_diurnal_mult(scen, rounds.cuda()).cpu()
    cpu = scenario_diurnal_mult(scen, rounds)
    if not torch.equal(card.view(torch.int32), cpu.view(torch.int32)):
        n = int((card.view(torch.int32) != cpu.view(torch.int32)).sum())
        raise AssertionError(f"[12] diurnal multiplier: {n} of 400 rounds "
                             f"differ between card and CPU")
    log("[12] diurnal-drift multiplier, rounds 1..400: card equals CPU "
        "bitwise")


def phase_lm(results: dict) -> None:
    t0 = time.perf_counter()
    phase_flash_kernel(results)
    phase_lm_card_vs_cpu(results)
    phase_serve(results)
    phase_diurnal()
    log(f"[12] phase time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: the griffin slice (RG-LRU scan kernel, recurrentgemma-9b serving)
# ---------------------------------------------------------------------------

# (B, T, W, dtype): the full-width prefill's shape (the main path's, first),
# bf16, a long T and a ragged shape
RG_LRU_CASES = [(4, 4096, 4096, "float32"), (2, 2048, 4096, "bfloat16"),
                (1, 16384, 4096, "float32"), (3, 1000, 1000, "float32")]
# kernel against its plain version: float32 bitwise (both round each step
# once, __fmaf_rn in the kernel, addcmul in the plain version); bfloat16
# within one output step (2**-7 of the value at most), though both carry
# the same float32 value and round it to bfloat16 once.  Read on an H100
# (700 W): no entry differs at any case, in either dtype
RG_LRU_BF16_RTOL = 2 ** -7
# card against CPU on the same parameters and prompts (the CPU tests'
# tolerances against the JAX package, tests/test_torch_griffin.py): logits
# and states
GRIFFIN_TOL = {"float32": (dict(rtol=1e-5, atol=1e-5),
                           dict(rtol=1e-5, atol=5e-5)),
               "bfloat16": (dict(rtol=2e-2, atol=5e-2),
                            dict(rtol=2e-2, atol=0.1))}
GRIFFIN_SERVE_ARGS = ["--arch", "recurrentgemma-9b", "--full", "--batch",
                      "4", "--prompt-len", "4096", "--decode-steps", "16"]
GRIFFIN_PARAMS = 9_396_088_832   # the JAX package's count of griffin.init
GRIFFIN_SCANS = 26               # recurrent layers: 12 groups x 2 + 2 tail


def rg_lru_bound(b, t, w, itemsize):
    """Least time (ms) of one scan: a and b read once and y written once
    over the memory rate, against 2 float operations (one FMA) per element
    over the float32 rate."""
    t_bytes = 3 * b * t * w * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * t * w / FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_rg_lru_kernel(results: dict) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru as cuda_rg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    worst = 0.0
    for b, t, w, dtype in RG_LRU_CASES:
        dt = getattr(torch, dtype)
        # a in [0, 1) as the model's exp(-8 softplus(lam) sigmoid(r)); b at
        # the model's scale, sqrt(1 - a^2) times a unit normal
        a = torch.rand((b, t, w), generator=gen, device="cuda")
        x = (torch.randn((b, t, w), generator=gen, device="cuda")
             * torch.sqrt(1.0 - a * a)).to(dt)
        a = a.to(dt)
        got = cuda_rg.rg_lru_scan_cuda(a, x)
        want = ref.rg_lru_ref(a, x)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        n_diff = int((got != want).sum())
        where = f"rg_lru_scan (B, T, W)=({b}, {t}, {w}) {dtype}"
        if dtype == "float32":
            if n_diff:
                raise AssertionError(f"[13] {where}: {n_diff} entries differ "
                                     f"from the plain version (max abs "
                                     f"{err:.3g}); float32 must be bitwise")
        else:
            torch.testing.assert_close(got, want, rtol=RG_LRU_BF16_RTOL,
                                       atol=0, msg=f"[13] {where}: kernel "
                                       f"differs from the plain version")
        worst = max(worst, err)
        def launch():
            return cuda_rg.rg_lru_scan_cuda(a, x)
        ms = time_ms(launch, 10)
        dev_ms = profiled_kernel_ms(launch, 5, "rg_lru_kernel")
        pms = time_ms(lambda: ref.rg_lru_ref(a, x), 1)
        bms, by = rg_lru_bound(b, t, w, a.element_size())
        rule = ("bitwise required" if dtype == "float32"
                else f"rtol {RG_LRU_BF16_RTOL}")
        log(f"[13] {where}: max abs err {err:.3g}, {n_diff} entries differ "
            f"({rule}); kernel {ms:.4f} ms (device time by torch.profiler "
            f"{'none' if dev_ms is None else f'{dev_ms:.4f}'} ms), plain "
            f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{100 * bms / ms:.2f}% of bound; no single PyTorch call")
        if (b, t, w, dtype) == RG_LRU_CASES[0]:
            results["rg_lru_scan"].update(
                ms=ms, device_ms=dev_ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, shape=dict(b=b, t=t, w=w))
    results["rg_lru_scan"]["max_abs_err"] = worst


def _state_items(states: dict):
    """(name, tensor) of every leaf of a griffin decode state."""
    for name, v in states.items():
        if isinstance(v, dict):
            yield from ((f"{name}.{k}", t) for k, t in v.items())
        else:
            yield from zip((f"{name}.h", f"{name}.conv_buf"), v)


def phase_griffin_card_vs_cpu() -> None:
    """Reduced recurrentgemma-9b at S = 1024 (window 32, so the window mask
    and the ring cache both matter) on the card and on the CPU from the
    same parameters and prompts: prefill logits and states, then 4 decode
    steps fed the CPU's greedy tokens."""
    import dataclasses

    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.kernels import rg_lru as cuda_rg
    from repro_torch.models import griffin
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(recurrentgemma_9b.REDUCED,
                                  compute_dtype=getattr(torch, dtype))
        n_rec = 2 * (cfg.n_layers // 3) + cfg.n_layers % 3
        gen = torch.Generator()
        gen.manual_seed(3)
        cpu_params = griffin.init(gen, cfg)
        card_params = _to(cpu_params, "cuda")
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 1024))
        batch = {"tokens": torch.tensor(toks, dtype=torch.int32)}
        tol, stol = GRIFFIN_TOL[dtype]
        cuda_rg.reset_launch_counts()
        with torch.inference_mode():
            logits_c, st_c, pos = griffin.prefill(card_params,
                                                  _to(batch, "cuda"), cfg)
            logits_h, st_h, _ = griffin.prefill(cpu_params, batch, cfg)
            launched = cuda_rg.launch_counts["rg_lru_scan"]
            if launched != n_rec:
                raise AssertionError(f"[13] reduced prefill launched the "
                                     f"scan kernel {launched} times, not "
                                     f"{n_rec}")
            for (name, c), (_, h) in zip(_state_items(st_c),
                                         _state_items(st_h)):
                torch.testing.assert_close(c.cpu(), h, **stol,
                                           msg=f"[13] {dtype} prefill {name}")
            torch.testing.assert_close(logits_c.cpu(), logits_h, **tol,
                                       msg=f"[13] {dtype} prefill logits")
            worst = (logits_c.cpu().float() - logits_h.float()).abs().max()
            same = 0
            for i in range(4):
                tok, agree = greedy_picks(logits_c, logits_h, tol["atol"],
                                          f"[13] {dtype} step {i}")
                same += agree
                logits_c, st_c = griffin.decode_step(card_params, st_c,
                                                     tok.cuda(), pos + i, cfg)
                logits_h, st_h = griffin.decode_step(cpu_params, st_h, tok,
                                                     pos + i, cfg)
                torch.testing.assert_close(logits_c.cpu(), logits_h, **tol,
                                           msg=f"[13] {dtype} decode {i}")
                worst = max(worst, (logits_c.cpu().float()
                                    - logits_h.float()).abs().max())
            for (name, c), (_, h) in zip(_state_items(st_c),
                                         _state_items(st_h)):
                torch.testing.assert_close(c.cpu(), h, **stol,
                                           msg=f"[13] {dtype} {name}")
            if cuda_rg.launch_counts["rg_lru_scan"] != n_rec:
                raise AssertionError("[13] decode launched the scan kernel")
        log(f"[13] reduced recurrentgemma-9b, S=1024, window "
            f"{cfg.sliding_window}, {dtype}: card equals CPU within "
            f"rtol/atol {tol['rtol']}/{tol['atol']} (max abs logit err "
            f"{float(worst):.3g}), greedy tokens equal in {same}/4 steps, "
            f"states within atol {stol['atol']}; scan launches {launched} "
            f"(one per recurrent layer)")


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_griffin_serve(results: dict) -> None:
    """``launch/serve.py``'s main at recurrentgemma-9b's full width: one
    prefill of 4 x 4096 tokens must launch the scan kernel once per
    recurrent layer and the attention kernel never (griffin's local
    attention runs the plain blockwise version, as in the JAX package)."""
    from repro_torch.launch import serve
    from repro_torch.models.registry import build
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(GRIFFIN_SERVE_ARGS)
    counts = check_launches("13", {"rg_lru_scan": GRIFFIN_SCANS})
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in ("prefill_logits", "logits"):
        if not bool(torch.isfinite(out[name]).all()):
            raise AssertionError(f"[13] serve: {name} not finite")
    if out["tokens"].shape != (4, 17):
        raise AssertionError(f"[13] serve: tokens {out['tokens'].shape}")
    results["rg_lru_scan"]["launches"] = counts["rg_lru_scan"]
    log(f"[13] serve recurrentgemma-9b full width, batch 4, prompt 4096, 16 "
        f"decode steps: prefill {out['prefill_ms']:.1f} ms, decode "
        f"{out['tok_per_s']:.1f} tok/s ({out['decode_s'] * 1e3:.1f} ms), "
        f"peak device memory {peak:.2f} GiB; scan kernel launches "
        f"{counts['rg_lru_scan']} (one per recurrent layer), attention "
        f"kernel launches {counts['flash_attention']} (float32) and "
        f"{counts['flash_attention_wgmma']} (bfloat16); logits finite")
    del out
    api = build("recurrentgemma-9b", reduced=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = api.init(gen)
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != GRIFFIN_PARAMS:
        raise AssertionError(f"[13] {n_params} parameters, not "
                             f"{GRIFFIN_PARAMS}")
    batch = serve.make_batch(api, np.random.default_rng(0), 4, 4096, "cuda")
    with torch.inference_mode():
        logits, states, pos = api.prefill(params, batch)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
    profile_device("full-width prefill (4 x 4096)",
                   lambda: api.prefill(params, batch), tag="13p",
                   kernel="rg_lru_kernel")
    profile_device("full-width decode step (batch 4, window 2048)",
                   lambda: api.decode_step(params, states, tok, pos),
                   steps=2, tag="13p", kernel="rg_lru_kernel")
    del params, states, logits
    torch.cuda.empty_cache()
    log(f"[13] {n_params} parameters ({n_params * 4 / 1e9:.1f} GB float32) "
        f"freed")


def phase_griffin(results: dict) -> None:
    t0 = time.perf_counter()
    phase_rg_lru_kernel(results)
    phase_griffin_card_vs_cpu()
    phase_griffin_serve(results)
    log(f"[13] phase time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: async bounded-staleness serving, checkpoints, the FL twin
# ---------------------------------------------------------------------------

ASYNC_TICKS = 200                 # (a): ticks of each card-against-CPU run
ASYNC_RTOL = 1e-5                 # the card-against-CPU limit on times
# (b): 3 segments, stopped after 2 and resumed (the ticks cut, to keep the
# whole script inside its time limit)
SERVE_TICKS, SERVE_SEGMENT, SERVE_CRASH = 1500, 500, 2
PROFILE_TICKS = 20                # (b)'s profile, run warm after (b)
ASYNC_FL_TICKS = 6                                          # (c)


def _async_cases():
    """(a)'s runs: (label, scenario, policy, deadline, expected UCB-score
    launches per tick)."""
    return [("naive_ucb", "paper-baseline", "naive_ucb", None, 1),
            ("elementwise_ucb", "paper-baseline", "elementwise_ucb", None, 0),
            ("flaky", "flaky-clients", "elementwise_ucb", DEADLINE, 0)]


def _snapshots_equal(a, b) -> bool:
    from repro_torch.sim import async_engine as ae
    ta, tb = ae.snapshot_tree(a), ae.snapshot_tree(b)
    return all(torch.equal(ta[k], tb[k]) for k in ta if k != "bandit") and \
        all(torch.equal(ta["bandit"][k], tb["bandit"][k])
            for k in ta["bandit"])


def phase_async_card_vs_cpu(results: dict) -> None:
    """(a) paper-baseline at K = 10^4 (n_req 1000, 32 slots, cohorts of 5,
    FedBuff batches of 5, Poisson arrivals): each run's CPU-made draws
    through the card and through the CPU.  Selections and counters exact,
    times and state within ASYNC_RTOL, kernel #4 once a tick under
    naive_ucb and never otherwise."""
    from repro_torch.sim import async_engine as ae
    from repro_torch.sim import engine as sim
    from repro_torch.sim.scenarios import get_scenario

    k = 10_000
    traces = ("selected", "admitted", "aggregated", "dropped", "failed",
              "corrupt", "buffered", "max_staleness")
    for label, scen_name, policy, deadline, per_tick in _async_cases():
        scen = get_scenario(scen_name)
        cfg = ae.AsyncConfig(n_req=1000, deadline=deadline)
        env_np = scen.build_env(k, np.random.default_rng(0))
        draws = [ae.draw_tick(0, t, k=k, cfg=cfg, scen=scen, policy=policy)
                 for t in range(ASYNC_TICKS)]
        out = {}
        for dev in ("cpu", "cuda"):
            env = sim.EnvArrays.from_scenario(scen, env_np, dev)
            moved = [d.to(dev) for d in draws]
            reset_counts()
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ae.serve(scen, policy, n_ticks=ASYNC_TICKS, cfg=cfg,
                           env=env, eta=1.5, draws=moved, device=dev)
            wall = time.perf_counter() - t0
            out[dev] = (res, launch_counts(), wall)
        (a, ca, wa), (b, _, wb) = out["cuda"], out["cpu"]
        where = f"[14a] {label}"
        expect = {"ucb_score": per_tick * ASYNC_TICKS}
        want = {**{n: 0 for n in ca}, **expect}
        if ca != want:
            raise AssertionError(f"{where}: launches {ca} != {want}")
        for name in traces:
            if not np.array_equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"{where}: {name} differ")
        for name in ("dt", "elapsed"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       rtol=ASYNC_RTOL, atol=0,
                                       err_msg=f"{where} {name}")
        ta, tb = ae.snapshot_tree(a.state), ae.snapshot_tree(b.state)
        flat = [(n, ta[n], tb[n]) for n in ta if n != "bandit"] + [
            (n, ta["bandit"][n], tb["bandit"][n]) for n in ta["bandit"]]
        for name, x, y in flat:
            x = x.cpu()
            if x.dtype.is_floating_point:
                torch.testing.assert_close(x, y, rtol=ASYNC_RTOL, atol=0,
                                           msg=f"{where} state {name}")
            elif not torch.equal(x, y):
                raise AssertionError(f"{where}: state {name} differs")
        if not (a.conserved() and np.isfinite(a.elapsed).all()
                and (np.diff(a.elapsed) > 0).all()):
            raise AssertionError(f"{where}: invariants broken")
        if per_tick:
            results["ucb_score"]["async_launches"] = ca["ucb_score"]
        log(f"{where}: K={k}, {ASYNC_TICKS} ticks, card equals CPU "
            f"(selections and counters exact, times within {ASYNC_RTOL:g}; "
            f"max |dt| rel diff "
            f"{float(np.max(np.abs(a.dt - b.dt) / b.dt)):.3g}); aggregated "
            f"{int(a.aggregated.sum())}, dropped {int(a.dropped.sum())}, "
            f"failed {int(a.failed.sum())}; card {wall_s(wa, ASYNC_TICKS)}, "
            f"cpu {wall_s(wb, ASYNC_TICKS)} (given draws); launches {ca}")


def wall_s(wall: float, ticks: int) -> str:
    return (f"{ticks / wall:.1f} ticks/s ({1e3 * wall / ticks:.3f} ms a "
            f"tick)")


def phase_async_serving(results: dict) -> None:
    """(b) ``launch/serve_fl.run_serving`` on the card, K = 10^4,
    elementwise_ucb, serve_fl's defaults otherwise: SERVE_TICKS ticks in
    segments of SERVE_SEGMENT through the checkpoint manager in a temporary
    directory, stopped after SERVE_CRASH segments and re-invoked, against
    an uninterrupted run without checkpoints, bitwise; a torch.profiler
    trace of one segment."""
    import tempfile

    from repro_torch.launch import serve_fl

    kw = dict(ticks=SERVE_TICKS, segment=SERVE_SEGMENT, n_clients=10_000,
              seed=0, log=lambda *_: None)
    straight = serve_fl.run_serving("paper-baseline", "elementwise_ucb",
                                    **kw)
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        crashed = serve_fl.run_serving("paper-baseline", "elementwise_ucb",
                                       ckpt_dir=d, max_segments=SERVE_CRASH,
                                       **kw)
        lines = []
        resumed = serve_fl.run_serving("paper-baseline", "elementwise_ucb",
                                       ckpt_dir=d,
                                       **{**kw, "log": lines.append})
        check_launches("14b", {})
    if crashed["ticks"] != SERVE_CRASH * SERVE_SEGMENT or \
            resumed["ticks"] != SERVE_TICKS or "resumed" not in lines[0]:
        raise AssertionError(f"[14b] crash/resume: {crashed['ticks']}, "
                             f"{resumed['ticks']}, {lines[:1]}")
    keys = ("sim_time", "admitted", "aggregated", "dropped", "failed",
            "buffered")
    if any(resumed[k] != straight[k] for k in keys) or not \
            _snapshots_equal(resumed["state"], straight["state"]):
        raise AssertionError("[14b] the resumed run differs from the "
                             "uninterrupted one")
    if not (np.isfinite(straight["sim_time"])
            and straight["admitted"] == straight["aggregated"]
            + straight["dropped"] + straight["failed"]
            + straight["buffered"]):
        raise AssertionError("[14b] counters do not add up")
    log(f"[14b] run_serving paper-baseline elementwise_ucb K=10000, "
        f"{SERVE_TICKS} ticks in segments of {SERVE_SEGMENT}: stopped after "
        f"{SERVE_CRASH} segments and resumed ({lines[0].strip()}); final "
        f"state bitwise the uninterrupted run's; sim_time "
        f"{straight['sim_time']:.1f} s, aggregated {straight['aggregated']}, "
        f"dropped {straight['dropped']}")
    log(f"[14b] ticks/s: uninterrupted (no checkpoints) "
        f"{straight['ticks_per_s']:.1f} ({1e3 / straight['ticks_per_s']:.3f} "
        f"ms wall a tick); checkpointed segments "
        f"{crashed['ticks_per_s']:.1f} before the crash, "
        f"{resumed['ticks_per_s']:.1f} after the resume; "
        f"{card_name_and_power()}")
    profile_async_segment()


def profile_async_segment() -> None:
    """Where a tick's time goes: torch.profiler over PROFILE_TICKS ticks of
    (b)'s configuration (draws included), the device's busy time per tick
    against the profiled wall time (which the profiler's host overhead
    lengthens: compare the busy time with (b)'s unprofiled ms a tick),
    device operations and kernel launches per tick and the top device
    operations."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import async_engine as ae
    n = PROFILE_TICKS       # short: the profiler's post-processing time
    kw = dict(n_ticks=n, n_clients=10_000, seed=0, eta=1.5)   # grows with
    torch.cuda.synchronize()                                  # its events
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ae.serve("paper-baseline", "elementwise_ucb", **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    events = [(e.key, e.self_device_time_total, e.count) for e in averages
              if e.device_type == cuda]
    device_us = sum(t for _, t, _ in events)
    ops = sum(c for _, _, c in events)
    top = sorted(events, key=lambda e: -e[1])[:6]
    launches = sum(e.count for e in averages if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    log(f"[14p] profiled segment of {n} ticks (K=10000, elementwise_ucb, "
        f"draws included): wall {wall_us / 1e3:.1f} ms, "
        f"{wall_us / 1e3 / n:.3f} ms a tick under the profiler; device busy "
        f"{device_us / 1e3 / n:.4f} ms a tick, "
        f"{100 * device_us / wall_us:.1f}% of the profiled wall time (idle "
        f"{100 * (1 - device_us / wall_us):.1f}%, the profiler's host "
        f"overhead included); {ops / n:.0f} device "
        f"operations and {launches / n:.0f} kernel launches a tick; top "
        "device ops " + ", ".join(f"{k[:40]}={t / 1e3 / n:.4f} ms/tick"
                                  for k, t, _ in top))


def phase_async_fl(results: dict) -> None:
    """(c) ``fl.engine.async_accuracy_run`` at full width: the paper CNN,
    K = 100, E = 5, B = 50, 50k/10k images, eta 1.5, the default
    AsyncConfig (32 slots: a 587 MB delta buffer), elementwise_ucb,
    ASYNC_FL_TICKS ticks, TF32 off as in phase 8.  Kernel #5 must launch
    once per tick that aggregates, and no other kernel."""
    from repro_torch.fl import engine as fl
    from repro_torch.models import cnn

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = cnn.CnnConfig()
        task = fl.make_cnn_task("paper-baseline", 100, cfg=cfg,
                                n_train=50_000, n_test=10_000,
                                batch_size=50, device="cuda")
        if cnn.param_count(task.params0) != N_CNN:
            raise AssertionError("[14c] the CNN's size")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = fl.async_accuracy_run(
            "paper-baseline", "elementwise_ucb", n_ticks=ASYNC_FL_TICKS,
            task=task, cfg=cfg, epochs=5, batch_size=50, eta=1.5,
            device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        aggregating = int((out["aggregated"] > 0).sum())
        counts = check_launches("14c", {"fedavg_combine": aggregating})
        peak = torch.cuda.max_memory_allocated() / 2**30
        combine_check()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    acc = out["accuracy"]
    if not (np.isfinite(acc).all() and ((acc >= 0) & (acc <= 1)).all()
            and aggregating > 0 and (np.diff(out["elapsed"]) > 0).all()):
        raise AssertionError(f"[14c] traces: accuracy {acc}, aggregated "
                             f"{out['aggregated']}")
    results["fedavg_combine"]["async_launches"] = counts["fedavg_combine"]
    log(f"[14c] async_accuracy_run paper CNN ({N_CNN} parameters), K=100, "
        f"E=5, B=50, default AsyncConfig, {ASYNC_FL_TICKS} ticks in "
        f"{wall:.2f} s: {wall / ASYNC_FL_TICKS:.3f} s a tick; peak device "
        f"memory {peak:.2f} GiB; aggregated per tick "
        f"{out['aggregated'].tolist()}, fedavg_combine launches "
        f"{counts['fedavg_combine']} (one per aggregating tick); accuracy "
        f"{np.round(acc, 4).tolist()}; {card_name_and_power()}")


def combine_check() -> None:
    """Kernel #5 at the FL twin's call, a [buffer_size, N] gather of the
    delta buffer (fill slots: slot 0 at weight 0) with [buffer_size]
    staleness weights and no grid axis, against its plain version on the
    same card tensors: max abs error 0, as phase 6's."""
    from repro_torch.kernels import fedavg as cuda_fedavg
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    buf = 1e-3 * torch.randn((18, N_CNN), generator=gen, device="cuda")
    rows = buf[torch.tensor([4, 17, 0, 0, 0], device="cuda")]
    sw = torch.tensor([431.0, 287.5, 0.0, 0.0, 0.0], device="cuda")
    got = cuda_fedavg.fedavg_combine_cuda(rows, sw)
    want = ref.fedavg_combine_ref(rows, sw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("[14c] fedavg_combine at the FL twin's [C, N] "
                             "call differs from its plain version")
    log(f"[14c] fedavg_combine at the twin's call ({list(rows.shape)} rows, "
        f"[5] weights, two fill slots): equal to the plain version (max abs "
        f"err 0)")


def phase_async(results: dict) -> None:
    t0 = time.perf_counter()
    for part in (phase_async_card_vs_cpu, phase_async_serving,
                 phase_async_fl):
        t1 = time.perf_counter()
        part(results)
        log(f"[14] {part.__name__} {time.perf_counter() - t1:.1f} s")
    log(f"[14] phase time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: training — gradients through kernels #6 and #7, the full-width
# smollm-135m train step, launch/train.py's FL loop
# ---------------------------------------------------------------------------

GRAD_SEQ = 1100                   # (a): S >= 1024 and no multiple of 64
GRAD_LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}   # (a): relative L2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 3   # (b): train_4k's S
CNN_ROUNDS, CNN_RESUME_AT = 3, 2                   # (c)
LM_LOSS_RTOL = 5e-3               # (d): card against CPU, bf16 compute


def _plain_route():
    """A context in which kernels/ops.py sends CUDA tensors to the plain
    versions (the autograd Functions stay: their backward is already
    plain for attention, and the reversed scan then runs the plain loop)."""
    import contextlib

    from repro_torch.kernels import ops, ref

    @contextlib.contextmanager
    def ctx():
        saved = ops._flash_forward, ops._rg_forward
        ops._flash_forward = (
            lambda q, k, v, causal, q_offset=0: ref.flash_attention_ref(
                q, k, v, causal, q_offset=q_offset))
        ops._rg_forward = ref.rg_lru_ref
        try:
            yield
        finally:
            ops._flash_forward, ops._rg_forward = saved
    return ctx()


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def phase_train_grads(results: dict) -> None:
    """(a) One loss and gradient of reduced smollm-135m (f32 and bf16
    compute) and reduced recurrentgemma-9b (f32) at S = GRAD_SEQ on the
    card through the kernels, against the plain route on the same card
    tensors: every parameter's gradient finite, non-zero where the plain
    one is, within GRAD_LIMIT (relative L2); the attention kernel launched
    once per layer, the scan twice per recurrent layer (forward, and the
    backward on reversed inputs)."""
    import dataclasses
    import functools

    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.registry import build
    from repro_torch.utils.trees import tree_leaves

    cases = [("smollm-135m", "float32"), ("smollm-135m", "bfloat16"),
             ("recurrentgemma-9b", "float32")]
    for arch, dtype in cases:
        api = build(arch, reduced=True)
        cfg = dataclasses.replace(api.cfg, compute_dtype=getattr(torch,
                                                                  dtype))
        if cfg.remat:
            raise AssertionError(f"[15a] {arch} reduced sets remat")
        loss_fn = functools.partial(api.loss_fn.func, cfg=cfg)
        params = _to(api.init(torch.Generator().manual_seed(15)), "cuda")
        toks = np.random.default_rng(15).integers(0, cfg.vocab,
                                                  (2, GRAD_SEQ))
        batch = {"tokens": torch.tensor(toks, dtype=torch.int32,
                                         device="cuda")}
        reset_counts()
        loss_k, grads_k = value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        if arch == "smollm-135m":
            name = FLASH_VARIANT[dtype][0]
            expect = {name: cfg.n_layers}
        else:
            n_rec = 2 * (cfg.n_layers // 3) + cfg.n_layers % 3
            expect = {"rg_lru_scan": 2 * n_rec}
        counts = check_launches("15a", expect)
        with _plain_route():
            loss_p, grads_p = value_and_grad(loss_fn, params, batch)
        check_launches("15a", expect)          # the plain route: none more
        worst, zero = 0.0, 0
        for i, (gk, gp) in enumerate(zip(tree_leaves(grads_k),
                                         tree_leaves(grads_p))):
            if not bool(torch.isfinite(gk).all()):
                raise AssertionError(f"[15a] {arch} {dtype}: leaf {i} "
                                     f"gradient not finite")
            if float(gp.float().norm()) == 0.0:
                zero += 1
                continue
            if float(gk.float().norm()) == 0.0:
                raise AssertionError(f"[15a] {arch} {dtype}: leaf {i} has "
                                     f"no gradient through the kernel")
            worst = max(worst, _rel_l2(gk.float(), gp.float()))
        if worst > GRAD_LIMIT[dtype]:
            raise AssertionError(f"[15a] {arch} {dtype}: gradient relative "
                                 f"L2 {worst:.3g} > {GRAD_LIMIT[dtype]}")
        if arch != "smollm-135m":
            results["rg_lru_scan"]["train_launches"] = counts["rg_lru_scan"]
        log(f"[15a] reduced {arch}, {dtype}, S={GRAD_SEQ}, batch 2: loss "
            f"kernel route {float(loss_k):.6f}, plain route "
            f"{float(loss_p):.6f}; {len(tree_leaves(grads_k))} gradient "
            f"leaves finite, worst relative L2 against the plain route "
            f"{worst:.3g} (limit {GRAD_LIMIT[dtype]:g}; {zero} leaves zero "
            f"on both routes); launches {expect}")


def phase_train_step(results: dict) -> None:
    """(b) ``launch.steps.make_train_step`` at smollm-135m's full width
    (30 layers, remat on, bf16 compute, f32 parameters), AdamW lr 3e-4,
    weight decay 0.1, at train_4k's S = 4096 with batch 4 (its global
    batch of 256 cut to one card's 4): one warm-up step, then TRAIN_STEPS
    timed steps; each step must launch the bf16 attention kernel twice per
    layer (the forward, and remat's recompute) and no other kernel."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build
    from repro_torch.optim.sgd import OptimizerConfig

    cell = SHAPES["train_4k"]
    if cell.seq_len != TRAIN_SEQ:
        raise AssertionError("[15b] train_4k's sequence length")
    api = build("smollm-135m", reduced=False)
    cfg = api.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = api.init(gen)
    step, opt = make_train_step(api, OptimizerConfig(
        name="adamw", lr=3e-4, weight_decay=0.1))
    state = opt.init(params)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.tensor(
        rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)),
        dtype=torch.int32, device="cuda")} for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batches[0])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    losses = [float(loss)]
    reset_counts()
    t0 = time.perf_counter()
    for b in batches[1:]:
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    per_step = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    counts = check_launches("15b", {"flash_attention_wgmma":
                                    per_step * TRAIN_STEPS})
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (all(math.isfinite(x) for x in losses)
            and int(state["step"]) == TRAIN_STEPS + 1):
        raise AssertionError(f"[15b] losses {losses}, step "
                             f"{int(state['step'])}")
    results["flash_attention_wgmma"]["train_launches"] = \
        counts["flash_attention_wgmma"] // TRAIN_STEPS
    TRAIN_ONE["s"] = dt
    holder = {"p": params, "s": state}

    def one_step():
        holder["p"], holder["s"], _ = step(holder["p"], holder["s"],
                                           batches[0])
    profile_device("full-width AdamW train step (4 x 4096)", one_step,
                   tag="15p", kernel="flash_attention_wgmma_kernel",
                   inference=False, top_n=8)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[15b] smollm-135m full width ({n_params} parameters, remat "
        f"{cfg.remat}), AdamW train step at batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} (train_4k's global batch {cell.global_batch} cut to "
        f"{TRAIN_BATCH} for one card): {dt:.4f} s a step, "
        f"{TRAIN_BATCH * TRAIN_SEQ / dt:.0f} tokens/s (warm-up step "
        f"{warm:.2f} s); peak device memory {peak:.2f} GiB; bf16 attention "
        f"kernel launches {counts['flash_attention_wgmma'] // TRAIN_STEPS} a "
        f"step; losses {[round(x, 5) for x in losses]}; "
        f"{card_name_and_power()}")
    del params, state, batches, holder
    torch.cuda.empty_cache()


def _train_main(argv: list[str]):
    """``launch.train.main`` with its printed lines captured."""
    import contextlib
    import io

    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train.main(argv)
    return out, buf.getvalue().splitlines()


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two float32 tensors, NaN payloads included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cnn_resume(argv: list[str], rounds: int, label: str):
    """``launch.train`` for ``rounds`` rounds checkpointed every round,
    then the checkpoints after CNN_RESUME_AT deleted and ``--resume`` run:
    its selections, elapsed time and parameters (bitwise) must equal the
    straight run's; one FedAvg-combine launch a round, no other kernel.
    Returns (straight run, its lines, the resumed run's lines, wall s,
    peak GiB)."""
    import shutil
    import tempfile

    from repro_torch.utils.trees import tree_leaves
    with tempfile.TemporaryDirectory() as d:
        argv = argv + ["--rounds", str(rounds), "--ckpt-dir", d,
                       "--ckpt-every", "1"]
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        straight, lines = _train_main(argv)
        wall = time.perf_counter() - t0
        check_launches(label, {"fedavg_combine": rounds})
        peak = torch.cuda.max_memory_allocated() / 2**30
        for step in range(CNN_RESUME_AT + 1, rounds + 1):
            shutil.rmtree(Path(d) / f"ckpt_{step:08d}")
        reset_counts()
        resumed, rlines = _train_main(argv + ["--resume"])
        check_launches(label, {"fedavg_combine": rounds - CNN_RESUME_AT})
    sa, sb = straight["server"], resumed["server"]
    pa = tree_leaves(straight["trainer"].params)
    pb = tree_leaves(resumed["trainer"].params)
    checks = {
        "start": resumed["start"] == CNN_RESUME_AT,
        "selections": [r.selected for r in sa.history[CNN_RESUME_AT:]]
        == [r.selected for r in sb.history],
        "elapsed": sa.elapsed == sb.elapsed,
        "parameters": all(_same_bits(a, b) for a, b in zip(pa, pb))}
    if not all(checks.values()):
        raise AssertionError(f"[{label}] the resumed run differs from the "
                             f"straight one: {checks}")
    return straight, lines, rlines, wall, peak


def phase_train_cnn(results: dict) -> None:
    """(c) ``launch.train --arch cifar-cnn`` at full width on the card (the
    paper CNN, K = 100, 50k/10k images, E = 5, B = 50) for CNN_ROUNDS
    rounds, stopped and resumed (:func:`_cnn_resume`).  The paper's recipe
    sends this model to non-finite weights within a client's first epoch
    (ROADMAP, the reference's hazards), so the same check runs again with
    ``--fast`` (5000 images, one epoch), whose weights stay finite.  cuDNN
    runs deterministic here, so that two runs of a round agree bit for
    bit."""
    from repro_torch.utils.trees import tree_leaves
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        full, lines, rlines, wall, peak = _cnn_resume(
            ["--arch", "cifar-cnn", "--clients", "100"], CNN_ROUNDS, "15c")
        fast, _, _, fast_wall, _ = _cnn_resume(
            ["--arch", "cifar-cnn", "--clients", "100", "--fast"],
            CNN_ROUNDS, "15c fast")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    if not all(bool(torch.isfinite(x).all())
               for x in tree_leaves(fast["trainer"].params)):
        raise AssertionError("[15c] --fast: non-finite parameters")
    acc = full["trainer"].accuracy()
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"[15c] accuracy {acc}")
    leaves = tree_leaves(full["trainer"].params)
    bad = sum(int((~torch.isfinite(x)).sum()) for x in leaves)
    n = sum(x.numel() for x in leaves)
    results["fedavg_combine"]["train_launches"] = CNN_ROUNDS
    rs = full["round_s"]
    log(f"[15c] launch.train --arch cifar-cnn, K=100, {CNN_ROUNDS} rounds "
        f"(E=5, B=50, 50k/10k images) in {wall:.2f} s with set-up: "
        f"{statistics.mean(rs):.3f} s a round (rounds "
        f"{[round(x, 3) for x in rs]}, the test accuracy of each round "
        f"included); peak device memory {peak:.2f} GiB; fedavg_combine "
        f"launches {CNN_ROUNDS} (one a round); test accuracy {acc:.4f}, "
        f"{bad} of {n} parameters non-finite"
        f"{' (the recipe collapses the model)' if bad else ''}; "
        f"{rlines[0].strip()}: selections, elapsed time and parameters "
        f"(bitwise) equal to the straight run's; {card_name_and_power()}")
    log(f"[15c] --fast (5000 images, one epoch), {CNN_ROUNDS} rounds in "
        f"{fast_wall:.2f} s: parameters finite, test accuracy "
        f"{fast['trainer'].accuracy():.4f}, the resumed run bitwise the "
        f"straight one")
    for line in lines:
        log(f"[15c]   {line}")


def phase_train_lm(results: dict) -> None:
    """(d) ``launch.train`` with the reduced LMs (bf16 compute, seq 64, 4
    SGD steps of lr 0.5 a client): smollm-135m for 2 rounds and
    recurrentgemma-9b for 1, on the card and on the CPU: the same batches,
    every step's loss within LM_LOSS_RTOL, the same selections.  FedAvg
    once a round; no attention launch (S < 1024); the scan twice per
    recurrent layer a step and once per layer in each no-grad pass."""
    for arch, rounds in (("smollm-135m", 2), ("recurrentgemma-9b", 1)):
        argv = ["--arch", arch, "--rounds", str(rounds)]
        reset_counts()
        t0 = time.perf_counter()
        card, _ = _train_main(argv)
        wall = time.perf_counter() - t0
        tr = card["trainer"]
        cfg = tr.api.cfg
        n_rec = (2 * (cfg.n_layers // 3) + cfg.n_layers % 3
                 if cfg.family == "griffin" else 0)
        steps = len(tr.loss_log)
        evals = rounds // max(rounds // 10, 1)       # accuracy() calls
        expect = {"fedavg_combine": rounds}
        if n_rec:
            expect["rg_lru_scan"] = n_rec * (2 * steps + evals)
        counts = check_launches("15d", expect)
        host, _ = _train_main(argv + ["--device", "cpu"])
        got, want = np.array(tr.loss_log), np.array(host["trainer"].loss_log)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"[15d] {arch}: losses {got} / {want}")
        gap = float(np.max(np.abs(got - want) / np.abs(want)))
        sel_c = [r.selected for r in card["server"].history]
        if gap > LM_LOSS_RTOL or sel_c != [r.selected for r in
                                           host["server"].history]:
            raise AssertionError(f"[15d] {arch}: card losses {got} against "
                                 f"CPU {want} (gap {gap:.3g})")
        if n_rec:
            results["rg_lru_scan"]["fl_train_launches"] = \
                counts["rg_lru_scan"]
        log(f"[15d] launch.train --arch {arch} (reduced), {rounds} "
            f"round(s), {steps} SGD steps: card {wall:.2f} s; losses "
            f"{np.round(got, 3).tolist()}; card against CPU on the same "
            f"batches: largest relative gap {gap:.3g} (limit "
            f"{LM_LOSS_RTOL:g}); launches {counts}")


def phase_train_time_only() -> None:
    """(e) ``launch.train --arch none`` on the card and on the CPU: the
    same lines (all numpy), the wall-clock seconds aside."""
    import re
    argv = ["--arch", "none", "--rounds", "50", "--policy",
            "elementwise_ucb", "--failure-prob", "0.1", "--swap-clients",
            "7"]
    reset_counts()
    _, card = _train_main(argv)
    check_launches("15e", {})
    _, host = _train_main(argv + ["--device", "cpu"])
    wall = re.compile(r"in \d+s wall")
    if [wall.sub("", x) for x in card] != [wall.sub("", x) for x in host]:
        raise AssertionError("[15e] time-only lines differ card/CPU")
    log(f"[15e] launch.train --arch none, 50 rounds (failure prob 0.1, "
        f"elastic swap every 7): card and CPU print the same {len(card)} "
        f"lines; last: {card[-2].strip()}")


def phase_train(results: dict) -> None:
    t0 = time.perf_counter()
    phase_train_grads(results)
    phase_train_step(results)
    phase_train_cnn(results)
    phase_train_lm(results)
    phase_train_time_only()
    log(f"[15] phase time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: the moe, vlm, xlstm and encdec families
# ---------------------------------------------------------------------------

# (a): (B, Sq, Skv, KV, G, dh, causal, dtype) of the new families' full-
# width prefills at 4 x 4096: phi3.5-moe (G = 4, dh 128), llava-next-34b
# (G = 7), seamless-m4t-medium's encoder (G = 1, dh 64, full; also its
# cross-attention's shape at 4096 frames) and decoder (causal), its
# cross-attention at 1100 queries; then the float32 kernel at G = 7 and at
# the ragged G = 1 cross shape
FAMILY_FLASH_CASES = [(4, 4096, 4096, 8, 4, 128, True, "bfloat16"),
                      (4, 4096, 4096, 8, 7, 128, True, "bfloat16"),
                      (4, 4096, 4096, 16, 1, 64, False, "bfloat16"),
                      (4, 4096, 4096, 16, 1, 64, True, "bfloat16"),
                      (4, 1100, 4096, 16, 1, 64, False, "bfloat16"),
                      (4, 4096, 4096, 8, 7, 128, True, "float32"),
                      (4, 1100, 4096, 16, 1, 64, False, "float32")]
FAMILY_ARCHS = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "llava-next-34b",
                "xlstm-1.3b", "seamless-m4t-medium")
FAMILY_SEQ = 1024                  # (b): S, a vlm's 8 patches included
FAMILY_STEPS = 4                   # (b): decode steps after the prefill
# (b) card against CPU, logits, by family and dtype: an elementwise
# (rtol, atol), or "budget": the card's relative L2 distance from the CPU's
# float32 logits at most 2 x the CPU's own bfloat16 distance + 0.01.
# float32: rtol 1e-5 / atol 1e-4 (read on an H100, 700 W: up to 2.5e-5 for
# moe and vlm, 4.3e-5 for enc-dec; the float32 attention kernel's 3xTF32
# products sit within 2e-5 of the plain version and cuBLAS sums in other
# orders, through layers of width 128 whose logits reach ~4; the smaller
# smollm of phase 12 holds 1e-5); xlstm 1e-4 / 1e-3, the CPU tests' limit
# against the JAX package (the chunkwise mLSTM divides by max(|n . q|,
# exp(-m)), amplifying float32 rounding where n . q nearly cancels; read up
# to 3.4e-4).  bfloat16: 2e-2 / 6e-2 for moe and vlm, 2e-2 / 8e-2 for
# enc-dec, as their CPU tests (read up to 0.024, 0.017 and 0.042 beyond the
# rtol part); xlstm by the budget, since its exponential gates amplify one
# bfloat16 step to ~0.1 (the card's distance read 0.20, the CPU's 0.20).
# moe routes on rounded activations, so the card's run takes the CPU's
# expert choices (``check_routes`` holds its own to them)
FAMILY_TOL = {
    ("moe", "float32"): (1e-5, 1e-4), ("moe", "bfloat16"): (2e-2, 6e-2),
    ("vlm", "float32"): (1e-5, 1e-4), ("vlm", "bfloat16"): (2e-2, 6e-2),
    ("xlstm", "float32"): (1e-4, 1e-3), ("xlstm", "bfloat16"): "budget",
    ("encdec", "float32"): (1e-5, 1e-4), ("encdec", "bfloat16"): (2e-2, 8e-2)}
# (b), moe: the router's log-probabilities on the card against the CPU's,
# both on the CPU's expert choices, by dtype.  Read on an H100 (700 W):
# float32 up to 2.2e-5, bfloat16 up to 0.026 (the CPU's own bfloat16 run
# sits up to 0.06 from its float32 one)
ROUTER_TOL = {"float32": 1e-4, "bfloat16": 0.1}
# (c): (arch, layers kept or None, attention launches a prefill).  The
# depth is cut only where one card cannot hold the float32 parameters:
# phi3.5-moe's 32 layers are 41,872,527,360 parameters (~168 GB) and
# llava's 60 are 34,396,257,280 (~138 GB); 8 of each keep every width
FAMILY_SERVE = [("phi3.5-moe-42b-a6.6b", 8, 8), ("llava-next-34b", 8, 8),
                ("seamless-m4t-medium", None, 36), ("xlstm-1.3b", None, 0)]
# the JAX package's counts of the full configs (registry.param_counts)
FAMILY_PARAMS = {"phi3.5-moe-42b-a6.6b": 41_872_527_360,
                 "llava-next-34b": 34_396_257_280,
                 "seamless-m4t-medium": 977_758_208,
                 "xlstm-1.3b": 3_604_207_616}
FAMILY_SERVE_STEPS = 16


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def family_attention_launches(cfg) -> int:
    """The attention kernel's launches in one prefill of ``cfg`` at S >=
    1024: one a layer; enc-dec one an encoder layer and two a decoder
    layer (self, cross); xlstm none."""
    return {"moe": cfg.n_layers, "vlm": cfg.n_layers, "xlstm": 0,
            "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}[cfg.family]


class _Routes:
    """Records each ``layers.moe_route`` call's (probs, expert indices) on
    the CPU while active; given ``forced``, another run's record, each call
    returns that run's indices in its place (its own are still recorded)."""

    def __init__(self, forced=None):
        self.calls, self.forced = [], forced

    def __enter__(self):
        from repro_torch.models import layers
        self.route = layers.moe_route

        def route(xt, router, mc):
            probs, idx = self.route(xt, router, mc)
            self.calls.append((probs.float().cpu(), idx.cpu()))
            if self.forced is not None:
                idx = self.forced[len(self.calls) - 1][1].to(idx.device)
            return probs, idx
        layers.moe_route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.moe_route = self.route


def check_routes(card: list, cpu: list, limit: float,
                 where: str) -> tuple[int, float]:
    """The card's router against the CPU's over the same calls, both run
    on the CPU's expert choices: log-probabilities within ``limit``, and
    every token whose own top-k on the card differs from the CPU's (in set
    or in order) a near tie — two neighbours among its k + 1 largest
    log-probabilities on the CPU closer than twice that call's largest
    log-probability gap, so the gap explains the other pick (a top-k that
    ranks wrongly fails here).  Returns (tokens
    whose pick differs, the largest gap)."""
    if len(card) != len(cpu):
        raise AssertionError(f"{where}: {len(card)} routings on the card, "
                             f"{len(cpu)} on the CPU")
    n, worst = 0, 0.0
    for (pc, ic), (ph, ih) in zip(card, cpu):
        lc, lh = (x.clamp_min(1e-38).log() for x in (pc, ph))
        gap = float((lc - lh).abs().max())
        worst = max(worst, gap)
        # a pick differs where two of the CPU's k + 1 largest swap places
        top = lh.sort(-1, descending=True).values[:, :ih.shape[1] + 1]
        margin = (top[:, :-1] - top[:, 1:]).amin(-1)[(ic != ih).any(-1)]
        if bool((margin > 2 * gap).any()):
            raise AssertionError(f"{where}: the card picks other experts at "
                                 f"a margin of {float(margin.max()):.3g}, "
                                 f"its router {gap:.3g} from the CPU's")
        n += margin.numel()
    if worst > limit:
        raise AssertionError(f"{where}: router log-probabilities {worst:.3g} "
                             f"from the CPU's, above {limit}")
    return n, worst


def _family_run(api, cfg, params, batch, toks):
    """Prefill logits and FAMILY_STEPS decode logits fed ``toks``, with
    ``cfg`` in place of the registry's config."""
    logits, cache, pos = api.prefill(params, batch, cfg=cfg,
                                     max_len=FAMILY_SEQ + FAMILY_STEPS)
    out = [logits.float().cpu()]
    for i, tok in enumerate(toks):
        logits, cache = api.decode_step(params, cache,
                                        tok.to(logits.device), pos + i,
                                        cfg=cfg)
        out.append(logits.float().cpu())
    return out


def phase_family_card_vs_cpu() -> None:
    """(b): the reduced configs of the five archs at S = 1024 on the card
    and on the CPU from the same parameters and inputs, float32 and
    bfloat16 compute: prefill logits and FAMILY_STEPS decode steps fed the
    same tokens, within FAMILY_TOL; each card prefill launches its dtype's
    attention variant ``family_attention_launches`` times and nothing
    else.  A moe run on the card takes the CPU's expert choices, and its
    router is held to the CPU's (``check_routes``)."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models.registry import build
    log(f"[16] float32 matmul flags: {tf32_flags()}")
    for arch in FAMILY_ARCHS:
        api = build(arch, reduced=True)
        gen = torch.Generator()
        gen.manual_seed(16)
        cpu_params = api.init(gen)
        card_params = _to(cpu_params, "cuda")
        rng = np.random.default_rng(16)
        batch = serve.make_batch(api, rng, 2, FAMILY_SEQ)
        toks = [torch.tensor(rng.integers(0, api.cfg.vocab, 2),
                             dtype=torch.int32) for _ in range(FAMILY_STEPS)]
        runs = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(api.cfg,
                                      compute_dtype=getattr(torch, dtype))
            n = family_attention_launches(cfg)
            name = FLASH_VARIANT[dtype][0]
            with torch.inference_mode():
                with _Routes() as cpu_routes:
                    cpu = _family_run(api, cfg, cpu_params, batch, toks)
                reset_counts()
                with _Routes(forced=cpu_routes.calls) as card_routes:
                    card = _family_run(api, cfg, card_params,
                                       _to(batch, "cuda"), toks)
                counts = check_launches("16", {name: n})
            runs[dtype] = card, cpu
            routing = ""
            if cfg.moe is not None:
                flips, noise = check_routes(
                    card_routes.calls, cpu_routes.calls, ROUTER_TOL[dtype],
                    f"[16] reduced {arch} {dtype}")
                routing = (f"; router log-probabilities within {noise:.3g} "
                           f"of the CPU's (limit {ROUTER_TOL[dtype]}), the "
                           f"card's own pick differing in {flips} "
                           f"token-layer routings, each a near tie")
            tol = FAMILY_TOL[(cfg.family, dtype)]
            worst = max(float((c - h).abs().max()) for c, h in zip(card, cpu))
            if tol == "budget":
                ref = runs["float32"][1]
                got = max(_rel_l2(c, r) for c, r in zip(card, ref))
                own = max(_rel_l2(h, r) for h, r in zip(cpu, ref))
                if got > 2 * own + 0.01:
                    raise AssertionError(
                        f"[16] reduced {arch} {dtype}: the card's logits "
                        f"are {got:.4g} from the float32 reference, the "
                        f"CPU's {own:.4g}")
                verdict = (f"relative L2 from the float32 reference {got:.4g}"
                           f" (CPU {own:.4g}, budget {2 * own + 0.01:.4g})")
            else:
                for i, (c, h) in enumerate(zip(card, cpu)):
                    torch.testing.assert_close(
                        c, h, rtol=tol[0], atol=tol[1],
                        msg=lambda m, i=i: f"[16] reduced {arch} {dtype} "
                                           f"logits {i}: {m}")
                verdict = f"within rtol/atol {tol[0]}/{tol[1]}"
            log(f"[16] reduced {arch} ({cfg.family}), S={FAMILY_SEQ}, "
                f"{dtype}: card against CPU, prefill + {FAMILY_STEPS} decode "
                f"logits {verdict}, max abs gap {worst:.3g}{routing}; {name} "
                f"launches {counts[name]} a prefill (expected {n})")
        del card_params


def _profile_family(arch: str, layers) -> None:
    """torch.profiler breakdowns of one warm full-width prefill and of two
    decode steps after it, on fresh parameters from the same seed."""
    from repro_torch.launch import serve
    from repro_torch.models.registry import build
    torch.cuda.empty_cache()
    api = build(arch, reduced=False, n_layers=layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = api.init(gen)
    batch = serve.make_batch(api, np.random.default_rng(0), 4, 4096, "cuda")
    with torch.inference_mode():
        logits, cache, pos = api.prefill(params, batch,
                                         max_len=4096 + FAMILY_SERVE_STEPS)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
    profile_device(f"{arch} full-width prefill (4 x 4096)",
                   lambda: api.prefill(params, batch), tag="16p",
                   kernel="flash_attention_wgmma")
    profile_device(f"{arch} full-width decode step (batch 4)",
                   lambda: api.decode_step(params, cache, tok, pos), steps=2,
                   tag="16p", kernel="flash_attention_wgmma")
    del params, batch, cache
    torch.cuda.empty_cache()


def _time_xlstm_blocks() -> None:
    """Where xlstm-1.3b's prefill goes: one mLSTM and one sLSTM block at
    full width (batch 4, 4096 steps), timed warm on the host clock after
    synchronising the card."""
    from repro_torch.models import xlstm
    from repro_torch.models.registry import build
    cfg = build("xlstm-1.3b").cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    mp = xlstm.init_mlstm_block(gen, cfg)
    sp = xlstm.init_slstm_block(gen, cfg)
    states = xlstm.init_states(cfg, 4, "cuda")
    mstate = tuple(t[0, 0] for t in states["mlstm"])
    sstate = tuple(t[0] for t in states["slstm"])
    x = torch.randn((4, 4096, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.compute_dtype)
    times = {}
    with torch.inference_mode():
        for name, fn in (("mLSTM", lambda: xlstm.mlstm_block_apply(
                              mp, x, cfg, mstate, chunk=cfg.mlstm_chunk)),
                         ("sLSTM", lambda: xlstm.slstm_block_apply(
                              sp, x, cfg, sstate))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
    groups = cfg.n_layers // 8
    log(f"[16t] xlstm-1.3b blocks at batch 4, 4096 steps: mLSTM "
        f"{times['mLSTM']:.1f} ms (x {7 * groups} = "
        f"{7 * groups * times['mLSTM']:.0f} ms), sLSTM {times['sLSTM']:.1f} "
        f"ms ({times['sLSTM'] / 4096 * 1e3:.1f} us a step; x {groups} = "
        f"{groups * times['sLSTM']:.0f} ms)")


def phase_family_serve(results: dict) -> None:
    """(c): ``launch/serve.py``'s main at full width, batch 4, a 4096-token
    prompt (llava: 2880 patches + 1216 text; seamless: 4096 frames + 4096
    tokens), 16 greedy steps: attention launches a prefill exactly as
    FAMILY_SERVE says and nothing else, finite logits, the parameter count
    (with its full-depth count from shapes alone), prefill ms, decode
    tok/s, peak memory."""
    from repro_torch.launch import serve
    from repro_torch.models.registry import build
    launches = {}
    for arch, layers, n_attn in FAMILY_SERVE:
        full_total, full_active = build(arch).param_counts()
        if full_total != FAMILY_PARAMS[arch]:
            raise AssertionError(f"[16] {arch}: {full_total} parameters at "
                                 f"full depth, not {FAMILY_PARAMS[arch]}")
        want = build(arch, n_layers=layers).param_counts()[0]
        argv = ["--arch", arch, "--full", "--batch", "4", "--prompt-len",
                "4096", "--decode-steps", str(FAMILY_SERVE_STEPS)]
        if layers is not None:
            argv += ["--layers", str(layers)]
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out = serve.main(argv)
        counts = check_launches("16", {"flash_attention_wgmma": n_attn})
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name in ("prefill_logits", "logits"):
            if not bool(torch.isfinite(out[name]).all()):
                raise AssertionError(f"[16] serve {arch}: {name} not finite")
        if out["tokens"].shape != (4, FAMILY_SERVE_STEPS + 1):
            raise AssertionError(f"[16] serve {arch}: tokens "
                                 f"{out['tokens'].shape}")
        if out["n_params"] != want:
            raise AssertionError(f"[16] serve {arch}: {out['n_params']} "
                                 f"parameters, not {want}")
        launches[arch] = counts["flash_attention_wgmma"]
        depth = ("full depth" if layers is None else
                 f"{layers} of {build(arch).cfg.n_layers} layers (depth cut: "
                 f"{full_total} float32 parameters, "
                 f"{full_total * 4 / 1e9:.0f} GB, exceed one card)")
        log(f"[16] serve {arch} full width, {depth}: {out['n_params']} "
            f"parameters ({out['n_params'] * 4 / 1e9:.1f} GB float32; full "
            f"depth {full_total} total, {full_active} active), batch 4, "
            f"prompt 4096, {FAMILY_SERVE_STEPS} decode steps: prefill "
            f"{out['prefill_ms']:.1f} ms, decode {out['tok_per_s']:.1f} "
            f"tok/s ({out['decode_s'] * 1e3:.1f} ms), peak device memory "
            f"{peak:.2f} GiB; tensor-core attention launches "
            f"{counts['flash_attention_wgmma']} a prefill (expected "
            f"{n_attn}), float32 kernel {counts['flash_attention']}; logits "
            f"finite")
        del out
        if arch == "xlstm-1.3b":
            _time_xlstm_blocks()
        else:
            _profile_family(arch, layers)
    results["flash_attention_wgmma"]["family_launches"] = launches


def phase_families(results: dict) -> None:
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    for case in FAMILY_FLASH_CASES:
        flash_case(results, case, gen, "16")
    phase_family_card_vs_cpu()
    phase_family_serve(results)
    log(f"[16] phase time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: several devices (NCCL, one rank): the grid- and client-sharded
# sweeps, chunk_rounds and the cohort-parallel FL round
# ---------------------------------------------------------------------------

# (d): each entry of the card's combine within half a float32 step of its
# value plus COHORT_TOL of the magnitude the card sums in float32 there
# (the weighted terms: 4 products, their float32 sum and, in the int8
# modes, the code x scale products round a few 2^-24 of it)
COHORT_TOL = 8 * 2.0 ** -24
COHORTS, COHORT_STEPS = 4, 2                     # (d)
COHORT_BATCH, COHORT_SEQ = 2, 1024               # (d): cut from 4 x 4096
COHORT_WEIGHTS = (1.0, 0.0, 2.0, 1.0)            # cohort 1 unselected
COHORT_LR, COHORT_RATIO = 1e-3, 0.01
FL17_POLICIES = ("naive_ucb", "fedcs")     # (c): a score, a greedy


def sweeps_equal(label: str, got, want, what: str) -> None:
    same = np.array_equal(got.round_times, want.round_times) and (
        want.flags is None or np.array_equal(got.flags, want.flags))
    if not same:
        d = np.abs(got.round_times.astype(np.float64) - want.round_times)
        raise AssertionError(f"[{label}] {what}: max abs diff {d.max():g} s "
                             f"in {(d > 0).sum()} rounds")
    log(f"[{label}] {what}: bitwise equal")


def fl_equal(label: str, got, want, what: str) -> None:
    for key in ("selected", "round_times", "accuracy"):
        if not np.array_equal(getattr(got, key), getattr(want, key)):
            raise AssertionError(f"[{label}] {what}: {key} differs")
    log(f"[{label}] {what}: selections, round times and accuracy bitwise "
        f"equal")


@contextlib.contextmanager
def process_group(label: str = "17"):
    """A NCCL process group of world size 1 on cuda:0 (a file rendezvous
    under build/), destroyed on the way out."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    (ROOT / "build").mkdir(exist_ok=True)
    store = Path(tempfile.mkdtemp(prefix="nccl-", dir=ROOT / "build"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        t0 = time.perf_counter()       # the first collective makes NCCL's
        dist.all_reduce(torch.zeros(1, device="cuda"))     # communicator
        torch.cuda.synchronize()
        log(f"[{label}] NCCL process group of world size 1 on cuda:0, first "
            f"collective {time.perf_counter() - t0:.3f} s")
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _topk_mask(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest entries of ``a`` (1-D), ties to the lower index."""
    t = torch.kthvalue(a, a.numel() - k + 1).values
    keep = a > t
    tied = torch.nonzero(a == t).flatten()[:k - int(keep.sum())]
    keep[tied] = True
    return keep


def cohort_reference(mode: str, stacked: torch.Tensor, base: torch.Tensor,
                     w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's combine recomputed apart from the port's code: the int8
    codes, shared scales and top-k picks by the JAX package's formulas in
    float32 (IEEE division by a tensor on the same device, half-to-even
    rounding), the weighted sum in float64.  ``stacked`` [C, ...] and
    ``base`` float32, ``w`` the normalised float32 weights, all on one
    device.  Returns (the combined leaf, the magnitude of the terms the
    card sums in float32 at each entry; the compressed modes' final base +
    average rounds once more, which half a float32 step covers), float64."""
    wv = w.view(-1, *([1] * (stacked.dim() - 1)))
    eps, c127 = (torch.tensor(x, device=stacked.device) for x in (1e-12,
                                                                  127.0))
    if mode == "none":
        terms = wv.double() * stacked
        return terms.sum(0), terms.abs().sum(0)
    d = stacked - base[None]                              # float32
    if mode == "int8":
        flat = d.reshape(d.shape[0], -1)
        scale = (flat.abs().amax(1) + eps) / c127
        q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127)
        parts = (q.double() * scale[:, None].double()).view(d.shape)
    elif mode == "int8_psum":
        wd = wv * d                                       # float32
        scale = (wd.abs().max() + eps) / c127
        q = torch.clamp(torch.round(wd / scale), -127, 127).double()
        return (base.double() + q.sum(0) * scale.double(),
                q.abs().sum(0) * scale.double())
    else:
        flat = d.reshape(d.shape[0], -1)
        k = max(1, int(flat.shape[1] * COHORT_RATIO))
        parts = torch.stack([torch.where(_topk_mask(x.abs(), k), x, 0)
                             for x in flat]).double().view(d.shape)
    terms = wv.double() * parts
    return base.double() + terms.sum(0), terms.abs().sum(0)


def cohort_check(mode: str, agg: list, stacked: list, base: list,
                 w: torch.Tensor) -> tuple[float, float]:
    """Every leaf of the card's combine ``agg`` against
    :func:`cohort_reference` on the leaves' device.  Returns (the largest
    |card - reference| over its allowance, half a float32 step of the
    entry (widened by 2^-20 for the float64 reference's own rounding) plus
    COHORT_TOL of the float32 terms there: at most 1 passes; the largest
    error of the aggregated delta card - base over the largest entry of
    the reference's delta)."""
    worst = delta_err = delta_max = 0.0
    for a, sp, bp in zip(agg, stacked, base):
        ref, terms = cohort_reference(mode, sp, bp, w)
        err = (a.double() - ref).abs()
        mag = torch.maximum(a.abs(), ref.abs().float())
        ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf")))
               - mag).double()
        allow = 0.5 * ulp * (1 + 2.0 ** -20) + COHORT_TOL * terms
        worst = max(worst, float((err / allow).max()))
        delta_err = max(delta_err, float(err.max()))
        delta_max = max(delta_max, float((ref - bp.double()).abs().max()))
        del ref, terms, err, mag, ulp, allow
    return worst, delta_err / max(delta_max, 1e-30)


def devices_references(a: dict, b: dict, c: dict, fl_expect: dict):
    """The one-process runs that (a)-(c) are held to, before any group."""
    flat_a, _ = run_sweep("17a", {"bandit_round_sampled": 8 * 100}, **a)
    one_b, _ = run_sweep("17b", {"topk_slots": 2 * 20}, devices=8, **b)
    plain_c, _ = run_fl_sweep("17c", fl_expect, **c)
    return flat_a, one_b, plain_c


def devices_sweeps(results: dict, refs, a: dict, b: dict, c: dict,
                   fl_expect: dict) -> None:
    """(a)-(c) inside the process group."""
    from repro_torch.core import bandit
    flat_a, one_b, plain_c = refs
    n_fl = len(FL17_POLICIES) * c["n_rounds"]
    grid, counts = run_sweep("17a", {"bandit_round_sampled": 8 * 100},
                             shard="grid", devices=4, **a)
    sweeps_equal("17a", grid, flat_a, "grid over 4 shards on NCCL rank 0 "
                 "against the flat sweep")
    results["bandit_round_sampled"]["devices_launches"] = counts[
        "bandit_round_sampled"]
    torch.cuda.reset_peak_memory_stats()
    seg, counts = run_sweep("17b", {"topk_slots": 2 * 20}, devices=8, **b)
    sweeps_equal("17b", seg, one_b, "8 client blocks through NCCL's "
                 "all_reduce / all_gather against the one-process segmented "
                 "sweep")
    log(f"[17b] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    results["topk_slots"]["devices_launches"] = counts["topk_slots"]
    chunked, _ = run_sweep("17c", {"bandit_round_sampled": 8 * 100},
                           chunk_rounds=25, **a)
    sweeps_equal("17c", chunked, flat_a, "chunk_rounds=25 against unchunked")
    got, _ = run_fl_sweep("17c", fl_expect, chunk_rounds=1, **c)
    fl_equal("17c", got, plain_c, "accuracy_sweep chunk_rounds=1")
    streamed, _ = run_fl_sweep(
        "17c", {"bandit_round_sampled": n_fl, "fedavg_combine": n_fl},
        fast_sampling=True, **c)
    n_score = sum(c["n_rounds"] for p in FL17_POLICIES
                  if bandit.policy_kind(p) == "score")
    got, counts = run_fl_sweep(
        "17c", {"topk_slots": n_score, "fedavg_combine": n_fl},
        shard="clients", devices=4, fast_sampling=True, **c)
    fl_equal("17c", got, streamed, "accuracy_sweep shard='clients' "
             "devices=4 (the segmented rounds, 4 client blocks through "
             "NCCL) against the flat streamed sweep")
    results["fedavg_combine"]["devices_launches"] = counts["fedavg_combine"]
    results["topk_slots"]["devices_launches"] += counts["topk_slots"]


def cohort_kernel_times(results: dict, n_params: int) -> None:
    """(d)'s kernel shapes timed: the f32 combine of the 4 cohorts' rows
    (against its plain version, exact, beside the bound and one einsum)
    and a bf16 attention call of one layer at 2 x 1024 tokens
    (``flash_case``: against the plain version, SDPA and the bound)."""
    from repro_torch.kernels import fedavg as cuda_fedavg
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(171)
    rows = torch.randn((COHORTS, n_params), generator=gen, device="cuda")
    w = torch.tensor(COHORT_WEIGHTS, device="cuda")
    w = w / w.sum()
    got = cuda_fedavg.fedavg_combine_cuda(rows, w)
    if not torch.equal(got, ref.fedavg_combine_ref(rows, w)):
        raise AssertionError("[17d] fedavg_combine differs from its plain "
                             "version at the cohort combine's shape")
    ms = time_ms(lambda: cuda_fedavg.fedavg_combine_cuda(rows, w), 5)
    pms = time_ms(lambda: ref.fedavg_combine_ref(rows, w), 1)
    lms = time_ms(lambda: torch.einsum("cn,c->n", rows, w), 5)
    bms, by = fedavg_bound(1, COHORTS, n_params, 4)
    log(f"[17d] fedavg_combine (C, N) = ({COHORTS}, {n_params}) f32: equal "
        f"to its plain version; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"einsum {lms:.4f} ms, bound {bms:.4f} ms ({by})")
    del rows, got
    flash_case(results, (COHORT_BATCH, COHORT_SEQ, COHORT_SEQ, 3, 3, 64, True,
                         "bfloat16"), gen, "17d")


def devices_cohorts(results: dict, group) -> None:
    """(d): the cohort-parallel FL round at smollm-135m's full width."""
    from repro_torch.distributed import fl_parallel
    from repro_torch.models.registry import build
    from repro_torch.optim.sgd import OptimizerConfig
    from repro_torch.utils.trees import tree_leaves, tree_map
    api = build("smollm-135m", reduced=False)
    cfg = api.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    params = api.init(gen)
    opt = OptimizerConfig(name="sgd", lr=COHORT_LR, lr_decay=0.0).build()
    rng = np.random.default_rng(17)
    batches = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab, (COHORTS, COHORT_STEPS, COHORT_BATCH, COHORT_SEQ)),
        dtype=torch.int32, device="cuda")}
    weights = torch.tensor(COHORT_WEIGHTS, device="cuda")
    per_step = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    attn = COHORTS * COHORT_STEPS * per_step

    def states():
        return fl_parallel.init_cohort_states(
            opt, fl_parallel.stack_for_cohorts(params, COHORTS))
    # one set of trained cohorts: every mode's combine input
    local = fl_parallel.make_local_steps(api.loss_fn, opt, COHORT_STEPS)
    st = states()
    trained = [local(params, tree_map(lambda x: x[i], st),
                     {"tokens": batches["tokens"][i]})[0]
               for i in range(COHORTS)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *trained)
    del trained, st
    leaves_s, leaves_b = tree_leaves(stacked), tree_leaves(params)
    w_n = weights / weights.sum().clamp_min(1e-9)
    # the largest leaf (the embedding) once more on the host's CPU, apart
    # from the card's arithmetic too
    big = max(range(len(leaves_b)), key=lambda i: leaves_b[i].numel())
    host_s, host_b = leaves_s[big].cpu(), leaves_b[big].cpu()
    for mode in fl_parallel.COMPRESS:
        agg = fl_parallel.fedavg_across_cohorts(
            stacked, weights, compress=mode, topk_ratio=COHORT_RATIO,
            base_params=params, group=group)
        t_ref = time.perf_counter()
        leaves_a = tree_leaves(agg)
        worst, delta_err = cohort_check(mode, leaves_a, leaves_s, leaves_b,
                                        w_n)
        worst_host, _ = cohort_check(mode, [leaves_a[big].cpu()], [host_s],
                                     [host_b], w_n.cpu())
        t_ref = time.perf_counter() - t_ref
        del agg, leaves_a
        if not max(worst, worst_host) <= 1.0:
            raise AssertionError(
                f"[17d] {mode}: an entry of the combine is "
                f"{max(worst, worst_host):.3g} x its allowance (half a "
                f"float32 step + {COHORT_TOL:.3g} of the summed terms) from "
                f"the recomputation")
        fl_round = fl_parallel.make_fl_round(
            api.loss_fn, opt, COHORT_STEPS, compress=mode,
            topk_ratio=COHORT_RATIO, group=group)
        st = states()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        new, _, loss = fl_round(params, st, batches, weights)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = check_launches("17d", {
            "flash_attention_wgmma": attn,
            "fedavg_combine": int(mode != "int8_psum")})
        if not (math.isfinite(float(loss)) and all(
                bool(torch.isfinite(x).all()) for x in tree_leaves(new))):
            raise AssertionError(f"[17d] {mode}: non-finite round")
        if mode == "none":
            results["flash_attention_wgmma"]["devices_launches"] = counts[
                "flash_attention_wgmma"]
        log(f"[17d] compress={mode}: combine against its recomputation "
            f"(float64 sums) at {worst:.6g} of its allowance on the card, "
            f"{worst_host:.6g} on the host's CPU for the {host_s[0].numel()}"
            f"-entry leaf (limit 1; half a float32 step + {COHORT_TOL:.3g} "
            f"of the summed terms), aggregated delta within "
            f"{delta_err:.3g} of its largest entry (checks {t_ref:.1f} s); "
            f"round {dt:.3f} s "
            f"({COHORTS} cohorts x "
            f"{COHORT_STEPS} SGD steps of {COHORT_BATCH} x {COHORT_SEQ} "
            f"tokens), loss {float(loss):.5f}, launches {counts}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del new, st
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"[17d] smollm-135m full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, remat {cfg.remat}, {n_params} parameters); "
        f"{card_name_and_power()}")
    del params, stacked, leaves_s, leaves_b, host_s, host_b
    torch.cuda.empty_cache()
    cohort_kernel_times(results, n_params)


def phase_devices(results: dict) -> None:
    from repro_torch.fl import engine as fl
    from repro_torch.models import cnn
    t0 = time.perf_counter()
    a = dict(scenario="paper-baseline", etas=(1.5,), seeds=8, n_rounds=100,
             n_clients=10_000)
    b = dict(scenario="paper-baseline", etas=(1.5,), seeds=2, n_rounds=20,
             n_clients=1_000_000, shard="clients")
    cfg = cnn.CnnConfig()
    # phase 8's width; the local epochs cut from 5 to 1 (four sweeps run)
    c = dict(cfg=cfg, policies=FL17_POLICIES, seeds=1, n_rounds=2,
             n_clients=100, s_round=5, frac_request=0.1, eta=1.5, epochs=1,
             batch_size=50, cohort="selected", device="cuda")
    n = len(FL17_POLICIES) * c["n_rounds"]
    fl_expect = {"bandit_round": n, "fedavg_combine": n}
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        c["task"] = fl.make_cnn_task("paper-baseline", 100, cfg=cfg,
                                     n_train=50_000, n_test=10_000,
                                     batch_size=50, device="cuda")
        refs = devices_references(a, b, c, fl_expect)
        with process_group() as group:
            devices_sweeps(results, refs, a, b, c, fl_expect)
            del c["task"], refs
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = saved
            devices_cohorts(results, group)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    log(f"[17] phase time {time.perf_counter() - t0:.1f} s; "
        f"{card_name_and_power()}")


# ---------------------------------------------------------------------------
# phase 18: the LM stack over a device mesh: the attention kernels at a
# query offset, smollm-135m and llava-next-34b through --mesh 1x1 on one
# NCCL rank, and the FL host-loop reference
# ---------------------------------------------------------------------------

# (a): (B, Sq = Skv, KV, G, dh, dtype) causal, its q rows split into P
# slices of Sq / P rows, each launched with q_offset = p·Sq / P
OFFSET_CASES = [(4, 4096, 3, 3, 64, "bfloat16"), (4, 4096, 8, 7, 128,
                                                  "bfloat16"),
                (4, 4096, 3, 3, 64, "float32")]
OFFSET_SPLITS = (2, 4, 16)
# SDPA's output at the offsets against the kernel's, |diff| / (1 + |out|):
# a check that the library calls timed beside the kernel compute the same
# function (a wrong mask moves outputs by tenths; two bf16 roundings of one
# value differ by at most 2^-7 of it), not a gate of either's precision
SDPA_SANITY = 2e-2


def flash_ops_rows(b, q0, q1, skv, kv, g, dh, causal) -> int:
    """4·dh float operations of query rows [q0, q1) (row i at position i)
    against Skv keys: the keys j <= i when causal."""
    if not causal:
        return 4 * b * kv * g * (q1 - q0) * skv * dh
    n = max(0, min(q1, skv) - q0)              # rows whose diagonal is inside
    inside = n * (q0 + 1) + n * (n - 1) // 2 if n else 0
    pairs = inside + (q1 - q0 - n) * skv
    return 4 * b * kv * g * pairs * dh


def offset_slice_bound(b, q0, q1, skv, kv, g, dh, itemsize):
    """Least time (ms) of one causal slice launch: its operations over the
    type's tensor-core peak against its q rows and output and the keys it
    attends, the first min(q1, Skv) of k and v (the kernel reads no key
    beyond its last row's position), moved once over the memory rate."""
    ops = flash_ops_rows(b, q0, q1, skv, kv, g, dh, True)
    rate = BF16_TC_OPS_PER_S if itemsize == 2 else TF32_TC_OPS_PER_S
    keys = min(q1, skv)
    nbytes = itemsize * (2 * b * (q1 - q0) * kv * g * dh
                         + 2 * b * keys * kv * dh)
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def offset_sdpa(q, k, v, q0: int):
    """The library's two single calls for one causal slice at q_offset
    ``q0`` (q [B, rows, KV, G, dh] and all of k, v [B, S, KV, dh], in SDPA's
    [B, heads, S, dh] layout made here, outside the timed calls): a boolean
    mask [rows, S] over every key, and ``causal_lower_right`` over the
    first q0 + rows keys, the same function.  Returns the two calls and a
    map of SDPA's output back to [B, rows, KV, G, dh]."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    b, rows, kv, g, dh = q.shape
    qs = q.permute(0, 2, 3, 1, 4).reshape(b, kv * g, rows, dh).contiguous()
    ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
    keys = q0 + rows
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            <= q0 + torch.arange(rows, device=q.device)[:, None])
    kc, vc = ks[:, :, :keys], vs[:, :, :keys]
    lower = causal_lower_right(rows, keys)

    def masked():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)

    def lower_right():
        return F.scaled_dot_product_attention(qs, kc, vc, attn_mask=lower,
                                              enable_gqa=True)

    def back(o):
        return o.reshape(b, kv, g, rows, dh).permute(0, 3, 1, 2, 4)
    return masked, lower_right, back


def phase_offset_kernels(results: dict) -> None:
    """(a): each case's unsplit causal launch, then its q rows in P slices
    launched with their q_offset: the slices concatenated bitwise the
    unsplit output (each warpgroup's 64 rows start at the same global row
    in both, since Sq / P · G is a multiple of 64, so every row sees the
    same tiles, masked and plain alike), each slice against the plain
    version with the same q_offset under FLASH_TOL; ms per slice by CUDA
    events beside its bound and beside SDPA's two single calls of the same
    slice (``offset_sdpa``; the faster is the slice's library time)."""
    from repro_torch.kernels import flash_attention as cuda_flash
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    for b, s, kv, g, dh, dtype in OFFSET_CASES:
        name, _ = FLASH_VARIANT[dtype]
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((b, s, kv, g, dh), (b, s, kv, dh),
                                 (b, s, kv, dh)))
        whole = cuda_flash.flash_attention_cuda(q, k, v, True)
        whole_ms = time_ms(lambda: cuda_flash.flash_attention_cuda(
            q, k, v, True), 3)
        res = results[name]
        rows = res.setdefault("offsets", {})
        for n_split in OFFSET_SPLITS:
            if (s // n_split * g) % 64:
                raise AssertionError(f"[18] {s} / {n_split} rows x G {g} "
                                     f"is no multiple of 64")
            rs = s // n_split
            parts = [q[:, p * rs:(p + 1) * rs].contiguous()
                     for p in range(n_split)]
            reset_counts()
            outs = [cuda_flash.flash_attention_cuda(x, k, v, True,
                                                    q_offset=p * rs)
                    for p, x in enumerate(parts)]
            counts = check_launches("18", {name: n_split})
            got = torch.cat(outs, 1)
            torch.cuda.synchronize()
            where = (f"{name} (B, S, KV, G, dh)=({b}, {s}, {kv}, {g}, {dh}) "
                     f"causal {dtype}, {n_split} slices of {rs} rows")
            if not torch.equal(got, whole):
                d = (got.float() - whole.float()).abs().max().item()
                raise AssertionError(f"[18] {where}: the slices differ from "
                                     f"the unsplit launch (max abs {d:g})")
            err = 0.0
            for p, (x, o) in enumerate(zip(parts, outs)):
                want = ref.flash_attention_ref(x, k, v, True, q_offset=p * rs)
                torch.testing.assert_close(
                    o, want, **FLASH_TOL[dtype],
                    msg=f"[18] {where}: slice {p} differs from the plain "
                        f"version at q_offset {p * rs}")
                err = max(err, (o.float() - want.float()).abs().max().item())
            res["max_abs_err"] = max(res.get("max_abs_err") or 0.0, err)
            ms = [time_ms(lambda x=x, p=p: cuda_flash.flash_attention_cuda(
                x, k, v, True, q_offset=p * rs), 3) for p, x in
                enumerate(parts)]
            bms = [offset_slice_bound(b, p * rs, (p + 1) * rs, s, kv, g, dh,
                                      q.element_size())[0]
                   for p in range(n_split)]
            pms = time_ms(lambda: ref.flash_attention_ref(
                parts[-1], k, v, True, q_offset=(n_split - 1) * rs), 1)
            lib = {"mask": [], "lower_right": []}
            lib_err = 0.0
            for p, (x, o) in enumerate(zip(parts, outs)):
                masked, lower, back = offset_sdpa(x, k, v, p * rs)
                for key, call in (("mask", masked), ("lower_right", lower)):
                    d = ((back(call()).float() - o.float()).abs()
                         / (1 + o.float().abs())).max().item()
                    lib_err = max(lib_err, d)
                    lib[key].append(time_ms(call, 3))
            if not lib_err < SDPA_SANITY:
                raise AssertionError(f"[18] {where}: SDPA at the offsets "
                                     f"differs from the kernel by "
                                     f"{lib_err:g}: not the same function")
            lms = [min(a, c) for a, c in zip(lib["mask"],
                                              lib["lower_right"])]
            rows[f"{b}x{s}x{kv}x{g}x{dh}/P{n_split}"] = dict(
                launches=counts[name], ms=ms, bound_ms=bms,
                plain_ms_last=pms, max_abs_err=err, unsplit_ms=whole_ms,
                library_ms=lms, sdpa_mask_ms=lib["mask"],
                sdpa_lower_right_ms=lib["lower_right"])
            log(f"[18] {where}: bitwise the unsplit launch; against the "
                f"plain version max abs err {err:.3g}; {counts[name]} "
                f"launches; ms per slice {', '.join(f'{t:.4f}' for t in ms)} "
                f"(sum {sum(ms):.4f}; the unsplit launch {whole_ms:.4f}); "
                f"bound per slice "
                f"{', '.join(f'{t:.4f}' for t in bms)}; SDPA per slice, "
                f"boolean mask over every key "
                f"{', '.join(f'{t:.4f}' for t in lib['mask'])}; "
                f"causal_lower_right over the attended keys "
                f"{', '.join(f'{t:.4f}' for t in lib['lower_right'])} "
                f"(from the kernel at most {lib_err:.3g} of 1 + |out|); "
                f"plain version "
                f"of the last slice {pms:.1f} ms")


LLAVA_LAYERS = 8                  # (c): phase 16's cut of llava's depth
HOST_REF_ROUNDS = 3               # (d)


def _collectives() -> dict:
    from repro_torch.distributed import sharding
    return {k: v["calls"] for k, v in sharding.collective_counts.items()}


def phase_mesh_serve(results: dict) -> None:
    """(b): ``launch/serve.py --mesh 1x1`` at smollm-135m's full width, 4 x
    4096 prompt tokens and 32 greedy steps, on one NCCL rank: the
    model-parallel route (a 1 x 1 mesh: every collective runs over a group
    of one) bitwise phase 12's one-process run, prefill logits, last
    logits and tokens, with 30 bf16 attention launches a prefill and the
    collectives the route issues.  (c): llava-next-34b cut to 8 layers
    (phase 16's cut), prefill only, one process then through the same mesh
    path, whose ``shard_attn_batch`` makes the prefill context-parallel
    (the kernel at q_offset 0 here): prefill logits bitwise."""
    from repro_torch.launch import serve
    if not SERVE_ONE:
        raise AssertionError("[18] phase 12's serve did not run")
    res = results["flash_attention_wgmma"]
    mesh_launches = {}
    with process_group("18"):
        reset_counts()
        torch.cuda.empty_cache()
        out = serve.main(SERVE_ARGS + ["--mesh", "1x1"])
        counts = check_launches("18", {"flash_attention_wgmma": 30})
        for key in ("prefill_logits", "logits"):
            if not torch.equal(out[key].cpu(), SERVE_ONE[key]):
                raise AssertionError(f"[18] smollm-135m --mesh 1x1: {key} "
                                     f"differ from the one-process run")
        if not np.array_equal(out["tokens"], SERVE_ONE["tokens"]):
            raise AssertionError("[18] smollm-135m --mesh 1x1: tokens "
                                 "differ")
        coll = out["collectives"]
        if min(coll["prefill"]["all_reduce"][0],
               coll["prefill"]["all_gather"][0],
               coll["decode"]["all_reduce_max"][0]) < 1:
            raise AssertionError(f"[18] the sharded route did not run: "
                                 f"{coll}")
        mesh_launches["smollm-135m"] = counts["flash_attention_wgmma"]
        log(f"[18] serve smollm-135m full width --mesh 1x1 (one NCCL rank), "
            f"batch 4, prompt 4096, 32 decode steps: prefill logits, last "
            f"logits and tokens bitwise phase 12's one-process run; prefill "
            f"{out['prefill_ms']:.1f} ms (one process "
            f"{SERVE_ONE['prefill_ms']:.1f} ms), decode "
            f"{out['tok_per_s']:.1f} tok/s (one process "
            f"{SERVE_ONE['tok_per_s']:.1f}); collectives (calls, bytes) "
            f"{coll}; attention kernel launches {counts}")
        del out
        argv = ["--arch", "llava-next-34b", "--full", "--layers",
                str(LLAVA_LAYERS), "--batch", "4", "--prompt-len", "4096",
                "--decode-steps", "0"]
        torch.cuda.empty_cache()
        one = serve.main(argv)["prefill_logits"].cpu()
        torch.cuda.empty_cache()
        reset_counts()
        out = serve.main(argv + ["--mesh", "1x1"])
        counts = check_launches("18", {"flash_attention_wgmma": LLAVA_LAYERS})
        if not torch.equal(out["prefill_logits"].cpu(), one):
            d = (out["prefill_logits"].cpu().float() - one.float()).abs()
            raise AssertionError(f"[18] llava --mesh 1x1 prefill logits "
                                 f"differ (max abs {d.max().item():g})")
        coll = out["collectives"]["prefill"]
        # context-parallel: per layer 4 weight gathers and the output's
        if coll["all_gather"][0] < 5 * LLAVA_LAYERS:
            raise AssertionError(f"[18] llava: not the context-parallel "
                                 f"route: {coll}")
        mesh_launches["llava-next-34b"] = counts["flash_attention_wgmma"]
        log(f"[18] serve llava-next-34b full width on {LLAVA_LAYERS} layers "
            f"--mesh 1x1, batch 4, prompt 4096 (2880 patches + 1216 text), "
            f"context-parallel prefill: logits bitwise the one-process "
            f"prefill; prefill {out['prefill_ms']:.1f} ms; collectives "
            f"(calls, bytes) {coll}; attention kernel launches {counts}")
        del out
    torch.cuda.empty_cache()
    res["mesh_launches"] = mesh_launches


def phase_host_reference() -> None:
    """(d): ``fl.engine.run_host_reference`` on phase 7's small CNN (BN
    off, 12 clients, 6 candidates, S = 3, 2 epochs of batch 10), 3 rounds
    of two policies on the same CPU-made inputs on the card and on the CPU
    (TF32 off): selections equal, round times within rtol 1e-5, the final
    model within phase 7's relative L2; on the card one FedAvg-combine
    launch a round and no other kernel."""
    from repro_torch.fl import engine as fl
    from repro_torch.models import cnn
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = cnn.CnnConfig(batchnorm=False, **SMALL_CNN)
        tasks = {dev: fl.make_cnn_task(
            "paper-baseline", 12, cfg=cfg, n_train=600, n_test=400,
            eval_batch=200, max_samples=40, batch_size=10, device=dev)
            for dev in ("cpu", "cuda")}
        cap = tasks["cpu"].part_idx.shape[1]
        gen = torch.Generator().manual_seed(18)
        r = HOST_REF_ROUNDS
        pre = {"cand_masks": torch.stack([
                   torch.zeros(12, dtype=torch.bool).index_fill(
                       0, torch.randperm(12, generator=gen)[:6], True)
                   for _ in range(r)]).numpy(),
               "t_ud": (1.0 + 9.0 * torch.rand(r, 12, generator=gen)).numpy(),
               "t_ul": (1.0 + 9.0 * torch.rand(r, 12, generator=gen)).numpy(),
               "orders": torch.stack([fl.draw_orders(
                   gen, 1, tasks["cpu"].part_count, 2, cap)[0]
                   for _ in range(r)]).numpy()}
        for policy in ("fedcs", "elementwise_ucb"):
            out = {}
            for dev, task in tasks.items():
                reset_counts()
                out[dev] = fl.run_host_reference(
                    task, pre, policy=policy, s_round=3, cfg=cfg, epochs=2,
                    batch_size=10)
                if dev == "cuda":
                    counts = check_launches("18", {"fedavg_combine": r})
            a, b = out["cuda"], out["cpu"]
            where = f"[18] run_host_reference {policy}"
            if not np.array_equal(a["selected"], b["selected"]):
                raise AssertionError(f"{where}: selections differ")
            np.testing.assert_allclose(a["round_times"], b["round_times"],
                                       rtol=1e-5, atol=0)
            pa = torch.cat([v.flatten().cpu() for v in a["params"].values()])
            pb = torch.cat([v.flatten() for v in b["params"].values()])
            rl2 = ((pa - pb).norm() / pb.norm()).item()
            if not rl2 < CARD_VS_CPU_RL2[False]:
                raise AssertionError(f"{where}: final model at relative L2 "
                                     f"{rl2:g}")
            log(f"{where}: {r} rounds card against CPU on the same inputs: "
                f"selections equal, round times max abs diff "
                f"{np.abs(a['round_times'] - b['round_times']).max():g} s, "
                f"final model at relative L2 {rl2:.3g} (limit "
                f"{CARD_VS_CPU_RL2[False]:g}); accuracy card "
                f"{a['accuracy'].round(4).tolist()} cpu "
                f"{b['accuracy'].round(4).tolist()}; card launches {counts}")
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def phase_mesh(results: dict) -> None:
    t0 = time.perf_counter()
    phase_offset_kernels(results)
    phase_mesh_serve(results)
    phase_host_reference()
    log(f"[18] phase time {time.perf_counter() - t0:.1f} s; "
        f"{card_name_and_power()}")


# ---------------------------------------------------------------------------
# phase 19: training over a (data, model) mesh on one NCCL rank
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3               # (a): timed steps after one warm-up
TRAIN_ONE: dict = {}               # phase 15b's seconds a step, for (a)


def _tree_equal(a, b) -> bool:
    from repro_torch.utils.trees import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _launched(counts: dict, more: dict) -> dict:
    return {k: counts.get(k, 0) + more.get(k, 0) for k in {*counts, *more}}


def phase_mesh_train_step(results: dict) -> None:
    """(a): the full-width smollm-135m AdamW step on a 1 x 1 mesh against
    the one-process step, step by step on the same weights and batches."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.layers import ModelParallel
    from repro_torch.models.registry import build
    from repro_torch.optim.sgd import OptimizerConfig

    api = build("smollm-135m", reduced=False)
    cfg = api.cfg
    opt_cfg = OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1)
    mesh = make_mesh(1, 1, device_type="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = api.init(gen)
    pspecs = sharding.param_specs(params, cfg, mesh)
    mp = ModelParallel.of(mesh, pspecs, global_batch=TRAIN_BATCH)
    one_step, opt = make_train_step(api, opt_cfg)
    mesh_step, _ = make_train_step(api, opt_cfg, mp=mp)
    one = {"p": params, "s": opt.init(params)}
    mine = {"p": sharding.shard_params(params, pspecs, mesh)}
    mine["s"] = opt.init(mine["p"])
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.tensor(
        rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)),
        dtype=torch.int32, device="cuda")}
        for _ in range(MESH_TRAIN_STEPS + 1)]
    per_step = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    times = {"one": [], "mesh": []}
    launches, coll = {}, {}
    for i, batch in enumerate(batches):
        for who, step in (("one", one_step), ("mesh", mesh_step)):
            st = one if who == "one" else mine
            reset_counts()
            sharding.reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st["p"], st["s"], st["loss"] = step(st["p"], st["s"], batch)
            torch.cuda.synchronize()
            times[who].append(time.perf_counter() - t0)
            counts = check_launches("19a", {"flash_attention_wgmma":
                                            per_step})
            if who == "mesh":
                launches = _launched(launches, counts)
                coll = {k: v["calls"] for k, v in
                        sharding.collective_counts.items()}
        same = {"loss": torch.equal(one["loss"], mine["loss"]),
                "params": _tree_equal(one["p"], mine["p"]),
                "m": _tree_equal(one["s"]["m"], mine["s"]["m"]),
                "v": _tree_equal(one["s"]["v"], mine["s"]["v"])}
        if not all(same.values()):
            raise AssertionError(f"[19a] step {i}: the 1 x 1 mesh step "
                                 f"differs from the one-process step: "
                                 f"{same}")
    if not (math.isfinite(float(mine["loss"]))
            and int(mine["s"]["step"]) == MESH_TRAIN_STEPS + 1):
        raise AssertionError("[19a] the mesh step's loss or counter")
    if min(coll["all_reduce"], coll["all_gather"]) < 1:
        raise AssertionError(f"[19a] the model-parallel route did not run: "
                             f"{coll}")
    results["flash_attention_wgmma"].setdefault(
        "mesh_train_launches", {})["19a_step"] = \
        launches["flash_attention_wgmma"] // len(batches)
    one_s = statistics.mean(times["one"][1:])
    mesh_s = statistics.mean(times["mesh"][1:])
    log(f"[19a] smollm-135m full width, AdamW step at {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} (remat {cfg.remat}) through make_train_step(mp=) on a "
        f"1 x 1 mesh: {len(batches)} steps, each step's loss, every "
        f"parameter and both AdamW moments bitwise the one-process step; "
        f"{mesh_s:.4f} s a step (one-process step in the same run "
        f"{one_s:.4f} s, phase 15b {TRAIN_ONE.get('s', float('nan')):.4f} "
        f"s; mean of the last {MESH_TRAIN_STEPS}); collectives a step "
        f"{coll} (one process: none); bf16 attention launches a step "
        f"{launches['flash_attention_wgmma'] // len(batches)}; last loss "
        f"{float(mine['loss']):.5f}")
    del one, mine, params, batches
    torch.cuda.empty_cache()
    # no fallback through the host: a CPU tensor in the NCCL group raises
    small = build("smollm-135m", reduced=True)
    cpu = small.init(torch.Generator().manual_seed(0))
    cspecs = sharding.param_specs(cpu, small.cfg, mesh)
    step, _ = make_train_step(small, opt_cfg, mp=ModelParallel.of(
        mesh, cspecs, global_batch=2))
    try:
        step(cpu, opt.init(cpu), {"tokens": torch.zeros(
            (2, 16), dtype=torch.int32)})
    except ValueError as e:
        if "nccl" not in str(e):
            raise
        log(f"[19a] the mesh step refuses CPU tensors in the NCCL group: "
            f"{e}")
    else:
        raise AssertionError("[19a] the mesh step took CPU tensors in a "
                             "NCCL group")


def phase_mesh_cohorts(results: dict) -> None:
    """(b): phase 17d's cohort round through ``make_fl_round`` with a mesh
    and the stacked specs at model size 1, against the round without a
    mesh on the same inputs, every compress mode."""
    from repro_torch.distributed import fl_parallel, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build
    from repro_torch.optim.sgd import OptimizerConfig
    api = build("smollm-135m", reduced=False)
    cfg = api.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    params = api.init(gen)
    opt = OptimizerConfig(name="sgd", lr=COHORT_LR, lr_decay=0.0).build()
    rng = np.random.default_rng(17)
    batches = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab, (COHORTS, COHORT_STEPS, COHORT_BATCH, COHORT_SEQ)),
        dtype=torch.int32, device="cuda")}
    weights = torch.tensor(COHORT_WEIGHTS, device="cuda")
    mesh = make_mesh(1, 1, device_type="cuda")
    sspecs = fl_parallel.stacked_param_specs(
        sharding.param_specs(params, cfg, mesh), mesh)
    per_step = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    attn = COHORTS * COHORT_STEPS * per_step
    for mode in fl_parallel.COMPRESS:
        out, dt = {}, {}
        for who in ("flat", "mesh"):
            kw = ({"group": torch.distributed.group.WORLD} if who == "flat"
                  else {"mesh": mesh, "stacked_specs": sspecs})
            fl_round = fl_parallel.make_fl_round(
                api.loss_fn, opt, COHORT_STEPS, compress=mode,
                topk_ratio=COHORT_RATIO, **kw)
            st = fl_parallel.init_cohort_states(
                opt, fl_parallel.stack_for_cohorts(params, COHORTS))
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[who] = fl_round(params, st, batches, weights)
            torch.cuda.synchronize()
            dt[who] = time.perf_counter() - t0
            counts = check_launches("19b", {
                "flash_attention_wgmma": attn,
                "fedavg_combine": int(mode != "int8_psum")})
            del st
        (a, oa, la), (b, ob, lb) = out["flat"], out["mesh"]
        if not (_tree_equal(a, b) and _tree_equal(oa, ob)
                and torch.equal(la, lb)):
            raise AssertionError(f"[19b] compress={mode}: the mesh round "
                                 f"differs from the round without a mesh")
        if mode == "none":
            results["flash_attention_wgmma"].setdefault(
                "mesh_train_launches", {})["19b_round"] = counts[
                "flash_attention_wgmma"]
            results["fedavg_combine"]["mesh_train_launches"] = {
                "19b_round": counts["fedavg_combine"]}
        log(f"[19b] compress={mode}: make_fl_round(mesh 1 x 1, stacked "
            f"specs) bitwise the round without a mesh (new global model, "
            f"cohort states, loss {float(lb):.5f}); round {dt['mesh']:.3f} "
            f"s (without a mesh {dt['flat']:.3f} s); launches {counts}")
        del out, a, b, oa, ob
    del params, batches
    torch.cuda.empty_cache()


def phase_mesh_train(results: dict) -> None:
    t0 = time.perf_counter()
    with process_group("19"):
        phase_mesh_train_step(results)
        phase_mesh_cohorts(results)
    log(f"[19] phase time {time.perf_counter() - t0:.1f} s; "
        f"{card_name_and_power()}")


# ---------------------------------------------------------------------------
# phase 20: the threefry kernel, the sweeps from the seed on the card
# against the CPU, and the layouts' draws on one NCCL rank
# ---------------------------------------------------------------------------

# (keys, counters, offset) of the sweeps' draws: phase 3's permutation sort
# keys (8 seeds) and Eq. (8) uniforms (8 theta and 8 gamma keys) at
# K = 100 and 24 rows of 100; phase 4a's candidate uniforms (8 seeds,
# K = 10^4) and its [2, C] block (C = 10^3); K = 10^6's candidates (2
# seeds, phases 10 and 17b) and one rank's quarter of them
THREEFRY_SHAPES = [(8, 100, 0), (16, 100, 0), (24, 100, 0), (8, 10_000, 0),
                   (8, 2_000, 0), (2, 1_000_000, 0), (2, 250_000, 500_000)]
THREEFRY_MAIN = (16, 100, 0)   # phase 3's Eq. (8) draw: one a policy round
# (phase, sweep, expected round-kernel launches): phases 3, 4a, 4b and 5 with
# their rounds cut to keep the CPU's runs short
SEED_SWEEPS = [
    ("3", dict(scenario="paper-baseline", etas=(1.0, 1.5, 1.9), seeds=8,
               n_rounds=50, n_clients=100), {"bandit_round": 8 * 50}),
    ("4a", dict(scenario="paper-baseline", etas=(1.5,), seeds=8,
                n_rounds=25, n_clients=10_000),
     {"bandit_round_sampled": 8 * 25}),
    ("4b", dict(scenario="flaky-clients", etas=(1.5,), seeds=8, n_rounds=25,
                n_clients=10_000, deadline=DEADLINE),
     {"bandit_round_sampled": 8 * 25}),
    ("5", dict(scenario="metro-congestion", etas=(1.5,), seeds=1,
               n_rounds=10, n_clients=100_000),
     {"bandit_round_sampled": 8 * 10}),
]


def threefry_bound(n_keys: int, n: int, out: str) -> float:
    """Least ms of one launch: the keys read once and the outputs written
    once (4 bytes, 8 for a key pair), over the memory rate."""
    return (8 * n_keys + n_keys * n * (8 if out == "pairs" else 4)) \
        / HBM_BYTES_PER_S * 1e3


def _threefry_case(keys, n: int, label: str, **kw) -> None:
    """The kernel against its plain version on the same card tensors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.threefry import threefry_cuda
    got = threefry_cuda(keys, n, **kw)
    want = ref.threefry_ref(keys, n, **kw)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        raise AssertionError(f"[20a] threefry {label}: kernel differs from "
                             f"its plain version")


def phase_threefry_kernel(results: dict) -> None:
    """(a) the threefry kernel bitwise its plain version at the sweeps'
    shapes, bits, key pairs and uniforms (also on bounds), split of 24 keys
    into 500 and fold_in of cell ids on the device, each shape's uniforms
    timed beside the plain version and the bound."""
    from repro_torch.core import prng
    from repro_torch.kernels import ref
    from repro_torch.kernels.threefry import threefry_cuda
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    r, shapes = results["threefry"], []
    for n_keys, n, offset in THREEFRY_SHAPES:
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_keys, 2), device=dev,
                             dtype=torch.int32, generator=gen)
        where = f"{n_keys} keys x {n} counters from {offset}"
        for out in ("bits", "pairs", "uniform"):
            _threefry_case(keys, n, f"{where} {out}", offset=offset, out=out)
        _threefry_case(keys, n, f"{where} uniform [10, 100)",
                       offset=offset, out="uniform", minval=10.0,
                       maxval=100.0)
        def launch():
            return threefry_cuda(keys, n, offset=offset, out="uniform")
        ms = time_ms(launch, 100)
        dms = profiled_kernel_ms(launch, 50, kernel="threefry_kernel")
        pms = time_ms(lambda: ref.threefry_ref(keys, n, offset=offset,
                                               out="uniform"), 5)
        b = threefry_bound(n_keys, n, "uniform")
        shapes.append(dict(keys=n_keys, n=n, offset=offset, ms=ms,
                           device_ms=dms, plain_ms=pms, bound_ms=b))
        if (n_keys, n, offset) == THREEFRY_MAIN:
            r.update(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=b,
                     bound_by="bytes", max_abs_err=0.0)
        dev_txt = "none" if dms is None else f"{dms:.4f}"
        log(f"[20a] threefry {where}: bits, pairs, uniforms (also on "
            f"[10, 100)) bitwise the plain version; uniforms {ms:.4f} ms a "
            f"call (device time by torch.profiler {dev_txt} ms), plain "
            f"{pms:.3f} ms, bound {b:.6f} ms")
    roots = torch.randint(-2 ** 31, 2 ** 31 - 1, (24, 2), device=dev,
                          dtype=torch.int32, generator=gen)
    _threefry_case(roots, 500, "split of 24 keys into 500", out="pairs")
    split = prng.split(roots, 500)
    if not bits_equal(split, ref.threefry_ref(roots, 500, out="pairs")):
        raise AssertionError("[20a] prng.split differs on the card")
    ms = time_ms(lambda: prng.split(roots, 500), 100)
    shapes.append(dict(keys=24, n=500, offset=0, out="pairs", ms=ms,
                       bound_ms=threefry_bound(24, 500, "pairs")))
    cells = torch.randint(0, 100, (2, 10), device=dev, dtype=torch.int32,
                          generator=gen)
    got = prng.fold_in(roots[:2, None], cells)
    want = ref.threefry_ref(roots[:2, None].expand(2, 10, 2), 1,
                            row_offsets=cells.long(), out="pairs")
    if not bits_equal(got.reshape(-1, 2), want.reshape(-1, 2)):
        raise AssertionError("[20a] fold_in of cell ids differs on the card")
    r["shapes"] = shapes
    log(f"[20a] split of 24 keys into 500: {ms:.4f} ms; fold_in of [2, 10] "
        f"cell ids on the device bitwise the plain version; "
        f"{card_name_and_power()}")


def seed_rounds_card_vs_cpu() -> None:
    """The rounds of a sweep from the same seeds on the card and on the
    CPU, each drawing on its own device: every round's selections and flags
    equal, round times within RTOL (flaky-clients with a deadline, legacy
    at K = 100 and streamed at K = 2000, 8 policies x 4 grid points x 30
    rounds)."""
    from repro_torch.core import bandit
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import get_scenario

    scen, rounds = get_scenario("flaky-clients"), 30
    for fast, k in ((False, 100), (True, 2000)):
        n_req = math.ceil(0.1 * k)
        env_np = scen.build_env(k, np.random.default_rng(0))
        worst = 0.0
        for policy in bandit.POLICY_NAMES:
            out = {}
            for dev in ("cpu", "cuda"):
                # grid points (eta 1.0, 1.9) x seeds (0, 1), as sweep lays
                # them out
                streams = engine.KeyStreams(
                    (0, 1), rounds, dev,
                    rows=torch.tensor([0, 1, 0, 1], device=dev))
                runner = engine.RoundRunner(
                    engine.EnvArrays.from_scenario(scen, env_np, dev),
                    torch.tensor([1.0, 1.0, 1.9, 1.9], device=dev),
                    policy=policy, scen=scen, s_round=5,
                    hyper=bandit.DEFAULT_HYPERS[policy], model_bits=146.4e6,
                    fast=fast, deadline=DEADLINE)
                rec = [runner.step(r + 1, engine.draw_round_inputs(
                    streams, rnd=r, k=k, n_req=n_req, s_round=5, fast=fast,
                    fluctuate=True, policy=policy, scen=scen,
                    fault=scen.fault.probs)) for r in range(rounds)]
                out[dev] = [torch.stack([x[i].cpu() for x in rec])
                            for i in range(3)]
            (sa, ta, fa), (sb, tb, fb) = out["cuda"], out["cpu"]
            if not (torch.equal(sa, sb) and torch.equal(fa, fb)):
                raise AssertionError(f"[20b] card vs CPU {policy} K={k}: "
                                     f"selections or flags differ")
            torch.testing.assert_close(ta, tb, rtol=RTOL, atol=0)
            worst = max(worst, (ta - tb).abs().max().item())
        log(f"[20b] rounds from the seeds on the card vs the CPU, "
            f"flaky-clients K={k} {'streamed' if fast else 'legacy'}, 8 "
            f"policies x 4 grid points x {rounds} rounds: selections and "
            f"flags equal, round times max abs diff {worst:g} s")


def phase_seed_sweeps() -> None:
    """(b) phases 3, 4a, 4b and 5 (rounds cut) from the seeds on the card
    against the port on the CPU, no replay: flags equal, round times within
    RTOL, the launches of each card sweep exact."""
    from repro_torch.sim import engine
    seed_rounds_card_vs_cpu()
    for label, kw, expect in SEED_SWEEPS:
        card, counts = run_sweep(f"20b-{label}", expect, **kw)
        t0 = time.perf_counter()
        cpu = engine.sweep(device="cpu", **kw)
        wall = time.perf_counter() - t0
        np.testing.assert_allclose(card.round_times, cpu.round_times,
                                   rtol=RTOL, atol=0,
                                   err_msg=f"[20b-{label}] card vs CPU")
        if (card.flags is None) != (cpu.flags is None) or (
                card.flags is not None
                and not np.array_equal(card.flags, cpu.flags)):
            raise AssertionError(f"[20b-{label}] flags differ card/CPU")
        d = np.abs(card.round_times.astype(np.float64) - cpu.round_times)
        log(f"[20b-{label}] the card's sweep from the seeds against the "
            f"CPU's ({wall:.1f} s there): round times max rel diff "
            f"{(d / cpu.round_times).max():g}"
            f"{', flags equal' if cpu.flags is not None else ''}; the "
            f"card's {RATES[f'20b-{label}']:.1f} rounds/s, "
            f"{counts['threefry']} threefry launches")


def phase_seed_layouts() -> None:
    """(c) phase 17a's and 17b's layouts, cut, inside a NCCL group of
    world size 1: bitwise the one-process sweeps, with the values each
    drew."""
    a = dict(scenario="paper-baseline", etas=(1.5,), seeds=8, n_rounds=20,
             n_clients=10_000)
    b = dict(scenario="paper-baseline", etas=(1.5,), seeds=2, n_rounds=10,
             n_clients=100_000, shard="clients", devices=8)
    flat_a, _ = run_sweep("20c", {"bandit_round_sampled": 8 * 20}, **a)
    one_b, _ = run_sweep("20c", {"topk_slots": 2 * 10}, **b)
    with process_group("20c"):
        grid, _ = run_sweep("20c", {"bandit_round_sampled": 8 * 20},
                            shard="grid", devices=4, **a)
        sweeps_equal("20c", grid, flat_a, "grid over 4 shards on NCCL rank "
                     f"0 against the flat sweep; drawn {grid.drawn}")
        seg, _ = run_sweep("20c", {"topk_slots": 2 * 10}, **b)
        sweeps_equal("20c", seg, one_b, "8 client blocks on NCCL rank 0 "
                     "(the candidate tops all-gathered) against the "
                     f"one-process sweep; drawn {seg.drawn}")


def phase_seed(results: dict) -> None:
    t0 = time.perf_counter()
    phase_threefry_kernel(results)
    phase_seed_sweeps()
    phase_seed_layouts()
    log(f"[20] phase time {time.perf_counter() - t0:.1f} s; "
        f"{card_name_and_power()}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs on "
                 "the card only")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    results = {name: dict(name=name, route="cuda", library_ms=None,
                          device_ms=None, **meta)
               for name, meta in KERNELS.items()}
    t0 = time.perf_counter()
    phase_device_and_build()
    phase_kernels(results)
    phase_paper_sweep(results)
    kernel_times(results, "bandit_round", g=24, k=100, s=5)
    phase_fast_path(results)
    kernel_times(results, "bandit_round_sampled", g=8, k=10_000, s=5)
    more_kernel_times(results)
    phase_real_size()
    phase_fedavg_kernel(results)
    phase_card_vs_cpu()
    phase_fl_full_width(results)
    phase_topk_kernel(results)
    phase_ucb_kernel(results)
    phase_segmented(results)
    phase_hierarchy()
    phase_lm(results)
    phase_griffin(results)
    phase_async(results)
    phase_train(results)
    phase_families(results)
    phase_devices(results)
    phase_mesh(results)
    phase_mesh_train(results)
    phase_seed(results)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(card_name_and_power())          # again, beside the results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms")
    extra = ("shapes", "split_device_ms", "async_launches", "train_launches",
             "fl_train_launches", "family_launches", "devices_launches",
             "offsets", "mesh_launches", "mesh_train_launches")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
        for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
