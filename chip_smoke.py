#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

In order: prints the card's name and power limit; builds every kernel
of the port with nvcc for sm_90a, one nvcc per source, all at once
(``src/repro_torch/kernels/csrc/``: the Eq. (20) consensus kernels B1-B3
in ``sign_agg.cu``, prefill attention B4 in ``flash_attention.cu`` --
two kernels by dtype, both on the tensor cores: f32 by 3xTF32
(``flash_fwd_tf32x3``) and bf16 (``flash_fwd_bf16``), whose registers and
spills per head dim are printed --, decode attention
B5 in ``decode_attention.cu`` -- one kernel, ``decode_cluster``, one
cluster launch per call --, the Mamba selective scan B6 in
``ssm_scan.cu``, B4's backward in ``flash_attention_bwd.cu``).

Training path (B1-B3): holds each kernel against its plain PyTorch
version on the card, bit for bit, at the main path's shapes, on the
reference's TPU test grid and at one bandwidth-bound shape, and each
also as the round calls it, one grouped launch over many leaves
(``check_groups``: B1/B2 ``sign_agg_group``, B3 ``sign_agg_int8_group``);
times kernel and plain version with CUDA events, each per round as one
grouped call beside eight one-leaf calls (``time_round``); trains the
BAFDP MLP_H24 traffic forecaster (``repro_torch.train.train_bafdp``, 10
clients, full width) for 20 rounds four times, once through each kernel,
checking each run's launch count (one a round); and runs 3 rounds on the
CPU and on the card from one state and compares them.

Sparse path (B2, B3 over the gathered block): trains through the O(S)
round on an event-driven schedule (``train_bafdp(schedule=build_schedule
(...), round_impl="sparse")``, MLP_H24 at full width, 10 clients, 20
rounds) three times: the f32 wire (B2, 20 launches), the int8 wire (B3
weighted, 20) and the streamed fold (no launch), the int8 and streamed
z bit-identical to the f32 run's (``sparse_runs``); holds B2 and B3 over
a gathered (64, D_l) block with ``n_total`` = 65,536 against their plain
versions bit for bit (``time_sparse_block``); runs 3 sparse rounds on the CPU and on the
card from one state under ``cpu_vs_cuda``'s drift rule, and the dense
active-scope round against the sparse one on the card
(``sparse_cpu_vs_cuda``); and runs 5 rounds on each wire at C=65,536
clients (38.4 GB of state), then 5 more on the f32 wire under each of
``robust_consensus="krum"`` and ``"trimmed_mean"``, holding the peak
memory to 2 GiB above the state over each wire's rounds and checking
that only the admitted rows move (``scale_round``).

Byzantine-robust path (B1, B2, B3): trains with every
``robust_consensus`` rule (trimmed mean, median, krum, centered clip)
under ``sign_flip`` at a Byzantine fraction of 0.3, MLP_H24 at full
width, 20 rounds, in the dense ``"all"`` scope (B1, one launch a round)
and in the sparse round on the schedule above (B2), and the trimmed mean
on the int8 wire (B3 weighted), its z bit-identical to the f32 run's
(``robust_runs``); runs the dense active scope against the sparse round
per rule (drift rule, bit identity printed) and the trimmed mean on the
CPU against the card (``robust_cpu_vs_cuda``); trains every baseline of
``train.METHODS`` for 10 rounds (no consensus launch) and prints Table IV
(quick, 20 rounds: 40 B1 launches) (``baseline_runs``).

Paper evaluation (B1, B2, B3): runs each of the paper's evaluation
suites on the card through its entry point, ``main(rounds=20,
quick=True)``: Tables II/III (the privacy budget), Fig. 3 (the privacy
level), Figs. 4-6 (synchronous against asynchronous on simulated
wall-clock, and the eight fleet scenarios), Fig. 7, Theorem 1 (the
convergence order) and Fig. 8, checking each suite's row labels, finite
values and B1/B2/B3 launches (one a round a run, the kernel chosen by the
run's wire and decay), and that each Figs. 4-6 run saw its schedule's
active clients; then prints the claim verdicts of ``summarize_claims``
over these rows and Table IV's (``paper_runs``).

Serving path (B4, B5): holds both attention kernels against their plain
versions (the reference's TPU test grid in f32 and bf16, Sq < Sk, ragged
lengths, the full-width SmolLM-360M shapes; abs/rel 3e-5 in f32, one
bf16 rounding of the output in bf16: see ``attn_tol``), and B4 f32 over
16,384-key rows within a stated max |err| (``LONG_ROW``); times them at
full width beside their bound, the plain version and PyTorch's
``scaled_dot_product_attention`` (B5 at B=8 x 4096 and at the serving
lengths), and B4 f32 at head dims 128 and 256; runs a full-width
SmolLM-360M prefill step (B=4, S=4096: 32 B4 launches) and a
``ServeEngine.generate`` of 8 requests (32 B5 calls per step, one launch
each: 9,216 in 288 steps), counting launches; and runs
the same weights on the CPU and on the card through a prefill step and
40 decode steps and compares the logits and the greedy tokens.

Hymba path (B4, B5, B6): holds B6 against its plain version on the card,
bit for bit (the reference's TPU test grid, the prefill chunk shape
(4, 128, 1600, 16), a nonzero initial state, bf16 inputs, odd shapes),
and B4/B5 at Hymba's heads (25/5) in bf16 within ``attn_tol``; times B6
at the chunk shape and at (1, 4096, 1600, 16) and B4/B5 at Hymba's
shapes; runs a full-width Hymba-1.5B prefill step (B=4, S=4096: 32 B4
and 32 x 32 = 1,024 B6 launches) and a ``ServeEngine.generate`` of the
same 8 requests as SmolLM's (B5 in every layer, no B6), counting
launches; and, in an f32 copy of the config, compares the CPU and the
card (a 2 x 160-token prompt, which crosses a 128-step chunk and needs
padding, then 24 decode steps) and the card's prefill against its
token-by-token decode of the same prompt (5e-4, the reference's bound).

MoE path (B4, B5 in bf16 at head dims 64 and 128): holds B4 and B5 at
Granite-MoE-3B-a800m's heads (24/8 x 64) and OLMoE-1B-7B's (16/16 x 128)
against their plain versions within ``attn_tol`` and times them there
(``moe_attention``); serves each model at full width (32 and 16
layers, bf16 compute, ``models/moe.py``'s scatter form): a prefill step
(B=4, S=4096: B4 once per layer, the (token, slot) pairs its capacity
drops counted) and the same generate as SmolLM's (B5 once per layer per
step); runs one Granite MoE layer in both forms, scatter and einsum, at
capacity factor 4 (no drops), f32 within 1e-4 of each other and bf16
each within 2^-5 (RMS) of the f32 result (``moe_forms``); and runs a
2-layer f32 copy of Granite on the CPU and on the card from the same
weights, the routing equal but at near-ties (gap < 1e-5, counted) and
the logits within 2e-3 where nothing flipped.

The rest of LM serving (B4, B5; no kernel for xLSTM), three phases, each
at full width from seed-0 random weights: ``xlstm_serve`` (xLSTM-1.3B,
[7 x mLSTM, sLSTM] x 6, bf16 compute), ``encdec_serve`` (SeamlessM4T-
medium, 12 encoder + 12 decoder layers, f32) and ``vlm_serve``
(LLaVA-NeXT-Mistral-7B, 32/8 x 128, bf16).  Each holds B4 and B5 at its
model's shapes against their plain versions within ``attn_tol`` and
times them (``hold_and_time_attention``: SeamlessM4T's encoder, 1,500 x
1,500 frames, and cross-attention, 4,096 x 1,500, both without the mask,
B5 over a 512 cache and over the 1,500-frame memory; LLaVA's causal
prefill and its decode at 32/8 x 128); runs a prefill step (B=4, 4,096
positions: xLSTM's tokens; SeamlessM4T's tokens beside 1,500 frames;
LLaVA's 2,880 patch positions, then 1,216 tokens) and the same generate
as SmolLM's (SeamlessM4T's engines first get ``encode`` of random frames
as their memory), checking the launches: none for xLSTM, B4 36 a prefill
and B5 24 a decode step for SeamlessM4T (encoder, self, cross), 32 and
32 for LLaVA; and runs the 2-layer f32 smoke model of each family on the
CPU and on the card (``smoke_cpu_vs_cuda``: logits within 2e-3, greedy
tokens equal; for xLSTM the card's prefill against its decode at 5e-4).

The dense models with their own head shapes (B4, B5 in bf16), each at
full width from seed-0 random weights after RoPE's frequencies are held
equal on both devices (``rope_cpu_vs_cuda``): ``dense_serve_gemma``
(Gemma-7B, 28 layers, 16/16 x 256) and ``dense_serve_phi3``
(Phi3-medium-14B, 40 layers, 40/10 x 128), each as ``serve_phase``
(B4/B5 held and timed at its shapes, a prefill step, a generate, the
smoke model's CPU vs card), and before its weights go
``window_decode``: the reference's ``long_500k`` decode, a ring of
``decode_window`` = 8,192 slots at B=1 filled with seeded K/V, 16 greedy
steps at positions 524,280-524,295 across the ring's wrap, each step's
written slot asserted, B5 at (1, 8,192) held and timed, one B5 launch
per layer a step, and the smoke model through a ring of 8 at the same
steps on the CPU and on the card (``window_cpu_vs_cuda``).

LM training path (B1, B4 and B4's backward, ``lm_train``): holds B4's
backward (``flash_attention_bwd.cu``: dQ with delta, each query head's dK
and dV, their sum per KV head, three launches a call; on the tensor
cores, f32 by 3xTF32) against its plain version
(``ref.flash_attention_bwd_ref``) within BWD_ATOL + BWD_RTOL |plain|
elementwise at SmolLM-360M's training shape (1 x 4,096, 15/5 x 64,
causal), with a window, at SeamlessM4T's (16/16: without a mask at the
4,096 x 1,500 cross and 1,500 x 1,500 encoder shapes, causal at 4,096)
and at the ``100m`` families' (4 x 128, 8/4, causal), and two calls bit
for bit; B4's output bit for bit
with and without its log-sum-exp output at SmolLM's prefill shape and
SeamlessM4T's cross shape; times the backward at the training shape
beside its bound (3xTF32 roof, and the f32 CUDA cores' as
``simt_bound_ms``), its plain version and SDPA's f32 backward; trains
SmolLM-360M at full width (f32, remat) for 3 BAFDP rounds through
``launch.steps.make_train_step`` (4 clients, one 4,096-token sequence
each, ``sign_flip`` at a Byzantine fraction of 0.25), checking the
launches (a round: B1 once, B4 2 x 32 x 4 with remat's recompute, its
backward 32 x 4 calls x 2), finite losses and weights and that W moved,
and printing ms per round, peak memory and the card's busy share (the
last round under ``torch.profiler``); and runs the 2-layer smoke model
through the same step on the CPU and on the card (C=2, every client
active, the LDP noise below rounding) under ``drift_check``.

The rest of LM training (B1, B4 f32 and bf16 and both backwards, B6 and
its backward): holds B4's bf16 output with and without its lse bit for
bit (Hymba-1.5B's prefill and training shapes) and the lse within
LSE_ATOL + LSE_RTOL |lse| of the plain version's; B4's bf16 backward
against its plain version within BWD_ATOL + BWD_RTOL |plain| plus one
bf16 ulp of the plain value, elementwise, at Hymba's training shape,
with a window and at Sq != Sk, two calls bit for bit; times it beside
its bound, the plain version and SDPA's bf16 backward, and B4 with its
lse at B=1 in both dtypes (``check_flash_bwd_bf16``); times the
backward kernel by kernel (dq, dK/dV, their sum) at BWD_TIMED, every
full-width training shape, beside the bound and SDPA's backward
(``time_flash_bwd_parts``); holds B6's
backward (``ssm_scan.cu``'s ``ssm_scan_bwd_kernel``, the reverse
recurrence) against ``ref.ssm_scan_bwd_ref`` bit for bit and times it at
Hymba's chunk and over 4,096 steps (``check_scan_bwd``); trains
Hymba-1.5B at full width (bf16 compute, remat, C=2, one 4,096-token
sequence each; a round launches B1 once, B4 128 times, its bf16 backward
128, B6 4,096 and B6's backward 2,048), runs its smoke model on the CPU
and on the card under ``drift_check`` and its bf16 ``loss_fn`` gradient
on the card under the bf16 policy's rule (``lm_train_hymba``,
``lm_train_cpu_vs_cuda``, ``bf16_grad_check``); trains SeamlessM4T-medium
at full width (f32, remat, C=2, 4,096 tokens beside 1,500 frames: B4 144
and its backward 144 a round, ``lm_train_seamless``); and trains
Granite-MoE, OLMoE, LLaVA-NeXT-Mistral, Gemma-7B, Phi3-medium and xLSTM
at the reference example's ``100m`` scale (C=4, 4 x 128, 3 rounds each;
xLSTM launches B1 only, ``lm_train_100m``), every run's launches
asserted exactly.  The LM training phases run under the training entry
point's allocator policy (``launch.train.use_expandable_segments``).
Then checkpoints (``lm_resume``, B1 and B4 with its backward): the port
of ``examples/federated_lm_training.py`` saves, restores (bit for bit on
the card) and resumes at the smoke scale, its first resumed round held
against the same round from the state in memory; runs at the 100m scale
under both servers, printing the save and restore seconds and the
archive's bytes; and ``launch.train --ckpt`` resumes at its label.

Placement (B1, B4 and its backward, B5): the reference's sharding plan
as DTensor placements on the host mesh (``launch.mesh.
registered_host_mesh``: 1 x 1, one NCCL rank).  ``placed_serve``:
Granite-MoE-3B-a800m (einsum form) prefilled through ``launch.steps.
prefill_setup`` under the variants ``einsum_moe`` and
``einsum_moe_gshard`` (``moe_group_shard``), Phi3-medium-14B under no
variant and ``seqpar16`` (``attn_seq_shards``), each pair's logits bit
for bit equal, and Phi3's long_500k window decode through
``decode_setup`` bit for bit equal to ``window_decode``'s logits;
``placed_train``: SmolLM-360M's lm_train rounds again through
``train_setup`` on the placed state, its per-leaf digests equal to
lm_train's; ``variant_train``: ``launch.train --variant
inner_dp+signs8+noremat`` at full width (the cfg patch only: B1, no B3,
no recompute).  Every placed tensor's local shard is the tensor itself
(same storage), and every run's launches are asserted.

Any failed check raises.  Each phase prints its seconds.  The last line
is the JSON result; the line before it lists the kernels with their
launches (summed over the main-path runs: B1's include the robust dense
runs, Table IV's BAFDP rows and the paper suites' constant-decay runs,
B2's and B3's the sparse, robust and scale runs and the Figs. 4-6
scenarios) and times.  Its B1-B3 entries
(B1's also the lm_train, placed_train, variant_train and lm_resume
rounds) give ``kernel`` (the f32 instance's
ptxas label) with ``ptxas`` (its
and the bf16 instance's registers and spills), the time per round of the
8 leaves as one grouped call, ``call_ms`` (its host time) and, as
``one_leaf_ms``/``one_leaf_call_ms``, the same round in eight one-leaf
calls, and, as ``bandwidth_ms``/``bandwidth_bound_ms``, the bandwidth
shape, and (B2, B3 weighted) as ``sparse_block_ms``/
``sparse_block_bound_ms`` the grouped call over a gathered (64, D_l)
block of the 8 leaves with ``n_total`` = 65,536 (``scale_round``'s).  Its
``flash_attention`` entry gives B4's f32 kernel (``f32_kernel``, its
ptxas label: name and tiles at head dim 64) at SmolLM-360M's prefill
shape, with ``bound_ms`` its 3xTF32 tensor-core roof and
``simt_bound_ms`` the f32 CUDA cores' roof of the same work, and, as
``bf16_ms``, ``bf16_bound_ms`` and ``bf16_library_ms``, the bf16 kernel
(``bf16_kernel``) at Hymba-1.5B's.  Its ``decode_attention`` entry gives
B5 at B=8 x 4096 valid positions (f32), then as ``serving_*`` at
SmolLM-360M's serving shape (f32) and as ``bf16_*`` at Hymba-1.5B's, with
``ptxas``: registers and spills of the instances those and the MoE
models launch.  B4's and B5's ``moe`` lists give each at each MoE
model's shape, bf16 (``kernel``: the instance, ms, bound, plain and
SDPA ms), and their ``encdec`` and ``vlm`` lists the same at
SeamlessM4T's and LLaVA's shapes, their ``dense`` lists at Gemma-7B's
and Phi3-medium's (B5's also at the 8,192-slot ring); their launches
include the MoE, SeamlessM4T, LLaVA, Gemma and Phi3 runs (B5's the
window decodes, placed_serve's too), B4's also placed_serve's prefills
and the lm_train, placed_train, variant_train and lm_resume rounds.  Its
``flash_attention_bwd`` entry (no TPU counterpart) gives the f32 backward
at SmolLM-360M's training shape, with ``simt_bound_ms``, each kernel's
ms (``dq_ms``, ``dkdv_ms``, ``sum_ms``), the ptxas lines and the
``registers`` and spill bytes of its three kernels, and as ``seamless``
the same rows at SeamlessM4T-medium's decoder and cross shapes; its
launches are the f32 training rounds' (SmolLM-360M, SeamlessM4T-medium,
the 100m families, placed_train's, variant_train's, lm_resume's).  Its
``flash_attention_bwd_bf16`` entry gives the
bf16 instances at Hymba's training shape, launched by Hymba's rounds;
B4's entry gains
``autograd_fwd_b1`` (the forward with its lse at B=1, f32 and bf16).
``ssm_scan_bwd`` (no TPU counterpart) gives B6's backward at Hymba's
chunk, with B6's forward there at B=1; ``ssm_scan``'s launches include
Hymba's training rounds.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Per-shape details also go to
``build/chip_smoke.json``.
"""
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PSI, ALPHA = 0.005, 0.01
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12      # H100 SXM tf32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
N_CLIENTS, ROUNDS = 10, 20
# scale_round: C clients of MLP_H24, S_max deliveries a round, rounds per
# wire, and the bound on the peak above the state (one dense (C, D) f32
# intermediate is 7.67 GB)
SCALE_C, SCALE_S, SCALE_ROUNDS = 65_536, 64, 5
SCALE_PEAK_BYTES = 2 << 30
MAIN_LEAF_D = [128, 2816, 128, 16384, 64, 8192, 24, 1536]   # MLP_H24
# MLP_H1, the model of every paper suite (paper_runs), and the client
# counts its runs launch B1-B3 at: Tables II/III, Figs. 3 and 8 C=10,
# Figs. 4-6 C=8, Theorem 1 C=6
PAPER_LEAF_D = [128, 2816, 128, 16384, 64, 8192, 1, 64]
PAPER_CLIENTS = (10, 8, 6)
# robust_runs: every robust_consensus rule in Table IV's setting (sign_flip
# at a Byzantine fraction of 0.3, trim 0.35), dense and sparse; the dense
# active scope against the sparse round over PARITY_ROUNDS; the baselines
# at H=1 over BASELINE_ROUNDS; Table IV (quick) over TABLE4_ROUNDS
ROBUST_RULES = ("trimmed_mean", "median", "krum", "centered_clip")
ROBUST_TRIM = 0.35
ROBUST_KNOBS = dict(attack="sign_flip", byzantine_frac=0.3,
                    robust_trim_frac=ROBUST_TRIM)
PARITY_ROUNDS, BASELINE_ROUNDS, TABLE4_ROUNDS = 3, 10, 20
# paper_runs: each evaluation suite's quick grid at PAPER_ROUNDS rounds,
# with the row labels the CPU tests hold to the reference's
# (tests/test_torch_train.py::test_chip_smoke_holds_the_reference_labels)
PAPER_ROUNDS = 20
PAPER_LABELS = {
    "table23": ["table23/milano/H1/a10", "table23/milano/H1/a40"],
    "fig3": ["fig3/milano"],
    "fig456": ["fig456/milano"] + [
        f"fig456/milano:{name}" for name in (
            "age_adaptive", "battery_tail", "diurnal", "fedbuff", "flap",
            "flash_crowd", "regional_outage", "surge")],
    "fig7": [f"fig7/ratio{r}" for r in (0.2, 0.4, 0.6, 0.8, 1.0)],
    "theorem1": ["theorem1/slope"],
    "fig8": ["fig8/ratio0.8", "fig8/ratio0.4", "fig8/ratio0.0",
             "fig8/ratio0.4-tm"],
}
# the claims of summarize_claims that the quick rows give: claim 1 needs
# Table I, claim 2 Table IV's BAFDP rows at ratios 0 and 0.3 (quick has
# 0.1 only), claim 8 a sweep of at least 3 budgets (quick has 2).  At
# PAPER_ROUNDS rounds claims 5 and 6 cannot fail: claim 5 lets a ratio
# take 30 rounds more than the next, and Theorem 1's ladder is anchored
# at round 20 (the last), so its slope is at most log 20 / log 8 < 2.2.
# Only the full run's verdicts count for them.
PAPER_CLAIMS = ["3", "4", "5", "6", "7"]
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = f"{CSRC}/sign_agg.cu"
TPU_SRC = "src/repro/kernels/sign_agg.py"

# The serving path: SmolLM-360M at full width (configs/smollm_360m.py).
ARCH = "smollm-360m"
PREFILL_B, PREFILL_S = 4, 4096              # one full-width prefill step
DECODE_B, DECODE_L = 8, 4096                # B5 timed at this cache
SERVE_REQUESTS, SERVE_PROMPT = 8, (16, 256)  # prompt lengths drawn in range
SERVE_MAX_NEW, SERVE_CACHE = 32, 512
SERVE_LENS = [16, 40, 100, 200, 256, 300, 400, 512]   # B5's serving rows
VS_ROWS, VS_PROMPT, VS_STEPS = 2, 32, 8     # serve_cpu_vs_cuda

# The Hymba path: Hymba-1.5B at full width (configs/hymba_1_5b.py), the
# same prefill and generate traffic as SmolLM's.
HYMBA = "hymba-1.5b"
SCAN_CHUNK = 128                            # models/ssm.MAMBA_CHUNK
SCAN_TIMED = [(PREFILL_B, SCAN_CHUNK, 1600, 16), (1, 4096, 1600, 16)]

# B4 f32 at the other head dims it takes, causal S=4096 (B, S, H, Hkv, D):
# LLaVA-NeXT-Mistral-7B's heads and Gemma-7B's; no served model uses them.
FLASH_HEAD_DIMS = [(2, 4096, 32, 8, 128), (1, 4096, 16, 16, 256)]
# B4 f32 over long rows: one KV group of SmolLM-360M's heads, causal.  The
# tensor cores truncate their f32 sums, so one mma chain over a row grows
# its error with the row; the f32 kernel sums each key tile's P V on its
# own.  Max |err| on the H100: 1.8e-6 summed per tile, 8.5e-6 on one chain
# (PERF.md §6); LONG_ROW_MAX_ERR lies between and fails the latter.
LONG_ROW = (1, 16384, 16384, 3, 1, 64)
LONG_ROW_MAX_ERR = 4e-6
HYMBA_VS_ROWS, HYMBA_VS_PROMPT = 2, 160     # crosses one chunk, padded
HYMBA_VS_DECODE, HYMBA_VS_STEPS = 16, 8     # decode: prompt + greedy steps

# The MoE path: Granite-MoE-3B-a800m (24/8 heads x 64) and OLMoE-1B-7B
# (16/16 x 128) at full width (configs/granite_moe_3b_a800m.py,
# olmoe_1b_7b.py), bf16 compute, the same prefill and generate traffic as
# SmolLM's.  CPU vs card: an f32 copy of Granite cut to MOE_VS_LAYERS
# layers over a MOE_VS_ROWS x MOE_VS_PROMPT prompt; routing may differ only
# where the CPU's top-k gap is below MOE_NEAR_TIE.  Scatter vs einsum: one
# Granite MoE layer over MOE_FORMS_BS tokens at capacity factor 4.
MOE_ARCHS = ("granite-moe-3b-a800m", "olmoe-1b-7b")
MOE_VS_LAYERS, MOE_VS_ROWS, MOE_VS_PROMPT = 2, 2, 64
MOE_NEAR_TIE = 1e-5
MOE_FORMS_BS = (4, 1024)

# The rest of LM serving at full width, the same prefill and generate
# traffic as SmolLM's (PREFILL_S positions; an encoder-decoder's frames
# beside them): xLSTM-1.3B (configs/xlstm_1_3b.py: [7 x mLSTM, sLSTM] x 6,
# d 2048, bf16 compute; no kernel of the port), SeamlessM4T-medium
# (seamless_m4t_medium.py: 12 encoder and 12 decoder layers, 16/16 x 64,
# f32, 1,500 frames) and LLaVA-NeXT-Mistral-7B (llava_next_mistral_7b.py:
# 32 layers, 32/8 x 128, bf16; 2,880 patch positions, then 1,216 text
# tokens).  CPU vs card: each one's 2-layer f32 smoke model
# (reduce_for_smoke) over SMOKE_VS_ROWS x SMOKE_VS_S positions, then
# SMOKE_VS_DECODE decode steps and a generate of SMOKE_VS_NEW tokens.
XLSTM, SEAMLESS, LLAVA = ("xlstm-1.3b", "seamless-m4t-medium",
                          "llava-next-mistral-7b")
SMOKE_VS_ROWS, SMOKE_VS_S, SMOKE_VS_DECODE, SMOKE_VS_NEW = 2, 64, 24, 8
# The dense models with head dims and groups no other model has, at full
# width (configs/gemma_7b.py: 28 layers, d 3,072, 16/16 x 256, GeGLU d_ff
# 24,576, vocab 256,000; phi3_medium_14b.py: 40 layers, d 5,120, 40/10 x
# 128, SwiGLU d_ff 17,920, vocab 100,352; bf16 params and compute), the
# same prefill and generate traffic as SmolLM's, then (window_decode) the
# reference's long_500k decode: launch.steps.decode_window's ring of
# cfg.sliding_window = 8,192 slots at B=1, filled with seeded K/V, for
# the WINDOW_STEPS of long_500k's positions that cross the ring's wrap.
# CPU vs card: each smoke model through a ring of WINDOW_SMOKE slots at
# the same steps.  ROPE_HEAD_DIMS: RoPE's frequencies on both devices.
GEMMA, PHI3 = "gemma-7b", "phi3-medium-14b"
WINDOW_STEPS = range(524_280, 524_296)
WINDOW_SMOKE = 8
# Placement (placed_serve, placed_train, variant_train): the variant pairs
# whose prefill logits must be equal, and the launcher's variant, trained
# at lm_train's shape (LM_TRAIN_CLIENTS sequences of LM_TRAIN_S tokens).
PLACED_PAIRS = {"granite-moe-3b-a800m": ("einsum_moe", "einsum_moe_gshard"),
                "phi3-medium-14b": ("", "seqpar16")}
TRAIN_VARIANT = "inner_dp+signs8+noremat"
ROPE_HEAD_DIMS, ROPE_THETAS = (64, 128, 256), (1e4, 5e5)
# Checkpoints and resume (lm_resume): examples/federated_lm_training.py's
# port at the smoke scale for RESUME_STEPS[0] rounds, then resumed to
# RESUME_STEPS[1]; once at the 100m scale for RESUME_100M_STEPS rounds
# per server with RESUME_100M_CLIENTS clients (a cut from the example's
# 4: np.savez_compressed deflates ~20-25 MB/s on one core, and C=4's
# 1.85 GB state would take ~80 s a save); launch.train --smoke --ckpt
# for LAUNCH_STEPS[0], then resumed to LAUNCH_STEPS[1].
RESUME_STEPS, RESUME_100M_STEPS, LAUNCH_STEPS = (6, 9), 4, (3, 5)
RESUME_100M_CLIENTS = 2

# LM training (lm_train): SmolLM-360M at full width (32 layers, d 960,
# 15/5 heads x 64, vocab 49,152, f32, remat) trains LM_TRAIN_ROUNDS BAFDP
# rounds through launch.steps.make_train_step, C = LM_TRAIN_CLIENTS
# clients with one LM_TRAIN_S-token sequence each (the train_4k shape's
# global batch of 256 does not fit one card at this width: a cut), the
# knobs of examples/federated_lm_training.py.  B4's backward is held to
# its plain version within BWD_ATOL + BWD_RTOL |plain| elementwise (f32
# sums in another order; stated before the kernel's first chip run) at
# BWD_CASES: every shape a training phase gives it (SmolLM's, SeamlessM4T's
# cross-attention, encoder and decoder self-attention, the ``100m``
# families' at B=4, lm_resume's smoke example and ``launch.train
# --smoke``) and a window.  B4's output with and without its
# log-sum-exp, bit for bit, at LSE_CASES: SmolLM's prefill,
# SeamlessM4T's cross shape and lm_resume's three training shapes.  CPU vs card: the 2-layer smoke model, C=2,
# LM_TRAIN_ROUNDS rounds, the noise below rounding (LM_VS_BUDGET).
LM_TRAIN_CLIENTS, LM_TRAIN_S, LM_TRAIN_ROUNDS = 4, 4096, 3
LM_TRAIN_KNOBS = dict(byzantine_frac=0.25, attack="sign_flip", alpha_w=2e-2)
BWD_ATOL, BWD_RTOL = 1e-5, 1e-4
BWD_CASES = [(1, 4096, 4096, 15, 5, 64, True, 0),      # SmolLM training
             (1, 4096, 4096, 15, 5, 64, True, 1024),   # a sliding window
             (1, 4096, 1500, 16, 16, 64, False, 0),    # SeamlessM4T cross
             (1, 1500, 1500, 16, 16, 64, False, 0),    # SeamlessM4T encoder
             (1, 4096, 4096, 16, 16, 64, True, 0),     # SeamlessM4T decoder
             (4, 128, 128, 8, 4, 64, True, 0),         # the 100m families
             (4, 128, 128, 4, 2, 64, True, 0),         # the smoke example
             (2, 64, 64, 4, 2, 64, True, 0)]           # launch.train --smoke
LSE_CASES = [(PREFILL_B, 4096, 4096, 15, 5, 64, True),
             (PREFILL_B, 4096, 1500, 16, 16, 64, False),
             (4, 128, 128, 8, 4, 64, True),
             (4, 128, 128, 4, 2, 64, True),
             (2, 64, 64, 4, 2, 64, True)]
LM_VS_CLIENTS, LM_VS_B, LM_VS_S = 2, 2, 128
LM_VS_BUDGET = 1e18      # eps = 5e17: sigma ~ 5e-19, below every ulp
# The other families' training (lm_train_families).  SeamlessM4T-medium
# (12 + 12 layers, d 1,024, 16/16 x 64, f32, remat) and Hymba-1.5B (32
# HYMBA layers, d 1,600, 25/5 x 64, bf16 compute, f32 params, remat) at
# full width: C = LM_FULL_CLIENTS clients (the federated state keeps 3C + 1
# copies of the tree: 24.6 and 39.3 GB), one LM_TRAIN_S-token sequence
# each (SeamlessM4T's beside 1,500 frames), LM_TRAIN_ROUNDS rounds, the
# last under the profiler.  The rest at the reference example's ``100m``
# scale (examples/federated_lm_training.py: 8 layers, d 512, 8/4 x 64,
# d_ff 2048, vocab 8192, f32, no remat; configs.scale_cfg is its copy),
# with the example's defaults: C = 4, batch 4, seq 128, a Byzantine
# fraction of 0.25, LM_100M_ROUNDS rounds each.  xLSTM's 100m config
# keeps the smoke variant's two-entry pattern, which fails its 8-layer
# ``pattern()`` check in the example as here: the chip tiles it to 8
# layers (lm100m_config).
LM_FULL_CLIENTS = 2
LM_100M_ARCHS = ("granite-moe-3b-a800m", "olmoe-1b-7b",
                 "llava-next-mistral-7b", "gemma-7b", "phi3-medium-14b",
                 "xlstm-1.3b")
LM_100M_CLIENTS, LM_100M_B, LM_100M_S, LM_100M_ROUNDS = 4, 4, 128, 3
LM_100M_KNOBS = dict(byzantine_frac=0.25, attack="sign_flip", alpha_w=2e-2)
# Scan backward (check_scan_bwd): B6's backward at Hymba's chunk and over a
# whole 4,096-token sequence, timed against its bytes bound.
SCAN_BWD_TIMED = [(1, SCAN_CHUNK, 1600, 16), (1, 4096, 1600, 16)]
# B4's bf16 backward (check_flash_bwd_bf16) at Hymba's heads: its output
# with and without the lse at BF16_LSE_CASES (the prefill and the training
# shape), the lse within LSE_ATOL + LSE_RTOL |lse| of the plain version's
# (f32 sums of exp2 in another order), the backward within BWD_ATOL +
# BWD_RTOL |plain| plus one bf16 ulp of the plain value at BF16_BWD_CASES
# (both compute in f32 from the same bf16 inputs and round once).
BF16_LSE_CASES = [(PREFILL_B, 4096, 4096, 25, 5, 64, True, 0),
                  (1, 4096, 4096, 25, 5, 64, True, 0)]
BF16_BWD_CASES = [(1, 4096, 4096, 25, 5, 64, True, 0),     # Hymba training
                  (1, 4096, 4096, 25, 5, 64, True, 1024),  # a window
                  (1, 4096, 1500, 16, 16, 64, False, 0)]   # Sq != Sk
LSE_ATOL, LSE_RTOL = 1e-5, 1e-6
# B4's backward timed kernel by kernel (time_flash_bwd_parts): dq, the
# per-head dK/dV kernel and their sum apart, beside the bound and SDPA's
# backward, at every full-width training shape: (model, (B, Sq, Sk, H,
# Hkv, D, causal), dtype).
BWD_TIMED = [("smollm-360m", (1, 4096, 4096, 15, 5, 64, True), "float32"),
             ("seamless-m4t-medium decoder", (1, 4096, 4096, 16, 16, 64,
                                              True), "float32"),
             ("seamless-m4t-medium cross", (1, 4096, 1500, 16, 16, 64,
                                            False), "float32"),
             ("hymba-1.5b", (1, 4096, 4096, 25, 5, 64, True), "bfloat16")]


def log(msg: str) -> None:
    print(msg, flush=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns; NaN positions equal whatever their payload."""
    a, b = a.float().cpu(), b.float().cpu()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32),
                                b[~nan].view(torch.int32)))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    ok = ~(torch.isnan(a) | torch.isnan(b))
    return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0


def call_ms(fn, reps: int = 25, inner: int = 10, warmup: int = 5) -> float:
    """Time per call as the main path pays it, host work included: the
    median over ``reps`` CUDA-event samples of ``inner`` back-to-back
    calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def sleep_cycles_per_ms() -> float:
    """Clock of ``torch.cuda._sleep``, measured with CUDA events."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, cycles_per_ms: float, reps: int = 25,
              inner: int = 10) -> float:
    """Device time per call: as :func:`call_ms`, but each sample starts
    behind a ``torch.cuda._sleep`` long enough for the host to enqueue
    all ``inner`` calls, so the launches run back to back on the card
    and the host's Python time drops out."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 0.05)))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def make_inputs(C: int, D: int, dtype: torch.dtype, seed: int,
                edge_cases: bool = True):
    """z, W, phi in ``dtype``; weights f32; the int8 sign payload.  With
    ``edge_cases``: NaN columns and exact ties (sign 0)."""
    from repro_torch.distributed import collectives

    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(D, generator=g, device="cuda")
    W = torch.randn(C, D, generator=g, device="cuda")
    phi = torch.randn(D, generator=g, device="cuda") * 0.01
    sw = torch.rand(C, generator=g, device="cuda") * 0.95 + 0.05
    if edge_cases and D >= 16:
        W[0, :5] = float("nan")
        W[C - 1, 5:9] = z[5:9]
    z, W, phi = z.to(dtype), W.to(dtype), phi.to(dtype)
    payload = collectives.encode_sign_message(z, W).payload
    return {"z": z, "W": W, "phi": phi, "sw": sw, "payload": payload}


def kernel_specs():
    """The four ways the main path reaches B1-B3: one-leaf wrapper, plain
    version, grouped call over every leaf of a round (``group``: the round
    ``r`` of lists, weights, ``n_total``) and its plain version, bytes
    moved, the FedConfig knobs that select it and the launches a round
    makes (one grouped launch over every leaf)."""
    from repro_torch.kernels import ref, sign_agg as sa

    def vec_bytes(x):
        return 3 * x["z"].numel() * x["z"].element_size()

    f32_group = dict(
        kernel_name="sign_agg_group", rows="W", per_round=1,
        group=lambda r, w, n: sa.sign_agg_group(
            r["z"], r["W"], r["phi"], w, PSI, ALPHA, n_total=n),
        group_plain=lambda r, w, n: ref.sign_agg_group_ref(
            r["z"], r["W"], r["phi"], w, PSI, ALPHA, n_total=n))
    int8_group = dict(
        kernel_name="sign_agg_int8_group", rows="payload", per_round=1,
        counter="sign_agg_weighted_int8", replaces=f"{TPU_SRC}:160",
        group=lambda r, w, n: sa.sign_agg_int8_group(
            r["z"], r["payload"], r["phi"], w, PSI, ALPHA, n_total=n),
        group_plain=lambda r, w, n: ref.sign_agg_int8_group_ref(
            r["z"], r["payload"], r["phi"], w, PSI, ALPHA, n_total=n))
    return [
        dict(f32_group, name="sign_agg", counter="sign_agg",
             replaces=f"{TPU_SRC}:58",
             knobs=dict(sign_message="f32", staleness_decay="constant"),
             weighted=False,
             kernel=lambda x: sa.sign_agg(x["z"], x["W"], x["phi"], PSI,
                                          ALPHA),
             plain=lambda x: ref.sign_agg_ref(x["z"], x["W"], x["phi"], PSI,
                                              ALPHA),
             nbytes=lambda x: x["W"].numel() * x["W"].element_size()
             + vec_bytes(x),
             flops=lambda x: 2 * x["W"].numel()),
        dict(f32_group, name="sign_agg_weighted",
             counter="sign_agg_weighted", replaces=f"{TPU_SRC}:100",
             knobs=dict(sign_message="f32", staleness_decay="poly"),
             weighted=True,
             kernel=lambda x: sa.sign_agg_weighted(
                 x["z"], x["W"], x["phi"], x["sw"], PSI, ALPHA),
             plain=lambda x: ref.sign_agg_weighted_ref(
                 x["z"], x["W"], x["phi"], x["sw"], PSI, ALPHA),
             nbytes=lambda x: x["W"].numel() * x["W"].element_size()
             + vec_bytes(x) + 4 * x["sw"].numel(),
             flops=lambda x: 3 * x["W"].numel()),
        dict(int8_group, name="sign_agg_weighted_int8/weighted",
             knobs=dict(sign_message="int8", staleness_decay="poly"),
             weighted=True,
             kernel=lambda x: sa.sign_agg_weighted_int8(
                 x["z"], x["payload"], x["sw"], x["phi"], PSI, ALPHA),
             plain=lambda x: ref.sign_agg_int8_ref(
                 x["z"], x["payload"], x["sw"], x["phi"], PSI, ALPHA),
             nbytes=lambda x: x["payload"].numel() + vec_bytes(x)
             + 4 * x["sw"].numel(),
             flops=lambda x: 2 * x["payload"].numel()),
        dict(int8_group, name="sign_agg_weighted_int8/unweighted",
             knobs=dict(sign_message="int8", staleness_decay="constant"),
             weighted=False,
             kernel=lambda x: sa.sign_agg_weighted_int8(
                 x["z"], x["payload"], None, x["phi"], PSI, ALPHA),
             plain=lambda x: ref.sign_agg_int8_ref(
                 x["z"], x["payload"], None, x["phi"], PSI, ALPHA),
             nbytes=lambda x: x["payload"].numel() + vec_bytes(x),
             flops=lambda x: x["payload"].numel()),
    ]


def bound_ms(spec, x):
    """The least time for this call: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes = spec["nbytes"](x) / HBM_BYTES_PER_S * 1e3
    t_ops = spec["flops"](x) / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernels(specs, report):
    """Every kernel against its plain version on the card, bit for bit."""
    from repro_torch.kernels import ref, sign_agg as sa

    shapes = [("main", N_CLIENTS, d, torch.float32) for d in MAIN_LEAF_D]
    shapes += [("tpu_grid", c, d, dt) for d in (128, 1024, 5000, 8193)
               for c in (2, 16) for dt in (torch.float32, torch.bfloat16)]
    shapes += [("tpu_grid", 200, d, dt) for d in (600, 8193)
               for dt in (torch.float32, torch.bfloat16)]
    shapes += [("bandwidth", 64, 4_194_304, torch.float32)]
    n = 0
    grid = []
    cpm = sleep_cycles_per_ms()
    for spec in specs:
        spec["max_abs_err"] = 0.0
    for i, (tag, C, D, dt) in enumerate(shapes):
        x = make_inputs(C, D, dt, seed=i)
        for spec in specs:
            got, want = spec["kernel"](x), spec["plain"](x)
            torch.cuda.synchronize()
            if got.dtype != x["z"].dtype or got.shape != x["z"].shape:
                raise AssertionError(f"{spec['name']} {tag} C={C} D={D}: "
                                     f"{got.dtype}{tuple(got.shape)}")
            if not bits_equal(got, want):
                raise AssertionError(
                    f"{spec['name']} {tag} C={C} D={D} {dt}: kernel != "
                    f"plain version (max |err| {max_abs_err(got, want)})")
            spec["max_abs_err"] = max(spec["max_abs_err"],
                                      max_abs_err(got, want))
            n += 1
            if tag == "tpu_grid":
                grid.append(time_grid_shape(spec, x, C, D, dt, cpm))
        if tag == "tpu_grid":
            # B2 with the active-subset divisor n_total of a later slice
            got = sa.sign_agg_weighted(x["z"], x["W"], x["phi"], x["sw"],
                                       PSI, ALPHA, n_total=3 * C)
            want = ref.sign_agg_fold_ref(x["z"], x["W"], x["phi"], x["sw"],
                                         PSI, ALPHA, 3 * C)
            if not bits_equal(got, want):
                raise AssertionError(f"sign_agg_weighted n_total C={C} D={D}")
            n += 1
        del x
    # B3 past the int8 range: 200 clients on one side of z sum to 200
    x = make_inputs(200, 600, torch.float32, seed=0, edge_cases=False)
    payload = torch.ones_like(x["payload"])
    got = sa.sign_agg_weighted_int8(x["z"], payload, None, x["phi"], PSI,
                                    ALPHA)
    want = ref.sign_agg_ref(x["z"], x["z"][None].expand(200, -1) - 1000.0,
                            x["phi"], PSI, ALPHA)
    if not bits_equal(got, want):
        raise AssertionError("sign_agg_weighted_int8: C=200 sum wrapped")
    n += 1
    report["checks"] = n
    report["grid_timings"] = grid
    log(f"checks: {n} kernel calls equal their plain versions bit for bit "
        f"({len(shapes)} shapes, NaN and tie columns included)")


def group_inputs(sizes, C, dtype, seed, shifted=()):
    """The round ``r`` of one grouped call: z, W, phi_mean and int8
    payload lists (:func:`make_inputs` per leaf, so NaN and tie columns in
    every leaf of 16 columns or more), and the first leaf's weights.  The
    leaves numbered in ``shifted`` lie one element into their storage: no
    address of theirs is 16-byte aligned."""
    r = {k: [] for k in ("z", "W", "phi", "payload")}
    for l, D in enumerate(sizes):
        x = make_inputs(C, D, dtype, seed=seed + l)
        for k in r:
            t = x[k]
            if l in shifted:
                t = torch.empty(t.numel() + 1, dtype=t.dtype,
                                device="cuda")[1:].view(t.shape).copy_(t)
            r[k].append(t)
        if l == 0:
            sw = x["sw"]
    return r, sw


def vector_flags(r, rows):
    """Which leaves a grouped call with message rows ``r[rows]`` would put
    on the vector path (its output is 16-byte aligned by
    construction)."""
    from repro_torch.kernels import sign_agg as sa

    table = sa.leaf_table([(z.data_ptr(), q.data_ptr(), p.data_ptr(), 0,
                            z.numel())
                           for z, q, p in zip(r["z"], r[rows], r["phi"])],
                          r[rows][0].element_size())
    return table[6::sa.TABLE_COLS]


def check_groups(specs, report):
    """B1-B3 as the main path calls them: one grouped launch (two past
    ``MAX_LEAVES`` leaves) over the leaves of a tree, each leaf bit for
    bit against its plain version: the 8 MLP_H24 leaves (all on the
    vector path: D a multiple of the vector width), the TPU grid's leaves,
    odd sizes beside a leaf offset by one element (scalar path), and 65
    leaves, and the MLP_H1 leaves at the client counts of the paper
    suites (:data:`PAPER_CLIENTS`); without weights, with them and with
    ``n_total``; and B3 with C=200 all-ones payloads, past the int8
    range."""
    from repro_torch.kernels import ref, sign_agg as sa

    dts = (torch.float32, torch.bfloat16)
    cases = [("main", MAIN_LEAF_D, N_CLIENTS, dt, ()) for dt in dts]
    cases += [("tpu_grid", [128, 1024, 5000, 8193], c, dt, ())
              for c in (2, 16) for dt in dts]
    cases += [("tpu_grid", [600, 8193], 200, dt, ()) for dt in dts]
    cases += [("odd", [1, 3, 8193, 4096, 4096, 24], N_CLIENTS, dt, (3,))
              for dt in dts]
    cases += [("65_leaves", [(37 * l) % 300 + 1 for l in range(65)], 16,
               torch.float32, ())]
    cases += [("paper", PAPER_LEAF_D, c, dt, ()) for c in PAPER_CLIENTS
              for dt in dts]
    n = 0
    for i, (tag, sizes, C, dt, shifted) in enumerate(cases):
        r, sw = group_inputs(sizes, C, dt, 1000 + 100 * i, shifted)
        launches = -(-len(sizes) // sa.MAX_LEAVES)
        for spec in specs:
            flags = vector_flags(r, spec["rows"])
            if tag == "main" and flags != [1] * len(sizes):
                raise AssertionError(f"{spec['name']} group {tag} {dt}: "
                                     f"vector flags {flags}")
            if any(flags[l] for l in shifted):
                raise AssertionError(f"group {tag} {dt}: a shifted leaf is "
                                     f"vectorized ({flags})")
            modes = ([(sw, 0), (sw, 3 * C)] if spec["weighted"]
                     else [(None, 0)])
            for weights, n_total in modes:
                reset_all_counts()
                got = spec["group"](r, weights, n_total)
                torch.cuda.synchronize()
                check_path_counts(f"{spec['name']} group {tag} C={C} {dt}",
                                  all_counts(), {spec["counter"]: launches})
                want = spec["group_plain"](r, weights, n_total)
                for l, (g, w) in enumerate(zip(got, want)):
                    if (g.dtype != w.dtype or g.shape != w.shape
                            or not bits_equal(g, w)):
                        raise AssertionError(
                            f"{spec['name']} group {tag} C={C} {dt} "
                            f"n_total={n_total} leaf {l} (D={sizes[l]}, "
                            f"vector {flags[l]}): kernel != plain version "
                            f"(max |err| {max_abs_err(g, w)})")
                    spec["max_abs_err"] = max(spec["max_abs_err"],
                                              max_abs_err(g, w))
                n += 1
        del r
    # B3 past the int8 range: 200 clients on one side of z sum to 200
    for dt in dts:
        r, _ = group_inputs([600, 8193], 1, dt, 7, ())
        qs = [torch.ones(200, z.numel(), dtype=torch.int8, device="cuda")
              for z in r["z"]]
        got = sa.sign_agg_int8_group(r["z"], qs, r["phi"], None, PSI, ALPHA)
        for z, q, p, g in zip(r["z"], qs, r["phi"], got):
            below = (z.float()[None] - 1000.0).expand(200, -1).to(dt)
            if not (bits_equal(g, ref.sign_agg_ref(z, below, p, PSI, ALPHA))
                    and bits_equal(g, ref.sign_agg_int8_fold_ref(
                        z, q, None, p, PSI, ALPHA, 200))):
                raise AssertionError(f"sign_agg_int8_group C=200 {dt}: the "
                                     f"sum wrapped")
        n += 1
    report["group_checks"] = n
    log(f"checks: {n} grouped calls (B1-B3, {len(cases)} leaf sets: "
        f"MLP_H24 at C={N_CLIENTS}, MLP_H1 at C={PAPER_CLIENTS}, up to 65 "
        f"leaves, and B3 at C=200) equal their plain versions bit for bit")


def time_grid_shape(spec, x, C, D, dtype, cpm):
    """Device time of kernel and plain version at one shape of the TPU
    test grid (fewer samples than the main path's).  At C=200 the plain
    version's ~1400 launches can fill the launch queue, and then its time
    includes some host time."""
    row = dict(kernel=spec["name"], C=C, D=D, dtype=str(dtype),
               kernel_ms=device_ms(lambda: spec["kernel"](x), cpm, reps=20,
                                   inner=2),
               plain_ms=device_ms(lambda: spec["plain"](x), cpm, reps=20,
                                  inner=2))
    row["bound_ms"], row["bound_by"] = bound_ms(spec, x)
    log(f"grid {spec['name']:34s} C={C:3d} D={D:5d} {dtype} "
        f"kernel_ms={row['kernel_ms']:.6f} plain_ms={row['plain_ms']:.6f} "
        f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']})")
    return row


def time_kernels(specs, report):
    """Kernel, plain version and bound at the main path's shapes (each of
    the 8 leaves in a one-leaf call; B1/B2 also in one grouped call, as a
    round makes it: :func:`time_round`) and at the bandwidth-bound shape.
    ``*_ms`` is device time (:func:`device_ms`); ``*_call_ms`` includes the
    host's time per call (:func:`call_ms`), what an eager round pays."""
    cpm = sleep_cycles_per_ms()
    rows = []
    for spec in specs:
        spec.update(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for tag, C, D in ([("main", N_CLIENTS, d) for d in MAIN_LEAF_D]
                          + [("bandwidth", 64, 4_194_304)]):
            x = make_inputs(C, D, torch.float32, seed=D, edge_cases=False)
            inner = 10 if tag == "main" else 2
            row = dict(kernel=spec["name"], shape=tag, C=C, D=D,
                       kernel_ms=device_ms(lambda: spec["kernel"](x), cpm,
                                           inner=inner),
                       plain_ms=device_ms(lambda: spec["plain"](x), cpm,
                                          reps=21, inner=inner),
                       kernel_call_ms=call_ms(lambda: spec["kernel"](x),
                                              inner=inner),
                       plain_call_ms=call_ms(lambda: spec["plain"](x),
                                             reps=21, inner=inner),
                       bytes=spec["nbytes"](x))
            row["bound_ms"], row["bound_by"] = bound_ms(spec, x)
            rows.append(row)
            log(f"time {spec['name']:34s} {tag:9s} C={C:3d} D={D:8d} "
                f"kernel_ms={row['kernel_ms']:.6f} "
                f"plain_ms={row['plain_ms']:.6f} "
                f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
                f"call_ms: kernel={row['kernel_call_ms']:.6f} "
                f"plain={row['plain_call_ms']:.6f}")
            if tag == "main":
                spec["ms"] += row["kernel_ms"]
                spec["plain_ms"] += row["plain_ms"]
                spec["bound_ms"] += row["bound_ms"]
                spec["bound_by"] = row["bound_by"]
            else:
                spec["bandwidth_ms"] = row["kernel_ms"]
                spec["bandwidth_bound_ms"] = row["bound_ms"]
            del x
    rows += time_round(specs, cpm)
    rows += time_sparse_block(specs, cpm)
    report["timings"] = rows


def time_round(specs, cpm):
    """B1-B3 per round as the main path calls them: one grouped call over
    the 8 MLP_H24 leaves (device ms and ``call_ms``) beside the same leaves
    in eight one-leaf calls and the plain version (one call a sample: its
    ~500 launches fit the launch queue, ten would not).  The grouped
    call's times become the spec's ``ms`` and ``plain_ms``."""
    xs = [make_inputs(N_CLIENTS, d, torch.float32, seed=d, edge_cases=False)
          for d in MAIN_LEAF_D]
    for x in xs:
        x["sw"] = xs[0]["sw"]
    r = {k: [x[k] for x in xs] for k in ("z", "W", "phi", "payload")}
    rows = []
    for spec in specs:
        w = xs[0]["sw"] if spec["weighted"] else None
        group = lambda: spec["group"](r, w, 0)
        plain = lambda: spec["group_plain"](r, w, 0)
        one_leaf = lambda: [spec["kernel"](x) for x in xs]
        row = dict(kernel=spec["name"], shape="round", C=N_CLIENTS,
                   D=sum(MAIN_LEAF_D), leaves=len(MAIN_LEAF_D),
                   kernel_ms=device_ms(group, cpm),
                   plain_ms=device_ms(plain, cpm, reps=21, inner=1),
                   kernel_call_ms=call_ms(group),
                   plain_call_ms=call_ms(plain, reps=21),
                   one_leaf_ms=device_ms(one_leaf, cpm),
                   one_leaf_call_ms=call_ms(one_leaf),
                   bytes=sum(spec["nbytes"](x) for x in xs),
                   bound_ms=spec["bound_ms"], bound_by=spec["bound_by"])
        rows.append(row)
        spec.update(ms=row["kernel_ms"], plain_ms=row["plain_ms"],
                    call_ms=row["kernel_call_ms"],
                    one_leaf_ms=row["one_leaf_ms"],
                    one_leaf_call_ms=row["one_leaf_call_ms"])
        log(f"time {spec['name']:34s} round     C={N_CLIENTS:3d} "
            f"{len(MAIN_LEAF_D)} leaves: grouped kernel_ms="
            f"{row['kernel_ms']:.6f} call_ms={row['kernel_call_ms']:.6f}; "
            f"8 one-leaf calls kernel_ms={row['one_leaf_ms']:.6f} "
            f"call_ms={row['one_leaf_call_ms']:.6f}; plain_ms="
            f"{row['plain_ms']:.6f} bound_ms={row['bound_ms']:.6f} "
            f"({row['bound_by']})")
    return rows


def time_sparse_block(specs, cpm):
    """B2 and B3 (weighted) as the sparse round calls them in
    ``scale_round``: one grouped call over the 8 MLP_H24 leaves of a
    gathered (SCALE_S, D_l) block with the divisor ``n_total = SCALE_C``,
    each leaf first held bit for bit against its plain version; device ms
    beside the bound of the same work.  Becomes the spec's
    ``sparse_block_ms`` / ``sparse_block_bound_ms``."""
    xs = [make_inputs(SCALE_S, d, torch.float32, seed=d, edge_cases=False)
          for d in MAIN_LEAF_D]
    for x in xs:
        x["sw"] = xs[0]["sw"]
    r = {k: [x[k] for x in xs] for k in ("z", "W", "phi", "payload")}
    rows = []
    for spec in specs:
        if not spec["weighted"]:
            continue
        got = spec["group"](r, xs[0]["sw"], SCALE_C)
        want = spec["group_plain"](r, xs[0]["sw"], SCALE_C)
        for l, (g, w) in enumerate(zip(got, want)):
            if (g.dtype != w.dtype or g.shape != w.shape
                    or not bits_equal(g, w)):
                raise AssertionError(
                    f"{spec['name']} sparse block S={SCALE_S} n_total="
                    f"{SCALE_C} leaf {l} (D={MAIN_LEAF_D[l]}): kernel != "
                    f"plain version (max |err| {max_abs_err(g, w)})")
            spec["max_abs_err"] = max(spec["max_abs_err"], max_abs_err(g, w))
        t_bytes = sum(spec["nbytes"](x) for x in xs) / HBM_BYTES_PER_S * 1e3
        t_ops = sum(spec["flops"](x) for x in xs) / F32_FLOPS_PER_S * 1e3
        row = dict(kernel=spec["name"], shape="sparse_block", C=SCALE_S,
                   D=sum(MAIN_LEAF_D), n_total=SCALE_C,
                   kernel_ms=device_ms(
                       lambda: spec["group"](r, xs[0]["sw"], SCALE_C), cpm),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        rows.append(row)
        spec.update(sparse_block_ms=row["kernel_ms"],
                    sparse_block_bound_ms=row["bound_ms"])
        log(f"time {spec['name']:34s} sparse    S={SCALE_S:3d} "
            f"{len(MAIN_LEAF_D)} leaves, n_total={SCALE_C}: grouped "
            f"kernel_ms={row['kernel_ms']:.6f} bound_ms="
            f"{row['bound_ms']:.6f} ({row['bound_by']})")
    return rows


def train_runs(specs, report):
    """The main path: train_bafdp on the card, once through each kernel;
    each run must launch its kernel rounds x its launches a round (one
    grouped launch) times and no other."""
    from repro_torch import train
    from repro_torch.configs import FedConfig
    train.problem("milano", 24, N_CLIENTS, 0)              # data set-up
    train.train_bafdp("milano", 24, FedConfig(n_clients=N_CLIENTS),
                      rounds=2, device="cuda")             # CUDA warm-up
    runs = []
    for spec in specs:
        fed = FedConfig(n_clients=N_CLIENTS, **spec["knobs"])
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, cfg, hist = train.train_bafdp(
            "milano", 24, fed, rounds=ROUNDS, seed=0,
            collect=("data_loss",), device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = all_counts()
        check_path_counts(f"{spec['name']} run", counts,
                          {spec["counter"]: ROUNDS * spec["per_round"]})
        spec["launches"] = counts[spec["counter"]]
        _, test, scalers = train.problem("milano", 24, N_CLIENTS, 0)
        rmse, mae = train.eval_fed_state(state, cfg, test, scalers)
        loss = np.asarray(hist["data_loss"])
        if not (np.isfinite(loss).all() and np.isfinite([rmse, mae]).all()):
            raise AssertionError(f"{spec['name']} run: non-finite "
                                 f"loss {loss} rmse {rmse} mae {mae}")
        ms = secs * 1e3 / ROUNDS
        runs.append(dict(kernel=spec["name"], knobs=spec["knobs"],
                         rounds=ROUNDS, ms_per_round=ms, launches=counts,
                         data_loss_first=float(loss[0]),
                         data_loss_last=float(loss[-1]), rmse=rmse, mae=mae))
        log(f"train {spec['name']:34s} {spec['knobs']} {ROUNDS} rounds: "
            f"ms_per_round={ms:.3f} launches={spec['launches']} "
            f"data_loss {loss[0]:.5f}->{loss[-1]:.5f} rmse={rmse:.3f} "
            f"mae={mae:.3f}")
    report["train"] = runs


def drift_check(label, a, b, rounds, alpha_w):
    """Two final states of the same rounds (``a`` on the CPU, ``b`` on the
    card) agree within the drift rule: every element of every leaf within
    DRIFT = 2e-5 + 1e-4 |x|, except where that drift decided a
    discontinuity (a sign(w - z) or sign(z - w) at a tie, the direction of
    an Adam step on a near-zero gradient: m / sqrt(v) is +-1 whatever the
    gradient's size).  Such an element may differ by up to what Adam can
    move a weight, 2 alpha_w per round (BOUND), and at most 1 % of a
    leaf's elements (at least one) may exceed DRIFT.  Returns ((max |diff|,
    its leaf), elements beyond DRIFT)."""
    drift = 2e-5
    bound = rounds * 2 * alpha_w
    worst, n_off = (0.0, ""), 0
    for (path, x), (_, y) in zip(_named_leaves(a._asdict()),
                                 _named_leaves(b._asdict())):
        x, y = x.cpu().double(), y.cpu().double()
        d = (x - y).abs()
        scale = 1e-4 * x.abs()
        if bool((d > bound + scale).any()):
            raise AssertionError(f"{label}: {path} differs by "
                                 f"{float(d.max()):.3e} > {bound:.1e}")
        off = int((d > drift + scale).sum())
        if off > max(1, x.numel() // 100):
            raise AssertionError(f"{label}: {path} has {off} of "
                                 f"{x.numel()} elements off by > {drift}")
        n_off += off
        if float(d.max()) > worst[0]:
            worst = (float(d.max()), path)
    return worst, n_off


def _init_arrays(fed, cfg):
    """A fresh Adam state of ``fed`` as numpy arrays (seed 0, CPU draws)."""
    from repro_torch.core.fed_state import init_fed_state
    from repro_torch.models.forecasting import init_forecaster

    init = init_fed_state(torch.Generator().manual_seed(0),
                          lambda g: init_forecaster(g, cfg),
                          dataclasses.replace(fed, omega_optimizer="adam"),
                          device="cpu")
    return {k: None if v is None else _to_numpy(v)
            for k, v in init._asdict().items()}


def cpu_vs_cuda(report):
    """3 rounds of the f32 + poly config on the CPU and on the card from
    one state, input_sigma=0, explicit activity rows, held to
    :func:`drift_check`; the per-round losses and the final RMSE / MAE
    agree within rtol 1e-4."""
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.core.fed_state import fed_state_from_numpy

    rounds = 3
    fed = FedConfig(n_clients=N_CLIENTS, staleness_decay="poly")
    cfg = train.forecast_cfg("mlp", 24)
    arrays = _init_arrays(fed, cfg)
    rows = np.random.RandomState(1).rand(rounds, N_CLIENTS) < 0.6
    rows[:, 0] = True
    _, test, scalers = train.problem("milano", 24, N_CLIENTS, 0)
    out = {}
    for dev in ("cpu", "cuda"):
        state, _, hist = train.train_bafdp(
            "milano", 24, fed, rounds=rounds, seed=0, input_sigma=0.0,
            active_masks=rows, collect=("data_loss",),
            state=fed_state_from_numpy(arrays, device=dev), device=dev)
        out[dev] = (state, hist["data_loss"],
                    train.eval_fed_state(state, cfg, test, scalers))
    worst, n_off = drift_check("cpu vs cuda", out["cpu"][0], out["cuda"][0],
                               rounds, fed.alpha_w)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4)
    report["cpu_vs_cuda"] = dict(max_abs_state_diff=worst[0],
                                 worst_leaf=worst[1],
                                 elements_beyond_drift=n_off,
                                 rmse_mae_cpu=out["cpu"][2],
                                 rmse_mae_cuda=out["cuda"][2])
    log(f"cpu vs cuda, {rounds} rounds: max |state diff| = {worst[0]:.3e} "
        f"at {worst[1]}; {n_off} elements beyond the 2e-05 drift bound; "
        f"rmse/mae cpu {out['cpu'][2]} cuda {out['cuda'][2]}")


def sparse_schedule(rounds: int):
    """The event-driven fleet of the sparse runs: 10 clients of
    heterogeneous latency under the quickstart's quorum server (adaptive
    quorum, age-aware selection)."""
    from repro_torch import train
    from repro_torch.core.async_engine import DelayModel
    from repro_torch.core.schedule import build_schedule

    return build_schedule(rounds, DelayModel(n_clients=N_CLIENTS, hetero=1.0,
                                             seed=0),
                          train.make_trigger("quorum", 0.6))


def sparse_runs(specs, report):
    """The schedule path: ``train_bafdp(schedule=, round_impl="sparse")``
    on the card, MLP_H24 at full width, 20 rounds of one schedule, three
    times: the f32 wire (B2, one launch a round), the int8 wire (B3
    weighted, one a round) and the f32 wire streamed in chunks of 3 rows
    (the plain streamed fold, no consensus launch).  The streamed z and
    the int8 z must equal the f32 run's bit for bit: the sign wire loses
    nothing, and B3's weighted fold is B2's.  Adds each run's launches to
    its spec."""
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.tree import tree_leaves

    sched = sparse_schedule(ROUNDS)
    spec_of = {s["name"]: s for s in specs}
    cases = [("f32", {}, "sign_agg_weighted"),
             ("int8", dict(sign_message="int8"),
              "sign_agg_weighted_int8/weighted"),
             ("streamed", dict(consensus_streaming=True, consensus_chunk=3),
              None)]
    _, test, scalers = train.problem("milano", 24, N_CLIENTS, 0)
    runs, z = [], {}
    for tag, knobs, spec_name in cases:
        fed = FedConfig(n_clients=N_CLIENTS, staleness_decay="poly", **knobs)
        counter = spec_of[spec_name]["counter"] if spec_name else None
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, cfg, hist = train.train_bafdp(
            "milano", 24, fed, rounds=ROUNDS, seed=0, schedule=sched,
            round_impl="sparse", collect=("data_loss",), device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = all_counts()
        check_path_counts(f"sparse {tag} run", counts,
                          {counter: ROUNDS} if counter else {})
        if spec_name:
            spec_of[spec_name]["launches"] += counts[counter]
        z[tag] = tree_leaves(state.z)
        rmse, mae = train.eval_fed_state(state, cfg, test, scalers)
        loss = np.asarray(hist["data_loss"])
        if not (np.isfinite(loss).all() and np.isfinite([rmse, mae]).all()):
            raise AssertionError(f"sparse {tag} run: non-finite loss {loss} "
                                 f"rmse {rmse} mae {mae}")
        ms = secs * 1e3 / ROUNDS
        runs.append(dict(wire=tag, knobs=knobs, rounds=ROUNDS,
                         arrivals=int(sched.arrivals.sum()),
                         s_max=sched.s_max, ms_per_round=ms,
                         launches=counts, data_loss_first=float(loss[0]),
                         data_loss_last=float(loss[-1]), rmse=rmse, mae=mae))
        log(f"sparse {tag:8s} {ROUNDS} rounds (S_max={sched.s_max}, "
            f"{int(sched.arrivals.sum())} deliveries): ms_per_round={ms:.3f} "
            f"launches={ {k: v for k, v in counts.items() if v} } "
            f"data_loss {loss[0]:.5f}->{loss[-1]:.5f} rmse={rmse:.3f} "
            f"mae={mae:.3f}")
    for tag in ("streamed", "int8"):
        if not all(bits_equal(a, b) for a, b in zip(z[tag], z["f32"])):
            raise AssertionError(f"sparse runs: the {tag} z differs from "
                                 f"the f32 (B2) z")
    log("sparse runs: the streamed z and the int8 (B3) z equal the f32 (B2) "
        "z bit for bit")
    report["sparse_runs"] = runs


def sparse_cpu_vs_cuda(report):
    """3 sparse rounds of the f32 + poly config on the CPU and on the card
    from one state, input_sigma=0, fed the schedule's padded rows, held to
    :func:`drift_check`; then, on the card, the dense active-scope round
    fed the same deliveries as (C,) rows from the same state, against the
    sparse round: bit identity is printed, the drift rule asserted (the
    CPU tests are the bitwise gate: cuBLAS may pick other batched-GEMM
    kernels for a batch of C and a batch of S)."""
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.core.fed_state import fed_state_from_numpy

    rounds = 3
    fed = FedConfig(n_clients=N_CLIENTS, staleness_decay="poly")
    cfg = train.forecast_cfg("mlp", 24)
    arrays = _init_arrays(fed, cfg)
    sched = sparse_schedule(rounds)
    _, test, scalers = train.problem("milano", 24, N_CLIENTS, 0)
    out = {}
    for dev in ("cpu", "cuda"):
        state, _, hist = train.train_bafdp(
            "milano", 24, fed, rounds=rounds, seed=0, input_sigma=0.0,
            schedule=sched, round_impl="sparse", collect=("data_loss",),
            state=fed_state_from_numpy(arrays, device=dev), device=dev)
        out[dev] = (state, hist["data_loss"],
                    train.eval_fed_state(state, cfg, test, scalers))
    worst, n_off = drift_check("sparse cpu vs cuda", out["cpu"][0],
                               out["cuda"][0], rounds, fed.alpha_w)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4)
    log(f"sparse cpu vs cuda, {rounds} rounds: max |state diff| = "
        f"{worst[0]:.3e} at {worst[1]}; {n_off} elements beyond the 2e-05 "
        f"drift bound; rmse/mae cpu {out['cpu'][2]} cuda {out['cuda'][2]}")

    same, d_worst, d_off = dense_active_vs_sparse(
        "dense active vs sparse", fed, arrays, sched, rounds, out["cuda"][0])
    report["sparse_cpu_vs_cuda"] = dict(
        max_abs_state_diff=worst[0], worst_leaf=worst[1],
        elements_beyond_drift=n_off, rmse_mae_cpu=out["cpu"][2],
        rmse_mae_cuda=out["cuda"][2], dense_active_vs_sparse_bitwise=same,
        dense_active_vs_sparse_max_diff=d_worst[0],
        dense_active_vs_sparse_worst_leaf=d_worst[1],
        dense_active_vs_sparse_beyond_drift=d_off)
    log(f"dense active vs sparse on the card, {rounds} rounds: bit-identical"
        f" {same}; max |state diff| = {d_worst[0]:.3e} at {d_worst[1]}; "
        f"{d_off} elements beyond the drift bound")


def dense_active_vs_sparse(label, fed, arrays, sched, rounds, sparse):
    """The dense active-scope round on the card, fed the deliveries of
    ``sched`` as (C,) rows from the state ``arrays``, against ``sparse``
    (the sparse rounds' final state from the same state): bit identity
    and :func:`drift_check`'s ((max |diff|, its leaf), elements beyond the
    drift).  The CPU tests are the bitwise gate: cuBLAS may pick other
    batched-GEMM kernels for a batch of C and a batch of S."""
    from repro_torch import train
    from repro_torch.core.fed_state import fed_state_from_numpy

    acts = np.zeros((rounds, N_CLIENTS), bool)
    stales = np.zeros((rounds, N_CLIENTS), np.float32)
    for r, (idx, stale, weight) in zip(range(rounds), sched.padded_rows()):
        k = int(weight.sum())
        acts[r, idx[:k]] = True
        stales[r, idx[:k]] = stale[:k]
    dense, _, _ = train.train_bafdp(
        "milano", 24, dataclasses.replace(fed, consensus_scope="active"),
        rounds=rounds, seed=0, input_sigma=0.0, active_masks=acts,
        staleness=stales, state=fed_state_from_numpy(arrays, device="cuda"),
        device="cuda")
    same = all(bits_equal(a, b) for (_, a), (_, b) in zip(
        _named_leaves(dense._asdict()), _named_leaves(sparse._asdict())))
    d_worst, d_off = drift_check(label, dense, sparse, rounds, fed.alpha_w)
    return same, d_worst, d_off


def scale_state(C, cfg, fed, seed):
    """A full-width Adam state of ``C`` clients on the card from stacked
    seeded draws (one draw per weight leaf of all clients at once, no
    per-client loop): fan-in normal weights, zero biases, z = client 0."""
    from repro_torch.core.fed_state import FedState
    from repro_torch.tree import tree_map

    dims = (cfg.d_x,) + tuple(cfg.hidden) + (cfg.d_y,)
    g = torch.Generator(device="cuda").manual_seed(seed)
    W = {f"l{i}": {
        "b": torch.zeros((C, dims[i + 1]), device="cuda"),
        "w": torch.randn((C, dims[i], dims[i + 1]), generator=g,
                         device="cuda") / float(np.sqrt(dims[i]))}
        for i in range(len(dims) - 1)}
    z = tree_map(lambda l: l[0].clone(), W)
    vec = dict(dtype=torch.float32, device="cuda")
    return FedState(
        W=W, z=z,
        z_local=tree_map(lambda l: l[None].expand((C,) + l.shape).clone(),
                         z),
        phi=tree_map(torch.zeros_like, W),
        lam=torch.zeros((C,), **vec),
        eps=torch.full((C,), max(fed.privacy_budget_a * fed.eps_init_frac,
                                 fed.eps_min), **vec),
        t=torch.zeros((), dtype=torch.int32, device="cuda"),
        opt={"m": tree_map(torch.zeros_like, W),
             "v": tree_map(torch.zeros_like, W),
             "count": torch.zeros((C,), dtype=torch.int32, device="cuda")},
        tau=torch.zeros((C,), dtype=torch.int32, device="cuda"))


def scale_round(specs, report):
    """The O(S) round at a size no dense round could hold: MLP_H24 at full
    width, C = 65,536 clients, Adam, no Taylor compensation, so W,
    z_local, phi, m and v hold 5 x 7.67 GB = 38.4 GB of state.  Each round
    admits S_max = 64 deliveries of a streamed quorum schedule, with
    pre-gathered (64, 32, 22) batches from the Milano windows of client id
    mod 10 (``batch_gathered=True``); 5 rounds on the f32 wire, 5 on the
    int8 wire, then 5 on the f32 wire with ``robust_consensus="krum"``
    (its pairwise distances over the (64, 29,272) block) and 5 with
    ``"trimmed_mean"``, on the same state.  Asserts that the peak of
    ``torch.cuda.max_memory_allocated()`` stays within SCALE_PEAK_BYTES of
    the state's bytes (one dense (C, D) f32 intermediate is 7.67 GB) over
    each wire's rounds, that each round launches its consensus kernel
    once, that tau of the admitted rows is the round, and that exactly the
    admitted rows of W changed."""
    import functools

    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.core import bafdp
    from repro_torch.core.async_engine import DelayModel
    from repro_torch.core.privacy import gaussian_c3
    from repro_torch.core.schedule import (QuorumTrigger, build_schedule,
                                           round_generator)
    from repro_torch.data import client_batches
    from repro_torch.tree import tree_leaves

    C, S = SCALE_C, SCALE_S
    cfg = train.forecast_cfg("mlp", 24)
    base = FedConfig(n_clients=C, consensus_scope="active",
                     staleness_decay="poly", omega_optimizer="adam",
                     dro_weight=0.01, attack="none")
    spec_of = {s["name"]: s for s in specs}
    wires = [("f32", "sign_agg_weighted", {}),
             ("int8", "sign_agg_weighted_int8/weighted", {}),
             ("f32-krum", "sign_agg_weighted",
              dict(robust_consensus="krum")),
             ("f32-trimmed_mean", "sign_agg_weighted",
              dict(robust_consensus="trimmed_mean",
                   robust_trim_frac=ROBUST_TRIM))]
    rounds = len(wires) * SCALE_ROUNDS
    train_w, _, _ = train.problem("milano", 24, N_CLIENTS, 0)
    sched = build_schedule(rounds, DelayModel(n_clients=C, hetero=1.0,
                                              seed=0),
                           QuorumTrigger(s_target=S), stream=True)
    rows = list(sched.padded_rows(S))
    torch.cuda.synchronize()
    before_state = torch.cuda.memory_allocated()
    state = scale_state(C, cfg, base, seed=0)
    state_bytes = sum(l.numel() * l.element_size() for f in state
                      if f is not None for l in tree_leaves(f))
    if tree_leaves(state.W)[0].shape[0] != C \
            or sum(l[0].numel() for l in tree_leaves(state.W)) != 29_272:
        raise AssertionError("scale_round: not MLP_H24 at full width")
    W_before = [l.to("cpu", copy=True) for l in tree_leaves(state.W)]
    c3 = gaussian_c3(cfg.d_x + cfg.d_y, base.dp_delta, 0.05)
    rng = np.random.RandomState(0)
    zero_byz = torch.zeros((C,), dtype=torch.bool, device="cuda")

    def local_loss(W, batch, gen, eps):
        from repro_torch.core.privacy import perturb_inputs
        from repro_torch.models.forecasting import mse_loss
        x, y = batch
        return mse_loss(W, perturb_inputs(gen, x, eps, 0.02, base.eps_min),
                        y, cfg)

    def gathered_batch(idx):
        xs = np.zeros((S, train.BATCH, cfg.d_x), np.float32)
        ys = np.zeros((S, train.BATCH, cfg.d_y), np.float32)
        for j, cid in enumerate(idx):
            if cid < C:
                x, y = client_batches(rng, train_w, train.BATCH)
                xs[j], ys[j] = x[cid % N_CLIENTS], y[cid % N_CLIENTS]
        return (torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda())

    times = {w: [] for w, _, _ in wires}
    peaks = {}
    tau_want = np.zeros(C, np.int64)
    for t, (idx, stale, weight) in enumerate(rows):
        wire, spec_name, knobs = wires[t // SCALE_ROUNDS]
        if t % SCALE_ROUNDS == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        fed = dataclasses.replace(base, sign_message=wire.split("-")[0],
                                  **knobs)
        step = functools.partial(
            bafdp.bafdp_round_sparse, local_loss=local_loss, fed=fed, c3=c3,
            n_samples=train_w["x"].shape[1], d_dim=cfg.d_x + cfg.d_y,
            byz_mask=zero_byz, batch_gathered=True)
        batch = gathered_batch(idx)
        counter = spec_of[spec_name]["counter"]
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, round_generator(0, t, "cuda"),
                        idx=idx, stale=stale, weight=weight)
        torch.cuda.synchronize()
        times[wire].append((time.perf_counter() - t0) * 1e3)
        check_path_counts(f"scale round {t} ({wire})", all_counts(),
                          {counter: 1})
        spec_of[spec_name]["launches"] += 1
        ids = idx[weight > 0].astype(np.int64)
        tau_want[ids] = t
        if not bool((state.tau[torch.from_numpy(ids).cuda()] == t).all()):
            raise AssertionError(f"scale round {t}: tau of the admitted "
                                 "rows is not the round")
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"scale round {t}: loss {m['loss']}")
        if t % SCALE_ROUNDS == SCALE_ROUNDS - 1:
            torch.cuda.synchronize()
            peaks[wire] = torch.cuda.max_memory_allocated()
            if peaks[wire] - state_bytes > SCALE_PEAK_BYTES:
                raise AssertionError(
                    f"scale_round ({wire}): peak {peaks[wire]} B is "
                    f"{peaks[wire] - state_bytes} B above the {state_bytes} "
                    f"B state (> {SCALE_PEAK_BYTES} B): a dense (C, D) "
                    "intermediate?")
    peak = max(peaks.values())
    extra = peak - state_bytes
    if not np.array_equal(state.tau.cpu().numpy(), tau_want):
        raise AssertionError("scale_round: tau outside the admitted rows")
    moved = torch.zeros((C,), dtype=torch.bool)
    chunk = 4096
    for old, new in zip(W_before, tree_leaves(state.W)):
        for a in range(0, C, chunk):
            diff = new[a:a + chunk].cpu() != old[a:a + chunk]
            moved[a:a + chunk] |= diff.reshape(diff.shape[0], -1).any(1)
    admitted = np.unique(np.concatenate(
        [i[w > 0] for i, _, w in rows])).astype(np.int64)
    if not np.array_equal(moved.nonzero().flatten().numpy(), admitted):
        raise AssertionError(f"scale_round: {int(moved.sum())} rows of W "
                             f"moved, {admitted.size} were admitted")
    report["scale_round"] = dict(
        n_clients=C, s_max=S, rounds=rounds, state_bytes=state_bytes,
        allocated_before_state=before_state, peak_bytes=peak,
        peak_above_state=extra, admitted_rows=int(admitted.size),
        peak_above_state_by_wire={w: p - state_bytes
                                  for w, p in peaks.items()},
        ms_per_round={w: statistics.median(v) for w, v in times.items()},
        ms_rounds=times)
    log(f"scale round: C={C} S_max={S}, state {state_bytes / 1e9:.2f} GB "
        f"(allocated before it {before_state / 1e9:.3f} GB); peak "
        f"{peak / 1e9:.3f} GB, {extra / 2**30:.3f} GiB above the state "
        "(" + ", ".join(f"{w} {(p - state_bytes) / 2**30:.3f}"
                        for w, p in peaks.items()) + " GiB); "
        f"{admitted.size} rows of W moved, all admitted; ms per round "
        + ", ".join(f"{w} {statistics.median(v):.3f} (rounds "
                    f"{' '.join(f'{x:.1f}' for x in v)})"
                    for w, v in times.items()))
    del state, W_before
    torch.cuda.empty_cache()


def robust_runs(specs, report):
    """The Byzantine-robust path: ``train_bafdp`` on the card, MLP_H24 at
    full width, 10 clients, ``sign_flip`` at 0.3, 20 rounds, once per
    ``robust_consensus`` rule: the dense ``"all"`` scope (constant decay,
    B1, exactly one launch a round) and the sparse round on the schedule
    of ``sparse_runs`` (poly decay, B2, one a round), plus the trimmed
    mean on the int8 wire (B3 weighted, one a round), whose z must equal
    the f32 run's bit for bit (the wire is lossless and the broadcast
    aggregate folds alike).  Then per rule 3 rounds of the dense active
    scope against the sparse round from one state (``drift_check``; bit
    identity printed).  Adds each run's launches to its spec."""
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.core.fed_state import fed_state_from_numpy
    from repro_torch.tree import tree_leaves

    spec_of = {s["name"]: s for s in specs}
    sched = sparse_schedule(ROUNDS)
    _, test, scalers = train.problem("milano", 24, N_CLIENTS, 0)
    cases = [("dense", rule, {}, "sign_agg") for rule in ROBUST_RULES]
    cases += [("sparse", rule, {}, "sign_agg_weighted")
              for rule in ROBUST_RULES]
    cases += [("sparse", "trimmed_mean", dict(sign_message="int8"),
               "sign_agg_weighted_int8/weighted")]
    runs, z = [], {}
    for path, rule, knobs, spec_name in cases:
        sparse = path == "sparse"
        tag = f"{path} {rule}" + (" int8" if knobs else "")
        fed = FedConfig(n_clients=N_CLIENTS, robust_consensus=rule,
                        staleness_decay="poly" if sparse else "constant",
                        **ROBUST_KNOBS, **knobs)
        counter = spec_of[spec_name]["counter"]
        route = dict(schedule=sched, round_impl="sparse") if sparse else {}
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, cfg, hist = train.train_bafdp(
            "milano", 24, fed, rounds=ROUNDS, seed=0,
            collect=("data_loss",), device="cuda", **route)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = all_counts()
        check_path_counts(f"robust {tag} run", counts, {counter: ROUNDS})
        spec_of[spec_name]["launches"] += counts[counter]
        z[tag] = tree_leaves(state.z)
        rmse, mae = train.eval_fed_state(state, cfg, test, scalers)
        rmse_z, _ = train.eval_rmse_mae(state.z, cfg, test, scalers)
        loss = np.asarray(hist["data_loss"])
        if not (np.isfinite(loss).all()
                and np.isfinite([rmse, mae, rmse_z]).all()):
            raise AssertionError(f"robust {tag} run: non-finite loss {loss}"
                                 f" rmse {rmse} mae {mae} rmse_z {rmse_z}")
        ms = secs * 1e3 / ROUNDS
        runs.append(dict(path=path, rule=rule, knobs=knobs, rounds=ROUNDS,
                         ms_per_round=ms, launches=counts,
                         data_loss_first=float(loss[0]),
                         data_loss_last=float(loss[-1]), rmse=rmse, mae=mae,
                         consensus_rmse=rmse_z))
        log(f"robust {tag:26s} {ROUNDS} rounds: ms_per_round={ms:.3f} "
            f"launches={ {k: v for k, v in counts.items() if v} } "
            f"data_loss {loss[0]:.5f}->{loss[-1]:.5f} rmse={rmse:.3f} "
            f"mae={mae:.3f} consensus rmse={rmse_z:.3f}")
    if not all(bits_equal(a, b) for a, b in zip(
            z["sparse trimmed_mean int8"], z["sparse trimmed_mean"])):
        raise AssertionError("robust runs: the int8 (B3) trimmed-mean z "
                             "differs from the f32 (B2) z")
    log("robust runs: the int8 (B3) trimmed-mean z equals the f32 (B2) z "
        "bit for bit")

    cfg = train.forecast_cfg("mlp", 24)
    psched = sparse_schedule(PARITY_ROUNDS)
    parity = {}
    for rule in ROBUST_RULES:
        fed = FedConfig(n_clients=N_CLIENTS, staleness_decay="poly",
                        robust_consensus=rule, **ROBUST_KNOBS)
        arrays = _init_arrays(fed, cfg)
        sparse_state, _, _ = train.train_bafdp(
            "milano", 24, fed, rounds=PARITY_ROUNDS, seed=0,
            input_sigma=0.0, schedule=psched, round_impl="sparse",
            state=fed_state_from_numpy(arrays, device="cuda"),
            device="cuda")
        same, worst, n_off = dense_active_vs_sparse(
            f"robust {rule}: dense active vs sparse", fed, arrays, psched,
            PARITY_ROUNDS, sparse_state)
        parity[rule] = dict(bitwise=same, max_abs_state_diff=worst[0],
                            worst_leaf=worst[1], elements_beyond_drift=n_off)
        log(f"robust {rule}: dense active vs sparse on the card, "
            f"{PARITY_ROUNDS} rounds: bit-identical {same}; max |state "
            f"diff| = {worst[0]:.3e} at {worst[1]}; {n_off} elements beyond "
            "the drift bound")
    report["robust_runs"] = dict(runs=runs, dense_active_vs_sparse=parity)


def robust_cpu_vs_cuda(report):
    """3 dense rounds with ``robust_consensus="trimmed_mean"`` under
    ``sign_flip`` at 0.3 on the CPU and on the card from one state,
    input_sigma=0, explicit activity rows, held to :func:`drift_check`;
    the losses and the final RMSE / MAE within rtol 1e-4."""
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.core.fed_state import fed_state_from_numpy

    rounds = 3
    fed = FedConfig(n_clients=N_CLIENTS, robust_consensus="trimmed_mean",
                    **ROBUST_KNOBS)
    cfg = train.forecast_cfg("mlp", 24)
    arrays = _init_arrays(fed, cfg)
    rows = np.random.RandomState(2).rand(rounds, N_CLIENTS) < 0.6
    rows[:, 0] = True
    _, test, scalers = train.problem("milano", 24, N_CLIENTS, 0)
    out = {}
    for dev in ("cpu", "cuda"):
        state, _, hist = train.train_bafdp(
            "milano", 24, fed, rounds=rounds, seed=0, input_sigma=0.0,
            active_masks=rows, collect=("data_loss",),
            state=fed_state_from_numpy(arrays, device=dev), device=dev)
        out[dev] = (state, hist["data_loss"],
                    train.eval_fed_state(state, cfg, test, scalers))
    worst, n_off = drift_check("robust cpu vs cuda", out["cpu"][0],
                               out["cuda"][0], rounds, fed.alpha_w)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4)
    report["robust_cpu_vs_cuda"] = dict(
        max_abs_state_diff=worst[0], worst_leaf=worst[1],
        elements_beyond_drift=n_off, rmse_mae_cpu=out["cpu"][2],
        rmse_mae_cuda=out["cuda"][2])
    log(f"robust cpu vs cuda (trimmed_mean), {rounds} rounds: max |state "
        f"diff| = {worst[0]:.3e} at {worst[1]}; {n_off} elements beyond the "
        f"2e-05 drift bound; rmse/mae cpu {out['cpu'][2]} cuda "
        f"{out['cuda'][2]}")


def baseline_runs(specs, report):
    """Every baseline of ``train.METHODS`` (all but BAFDP) through
    ``train.train_baseline`` on the card, H=1, 10 clients, 10 rounds:
    finite loss and RMSE, and no consensus launch (the baselines'
    aggregation is plain PyTorch, as the reference's is plain XLA).  Then
    ``bench.table4_byzantine.main(rounds=20, quick=True)``, which prints
    its rows; its two BAFDP runs launch B1 once a round, 40 in all, which
    are added to B1's spec."""
    from repro_torch import train
    from repro_torch.bench import table4_byzantine
    from repro_torch.configs import FedConfig

    runs = []
    for method, (kind, backbone, _) in train.METHODS.items():
        if kind == "bafdp":
            continue
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, cfg, (test, scalers), hist = train.train_baseline(
            method, "milano", 1, FedConfig(n_clients=N_CLIENTS),
            rounds=BASELINE_ROUNDS, collect=("loss",), device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check_path_counts(f"baseline {method} run", all_counts(), {})
        rmse, mae = train.eval_rmse_mae(params, cfg, test, scalers)
        loss = np.asarray(hist["loss"])
        if not (np.isfinite(loss).all() and np.isfinite([rmse, mae]).all()):
            raise AssertionError(f"baseline {method}: non-finite loss "
                                 f"{loss} rmse {rmse} mae {mae}")
        ms = secs * 1e3 / BASELINE_ROUNDS
        runs.append(dict(method=method, trainer=kind, backbone=backbone,
                         rounds=BASELINE_ROUNDS, ms_per_round=ms,
                         loss_first=float(loss[0]),
                         loss_last=float(loss[-1]), rmse=rmse, mae=mae))
        log(f"baseline {method:12s} ({kind}, {backbone}) {BASELINE_ROUNDS} "
            f"rounds: ms_per_round={ms:.3f} (set-up included) loss "
            f"{loss[0]:.5f}->{loss[-1]:.5f} rmse={rmse:.3f} mae={mae:.3f}")
    b1 = next(s for s in specs if s["name"] == "sign_agg")
    reset_all_counts()
    t0 = time.perf_counter()
    rows = table4_byzantine.main(rounds=TABLE4_ROUNDS, quick=True,
                                 device="cuda")
    secs = time.perf_counter() - t0
    counts = all_counts()
    check_path_counts("table4 (quick)", counts,
                      {b1["counter"]: 2 * TABLE4_ROUNDS})
    b1["launches"] += counts[b1["counter"]]
    for row in rows:
        values = [float(kv.split("=")[1])
                  for kv in row.split(",")[2].split(";")]
        if not np.isfinite(values).all():
            raise AssertionError(f"table4: non-finite row {row}")
    log(f"table4 (quick, {TABLE4_ROUNDS} rounds): {len(rows)} rows in "
        f"{secs:.1f} s; launches { {k: v for k, v in counts.items() if v} }")
    report["baselines"] = dict(runs=runs, table4=rows, table4_s=secs)


def consensus_spec(specs, fed):
    """The B1-B3 spec that a BAFDP round under ``fed`` launches once
    (``bafdp_round`` -> ``ops.sign_consensus_leaves``): the int8 sign wire
    B3, else B1/B2; weighted (B2, B3 weighted) unless the staleness decay
    is constant."""
    for s in specs:
        k = s["knobs"]
        if k["sign_message"] == fed.sign_message and (
                k["staleness_decay"] == "constant") == (
                fed.staleness_decay == "constant"):
            return s
    raise AssertionError(f"no consensus kernel for {fed}")


class RecordedRuns:
    """Wraps a suite module's ``train_bafdp`` (if it has one) while
    entered: ``runs`` holds the FedConfig and round count of every run it
    trains, in order, bound by the port's own signature."""

    def __init__(self, mod):
        import inspect

        from repro_torch import train

        self.mod, self.runs = mod, []
        self.signature = inspect.signature(train.train_bafdp)

    def __enter__(self):
        self.saved = getattr(self.mod, "train_bafdp", None)
        if self.saved is not None:
            self.mod.train_bafdp = self.run
        return self

    def __exit__(self, *exc):
        if self.saved is not None:
            self.mod.train_bafdp = self.saved

    def run(self, *args, **kwargs):
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        self.runs.append((bound.arguments["fed"], bound.arguments["rounds"]))
        return self.saved(*args, **kwargs)


def expected_launches(specs, runs):
    """{counter: launches} and {spec name: launches} of B1-B3 for the
    ``(fed, rounds)`` runs: one consensus launch a round
    (:func:`consensus_spec`)."""
    want, by_spec = {}, {}
    for fed, rounds in runs:
        s = consensus_spec(specs, fed)
        want[s["counter"]] = want.get(s["counter"], 0) + rounds
        by_spec[s["name"]] = by_spec.get(s["name"], 0) + rounds
    return want, by_spec


def paper_runs(specs, report):
    """The paper's evaluation on the card: each suite's ``main(rounds=20,
    quick=True, device=None)`` (Tables II/III, Fig. 3, Figs. 4-6 with
    ``with_meta=True``, Fig. 7, Theorem 1, and Fig. 8).  Per suite: the row
    labels of :data:`PAPER_LABELS`, every value finite, the B1/B2/B3
    launches those of the runs it trained (:class:`RecordedRuns`, one a
    round a run); for
    Figs. 4-6 the ``n_active`` each run saw equal to its schedule's mask
    row sums.  Then :mod:`summarize_claims` over these rows and Table IV's
    quick rows (``baseline_runs``), its verdict lines printed."""
    from repro_torch.bench import (fig3_privacy_level, fig456_async_efficiency,
                                   fig7_distributiveness,
                                   fig8_robust_convergence, summarize_claims,
                                   table23_privacy_budget,
                                   theorem1_convergence)

    mods = {
        "table23": table23_privacy_budget,
        "fig3": fig3_privacy_level,
        "fig456": fig456_async_efficiency,
        "fig7": fig7_distributiveness,
        "theorem1": theorem1_convergence,
        "fig8": fig8_robust_convergence,
    }
    spec_of = {s["name"]: s for s in specs}
    all_rows, suites = [], {}
    for suite, mod in mods.items():
        kw = dict(with_meta=True) if suite == "fig456" else {}
        recorded = RecordedRuns(mod)
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded:
            rows = mod.main(rounds=PAPER_ROUNDS, quick=True, device=None,
                            **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = all_counts()
        if [r for _, r in recorded.runs] != [PAPER_ROUNDS] * len(
                recorded.runs) or (suite != "fig7") != bool(recorded.runs):
            raise AssertionError(f"paper {suite}: trained rounds "
                                 f"{[r for _, r in recorded.runs]}")
        want, by_spec = expected_launches(specs, recorded.runs)
        check_path_counts(f"paper {suite} (quick)", counts, want)
        for name, n in by_spec.items():
            spec_of[name]["launches"] += n
        if suite == "fig456":
            rows, metas = rows
            meta = metas[0]
            runs = [("async", meta["n_active_async"], meta["masks_async"]),
                    ("sync", meta["n_active_sync"], meta["masks_sync"])]
            runs += [(name, v["n_active"], v["masks"])
                     for name, v in sorted(meta["variants"].items())]
            for name, n_active, masks in runs:
                if not np.array_equal(n_active, masks.sum(1)):
                    raise AssertionError(
                        f"fig456 {name}: n_active {n_active} != the "
                        f"schedule's mask row sums {masks.sum(1)}")
        labels = [row.split(",")[0] for row in rows]
        if labels != PAPER_LABELS[suite]:
            raise AssertionError(f"paper {suite}: labels {labels}, expected "
                                 f"{PAPER_LABELS[suite]}")
        for row in rows:
            _, us, derived = row.split(",")
            values = [float(us)] + [
                float(x) for kv in derived.split(";")
                for x in kv.split("=")[1].split("/")]
            if not np.isfinite(values).all():
                raise AssertionError(f"paper {suite}: non-finite row {row}")
        all_rows += rows
        suites[suite] = dict(rows=rows, seconds=secs, launches={
            k: v for k, v in counts.items() if v})
        log(f"paper {suite} (quick, {PAPER_ROUNDS} rounds): {len(rows)} rows "
            f"in {secs:.1f} s; launches { {k: v for k, v in counts.items() if v} }")
    summary = summarize_claims.main(
        rows=all_rows + report["baselines"]["table4"])
    verdicts = [line for line in summary.splitlines()
                if line[:2].rstrip(".").isdigit()]
    for line in verdicts:
        log(f"claim {line}")
    log(f"claims 5 and 6 cannot fail at {PAPER_ROUNDS} rounds; only the "
        f"full run's verdicts count for them")
    if [v.split(".")[0] for v in verdicts] != PAPER_CLAIMS:
        raise AssertionError(f"claim summary: claims "
                             f"{[v.split('.')[0] for v in verdicts]}, "
                             f"expected {PAPER_CLAIMS}")
    report["paper_runs"] = dict(suites=suites, verdicts=verdicts)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _named_leaves(t, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def _to_numpy(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.numpy(), tree)


def _kernel_label(mangled):
    """``flash_fwd_bf16<64,128,64,4>`` or ``decode_cluster<64,bf16,5>`` from
    a mangled kernel name: its last (nested) name and its template
    arguments (integers, booleans, ``float``, ``bf16``); an unmangled name
    as it is."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    names = []
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        end = len(digits) + int(digits)
        names.append(rest[len(digits):end])
        rest = rest[end:]
    if not names:
        return mangled
    args, i = [], 1
    while rest.startswith("I") and i < len(rest) and rest[i] != "E":
        if rest.startswith("Li", i):
            j = rest.index("E", i)
            args.append(rest[i + 2:j])
            i = j + 1
        elif rest.startswith("Lb", i):
            args.append("true" if rest[i + 2] == "1" else "false")
            i = rest.index("E", i) + 1
        elif rest[i].isdigit():
            digits = re.match(r"\d+", rest[i:]).group()
            name = rest[i + len(digits):i + len(digits) + int(digits)]
            args.append("bf16" if name == "__nv_bfloat16" else name)
            i += len(digits) + int(digits)
        else:
            args.append({"f": "float", "i": "int"}.get(rest[i], rest[i]))
            i += 1
    return names[-1] + (f"<{','.join(args)}>" if args else "")


def build_kernels(report):
    """One nvcc per source, all started together.  Prints one line per
    kernel instance with ptxas's registers and spill bytes, labelled with
    the kernel and its template arguments (for B4's f32 kernel: head dim,
    query rows, keys per tile; for its bf16 kernel the same and warps)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {}
    for lib in libs:
        log(f"build: {lib.name}")
        label = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                label = _kernel_label(entry.group(1))
            elif "registers" in line or "spill" in line or "error" in line:
                text = line.replace("ptxas info    :", "").strip()
                if label:
                    report["ptxas"].setdefault(label, []).append(text)
                log(f"  nvcc: {label}: {text}" if label else f"  nvcc: {text}")
    log(f"build: {len(libs)} libraries in {report['build_s']:.1f} s")


def dispatch_tiles(fn: str) -> dict:
    """{head dim: template arguments} of the kernels that ``fn``
    (``dispatch_f32`` or ``dispatch_bf16`` in ``flash_attention.cu``)
    launches, read from its ``case D: return launch_...<D, ...>`` lines."""
    src = (ROOT / CSRC / "flash_attention.cu").read_text()
    body = src[src.index(f"cudaError_t {fn}("):]
    body = body[:body.index("\n}\n")]
    return {int(d): tuple(int(x) for x in args.split(","))
            for d, args in re.findall(
                r"case (\d+):\s*return launch_\w+<([\d, ]+)>", body)}


def kernel_label(report, fn: str, D: int) -> str:
    """The ptxas label (``name<args>``, see :func:`build_kernels`) of the
    kernel that ``fn`` launches at head dim ``D``."""
    args = "<" + ",".join(map(str, dispatch_tiles(fn)[D])) + ">"
    hits = [label for label in report["ptxas"] if label.endswith(args)]
    if len(hits) != 1:
        raise AssertionError(f"{fn} at D={D}: ptxas labels {hits} for {args}")
    return hits[0]


def ptxas_registers(lines) -> dict:
    """Registers and spill bytes from one kernel instance's ptxas lines
    (``report["ptxas"][label]``)."""
    out = {}
    for text in lines:
        m = re.search(r"Used (\d+) registers", text)
        if m:
            out["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
        if m:
            out["spill_stores"], out["spill_loads"] = map(int, m.groups())
    return out


def _counted_modules():
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import sign_agg as sa
    from repro_torch.kernels import ssm_scan as ssm_k

    return sa, fa_k, dec_k, ssm_k


def reset_all_counts() -> None:
    for mod in _counted_modules():
        mod.reset_launch_counts()


def all_counts() -> dict:
    out = {}
    for mod in _counted_modules():
        out.update(mod.LAUNCHES)
    return out


def check_path_counts(path: str, counts: dict, want: dict) -> None:
    """Every kernel's launches in one main-path run: ``want`` for the
    kernels it names, 0 for the others."""
    expected = {k: want.get(k, 0) for k in counts}
    if counts != expected:
        raise AssertionError(f"{path}: launches {counts}, expected "
                             f"{expected}")


def _attn_inputs(B, Sq, Sk, H, Hkv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    return mk(B, Sq, H, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)


def kept_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Query-key pairs the mask keeps (queries end-aligned with keys)."""
    qa = np.arange(Sq) + (Sk - Sq)
    hi = np.minimum(qa, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qa - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(q, k, causal, window):
    """B4's operations: 4 B H D per kept query-key pair."""
    B, Sq, H, D = q.shape
    return 4 * B * H * D * kept_pairs(Sq, k.shape[1], causal, window)


def flash_bound(q, k, causal, window):
    """B4's least time: its operations over the tensor cores' peak rate
    for the inputs' type, or q, k, v, out bytes over 3.35 TB/s.  f32 runs
    as 3xTF32, three TF32 products for each f32 one: 3 x the operations
    over 494.7 TFLOP/s.  bf16: the operations over 989 TFLOP/s."""
    ops = flash_flops(q, k, causal, window)
    t_ops = (3 * ops / TF32_FLOPS_PER_S if q.dtype == torch.float32
             else ops / BF16_FLOPS_PER_S)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return _bound(t_ops, nbytes / HBM_BYTES_PER_S)


def decode_bound(q, k, length):
    """B5's least time: the valid K and V positions, q and out bytes over
    3.35 TB/s, or 4 H D flops per valid position over the peak rate."""
    B, H, D = q.shape
    Hkv, L = k.shape[2], k.shape[1]
    valid = int(length.clamp(max=L).sum())
    nbytes = (2 * valid * Hkv * D + 2 * q.numel()) * q.element_size() \
        + 4 * B
    peak = F32_FLOPS_PER_S if q.dtype == torch.float32 else BF16_FLOPS_PER_S
    return _bound(4 * H * D * valid / peak, nbytes / HBM_BYTES_PER_S)


def _bound(t_ops, t_bytes):
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attn_tol(want: torch.Tensor) -> torch.Tensor:
    """Per-element bound of |kernel - plain version| for B4/B5.  f32:
    abs/rel 3e-5, the reference's own bound between kernel and oracle
    (tests/test_kernels.py).  bf16: both compute in f32 from the same bf16
    inputs and round the output once, so they may differ by one bf16 ulp
    (<= 2^-7 relative) plus f32 sum-order noise: 1e-2 relative plus 1e-3
    of the output's RMS.  A bare 3e-2 (the reference's bf16 bound) is the
    size of a typical output at the full-width shapes (|out| ~ 0.03 over
    ~1000 keys), so it could not tell a wrong mask from a right one."""
    w = want.float()
    if want.dtype == torch.float32:
        return 3e-5 + 3e-5 * w.abs()
    return 1e-2 * w.abs() + 1e-3 * float(w.pow(2).mean().sqrt())


def sdpa_flash(q, k, v, causal):
    """``library_ms`` yardstick for B4 (never called by the port).  SDPA's
    ``is_causal`` aligns the mask top-left; where Sq != Sk the causal mask
    is passed aligned bottom-right instead, as B4 and its plain version
    align it (query i at key position i + Sk - Sq)."""
    import torch.nn.functional as F
    Sq, Sk = q.shape[1], k.shape[1]
    mask = None
    if causal and Sq != Sk:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
    return out.transpose(1, 2)


_SDPA_FLASH = {}


def sdpa_takes_flash(q, k, v, causal) -> bool:
    """Whether SDPA's flash backend alone takes :func:`sdpa_flash`'s call
    (``library_ms`` is SDPA's default dispatch, which falls back to
    another backend where flash refuses the shape or dtype).  Asked once
    for each dtype, head dim and mask (causal, Sq == Sk), on which
    flash's choice rests."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    key = (q.dtype, q.shape[-1], causal, q.shape[1] == k.shape[1])
    if key not in _SDPA_FLASH:
        try:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                sdpa_flash(q, k, v, causal)
            _SDPA_FLASH[key] = True
        except RuntimeError:
            _SDPA_FLASH[key] = False
    return _SDPA_FLASH[key]


def sdpa_decode(q, k, v, mask):
    """``library_ms`` yardstick for B5; ``mask``: (B, 1, 1, L) bool."""
    import torch.nn.functional as F
    out = F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True)
    return out[:, :, 0]


def expand_heads(k, H):
    """K or V (B, S, Hkv, D) repeated to H heads: the input of the second
    SDPA yardstick, which then needs no GQA support."""
    return k.repeat_interleave(H // k.shape[2], dim=2).contiguous()


def hold_attention(name, got, want, tag, errs, rows):
    """Kernel ``got`` against plain version ``want`` within ``attn_tol``:
    raises on a miss; records the max |err| in ``errs[name]`` and a row."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name} {tag}: {got.dtype}"
                             f"{tuple(got.shape)}")
    err = max_abs_err(got, want)
    excess = (got.float() - want.float()).abs() - attn_tol(want)
    if not (bool(torch.isfinite(got.float()).all())
            and bool((excess <= 0).all())):
        raise AssertionError(f"{name} {tag}: kernel != plain version "
                             f"(max |err| {err:.3e}, worst excess over "
                             f"attn_tol {float(excess.max()):.3e})")
    errs[name] = max(errs[name], err)
    rows.append(dict(kernel=name, shape=tag, max_abs_err=err,
                     worst_excess=float(excess.max())))


def check_attention(report):
    """B4 and B5 against their plain versions on the card: the reference's
    TPU test grid (tests/test_kernels.py) in f32 and bf16, Sq < Sk,
    ragged lengths and an odd cache, head dim 256, the full-width shapes
    of SmolLM-360M (15/5 heads) and Hymba-1.5B (25/5)."""
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ref

    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    rows = []

    flash = [(2, S, S, H, Hkv, D, c, w) for S, H, Hkv, D in
             [(128, 4, 2, 64), (256, 2, 2, 128), (256, 6, 2, 64)]
             for c, w in [(True, 0), (True, 64), (False, 0)]]
    flash += [(1, 128, 128, 4, 2, 64, True, 0),         # dtype test shape
              (2, 100, 300, 6, 2, 64, True, 0),         # Sq < Sk, ragged
              (2, 64, 192, 6, 2, 64, False, 32),
              (1, 77, 77, 3, 1, 256, True, 32),         # Gemma's head dim
              (PREFILL_B, PREFILL_S, PREFILL_S, 15, 5, 64, True, 0),
              (2, 300, 300, 25, 5, 64, True, 0),        # Hymba's heads
              (2, 100, 300, 25, 5, 64, True, 0),
              (PREFILL_B, PREFILL_S, PREFILL_S, 25, 5, 64, True, 0)]
    for i, (B, Sq, Sk, H, Hkv, D, c, w) in enumerate(flash):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, dt, seed=i)
            hold_attention(
                "flash_attention",
                fa_k.flash_attention(q, k, v, causal=c, window=w),
                ref.flash_attention_ref(q, k, v, causal=c, window=w),
                f"B={B} Sq={Sq} Sk={Sk} H={H}/{Hkv} D={D} causal={c} "
                f"window={w} {dt}", errs, rows)
            del q, k, v
    decode = [(3, L, H, Hkv, D, [1, L // 2, L]) for L, H, Hkv, D in
              [(256, 4, 2, 64), (512, 8, 8, 128), (1024, 2, 1, 64)]]
    decode += [(3, 777, 15, 5, 64, [1, 388, 777]),      # odd cache
               (2, 300, 16, 16, 256, [300, 17]),
               (DECODE_B, SERVE_CACHE, 15, 5, 64, SERVE_LENS),
               (DECODE_B, DECODE_L, 15, 5, 64, [DECODE_L] * DECODE_B),
               (3, 777, 25, 5, 64, [1, 388, 777]),      # Hymba's heads
               (DECODE_B, SERVE_CACHE, 25, 5, 64, SERVE_LENS)]
    for i, (B, L, H, Hkv, D, lens) in enumerate(decode):
        for dt in (torch.float32, torch.bfloat16):
            _, k, v = _attn_inputs(B, 1, L, H, Hkv, D, dt, seed=100 + i)
            q = _attn_inputs(B, 1, 1, H, Hkv, D, dt, seed=200 + i)[0][:, 0]
            length = torch.tensor(lens, dtype=torch.int32, device="cuda")
            hold_attention(
                "decode_attention",
                dec_k.decode_attention(q.contiguous(), k, v, length),
                ref.decode_attention_ref(q, k, v, length),
                f"B={B} L={L} H={H}/{Hkv} D={D} length={lens} {dt}", errs,
                rows)
            del q, k, v
    report["attention_checks"] = rows
    report["attention_max_abs_err"] = errs
    f32 = [r for r in rows if r["kernel"] == "flash_attention"
           and r["shape"].endswith("torch.float32")]
    worst = max(f32, key=lambda r: r["worst_excess"])
    log(f"attention checks: {len(rows)} kernel calls within attn_tol "
        f"(abs/rel 3e-5 f32; bf16 1e-2 rel + 1e-3 RMS) of their plain "
        f"versions; max |err| {errs}; flash_attention f32 alone: max "
        f"|err| {max(r['max_abs_err'] for r in f32):.3e}, worst excess over "
        f"attn_tol {worst['worst_excess']:.3e} at {worst['shape']}")
    return errs


def check_long_row(report):
    """B4 f32 over ``LONG_ROW`` (causal) against its plain version: within
    ``attn_tol`` and, over the whole output, max |err| at most
    ``LONG_ROW_MAX_ERR``.  Returns the max |err|."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ref

    B, S, _, H, Hkv, D = LONG_ROW
    q, k, v = _attn_inputs(*LONG_ROW, torch.float32, seed=300)
    got = fa_k.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    excess = float(((got - want).abs() - attn_tol(want)).max())
    del q, k, v, want
    tag = f"B={B} S={S} H={H}/{Hkv} D={D} causal f32"
    report["long_row"] = dict(shape=tag, max_abs_err=err, worst_excess=excess)
    log(f"long-row check {tag}: max |err| {err:.3e} (at most "
        f"{LONG_ROW_MAX_ERR:.0e}), worst excess over attn_tol {excess:.3e}")
    if not (bool(torch.isfinite(got).all()) and excess <= 0
            and err <= LONG_ROW_MAX_ERR):
        raise AssertionError(f"flash_attention {tag}: max |err| {err:.3e}, "
                             f"worst excess over attn_tol {excess:.3e}")
    return err


def time_head_dims(report):
    """B4 f32 at ``FLASH_HEAD_DIMS``: device ms beside the 3xTF32 bound.
    Uses only the wrapper's public call, so the same function times
    another checkout's package (put this file at that checkout's root)."""
    from repro_torch.kernels import flash_attention as fa_k

    cpm = sleep_cycles_per_ms()
    rows = []
    for i, (B, S, H, Hkv, D) in enumerate(FLASH_HEAD_DIMS):
        q, k, v = _attn_inputs(B, S, S, H, Hkv, D, torch.float32,
                               seed=400 + i)
        row = dict(shape=f"B={B} S={S} H={H}/{Hkv} D={D} f32 causal",
                   ms=device_ms(lambda: fa_k.flash_attention(q, k, v), cpm,
                                reps=10, inner=3))
        row["bound_ms"], row["bound_by"] = flash_bound(q, k, True, 0)
        rows.append(row)
        log(f"time flash_attention  {row['shape']}: kernel_ms="
            f"{row['ms']:.6f} bound_ms={row['bound_ms']:.6f} "
            f"({row['bound_by']})")
        del q, k, v
    report["flash_head_dims"] = rows
    return rows


def time_decode(H, dtype, lens, L, seed, cpm, Hkv=5, D=64):
    """B5 at (B=len(lens), L, H/Hkv heads, D) with valid ``lens``: device
    ms of the kernel, of the plain version and of SDPA (``library_ms``,
    ``enable_gqa``; ``library_expanded_ms`` on K/V expanded to H heads),
    host-inclusive ``call_ms``, and the bound."""
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import ref

    B = len(lens)
    _, k, v = _attn_inputs(B, 1, L, H, Hkv, D, dtype, seed=seed)
    q = _attn_inputs(B, 1, 1, H, Hkv, D, dtype,
                     seed=seed + 1)[0][:, 0].contiguous()
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (torch.arange(L, device="cuda")[None, :]
            < length[:, None])[:, None, None, :]
    kx, vx = expand_heads(k, H), expand_heads(v, H)
    plain = ref.decode_attention_ref(q, k, v, length)
    kernel = lambda: dec_k.decode_attention(q, k, v, length)
    valid = "(all valid)" if lens == [L] * B else f"length={lens}"
    row = dict(shape=f"B={B} L={L} {valid} H={H}/{Hkv} D={D} "
                     f"{str(dtype).split('.')[-1]}",
               ms=device_ms(kernel, cpm),
               launches_per_call=dec_k.launches_per_call(
                   B, Hkv, L,
                   torch.cuda.get_device_properties(0).multi_processor_count),
               plain_ms=device_ms(lambda: ref.decode_attention_ref(
                   q, k, v, length), cpm, reps=10, inner=3),
               library_ms=device_ms(lambda: sdpa_decode(q, k, v, mask), cpm),
               call_ms=call_ms(kernel),
               library_max_abs_err=max_abs_err(sdpa_decode(q, k, v, mask),
                                               plain),
               library_expanded_ms=device_ms(
                   lambda: sdpa_decode(q, kx, vx, mask), cpm),
               library_expanded_max_abs_err=max_abs_err(
                   sdpa_decode(q, kx, vx, mask), plain))
    row["bound_ms"], row["bound_by"] = decode_bound(q, k, length)
    return row


def time_attention(report):
    """B4 and B5 at SmolLM-360M's full-width shapes (B5 at B=8 x 4096
    valid positions and at the serving lengths in a 512 cache): device ms
    of the kernel, of the plain version and of PyTorch's SDPA
    (``library_ms``: one call with ``enable_gqa=True`` on the same inputs;
    ``library_expanded_ms``: on K/V expanded to H heads beforehand, which
    lets SDPA pick a backend without GQA support), and the bound."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ref

    cpm = sleep_cycles_per_ms()
    out = {}
    q, k, v = _attn_inputs(PREFILL_B, PREFILL_S, PREFILL_S, 15, 5, 64,
                           torch.float32, seed=7)
    lib_err = max_abs_err(sdpa_flash(q, k, v, True),
                          ref.flash_attention_ref(q, k, v))
    kx, vx = expand_heads(k, 15), expand_heads(v, 15)
    row = dict(shape=f"B={PREFILL_B} S={PREFILL_S} H=15/5 D=64 f32 causal",
               ms=device_ms(lambda: fa_k.flash_attention(q, k, v), cpm,
                            reps=10, inner=3),
               plain_ms=device_ms(lambda: ref.flash_attention_ref(q, k, v),
                                  cpm, reps=5, inner=1),
               library_ms=device_ms(lambda: sdpa_flash(q, k, v, True), cpm,
                                    reps=10, inner=3),
               library_max_abs_err=lib_err,
               library_expanded_ms=device_ms(
                   lambda: sdpa_flash(q, kx, vx, True), cpm, reps=10,
                   inner=3),
               library_expanded_max_abs_err=max_abs_err(
                   sdpa_flash(q, kx, vx, True),
                   ref.flash_attention_ref(q, k, v)))
    row["bound_ms"], row["bound_by"] = flash_bound(q, k, True, 0)
    # the f32 CUDA cores' roof of the same work, the SIMT design's bound
    row["simt_bound_ms"] = flash_flops(q, k, True, 0) / F32_FLOPS_PER_S * 1e3
    out["flash_attention"] = row
    del q, k, v, kx, vx
    out["decode_attention"] = time_decode(
        15, torch.float32, [DECODE_L] * DECODE_B, DECODE_L, 8, cpm)
    out["decode_attention_serving"] = time_decode(
        15, torch.float32, SERVE_LENS, SERVE_CACHE, 10, cpm)
    for name, r in out.items():
        log(f"time {name:24s} {r['shape']}: kernel_ms={r['ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"plain_ms={r['plain_ms']:.6f} library_ms={r['library_ms']:.6f} "
            f"(SDPA enable_gqa, max |err| vs plain "
            f"{r['library_max_abs_err']:.2e}) library_expanded_ms="
            f"{r['library_expanded_ms']:.6f} (SDPA on K/V expanded to 15 "
            f"heads, max |err| {r['library_expanded_max_abs_err']:.2e})"
            + (f" call_ms={r['call_ms']:.6f} launches_per_call="
               f"{r['launches_per_call']}" if "call_ms" in r else "")
            + (f" simt_bound_ms={r['simt_bound_ms']:.6f} (f32 CUDA cores)"
               if "simt_bound_ms" in r else ""))
    report["attention_timings"] = out
    return out


def serve_model(arch):
    """``arch`` at full width, random weights from seed 0, on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr

    cfg = get_arch(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, tr.init_lm(gen, cfg, device="cuda")


def layer_counts(cfg):
    """(B4 calls a prefill step, B5 calls a decode step, Mamba layers) of
    ``cfg``: one attention call per attention or Hymba layer (a Hymba
    layer is also a Mamba layer), one more per decoder layer of an
    encoder-decoder (its cross-attention) and, in a prefill, one per
    encoder layer; none in an mLSTM or sLSTM layer."""
    from repro_torch.configs.base import ATTN, SWA
    from repro_torch.configs.base import HYMBA as HYMBA_KIND, MAMBA

    kinds = cfg.pattern()
    n_attn = sum(k in (ATTN, SWA, HYMBA_KIND) for k in kinds)
    if cfg.n_enc_layers:
        n_attn += cfg.n_layers
    return (n_attn + cfg.n_enc_layers, n_attn,
            sum(k in (MAMBA, HYMBA_KIND) for k in kinds))


def prefill_run(cfg, params, report):
    """One full-width prefill step over ``PREFILL_S`` positions
    (``launch.steps.prefill_inputs``: a VLM's first ``frontend_tokens``
    are its patch prefix; an encoder-decoder's ``frontend_tokens`` frames
    go to its encoder beside them): B4 once in each attention layer,
    each encoder layer and each cross-attention, B6 once per 128-token
    chunk in each Mamba layer, no kernel in an mLSTM or sLSTM layer.
    Returns the launch counts."""
    from repro_torch.launch.steps import make_prefill_step, prefill_inputs

    step = make_prefill_step(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    inputs = prefill_inputs(cfg, PREFILL_B, PREFILL_S, g)
    step(params, dict(inputs, tokens=inputs["tokens"][:, :256]))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.perf_counter()
    logits = step(params, inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = all_counts()
    n_attn, _, n_mamba = layer_counts(cfg)
    check_path_counts(f"{cfg.name} prefill", counts, {
        "flash_attention": n_attn,
        "ssm_scan": n_mamba * -(-PREFILL_S // SCAN_CHUNK)})
    if logits.shape != (PREFILL_B, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    inputs_shapes = {k: list(v.shape) for k, v in inputs.items()}
    report.setdefault("prefill", {})[cfg.name] = dict(
        B=PREFILL_B, S=PREFILL_S, inputs=inputs_shapes,
        compute_dtype=cfg.compute_dtype, ms=ms, launches=counts,
        peak_gb=peak_gb)
    log(f"prefill {cfg.name} B={PREFILL_B} S={PREFILL_S} "
        f"(inputs {inputs_shapes}, {cfg.compute_dtype}): {ms:.3f} ms, "
        f"{PREFILL_B * PREFILL_S / ms * 1e3:.1f} tokens/s, launches "
        f"flash_attention={counts['flash_attention']} "
        f"ssm_scan={counts['ssm_scan']}, peak {peak_gb:.2f} GB")
    return counts


def generate_run(cfg, params, report, memory=None):
    """``ServeEngine.generate``: 8 requests, half greedy and half sampled,
    prompts of 16-256 tokens (prefilled token by token through the decode
    step, as the reference does), 32 new tokens each.  B5 in every
    attention layer (and cross-attention) of every step, no B6.  An
    encoder-decoder's engines get ``memory`` (B, F, d) in their state
    first.  Returns the launch counts."""
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.serving import ServeEngine, ServeRequest

    rng = np.random.RandomState(2)
    reqs = [ServeRequest(
        prompt=rng.randint(0, cfg.vocab_size,
                           rng.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1)
                           ).astype(np.int32),
        max_new=SERVE_MAX_NEW, temperature=0.0 if i % 2 == 0 else 0.7,
        rid=i) for i in range(SERVE_REQUESTS)]
    reqs[0].prompt = reqs[0].prompt[:SERVE_PROMPT[0]]
    reqs[1].prompt = rng.randint(0, cfg.vocab_size, SERVE_PROMPT[1]).astype(
        np.int32)

    def engine(seed):
        eng = ServeEngine(params, cfg, batch=SERVE_REQUESTS,
                          cache_len=SERVE_CACHE, seed=seed, device="cuda")
        if memory is not None:
            eng.state["memory"] = memory
        return eng

    engine(0).generate([ServeRequest(prompt=r.prompt[:8], max_new=2)
                        for r in reqs])                     # warm-up
    eng = engine(3)
    torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_counts()
    per_call = dec_k.launches_per_call(
        SERVE_REQUESTS, cfg.n_kv_heads, SERVE_CACHE,
        torch.cuda.get_device_properties(0).multi_processor_count)
    check_path_counts(f"{cfg.name} generate", counts, {
        "decode_attention": layer_counts(cfg)[1] * eng.steps * per_call})
    for r, o in zip(reqs, outs):
        if len(o) != r.max_new or not ((o >= 0) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"generate: request {r.rid} gave {o}")
    new = sum(len(o) for o in outs)
    ms_step = secs * 1e3 / eng.steps
    report.setdefault("generate", {})[cfg.name] = dict(
        requests=len(reqs), prompt_lens=[len(r.prompt) for r in reqs],
        max_new=SERVE_MAX_NEW, cache_len=SERVE_CACHE, steps=eng.steps,
        s=secs, ms_per_step=ms_step, new_tokens=new,
        new_tokens_per_s=new / secs, launches=counts,
        decode_launches_per_call=per_call)
    log(f"generate {cfg.name}: {len(reqs)} requests, prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, {SERVE_MAX_NEW} new "
        f"each, cache {SERVE_CACHE}: {eng.steps} decode steps in "
        f"{secs:.3f} s = {ms_step:.3f} ms per step, {new / secs:.1f} new "
        f"tokens/s, launches decode_attention="
        f"{counts['decode_attention']} ({layer_counts(cfg)[1]} calls per "
        f"step, {per_call} launches per call) ssm_scan={counts['ssm_scan']}")
    return counts


def serve_cpu_vs_cuda(cfg, report):
    """The same full-width weights on the CPU and on the card: a prefill
    step over a 2 x 32-token greedy prompt, then the prompt token by token
    through the decode step and 8 greedy steps (both devices fed the
    CPU's tokens, so every step compares like with like).

    Bound: |logit difference| <= 2e-3.  The devices sum in other orders
    (matmul blocking over d = 960 and d_ff = 2560, the attention core's
    key order), each f32 sum off by ~sqrt(n) ulp relative; through 32
    residual layers that is ~1e-4 relative on the hidden state, and the
    random-weight logits here are O(1) (|logit| < 10).  A greedy token
    may differ only where the CPU's top-2 margin is inside that bound."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as tr

    bound = 2e-3
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {"cuda": tr.init_lm(gen, cfg, device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    params["cpu"] = tr.init_lm(gen, cfg, device="cpu")
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                              (VS_ROWS, VS_PROMPT))
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    logits = {}
    for dev in ("cpu", "cuda"):
        toks = torch.from_numpy(prompt).to(dev)
        logits[dev] = [prefill(params[dev], {"tokens": toks}).cpu()]
    states = {dev: tr.init_decode_state(cfg, VS_ROWS, VS_PROMPT + VS_STEPS,
                                        torch.float32, device=dev)
              for dev in ("cpu", "cuda")}
    seq = prompt
    flips, greedy_equal = [], 0
    for t in range(VS_PROMPT + VS_STEPS):
        step_logits = {}
        for dev in ("cpu", "cuda"):
            tok = torch.from_numpy(np.ascontiguousarray(seq[:, t:t + 1]))
            out, states[dev] = decode(params[dev], states[dev], tok.to(dev),
                                      t)
            step_logits[dev] = out[:, 0].cpu()
            logits[dev].append(step_logits[dev])
        if t < VS_PROMPT - 1:
            continue
        a = step_logits["cpu"][:, :cfg.vocab_size]
        greedy_equal += greedy_check(a, step_logits["cuda"][:, :cfg.vocab_size],
                                     bound, t, "serve cpu vs cuda", flips)
        seq = np.concatenate([seq, a.argmax(-1).numpy()[:, None]], axis=1)
    diff = max(float((a - b).abs().max())
               for a, b in zip(logits["cpu"], logits["cuda"]))
    scale = max(float(a.abs().max()) for a in logits["cpu"])
    if not diff <= bound:
        raise AssertionError(f"serve cpu vs cuda: max logit difference "
                             f"{diff:.3e} > {bound}")
    report["serve_cpu_vs_cuda"] = dict(
        max_logit_diff=diff, max_abs_logit=scale, bound=bound,
        greedy_equal=greedy_equal, greedy_compared=greedy_equal + len(flips),
        flips=flips)
    log(f"serve cpu vs cuda ({ARCH} full width, {VS_ROWS} x {VS_PROMPT} "
        f"prompt, prefill + {VS_PROMPT + VS_STEPS} decode steps): max "
        f"|logit diff| = {diff:.3e} (bound {bound}, max |logit| "
        f"{scale:.3f}); greedy tokens equal {greedy_equal}/"
        f"{greedy_equal + len(flips)}; flips inside the bound: {flips}")
    del params, states


def time_attention_hymba(report):
    """B4 and B5 at Hymba-1.5B's shapes in bf16 (25/5 heads): its prefill
    step's (B=4, S=4096, causal) and its generate's (B=8, cache 512 at
    the serving lengths): kernel, plain version, SDPA (``enable_gqa``) and
    bound, device ms."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ref

    cpm = sleep_cycles_per_ms()
    bf = torch.bfloat16
    out = {}
    q, k, v = _attn_inputs(PREFILL_B, PREFILL_S, PREFILL_S, 25, 5, 64, bf,
                           seed=17)
    row = dict(shape=f"B={PREFILL_B} S={PREFILL_S} H=25/5 D=64 bf16 causal",
               ms=device_ms(lambda: fa_k.flash_attention(q, k, v), cpm,
                            reps=10, inner=3),
               plain_ms=device_ms(lambda: ref.flash_attention_ref(q, k, v),
                                  cpm, reps=5, inner=1),
               library_ms=device_ms(lambda: sdpa_flash(q, k, v, True), cpm,
                                    reps=10, inner=3))
    row["bound_ms"], row["bound_by"] = flash_bound(q, k, True, 0)
    out["flash_attention"] = row
    del q, k, v
    out["decode_attention"] = time_decode(25, bf, SERVE_LENS, SERVE_CACHE,
                                          18, cpm)
    for name, r in out.items():
        log(f"time {name:18s} hymba {r['shape']}: kernel_ms={r['ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"plain_ms={r['plain_ms']:.6f} library_ms={r['library_ms']:.6f} "
            f"(SDPA enable_gqa)")
    report["attention_timings_hymba"] = out
    return out


def scan_inputs(B, S, D, N, dtype, seed, with_h0=True):
    """a in [0.2, 0.999) (decays, as exp(delta A) gives), b ~ 0.1 N(0, 1),
    in ``dtype``; h0 ~ N(0, 1) f32 or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand((B, S, D, N), generator=g, device="cuda") * 0.799 + 0.2
    b = torch.randn((B, S, D, N), generator=g, device="cuda") * 0.1
    h0 = (torch.randn((B, D, N), generator=g, device="cuda") if with_h0
          else None)
    return a.to(dtype), b.to(dtype), h0


def scan_bound(a, h0):
    """B6's least time: a and b read once, hs (f32) written once, h0 read
    once, over 3.35 TB/s; or two flops per element over the f32 rate."""
    nbytes = a.numel() * (2 * a.element_size() + 4) + (
        0 if h0 is None else 4 * h0.numel())
    return _bound(2 * a.numel() / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def check_scan(report):
    """B6 against its plain version on the card, bit for bit: the
    reference's TPU test grid (tests/test_kernels.py, B=2), the prefill
    chunk shape, shapes that are multiples of nothing; f32 and bf16 a, b;
    from zeros and from a nonzero h0; one launch per call.  And two
    chained calls (h0 = the first's last state) against one call over the
    whole sequence, as the model's chunk loop chains them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm_k

    shapes = [(2, S, D, N) for S, D, N in [(128, 64, 8), (256, 256, 16),
                                           (64, 128, 4)]]
    shapes += [SCAN_TIMED[0], (3, 77, 100, 5), (5, 33, 7, 3), (1, 1, 1, 1)]
    n, err = 0, 0.0
    for i, shape in enumerate(shapes):
        for dt in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                a, b, h0 = scan_inputs(*shape, dt, seed=300 + i,
                                       with_h0=with_h0)
                ssm_k.reset_launch_counts()
                got = ssm_k.ssm_scan(a, b, h0)
                want = ref.ssm_scan_ref(a, b, h0)
                torch.cuda.synchronize()
                tag = f"ssm_scan {shape} {dt} h0={with_h0}"
                if got.dtype != torch.float32 or got.shape != a.shape:
                    raise AssertionError(f"{tag}: {got.dtype}"
                                         f"{tuple(got.shape)}")
                if ssm_k.LAUNCHES["ssm_scan"] != 1:
                    raise AssertionError(f"{tag}: {ssm_k.LAUNCHES}")
                if not bits_equal(got, want):
                    raise AssertionError(f"{tag}: kernel != plain version "
                                         f"(max |err| "
                                         f"{max_abs_err(got, want)})")
                err = max(err, max_abs_err(got, want))
                n += 1
    B, _, D, N = SCAN_TIMED[0]
    a, b, _ = scan_inputs(B, 2 * SCAN_CHUNK, D, N, torch.float32, seed=399,
                          with_h0=False)
    first = ssm_k.ssm_scan(a[:, :SCAN_CHUNK].contiguous(),
                           b[:, :SCAN_CHUNK].contiguous())
    second = ssm_k.ssm_scan(a[:, SCAN_CHUNK:].contiguous(),
                            b[:, SCAN_CHUNK:].contiguous(),
                            first[:, -1].contiguous())
    if not bits_equal(torch.cat([first, second], 1), ssm_k.ssm_scan(a, b)):
        raise AssertionError("ssm_scan: two chained chunks != one scan")
    n += 3
    report["scan_checks"] = n
    log(f"scan checks: {n} B6 calls equal their plain versions bit for bit "
        f"({len(shapes)} shapes x f32/bf16 x zeros/h0, and a chain of two "
        f"chunks against one scan)")
    return err


def time_scan(report):
    """B6 at the prefill chunk shape (the main path's) and at one
    bandwidth shape, f32 with a nonzero h0: device ms of kernel and plain
    version, and the bound.  No single PyTorch call computes the
    recurrence (a cumprod/cumsum rewrite underflows at these decays), so
    there is no library time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm_k

    cpm = sleep_cycles_per_ms()
    rows = []
    for i, shape in enumerate(SCAN_TIMED):
        a, b, h0 = scan_inputs(*shape, torch.float32, seed=500 + i)
        inner = 10 if shape[1] == SCAN_CHUNK else 3
        row = dict(shape=shape, ms=device_ms(
            lambda: ssm_k.ssm_scan(a, b, h0), cpm, reps=20, inner=inner),
                   plain_ms=device_ms(lambda: ref.ssm_scan_ref(a, b, h0),
                                      cpm, reps=5, inner=1),
                   call_ms=call_ms(lambda: ssm_k.ssm_scan(a, b, h0),
                                   inner=inner),
                   library_ms=None)
        row["bound_ms"], row["bound_by"] = scan_bound(a, h0)
        rows.append(row)
        log(f"time ssm_scan {shape} f32 h0: kernel_ms={row['ms']:.6f} "
            f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.3f} of it) "
            f"plain_ms={row['plain_ms']:.6f} call_ms={row['call_ms']:.6f} "
            f"library_ms=null")
        del a, b, h0
    report["scan_timings"] = rows
    return rows[0]


def greedy_check(a, b, bound, step, label, flips):
    """Greedy tokens of the CPU's logits ``a`` and the card's ``b`` (rows
    x vocab) agree, or the CPU's top-2 margin is inside ``bound``; each
    such flip is appended to ``flips``.  Returns how many rows agree."""
    top2 = a.topk(2, dim=-1).values
    ga, gb = a.argmax(-1), b.argmax(-1)
    equal = 0
    for r in range(a.shape[0]):
        if int(ga[r]) == int(gb[r]):
            equal += 1
            continue
        margin = float(top2[r, 0] - top2[r, 1])
        flips.append(dict(step=step, row=r, margin=margin))
        if margin > bound:
            raise AssertionError(
                f"{label}: greedy token differs at step {step} row {r} "
                f"with top-2 margin {margin:.3e} > {bound}")
    return equal


def hymba_cpu_vs_cuda(cfg, params, report):
    """Hymba-1.5B at full width in an f32 copy of its config (the weights
    are f32 already; the compute, bf16 in the timed runs, is f32 here so
    the bounds stay tight).

    * CPU vs card, same weights: the prefill forward over a 2 x 160-token
      prompt (B6 over one whole chunk and one padded chunk; the logits of
      every position), then the first 16 prompt tokens token by token
      through the decode step and 8 greedy steps (both devices fed the
      CPU's tokens).  Bound |logit difference| <= 2e-3, the argument of
      ``serve_cpu_vs_cuda``: f32 sums in other orders (d = 1600, d_ff =
      5504, the scan's f32 state) through 32 residual layers give ~1e-4
      relative, on logits of O(1).  A greedy token may differ only where
      the CPU's top-2 margin is inside the bound.
    * Prefill vs decode on the card: the same 2 x 160 prompt token by
      token through the decode step against the card's prefill logits,
      within abs/rel 5e-4, the reference's bound for Hymba
      (tests/test_arch_smoke.py).  This checks h carried across the chunk
      boundary and the Mamba decode state (h, the conv window)."""
    import dataclasses

    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as tr

    bound, pd_tol = 2e-3, 5e-4
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    both = {"cuda": params, "cpu": tr.init_lm(gen, cfg, device="cpu")}
    prompt = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (HYMBA_VS_ROWS, HYMBA_VS_PROMPT))
    full = {dev: tr.forward_logits(
        both[dev], {"tokens": torch.from_numpy(prompt).to(dev)}, cfg32)[0]
        for dev in ("cpu", "cuda")}
    prefill_diff = float((full["cpu"] - full["cuda"].cpu()).abs().max())
    if not prefill_diff <= bound:
        raise AssertionError(f"hymba cpu vs cuda: prefill logits differ by "
                             f"{prefill_diff:.3e} > {bound}")

    decode = make_decode_step(cfg32)
    steps = HYMBA_VS_DECODE + HYMBA_VS_STEPS
    states = {dev: tr.init_decode_state(cfg32, HYMBA_VS_ROWS, steps,
                                        torch.float32, device=dev)
              for dev in ("cpu", "cuda")}
    seq = prompt[:, :HYMBA_VS_DECODE]
    decode_diff, flips, greedy_equal = 0.0, [], 0
    for t in range(steps):
        out = {}
        for dev in ("cpu", "cuda"):
            tok = torch.from_numpy(np.ascontiguousarray(seq[:, t:t + 1]))
            lg, states[dev] = decode(both[dev], states[dev], tok.to(dev), t)
            out[dev] = lg[:, 0, :cfg.vocab_size].cpu()
        decode_diff = max(decode_diff,
                          float((out["cpu"] - out["cuda"]).abs().max()))
        if t >= HYMBA_VS_DECODE - 1:
            greedy_equal += greedy_check(out["cpu"], out["cuda"], bound, t,
                                         "hymba cpu vs cuda", flips)
            seq = np.concatenate([seq, out["cpu"].argmax(-1).numpy()[:, None]],
                                 axis=1)
    if not decode_diff <= bound:
        raise AssertionError(f"hymba cpu vs cuda: decode logits differ by "
                             f"{decode_diff:.3e} > {bound}")
    del both["cpu"], states

    state = tr.init_decode_state(cfg32, HYMBA_VS_ROWS, HYMBA_VS_PROMPT,
                                 torch.float32, device="cuda")
    toks = torch.from_numpy(prompt).cuda()
    pd_diff = 0.0
    for t in range(HYMBA_VS_PROMPT):
        lg, state = decode(params, state, toks[:, t:t + 1], t)
        want = full["cuda"][:, t]
        d = (lg[:, 0] - want).abs()
        pd_diff = max(pd_diff, float(d.max()))
        if bool((d > pd_tol + pd_tol * want.abs()).any()):
            raise AssertionError(f"hymba prefill vs decode: position {t} "
                                 f"differs by {float(d.max()):.3e} > abs/rel "
                                 f"{pd_tol}")
    scale = float(full["cpu"].abs().max())
    report["hymba_cpu_vs_cuda"] = dict(
        prefill_max_logit_diff=prefill_diff,
        decode_max_logit_diff=decode_diff, bound=bound,
        max_abs_logit=scale, greedy_equal=greedy_equal,
        greedy_compared=greedy_equal + len(flips), flips=flips,
        prefill_vs_decode_max_diff=pd_diff, prefill_vs_decode_tol=pd_tol)
    log(f"hymba cpu vs cuda ({HYMBA} full width, f32 copy of the config): "
        f"prefill {HYMBA_VS_ROWS} x {HYMBA_VS_PROMPT} max |logit diff| = "
        f"{prefill_diff:.3e}, {HYMBA_VS_DECODE} + {HYMBA_VS_STEPS} decode "
        f"steps max |logit diff| = {decode_diff:.3e} (bound {bound}, max "
        f"|logit| {scale:.3f}); greedy tokens equal {greedy_equal}/"
        f"{greedy_equal + len(flips)}; flips inside the bound: {flips}")
    log(f"hymba prefill vs token-by-token decode on the card, "
        f"{HYMBA_VS_ROWS} x {HYMBA_VS_PROMPT} positions: max |diff| = "
        f"{pd_diff:.3e} (abs/rel {pd_tol})")

def decode_label(H, Hkv, D, dtype):
    """B5's instance for H query and Hkv KV heads of dim D in ``dtype``:
    ``decode_cluster<D,T,GP>``, GP the query heads per KV head, at most 8
    a pass (``kMaxGroup``)."""
    tname = "float" if dtype == torch.float32 else "bf16"
    return f"decode_cluster<{D},{tname},{min(H // Hkv, 8)}>"


class RouteLog:
    """Wraps ``models.moe.route`` while active and keeps each call's
    ``Routing`` (on its device; nothing is read until asked)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe.route, []

    def __enter__(self):
        def spy(*args, **kwargs):
            r = self.real(*args, **kwargs)
            self.calls.append(r)
            return r
        self.moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def moe_prefill_run(cfg, params, report):
    """:func:`prefill_run` on an MoE model, also counting the (token,
    slot) pairs its capacity dropped in the timed step (the last
    ``n_layers`` routings).  Returns the launch counts."""
    from repro_torch.models import moe

    with RouteLog() as routes:
        counts = prefill_run(cfg, params, report)
    timed = routes.calls[-cfg.n_layers:]
    pairs = PREFILL_B * PREFILL_S * cfg.moe.top_k
    if len(routes.calls) != 2 * cfg.n_layers or any(
            r.keep.numel() != pairs for r in timed):
        raise AssertionError(f"{cfg.name} prefill: {len(routes.calls)} "
                             f"routings, expected {2 * cfg.n_layers}")
    dropped = [int((~r.keep).sum()) for r in timed]
    cap = moe.capacity(PREFILL_B * PREFILL_S, cfg)
    report["prefill"][cfg.name].update(
        capacity=cap, dropped_pairs=sum(dropped),
        dropped_pairs_per_layer=dropped, pairs_per_layer=pairs)
    log(f"prefill {cfg.name}: capacity {cap} slots per expert; (token, slot) "
        f"pairs dropped {sum(dropped)} of {pairs * cfg.n_layers} "
        f"({100 * sum(dropped) / (pairs * cfg.n_layers):.3f} %; per layer "
        f"min {min(dropped)} max {max(dropped)})")
    return counts


def moe_forms(cfg, params, report):
    """The scatter and einsum forms of one of ``cfg``'s MoE layers on the
    card, over ``MOE_FORMS_BS`` tokens at capacity factor 4 (neither
    drops: checked).  f32: the two within abs/rel 1e-4, the reference's
    bound between them (tests/test_variants_and_perf.py).  bf16: the two
    round at other places (the scatter form each gated product, the
    einsum form their sum, and the expert products by their own batch
    shapes), and where the k gated terms cancel an element misses
    ``attn_tol``'s bf16 form (the share is printed; ~1-3 % in a CPU run at
    this width), so each bf16 form is held to the f32 scatter form on the
    same inputs: RMS error <= 2^-5 and max error <= 2^-2 of the output's
    RMS (CPU, full width: 0.0057 and 0.040).  The aux losses come from one
    routing, so they are equal."""
    from repro_torch.models import moe

    c = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    p = params["layers"][0]["moe"]
    g = torch.Generator(device="cuda").manual_seed(6)
    xb = torch.randn(*MOE_FORMS_BS, cfg.d_model, generator=g,
                     device="cuda").bfloat16()
    out, ys = {}, {}
    for x in (xb.float(), xb):
        with RouteLog() as routes:
            y1, a1 = moe.moe_ffn(p, x, c)
            y2, a2 = moe.moe_ffn_einsum(p, x, c)
        torch.cuda.synchronize()
        name = str(x.dtype).split(".")[-1]
        ys[name] = (y1.float(), y2.float())
        out[name] = dict(
            dropped=[int((~r.keep).sum()) for r in routes.calls],
            max_abs_err=max_abs_err(y1, y2), aux=[float(a1), float(a2)],
            finite=bool(torch.isfinite(y1).all() & torch.isfinite(y2).all()))
        if out[name]["dropped"] != [0, 0] or not (
                out[name]["finite"] and torch.equal(a1, a2)):
            raise AssertionError(f"moe scatter vs einsum {name}: "
                                 f"{out[name]}")
    y32 = ys["float32"][0]
    rms = float(y32.pow(2).mean().sqrt())
    miss = (ys["float32"][0] - ys["float32"][1]).abs() - (1e-4 + 1e-4
                                                          * y32.abs())
    out["float32"]["worst_excess"] = float(miss.max())
    errs = [(yb - y32) for yb in ys["bfloat16"]]
    out["bfloat16"].update(
        rms_err_over_rms=[float(e.pow(2).mean().sqrt()) / rms for e in errs],
        max_err_over_rms=[float(e.abs().max()) / rms for e in errs],
        over_attn_tol=float(((ys["bfloat16"][0] - ys["bfloat16"][1]).abs()
                             > attn_tol(ys["bfloat16"][0].bfloat16()))
                            .float().mean()))
    cpm = sleep_cycles_per_ms()
    ms = {name: device_ms(lambda f=f: f(p, xb, c), cpm, reps=5, inner=2)
          for name, f in (("scatter", moe.moe_ffn),
                          ("einsum", moe.moe_ffn_einsum))}
    report["moe_forms"] = dict(arch=cfg.name, tokens=list(MOE_FORMS_BS),
                               bf16_ms=ms, **out)
    b = out["bfloat16"]
    log(f"moe scatter vs einsum ({cfg.name} layer 0, {MOE_FORMS_BS[0]} x "
        f"{MOE_FORMS_BS[1]} tokens, capacity factor 4, no drops, equal "
        f"aux): f32 max |diff| {out['float32']['max_abs_err']:.3e} (abs/rel "
        f"1e-4); bf16 vs the f32 scatter form, scatter / einsum: RMS error "
        f"{b['rms_err_over_rms'][0]:.4f} / {b['rms_err_over_rms'][1]:.4f}, "
        f"max {b['max_err_over_rms'][0]:.4f} / {b['max_err_over_rms'][1]:.4f}"
        f" of the output's RMS (bounds 2^-5, 2^-2); bf16 forms' share over "
        f"attn_tol {b['over_attn_tol']:.4f}; bf16 device ms scatter "
        f"{ms['scatter']:.3f} einsum {ms['einsum']:.3f}")
    if (out["float32"]["worst_excess"] > 0
            or max(b["rms_err_over_rms"]) > 2.0 ** -5
            or max(b["max_err_over_rms"]) > 2.0 ** -2):
        raise AssertionError(f"moe scatter vs einsum: {out}")


def routing_flips(cpu, gpu, S, bound):
    """Compare two devices' routings layer by layer (``Routing``s over B x
    S tokens).  Returns (near-ties, downstream flips, keep pairs compared,
    keep pairs equal): a token whose experts differ must be a near-tie
    (the CPU's gap at the first differing slot below ``bound``) unless an
    earlier layer's flip reached it (its position or an earlier one of
    its row); the keep masks are compared over the (token, slot) pairs
    ahead of the first flip of the layer in token order (a flip shifts
    the positions of every later pair in two experts).  Raises on a flip
    beyond a near-tie."""
    B = cpu[0].idx.shape[0] // S
    first = np.full(B, S)
    ties, downstream, compared, equal = [], [], 0, 0
    for layer, (a, b) in enumerate(zip(cpu, gpu)):
        ia, ib = a.idx.cpu(), b.idx.cpu()
        ka, kb = a.keep.cpu(), b.keep.cpu()
        top = a.probs.cpu().sort(dim=-1, descending=True).values
        reached = first.copy()
        rows = torch.nonzero((ia != ib).any(1)).flatten().tolist()
        for t in rows:
            r, s = divmod(t, S)
            j = int(torch.nonzero(ia[t] != ib[t])[0])
            gap = float(top[t, j] - top[t, j + 1])
            flip = dict(layer=layer, token=t, slot=j, gap=gap)
            if s >= reached[r]:
                downstream.append(flip)
            elif gap < bound:
                ties.append(flip)
            else:
                raise AssertionError(
                    f"moe cpu vs cuda: layer {layer} token {t} routes to "
                    f"{ia[t].tolist()} on the CPU, {ib[t].tolist()} on the "
                    f"card, at a gap of {gap:.3e} (near-tie: < {bound})")
            first[r] = min(first[r], s)
        n = rows[0] if rows else ia.shape[0]
        compared += ka[:n].numel()
        equal += int((ka[:n] == kb[:n]).sum())
    if equal != compared:
        raise AssertionError(f"moe cpu vs cuda: keep masks differ at "
                             f"{compared - equal} of {compared} (token, slot) "
                             f"pairs ahead of any flip")
    return ties, downstream, compared, equal


def moe_cpu_vs_cuda(report):
    """Granite-MoE at full width, cut to ``MOE_VS_LAYERS`` layers, in an
    f32 copy of its config, with the same weights on the CPU and on the
    card: the prefill forward over a ``MOE_VS_ROWS`` x ``MOE_VS_PROMPT``
    prompt.  The routing (top-k experts, keep mask) must agree but at
    near-ties (:func:`routing_flips`, each counted and printed); the
    logits are then held to ``serve_cpu_vs_cuda``'s bound, 2e-3, and only
    when no token flipped (else that comparison is reported skipped)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr

    bound = 2e-3
    cfg = dataclasses.replace(get_arch(MOE_ARCHS[0]), n_layers=MOE_VS_LAYERS,
                              compute_dtype="float32")
    prompt = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (MOE_VS_ROWS, MOE_VS_PROMPT)))
    logits, routes = {}, {}
    for dev in ("cuda", "cpu"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tr.init_lm(gen, cfg, device=dev)
        with RouteLog() as log_:
            logits[dev] = tr.forward_logits(
                params, {"tokens": prompt.to(dev)}, cfg)[0].cpu()
        routes[dev] = log_.calls
        del params
    ties, downstream, compared, equal = routing_flips(
        routes["cpu"], routes["cuda"], MOE_VS_PROMPT, MOE_NEAR_TIE)
    diff = float((logits["cpu"] - logits["cuda"]).abs().max())
    flipped = bool(ties or downstream)
    if not flipped and not diff <= bound:
        raise AssertionError(f"moe cpu vs cuda: logits differ by {diff:.3e} "
                             f"> {bound}")
    if not bool(torch.isfinite(logits["cuda"]).all()):
        raise AssertionError("moe cpu vs cuda: non-finite logits on the card")
    report["moe_cpu_vs_cuda"] = dict(
        arch=cfg.name, layers=MOE_VS_LAYERS, rows=MOE_VS_ROWS,
        prompt=MOE_VS_PROMPT, near_ties=ties, downstream_flips=downstream,
        keep_pairs_compared=compared, keep_pairs_equal=equal,
        max_logit_diff=diff, bound=bound,
        logits_compared=not flipped)
    log(f"moe cpu vs cuda ({cfg.name} full width, {MOE_VS_LAYERS} layers, "
        f"f32 copy of the config, {MOE_VS_ROWS} x {MOE_VS_PROMPT} prompt): "
        f"routing near-ties (gap < {MOE_NEAR_TIE}) {len(ties)} {ties}, "
        f"flips downstream of them {len(downstream)}; keep masks equal at "
        f"{equal}/{compared} pairs ahead of any flip; max |logit diff| = "
        f"{diff:.3e} " + (f"(bound {bound})" if not flipped else
                          "(not held: a routing flip occurred)"))


def moe_runs(report, launches):
    """Each MoE model at full width on the card: a prefill step and a
    generate (launches added to ``launches``), and for Granite the
    scatter-vs-einsum check and :func:`placed_serve`'s einsum prefills
    with and without ``moe_group_shard``; each model freed before the
    next."""
    for arch in MOE_ARCHS:
        cfg, params = serve_model(arch)
        for run in (moe_prefill_run, generate_run):
            for name, n in run(cfg, params, report).items():
                launches[name] += n
        if arch == MOE_ARCHS[0]:
            moe_forms(cfg, params, report)
        if arch in PLACED_PAIRS:
            placed_serve(arch, cfg, params, report, launches)
        del params
        torch.cuda.empty_cache()


def hold_and_time_attention(model, flash, decode, dtype, seed, report,
                            errs):
    """B4 at each (B, Sq, Sk, H, Hkv, D, causal) of ``flash`` and B5 at
    each (B, L, H, Hkv, D, lengths) of ``decode``, in ``dtype``: each held
    against its plain version within ``attn_tol`` (max |err| into
    ``errs``), then timed (device ms) beside the plain version, SDPA
    (``enable_gqa``) and the bound.  Returns {kernel: rows} for the
    kernels line, each row naming the instance its shape launches."""
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ref

    cpm = sleep_cycles_per_ms()
    name = str(dtype).split(".")[-1]
    fn = "dispatch_f32" if dtype == torch.float32 else "dispatch_bf16"
    rows = {"flash_attention": [], "decode_attention": []}
    checks = report.setdefault("attention_checks_serving", [])
    for i, (B, Sq, Sk, H, Hkv, D, causal) in enumerate(flash):
        q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, dtype, seed=seed + i)
        tag = (f"{model} B={B} Sq={Sq} Sk={Sk} H={H}/{Hkv} D={D} "
               f"causal={causal} {name}")
        hold_attention("flash_attention",
                       fa_k.flash_attention(q, k, v, causal=causal),
                       ref.flash_attention_ref(q, k, v, causal=causal), tag,
                       errs, checks)
        row = dict(model=model, shape=tag, kernel=kernel_label(report, fn, D),
                   ms=device_ms(lambda: fa_k.flash_attention(
                       q, k, v, causal=causal), cpm, reps=10, inner=3),
                   plain_ms=device_ms(lambda: ref.flash_attention_ref(
                       q, k, v, causal=causal), cpm, reps=5, inner=1),
                   library_ms=device_ms(lambda: sdpa_flash(q, k, v, causal),
                                        cpm, reps=10, inner=3),
                   library_max_abs_err=max_abs_err(
                       sdpa_flash(q, k, v, causal),
                       ref.flash_attention_ref(q, k, v, causal=causal)),
                   library_flash=sdpa_takes_flash(q, k, v, causal))
        row["bound_ms"], row["bound_by"] = flash_bound(q, k, causal, 0)
        rows["flash_attention"].append(row)
        del q, k, v
    for j, (B, L, H, Hkv, D, lens) in enumerate(decode):
        _, k, v = _attn_inputs(B, 1, L, H, Hkv, D, dtype, seed=seed + 50 + j)
        q = _attn_inputs(B, 1, 1, H, Hkv, D, dtype,
                         seed=seed + 70 + j)[0][:, 0].contiguous()
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        tag = f"{model} B={B} L={L} H={H}/{Hkv} D={D} length={lens} {name}"
        hold_attention("decode_attention",
                       dec_k.decode_attention(q, k, v, length),
                       ref.decode_attention_ref(q, k, v, length), tag, errs,
                       checks)
        del q, k, v
        row = time_decode(H, dtype, lens, L, seed + 90 + j, cpm, Hkv=Hkv,
                          D=D)
        label = decode_label(H, Hkv, D, dtype)
        if label not in report["ptxas"]:
            raise AssertionError(f"no ptxas lines for {label}")
        rows["decode_attention"].append(dict(
            model=model, shape=f"{model} {row['shape']}", kernel=label,
            ptxas=report["ptxas"][label],
            **{k: row[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                   "library_ms", "library_max_abs_err")}))
    for kernel, rs in rows.items():
        for r in rs:
            log(f"time {kernel:18s} {r['shape']}: kernel_ms={r['ms']:.6f} "
                f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
                f"plain_ms={r['plain_ms']:.6f} library_ms="
                f"{r['library_ms']:.6f} (SDPA enable_gqa"
                + ("" if r.get("library_flash", True) else
                   ", not its flash backend: flash refuses the call")
                + f", max |err| vs plain {r['library_max_abs_err']:.2e}) "
                f"{r['kernel']}")
    return rows


def smoke_cpu_vs_cuda(arch, report):
    """The 2-layer f32 smoke model of ``arch`` (``reduce_for_smoke``: d
    256, 16 frames or patches) with the same weights on the CPU and on
    the card:

    * the prefill logits of every text position over ``SMOKE_VS_ROWS`` x
      ``SMOKE_VS_S`` positions (``prefill_inputs``), B4 once per call of
      ``layer_counts`` on the card;
    * ``SMOKE_VS_DECODE`` decode steps of the prompt's text, an
      encoder-decoder's against ``encode`` of the same frames, B5 once per
      call a step;
    * the greedy tokens of a ``ServeEngine.generate`` (2 prompts,
      ``SMOKE_VS_NEW`` new tokens, the same memory) equal.

    Logits within ``serve_cpu_vs_cuda``'s bound, 2e-3 (f32 sums in the
    devices' own orders).  For xLSTM also the card's prefill against its
    own token-by-token decode within abs/rel 5e-4, the reference's bound
    (tests/test_arch_smoke.py): the chunkwise prefill, its stabilizer
    started at m = 0, against the recurrence from m = -1e9."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.steps import make_decode_step, prefill_inputs
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine, ServeRequest

    bound, pd_tol = 2e-3, 5e-4
    cfg = reduce_for_smoke(get_arch(arch))
    cpu = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = {"cpu": cpu, "cuda": tr.lm_params_from_numpy(
        tr.lm_params_to_numpy(cpu, cfg), cfg, device="cuda")}
    inputs = prefill_inputs(cfg, SMOKE_VS_ROWS, SMOKE_VS_S,
                            torch.Generator().manual_seed(4))
    toks = inputs["tokens"]
    n_prefill, n_step, _ = layer_counts(cfg)
    full, memory, counts = {}, {}, {}
    for dev in ("cpu", "cuda"):
        reset_all_counts()
        full[dev] = tr.forward_logits(
            params[dev], {k: v.to(dev) for k, v in inputs.items()},
            cfg)[0].cpu()
        counts[dev] = all_counts()
        memory[dev] = (tr.encode(params[dev], inputs["enc_embeds"].to(dev),
                                 cfg) if cfg.n_enc_layers else None)
    check_path_counts(f"{arch} smoke prefill on the card", counts["cuda"],
                      {"flash_attention": n_prefill})
    prefill_diff = float((full["cpu"] - full["cuda"]).abs().max())

    decode = make_decode_step(cfg)
    dec = {}
    for dev in ("cpu", "cuda"):
        state = tr.init_decode_state(cfg, SMOKE_VS_ROWS, SMOKE_VS_DECODE,
                                     torch.float32, device=dev)
        if memory[dev] is not None:
            state["memory"] = memory[dev]
        reset_all_counts()
        steps = []
        for t in range(SMOKE_VS_DECODE):
            lg, state = decode(params[dev], state, toks[:, t:t + 1].to(dev),
                               t)
            steps.append(lg[:, 0].cpu())
        dec[dev] = torch.stack(steps, dim=1)
    check_path_counts(f"{arch} smoke decode on the card", all_counts(),
                      {"decode_attention": n_step * SMOKE_VS_DECODE})
    decode_diff = float((dec["cpu"] - dec["cuda"]).abs().max())

    prompts = [toks[0, :8].numpy().astype(np.int32),
               toks[1, :5].numpy().astype(np.int32)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(params[dev], cfg, batch=2, cache_len=32, device=dev)
        if memory[dev] is not None:
            eng.state["memory"] = memory[dev]
        outs[dev] = [o.tolist() for o in eng.generate(
            [ServeRequest(prompt=p, max_new=SMOKE_VS_NEW) for p in prompts])]
    out = dict(prefill_max_logit_diff=prefill_diff,
               decode_max_logit_diff=decode_diff, bound=bound,
               max_abs_logit=float(full["cpu"].abs().max()),
               greedy_equal=outs["cpu"] == outs["cuda"],
               launches_prefill=counts["cuda"])
    if arch == XLSTM:
        # prefill vs token-by-token decode on the card, the same text
        pd = (dec["cuda"] - full["cuda"][:, :SMOKE_VS_DECODE]).abs()
        out["prefill_vs_decode_max_diff"] = float(pd.max())
        out["prefill_vs_decode_tol"] = pd_tol
        if bool((pd > pd_tol + pd_tol * full["cuda"][
                :, :SMOKE_VS_DECODE].abs()).any()):
            raise AssertionError(f"{arch} smoke prefill vs decode on the "
                                 f"card: {out}")
    report.setdefault("smoke_cpu_vs_cuda", {})[arch] = out
    log(f"{arch} smoke cpu vs cuda (2 layers, f32, {SMOKE_VS_ROWS} x "
        f"{SMOKE_VS_S} positions, inputs "
        f"{ {k: list(v.shape) for k, v in inputs.items()} }): prefill max "
        f"|logit diff| {prefill_diff:.3e}, {SMOKE_VS_DECODE} decode steps "
        f"{decode_diff:.3e} (bound {bound}, max |logit| "
        f"{out['max_abs_logit']:.3f}); greedy tokens equal: "
        f"{out['greedy_equal']}"
        + (f"; card prefill vs its decode max |diff| "
           f"{out['prefill_vs_decode_max_diff']:.3e} (abs/rel {pd_tol})"
           if "prefill_vs_decode_tol" in out else ""))
    if not (prefill_diff <= bound and decode_diff <= bound
            and out["greedy_equal"]
            and bool(torch.isfinite(full["cuda"]).all())):
        raise AssertionError(f"{arch} smoke cpu vs cuda: {out}")


def serving_shapes(cfg):
    """B4's and B5's shapes on ``cfg``'s serving path, as
    :func:`hold_and_time_attention` takes them: for an encoder-decoder the
    encoder (F x F) and the cross-attention (PREFILL_S x F), both without
    the mask, and its decode's self-attention (a 512 cache at the serving
    lengths) and cross-attention (all F positions); otherwise the causal
    prefill and the decode's self-attention."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    decode = [(DECODE_B, SERVE_CACHE, H, Hkv, D, SERVE_LENS)]
    if not cfg.n_enc_layers:
        return [(PREFILL_B, PREFILL_S, PREFILL_S, H, Hkv, D, True)], decode
    F = cfg.frontend_tokens
    return ([(PREFILL_B, F, F, H, Hkv, D, False),
             (PREFILL_B, PREFILL_S, F, H, Hkv, D, False)],
            decode + [(DECODE_B, F, H, Hkv, D, [F] * DECODE_B)])


def moe_attention(report, errs):
    """B4 and B5 in bf16 at each MoE model's heads, held and timed by
    :func:`hold_and_time_attention`: its serving shapes, and beside them
    a causal Sq < Sk prefill (2, 100 x 300) and an odd cache (3 rows in
    777 positions, lengths 1, 388, 777).  Returns the rows of both
    models."""
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import dtype_of

    out = {"flash_attention": [], "decode_attention": []}
    for i, arch in enumerate(MOE_ARCHS):
        cfg = get_arch(arch)
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        flash, decode = serving_shapes(cfg)
        rows = hold_and_time_attention(
            arch, flash + [(2, 100, 300, H, Hkv, D, True)],
            decode + [(3, 777, H, Hkv, D, [1, 388, 777])],
            dtype_of(cfg.compute_dtype), 300 + 100 * i, report, errs)
        for name, rs in rows.items():
            out[name] += rs
    return out


def serve_phase(arch, report, launches, errs, seed, then=None):
    """``arch`` at full width on the card: B4 and B5 held and timed at its
    shapes (none for a model without attention), a prefill step and a
    generate (launches added to ``launches``; an encoder-decoder's engines
    get ``encode`` of random frames as their memory), ``then(cfg,
    params)`` when given (its rows join the returned ones), then the smoke
    model's CPU vs card; the model freed after.  Returns the kernel rows
    of :func:`hold_and_time_attention`."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import dtype_of

    cfg = get_arch(arch)
    rows = {"flash_attention": [], "decode_attention": []}
    if layer_counts(cfg)[0]:
        rows = hold_and_time_attention(arch, *serving_shapes(cfg),
                                       dtype_of(cfg.compute_dtype), seed,
                                       report, errs)
    cfg, params = serve_model(arch)
    for name, n in prefill_run(cfg, params, report).items():
        launches[name] += n
    memory = None
    if cfg.n_enc_layers:
        g = torch.Generator(device="cuda").manual_seed(seed)
        frames = torch.randn((SERVE_REQUESTS, cfg.frontend_tokens,
                              cfg.d_model), generator=g, device="cuda")
        memory = tr.encode(params, frames, cfg)
    for name, n in generate_run(cfg, params, report, memory).items():
        launches[name] += n
    if then is not None:
        for name, rs in then(cfg, params).items():
            rows[name] += rs
    del params, memory
    torch.cuda.empty_cache()
    smoke_cpu_vs_cuda(arch, report)
    return rows


def rope_cpu_vs_cuda(report):
    """RoPE's frequencies (``layers.rope_freqs``) at ROPE_HEAD_DIMS and
    ROPE_THETAS bit for bit on the CPU and on the card: one ulp of a
    frequency near 1 moves its angle at long_500k's positions by ~0.03
    rad."""
    from repro_torch.models import layers

    rows = []
    for hd in ROPE_HEAD_DIMS:
        for theta in ROPE_THETAS:
            cpu = layers.rope_freqs(hd, theta, "cpu")
            gpu = layers.rope_freqs(hd, theta, "cuda")
            if gpu.device.type != "cuda" or not bits_equal(cpu, gpu.cpu()):
                raise AssertionError(f"rope_freqs({hd}, {theta}) differs "
                                     f"between the CPU and the card")
            rows.append(dict(head_dim=hd, theta=theta, equal=True))
            log(f"rope_freqs head_dim={hd} theta={theta:g}: CPU and card "
                "bit for bit")
    report["rope_cpu_vs_cuda"] = rows


def ring_state(cfg, state, seed):
    """Fill a window decode state's K/V rings, layer by layer, with normal
    values from ``seed`` in the cache dtype, then draw the first token
    from the same generator: (the (K, V) pairs, the token (1, 1))."""
    caches = [(layer["k"], layer["v"]) for layer in state["layers"]]
    g = torch.Generator(device="cuda").manual_seed(seed)
    for pair in caches:
        for c in pair:
            c.copy_(torch.randn(c.shape, generator=g, device="cuda",
                                dtype=c.dtype))
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=g,
                        device="cuda")
    return caches, tok


def window_decode(arch, cfg, params, report, launches, errs, seed,
                  keep=None):
    """The reference's ``long_500k`` decode of ``arch`` at full width
    (``launch.steps.decode_setup``): ``decode_window`` gives the ring of
    ``cfg.sliding_window`` slots, ``init_decode_state`` at B=1 and
    524,288 positions holds it, filled with seeded normal K/V in the
    cache dtype; then ``make_decode_step(cfg, window)`` greedy at each of
    WINDOW_STEPS, across the ring's wrap.  Each step writes slot ``step %
    window`` of every layer's K and V and nothing else, and makes one B5
    call per layer at ``length`` = window.  B5 held against its plain
    version and timed at (1, window) before.  Each step's logits are
    appended to ``keep`` when given.  Returns the kernel rows."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.launch.steps import decode_window, make_decode_step
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import dtype_of

    t_phase = time.perf_counter()
    shape = INPUT_SHAPES["long_500k"]
    W = decode_window(cfg, shape)
    if not (W == cfg.sliding_window == 8192 and shape.global_batch == 1):
        raise AssertionError(f"{cfg.name} long_500k: window {W}, batch "
                             f"{shape.global_batch}")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = dtype_of(cfg.compute_dtype)
    rows = hold_and_time_attention(f"{cfg.name} ring", [],
                                   [(1, W, H, Hkv, D, [W])], cdt, seed,
                                   report, errs)
    state = tr.init_decode_state(cfg, shape.global_batch, shape.seq_len, cdt,
                                 window=W, device="cuda")
    caches, tok = ring_state(cfg, state, seed)
    if caches[0][0].shape != (1, W, Hkv, D):
        raise AssertionError(f"ring {tuple(caches[0][0].shape)}")
    cache_gb = sum(c.numel() * c.element_size() for p in caches
                   for c in p) / 1e9
    step = make_decode_step(cfg, W)
    _, n_step, _ = layer_counts(cfg)
    torch.cuda.synchronize()
    reset_all_counts()
    ms, tokens = [], []
    for t in WINDOW_STEPS:
        before = [(k.clone(), v.clone()) for k, v in caches]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = step(params, state, tok, t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for old, new in zip(before, caches):
            for a, b in zip(old, new):
                moved = torch.nonzero((a != b).flatten(2).any(-1).any(0))
                if moved.flatten().tolist() != [t % W]:
                    raise AssertionError(
                        f"{cfg.name} window decode step {t}: slots "
                        f"{moved.flatten().tolist()} written, not {t % W}")
        del before
        if logits.shape != (1, 1, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name} window decode step {t}: "
                                 f"logits {tuple(logits.shape)}")
        if keep is not None:
            keep.append(logits.clone())
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        tokens.append(int(tok))
    counts = all_counts()
    per_call = dec_k.launches_per_call(
        1, Hkv, W, torch.cuda.get_device_properties(0).multi_processor_count)
    check_path_counts(f"{cfg.name} window decode", counts, {
        "decode_attention": len(WINDOW_STEPS) * n_step * per_call})
    launches["decode_attention"] += counts["decode_attention"]
    del state, caches
    torch.cuda.empty_cache()
    out = dict(window=W, batch=shape.global_batch, positions=shape.seq_len,
               steps=[WINDOW_STEPS[0], WINDOW_STEPS[-1]],
               slots=[t % W for t in WINDOW_STEPS], cache_gb=cache_gb,
               ms_per_step=ms, median_ms=statistics.median(ms),
               tokens=tokens, launches=counts)
    report.setdefault("window_decode", {})[cfg.name] = out
    log(f"window decode {cfg.name} (long_500k: ring of {W} slots, "
        f"{cache_gb:.2f} GB of K/V, steps {WINDOW_STEPS[0]}-"
        f"{WINDOW_STEPS[-1]}, slots {out['slots'][0]}..{W - 1}, 0.."
        f"{out['slots'][-1]}): each step wrote its slot and nothing else; "
        f"ms per step {[round(x, 3) for x in ms]} (median "
        f"{out['median_ms']:.3f}), launches decode_attention="
        f"{counts['decode_attention']} ({n_step} per step)")
    window_cpu_vs_cuda(arch, report)
    report[f"window_decode_{cfg.name}_s"] = time.perf_counter() - t_phase
    log(f"phase: window_decode ({cfg.name}) "
        f"{report[f'window_decode_{cfg.name}_s']:.1f} s")
    return rows


def window_cpu_vs_cuda(arch, report):
    """The 2-layer f32 smoke model of ``arch`` with the same weights on the
    CPU and on the card through a ring of WINDOW_SMOKE slots, filled with
    the same seeded K/V, at WINDOW_STEPS (across the wrap: RoPE at
    positions near 2^19), both fed the CPU's greedy tokens: logits within
    ``serve_cpu_vs_cuda``'s bound (2e-3), greedy tokens under
    :func:`greedy_check`."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as tr

    bound = 2e-3
    cfg = reduce_for_smoke(get_arch(arch))
    cpu = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = {"cpu": cpu, "cuda": tr.lm_params_from_numpy(
        tr.lm_params_to_numpy(cpu, cfg), cfg, device="cuda")}
    states = {dev: tr.init_decode_state(cfg, SMOKE_VS_ROWS, 524_288,
                                        torch.float32, window=WINDOW_SMOKE,
                                        device=dev)
              for dev in ("cpu", "cuda")}
    g = torch.Generator().manual_seed(5)
    for pair in zip(states["cpu"]["layers"], states["cuda"]["layers"]):
        for name in ("k", "v"):
            fill = torch.randn(pair[0][name].shape, generator=g)
            for layer in pair:
                layer[name].copy_(fill)
    step = make_decode_step(cfg, WINDOW_SMOKE)
    tok = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (SMOKE_VS_ROWS, 1)))
    _, n_step, _ = layer_counts(cfg)
    flips, equal, diff = [], 0, 0.0
    n_cuda = 0
    for t in WINDOW_STEPS:
        out = {}
        for dev in ("cpu", "cuda"):
            reset_all_counts()
            lg, states[dev] = step(params[dev], states[dev], tok.to(dev), t)
            n_cuda += all_counts()["decode_attention"] if dev == "cuda" else 0
            out[dev] = lg[:, 0, :cfg.vocab_size].cpu()
        diff = max(diff, float((out["cpu"] - out["cuda"]).abs().max()))
        equal += greedy_check(out["cpu"], out["cuda"], bound, t,
                              f"{arch} window cpu vs cuda", flips)
        tok = out["cpu"].argmax(-1, keepdim=True)
    if n_cuda != len(WINDOW_STEPS) * n_step:
        raise AssertionError(f"{arch} window cpu vs cuda: {n_cuda} B5 "
                             f"launches on the card")
    if not diff <= bound:
        raise AssertionError(f"{arch} window cpu vs cuda: max logit "
                             f"difference {diff:.3e} > {bound}")
    report.setdefault("window_cpu_vs_cuda", {})[arch] = dict(
        max_logit_diff=diff, bound=bound, greedy_equal=equal,
        greedy_compared=equal + len(flips), flips=flips)
    log(f"{arch} smoke window cpu vs cuda (ring of {WINDOW_SMOKE}, steps "
        f"{WINDOW_STEPS[0]}-{WINDOW_STEPS[-1]}, {SMOKE_VS_ROWS} rows): max "
        f"|logit diff| {diff:.3e} (bound {bound}); greedy tokens equal "
        f"{equal}/{equal + len(flips)}; flips inside the bound: {flips}")


# ---------------------------------------------------------------------------
# Placement: the reference's plan as DTensor placements on the host mesh
def place_whole(tree, specs, mesh, what):
    """``tree`` placed by ``specs`` on the host mesh
    (``distributed.sharding.place_tree``) and taken back as local tensors
    (``local_tree``); every local shard must be its leaf itself, the same
    storage, as on any 1 x 1 mesh.  Returns the local tree."""
    from repro_torch.distributed.sharding import local_tree, place_tree
    from repro_torch.tree import tree_leaves

    local = local_tree(place_tree(tree, specs, mesh))
    a, b = tree_leaves(tree), tree_leaves(local)
    if len(a) != len(b) or not all(
            x.data_ptr() == y.data_ptr() and x.shape == y.shape
            for x, y in zip(a, b)):
        raise AssertionError(f"{what}: a local shard is not its tensor")
    return local


INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
DIGEST_CHUNK = 1 << 24


def state_digests(state) -> dict:
    """{leaf path: [s1, s2]} of a ``FedState``: each leaf's bit patterns
    as integers summed, and summed with weights by position, in int64
    that wraps: an integer sum, so the same in any order, and equal
    states give equal digests without a second copy of either."""
    out = {}
    for path, x in _named_leaves(state._asdict()):
        bits = x.detach().contiguous().view(
            INT_OF_SIZE[x.element_size()]).reshape(-1)
        s1 = torch.zeros((), dtype=torch.int64, device=x.device)
        s2 = torch.zeros_like(s1)
        for i in range(0, bits.numel(), DIGEST_CHUNK):
            c = bits[i:i + DIGEST_CHUNK].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=x.device,
                             dtype=torch.int64) * 2654435761 % 2147483647
            s1 += c.sum()
            s2 += (c * (w + 1)).sum()
        out[path] = [int(s1), int(s2)]
    return out


def placed_prefill(cfg, params, mesh, variant):
    """One full-width prefill step (``prefill_run``'s PREFILL_B x
    PREFILL_S inputs) of ``variant``'s config of ``cfg`` (its
    ``launch/variants`` cfg patch; "" for none) through
    ``launch.steps.prefill_setup`` on ``mesh``: the serving params and
    the inputs placed by its specs and taken back whole, B4 once in each
    attention layer.  Returns (logits, ms, launch counts)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch.steps import prefill_inputs, prefill_setup
    from repro_torch.launch.variants import get_variant
    from repro_torch.models import transformer as tr

    vcfg = get_variant(variant).apply(cfg)[0] if variant else cfg
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"],
                                seq_len=PREFILL_S, global_batch=PREFILL_B)
    step, _, (p_specs, in_specs), _ = prefill_setup(vcfg, shape, mesh)
    inputs = prefill_inputs(vcfg, PREFILL_B, PREFILL_S,
                            torch.Generator(device="cuda").manual_seed(1))
    lp = place_whole(tr.serving_tree(params), p_specs, mesh,
                     f"{cfg.name} params")
    li = place_whole(inputs, in_specs, mesh, f"{cfg.name} inputs")
    torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    logits = step(lp, li)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = all_counts()
    check_path_counts(f"{cfg.name} placed prefill {variant or 'none'}",
                      counts, {"flash_attention": layer_counts(cfg)[0]})
    if logits.shape != (PREFILL_B, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} placed prefill {variant}: logits "
                             f"{tuple(logits.shape)}")
    return logits, ms, counts


def placed_window_decode(cfg, params, mesh, want, seed):
    """``long_500k``'s window decode of ``cfg`` through
    ``launch.steps.decode_setup`` on ``mesh``: the params, the ring state
    (filled as :func:`window_decode` fills it from ``seed``) and each
    token placed by its specs and taken back whole, greedy over
    WINDOW_STEPS; every step's logits bit for bit ``want``'s (the
    unplaced run's).  Returns (ms per step, launch counts)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.launch.steps import decode_setup, decode_window
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import dtype_of
    from repro_torch.tree import tree_leaves

    shape = INPUT_SHAPES["long_500k"]
    W = decode_window(cfg, shape)
    step, (_, s_sds, _, _), (p_specs, s_specs, tok_spec, _), _ = \
        decode_setup(cfg, shape, mesh)
    state = tr.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                 dtype_of(cfg.compute_dtype), window=W,
                                 device="cuda")
    if [l.shape for l in tree_leaves(state)] != [
            l.shape for l in tree_leaves(s_sds)]:
        raise AssertionError(f"{cfg.name}: decode state != decode_setup's")
    _, tok = ring_state(cfg, state, seed)
    lp = place_whole(tr.serving_tree(params), p_specs, mesh,
                     f"{cfg.name} params")
    state = place_whole(state, s_specs, mesh, f"{cfg.name} ring state")
    torch.cuda.synchronize()
    reset_all_counts()
    ms = []
    for i, t in enumerate(WINDOW_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = step(lp, state, place_whole(
            tok, tok_spec, mesh, f"{cfg.name} token"), t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not bits_equal(logits, want[i]):
            raise AssertionError(f"{cfg.name} placed window decode step {t}:"
                                 " logits differ from the unplaced run's")
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    counts = all_counts()
    per_call = dec_k.launches_per_call(
        1, cfg.n_kv_heads, W,
        torch.cuda.get_device_properties(0).multi_processor_count)
    check_path_counts(f"{cfg.name} placed window decode", counts, {
        "decode_attention": len(WINDOW_STEPS) * layer_counts(cfg)[1]
        * per_call})
    del state
    return ms, counts


def placed_serve(arch, cfg, params, report, launches, window_logits=None,
                 seed=None):
    """The ``placed_serve`` phase for ``arch`` under one host mesh
    (``launch.mesh.registered_host_mesh``): PLACED_PAIRS[arch]'s two
    variants prefilled through :func:`placed_prefill`, their logits bit
    for bit equal (the mesh knob is the identity on one device); with
    ``window_logits``, :func:`placed_window_decode` against them.
    Launches are added to ``launches``."""
    from repro_torch.launch.mesh import registered_host_mesh

    t_phase = time.perf_counter()
    variants = PLACED_PAIRS[arch]
    out = dict(variants=list(variants))
    with registered_host_mesh() as mesh:
        runs = [placed_prefill(cfg, params, mesh, v) for v in variants]
        if not bits_equal(runs[0][0], runs[1][0]):
            raise AssertionError(f"{cfg.name}: prefill logits under "
                                 f"{variants} differ")
        out.update(prefill_ms=[r[1] for r in runs],
                   prefill_launches=[r[2] for r in runs])
        del runs
        if window_logits is not None:
            ms, counts = placed_window_decode(cfg, params, mesh,
                                              window_logits, seed)
            out.update(window_ms_per_step=ms,
                       window_median_ms=statistics.median(ms),
                       window_launches=counts)
    for counts in out["prefill_launches"] + [out.get("window_launches",
                                                     {})]:
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    out["s"] = time.perf_counter() - t_phase
    report.setdefault("placed_serve", {})[cfg.name] = out
    log(f"placed_serve {cfg.name}: prefill under {variants} bit for bit "
        f"equal (ms {[round(x, 1) for x in out['prefill_ms']]}, B4 "
        f"{[c['flash_attention'] for c in out['prefill_launches']]})"
        + (f"; window decode through decode_setup bit for bit the unplaced "
           f"run's, median {out['window_median_ms']:.3f} ms a step, B5 "
           f"{out['window_launches']['decode_attention']}"
           if window_logits is not None else "")
        + f"; every placed tensor its own local shard; {out['s']:.1f} s")


def variant_train(specs, report):
    """``launch.train --variant TRAIN_VARIANT`` at full width: SmolLM-360M,
    LM_TRAIN_ROUNDS rounds of 4 clients with one LM_TRAIN_S-token sequence
    each (``--global-batch``), in this process so every launch counts.
    The variant applies its cfg patch only (remat off), as the
    reference's launcher does: B1 once a round (the f32 sign wire, no
    B3), B4 once in each layer for each client (no recompute) and its
    backward.  Returns the counts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.variants import get_variant

    t_phase = time.perf_counter()
    cfg = get_variant(TRAIN_VARIANT).apply(get_arch(ARCH))[0]
    C, L, R = LM_TRAIN_CLIENTS, cfg.n_layers, LM_TRAIN_ROUNDS
    if cfg.remat:
        raise AssertionError(f"{TRAIN_VARIANT} leaves remat on")
    b1 = consensus_spec(specs, launch_train.launcher_fed(cfg, C))
    if b1["name"] != "sign_agg":
        raise AssertionError(f"variant_train: the round would launch "
                             f"{b1['name']}, not B1")
    want = {b1["counter"]: R, "flash_attention": R * L * C,
            "flash_attention_bwd": R * L * C * fa_k.BWD_LAUNCHES}
    argv = ["--arch", ARCH, "--steps", str(R), "--variant", TRAIN_VARIANT,
            "--global-batch", str(C), "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    rc, out = _quiet_run(launch_train.main, argv)
    torch.cuda.synchronize()
    counts = all_counts()
    if rc != 0 or not out.strip().splitlines()[-1].startswith(
            "done. final loss"):
        raise AssertionError(f"variant_train: exit {rc}")
    check_path_counts(f"launch.train --variant {TRAIN_VARIANT}", counts,
                      want)
    b1["launches"] += counts[b1["counter"]]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l.split("loss=")[1].split()[0])
              for l in out.splitlines() if l.startswith("step")]
    report["variant_train"] = dict(
        argv=argv, clients=C, seq=LM_TRAIN_S, rounds=R, remat=cfg.remat,
        data_loss=losses, launches=counts, peak_gb=peak_gb,
        s=time.perf_counter() - t_phase)
    log(f"variant_train: launch.train {' '.join(argv)}: losses {losses}, "
        f"launches {counts} (B1, no B3, B4 {L} x {C} a round: no "
        f"recompute), peak {peak_gb:.2f} GB, "
        f"{report['variant_train']['s']:.1f} s")
    return counts


def placed_train(specs, report):
    """lm_train's rounds again (SmolLM-360M at full width, the same seed,
    state, batch and knobs) through ``launch.steps.train_setup`` on the
    host mesh: the state and the batch placed by its specs and taken
    back whole, the step its ``train_step``.  The final state's digests
    (:func:`state_digests`) must equal lm_train's: bit for bit.  Returns
    the counts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.launch.mesh import registered_host_mesh

    cfg = get_arch(ARCH)
    C, L = LM_TRAIN_CLIENTS, cfg.n_layers
    with registered_host_mesh() as mesh:
        counts = train_lm(
            "placed_train", cfg, specs, report, clients=C, batch_rows=1,
            seq=LM_TRAIN_S, rounds=LM_TRAIN_ROUNDS, knobs=LM_TRAIN_KNOBS,
            per_round={"flash_attention": 2 * L * C,
                       "flash_attention_bwd": L * C * fa_k.BWD_LAUNCHES},
            cuts=report["lm_train"]["cuts"], profile_last=False,
            mesh=mesh, digest=True)
    got, want = (report[k].pop("digests") for k in ("placed_train",
                                                     "lm_train"))
    if got != want:
        bad = [p for p in want if got.get(p) != want[p]]
        raise AssertionError(f"placed_train: state differs from lm_train's "
                             f"at {bad[:5]} ({len(bad)} leaves)")
    report["placed_train"]["bit_equal_to_lm_train"] = len(want)
    log(f"placed_train: the state after {LM_TRAIN_ROUNDS} rounds through "
        f"train_setup on the placed state equals lm_train's in all "
        f"{len(want)} leaves (digests); every placed tensor its own local "
        "shard")
    return counts


# ---------------------------------------------------------------------------
# LM training: B4's backward, then SmolLM-360M through make_train_step
def bwd_flops(q, k, causal, window):
    """B4 backward's operations: five products (S, dP, dV, dK, dQ) of
    2 B H D flops per kept query-key pair."""
    B, Sq, H, D = q.shape
    return 10 * B * H * D * kept_pairs(Sq, k.shape[1], causal, window)


def bwd_bound(q, k, causal, window):
    """B4 backward's least time: its operations on the tensor cores for
    the inputs' type (f32: by 3xTF32, 3 x the operations over 494.7
    TFLOP/s, as the forward's bound; bf16: the operations over 989
    TFLOP/s), or the bytes of q, k, v, out, dout (in their type), lse
    (f32) read once and dq, dk, dv written once over 3.35 TB/s.  Also the
    f32 CUDA cores' roof of the same work, which bounded the FFMA kernel
    that the tensor-core kernels replaced."""
    ops = bwd_flops(q, k, causal, window)
    nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) \
        + 4 * (q.numel() // q.shape[-1])
    t_ops = (3 * ops / TF32_FLOPS_PER_S if q.dtype == torch.float32
             else ops / BF16_FLOPS_PER_S)
    ms, by = _bound(t_ops, nbytes / HBM_BYTES_PER_S)
    return ms, by, ops / F32_FLOPS_PER_S * 1e3


def sdpa_bwd(q, k, v, causal):
    """``library_ms`` yardstick of B4's backward (never called by the
    port): SDPA's f32 forward once (``enable_gqa``), then a function
    that runs its backward alone."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    do = torch.ones_like(out)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), do,
                                       retain_graph=True)


def check_flash_bwd(report, errs):
    """B4's backward at BWD_CASES against its plain version on the same
    inputs (q, k, v, dO random; out and lse from B4): within BWD_ATOL +
    BWD_RTOL |plain| elementwise, finite, and bit for bit the same on a
    second call.  B4's output with and without its lse at LSE_CASES, bit
    for bit.  Times the backward at the training shape (kernel, plain
    version, SDPA's backward, the bound).  Launches here are not the
    main path's."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ref

    rows = []
    for i, (B, Sq, Sk, H, Hkv, D, causal) in enumerate(LSE_CASES):
        q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, torch.float32, 40 + i)
        plain = fa_k.flash_attention(q, k, v, causal=causal)
        out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if not bits_equal(out, plain):
            raise AssertionError(f"B4 with lse != without at {q.shape} "
                                 f"{k.shape}")
        rows.append(dict(kernel="flash_attention", shape=f"B={B} Sq={Sq} "
                         f"Sk={Sk} H={H}/{Hkv} causal={causal}",
                         lse_output_bit_identical=True))
        del q, k, v, plain, out, lse
    errs["flash_attention_bwd"] = 0.0
    for i, (B, Sq, Sk, H, Hkv, D, causal, window) in enumerate(BWD_CASES):
        q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, torch.float32, 50 + i)
        do = _attn_inputs(B, Sq, Sq, H, H, D, torch.float32, 60 + i)[0]
        out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal,
                                            window=window)
        got = fa_k.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
        again = fa_k.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                         window)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                           window)
        torch.cuda.synchronize()
        tag = (f"B={B} Sq={Sq} Sk={Sk} H={H}/{Hkv} D={D} causal={causal} "
               f"window={window}")
        used, err = 0.0, 0.0       # the largest share of the bound used
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            share = float(((g - w).abs()
                           / (BWD_ATOL + BWD_RTOL * w.abs())).max())
            if not (bool(torch.isfinite(g).all()) and share <= 1.0):
                raise AssertionError(
                    f"B4 backward {tag} {name}: kernel != plain version "
                    f"(max |err| {max_abs_err(g, w):.3e}, {share:.3f} of "
                    "the bound)")
            if not bits_equal(g, a):
                raise AssertionError(f"B4 backward {tag} {name}: two calls "
                                     "differ")
            used, err = max(used, share), max(err, max_abs_err(g, w))
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
        rows.append(dict(kernel="flash_attention_bwd", shape=tag,
                         max_abs_err=err, bound_share=used,
                         deterministic=True))
        log(f"flash_attention_bwd {tag}: max |err| {err:.3e}, {used:.3f} of "
            f"the bound {BWD_ATOL} + {BWD_RTOL} |plain|, two calls "
            "bit-identical")
        del q, k, v, do, out, lse, got, again, want
    report["flash_bwd_checks"] = rows
    log(f"B4 with and without lse: bit-identical at {len(LSE_CASES)} "
        f"shapes; backward max |err| {errs['flash_attention_bwd']:.3e}")

    cpm = sleep_cycles_per_ms()
    B, Sq, Sk, H, Hkv, D, causal, window = BWD_CASES[0]
    q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, torch.float32, 70)
    do = _attn_inputs(B, Sq, Sq, H, H, D, torch.float32, 71)[0]
    out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal)
    row = dict(shape=f"B={B} S={Sq} H={H}/{Hkv} D={D} f32 causal",
               ms=device_ms(lambda: fa_k.flash_attention_bwd(
                   q, k, v, out, lse, do, causal, 0), cpm, reps=10, inner=3),
               plain_ms=device_ms(lambda: ref.flash_attention_bwd_ref(
                   q, k, v, out, lse, do, causal, 0), cpm, reps=5, inner=1),
               library_ms=device_ms(sdpa_bwd(q, k, v, causal), cpm, reps=10,
                                    inner=3),
               gflop=bwd_flops(q, k, causal, 0) / 1e9)
    row["bound_ms"], row["bound_by"], row["simt_bound_ms"] = bwd_bound(
        q, k, causal, 0)
    report["flash_bwd_timing"] = row
    log(f"time flash_attention_bwd {row['shape']}: kernel_ms={row['ms']:.6f} "
        f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, 3xTF32; "
        f"{row['gflop']:.2f} GFLOP) simt_bound_ms={row['simt_bound_ms']:.6f} "
        f"(f32 CUDA cores) plain_ms={row['plain_ms']:.6f} "
        f"library_ms={row['library_ms']:.6f} (SDPA f32 backward, "
        f"enable_gqa)")
    return row


def device_busy_ms(fn, top: int = 8):
    """Wall ms of ``fn()`` (ending in a synchronize), the ms the card
    spent in kernels meanwhile, from ``torch.profiler`` (kernels of one
    stream do not overlap, so their times add; None when the profiler
    shows no device time), and the ``top`` kernel names by device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    # the raw trace's device events (kernels, copies, sets): building the
    # profiler's event tree for a round of ~10^6 events took minutes
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) \
                + e.duration_ns() / 1e6
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return wall, (busy if busy > 0 else None), [
        (name[:80], ms) for name, ms in ranked]


def state_bytes(state) -> int:
    """Bytes of a federated state's trees (W, z, z_local, phi, ...)."""
    from repro_torch.tree import tree_leaves

    return sum(l.numel() * l.element_size() for f in state
               if f is not None and not isinstance(f, torch.Tensor)
               for l in tree_leaves(f))


def train_lm(label, cfg, specs, report, *, clients, batch_rows, seq,
             rounds, knobs, per_round, cuts, profile_last=True, mesh=None,
             digest=False):
    """The main path of LM training: ``rounds`` BAFDP rounds of ``cfg``
    through ``launch.steps.make_train_step`` on the card from a seed-0
    state, C = ``clients`` clients with ``batch_rows`` sequences of
    ``seq`` positions each (``data/tokens.lm_batch``, seed 0), every
    launch counted: ``per_round`` kernel -> launches a round, plus the
    round's one consensus launch (its B1-B3 spec's count grows by it).
    The loss and every weight finite, W moved, the allocator's segments
    expandable (``launch.train.use_expandable_segments``).  The last round
    under the profiler (busy share and top kernels) when ``profile_last``.
    With ``mesh`` (the host mesh), the step is ``launch.steps.
    train_setup``'s and the state and the batch are placed by its specs
    (:func:`place_whole`).  With ``digest``, ``report[label]["digests"]``
    holds the final state's :func:`state_digests`.  Records
    ``report[label]`` and returns the counts."""
    from repro_torch.core.fed_state import init_fed_state, init_lm_tree
    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves

    C = clients
    fed = dataclasses.replace(steps.fed_config_for(cfg, C), **knobs)
    spec = consensus_spec(specs, fed)
    torch.cuda.empty_cache()
    state = init_fed_state(torch.Generator(device="cuda").manual_seed(0),
                           lambda g: init_lm_tree(g, cfg, "cuda"), fed,
                           device="cuda")
    state_gb = state_bytes(state) / 1e9
    sizes = [l.numel() for l in tree_leaves(state.W)]
    probe = sizes.index(max(sizes))          # the largest weight leaf
    w_probe = tree_leaves(state.W)[probe].reshape(C, -1)[:, :4096].clone()
    raw = lm_batch(np.random.RandomState(0), cfg, C * batch_rows, seq)
    batch = {k: torch.from_numpy(v).to("cuda").reshape(
        (C, batch_rows) + v.shape[1:]) for k, v in raw.items()}
    step = steps.make_train_step(cfg, fed)
    if mesh is not None:
        from repro_torch.configs import INPUT_SHAPES, FedConfig

        shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=seq,
                                    global_batch=C * batch_rows)
        step, _, (s_specs, b_specs, _), _ = steps.train_setup(
            cfg, shape, mesh, base_fed=FedConfig(**knobs), n_clients=C)
        if steps.fed_config_for(cfg, C, FedConfig(**knobs)) != fed:
            raise AssertionError(f"{label}: train_setup's FedConfig differs")
        state = place_whole(state, s_specs, mesh, f"{label} state")
        batch = place_whole(batch, b_specs, mesh, f"{label} batch")
    want = {spec["counter"]: rounds}
    for k, n in per_round.items():
        want[k] = want.get(k, 0) + rounds * n
    log(f"{label}: {cfg.name} C={C} b={batch_rows} S={seq} remat="
        f"{cfg.remat} {cfg.compute_dtype}, state {state_gb:.2f} GB; "
        f"expected launches {want}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    ms, losses, busy, top = [], [], None, []
    for t in range(rounds):
        out = {}

        def one_round(t=t, out=out):
            out["state"], out["m"] = step(state, batch, t)

        if profile_last and t == rounds - 1:
            wall, busy, top = device_busy_ms(one_round)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_round()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        del state                 # the round's old state goes before the next
        state, m = out.pop("state"), out.pop("m")
        ms.append(wall)
        losses.append(float(m["data_loss"]))
        log(f"{label} round {t}: {wall:.1f} ms, data_loss "
            f"{losses[-1]:.5f}, eps {float(m['eps_mean']):.3f}, gap "
            f"{float(m['consensus_gap']):.3e}, active "
            f"{int(m['n_active'])}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the training entry point's allocator policy is in force
    if not any(seg.get("is_expandable") for seg in
               torch.cuda.memory_snapshot()):
        raise AssertionError(f"{label}: no expandable segment")
    counts = all_counts()
    check_path_counts(f"{cfg.name} {label}", counts, want)
    spec["launches"] += counts[spec["counter"]]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite loss {losses}")
    for leaf in tree_leaves(state.W):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{label}: non-finite weights")
    moved = float((tree_leaves(state.W)[probe].reshape(C, -1)[:, :4096]
                   - w_probe).abs().max())
    if not moved > 0:
        raise AssertionError(f"{label}: W did not move")
    busy_share = busy / ms[-1] if busy is not None else None
    report[label] = dict(
        arch=cfg.name, clients=C, seq=seq, per_client_batch=batch_rows,
        rounds=rounds, knobs=knobs, compute_dtype=cfg.compute_dtype,
        remat=cfg.remat, ms_per_round=ms, data_loss=losses,
        state_gb=state_gb, peak_gb=peak_gb, device_busy_ms=busy,
        busy_share=busy_share, top_kernels_ms=top, launches=counts,
        launches_per_round={k: v // rounds for k, v in want.items()},
        w_moved=moved, cuts=cuts)
    log(f"{label} {cfg.name}, C={C}, {rounds} rounds: ms_per_round="
        f"{[round(x, 1) for x in ms]} peak {peak_gb:.2f} GB (state "
        f"{state_gb:.2f} GB) busy_share="
        + (f"{busy_share:.3f} ({busy:.1f} of {ms[-1]:.1f} ms, profiled "
           "round)" if busy_share is not None else "not measured")
        + f" launches {counts} W moved by {moved:.3e}; cuts: {cuts}")
    for name, t_ms in top:
        log(f"  {label} profiled round: {t_ms:10.3f} ms  {name}")
    if digest:
        report[label]["digests"] = state_digests(state)
    del state, out, batch
    torch.cuda.empty_cache()
    return counts


def lm_train_runs(specs, report):
    """The main path: LM_TRAIN_ROUNDS BAFDP rounds of SmolLM-360M at full
    width through ``make_train_step``, counting every launch.  A round
    launches B1 once (the Eq. (20) consensus over the 11 leaves), B4
    twice in each layer for each client (the forward and remat's
    recompute) and B4's backward once in each (BWD_LAUNCHES launches).
    The loss and every weight finite, W moved.  Returns the counts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa_k

    cfg = get_arch(ARCH)
    if not (cfg.remat and cfg.compute_dtype == "float32"
            and cfg.n_layers == 32 and cfg.d_model == 960):
        raise AssertionError(f"{ARCH}: not the full-width f32 remat model")
    C, L = LM_TRAIN_CLIENTS, cfg.n_layers
    return train_lm(
        "lm_train", cfg, specs, report, clients=C, batch_rows=1,
        seq=LM_TRAIN_S, rounds=LM_TRAIN_ROUNDS, knobs=LM_TRAIN_KNOBS,
        per_round={"flash_attention": 2 * L * C,
                   "flash_attention_bwd": L * C * fa_k.BWD_LAUNCHES},
        cuts=f"batch: one {LM_TRAIN_S}-token sequence per client ({C} in "
             "all; train_4k's global batch is 256)", digest=True)


def lm_train_cpu_vs_cuda(report, arch=ARCH, seq=LM_VS_S,
                         key="lm_train_cpu_vs_cuda"):
    """The 2-layer smoke model of ``arch`` (f32, head dim 64) through
    ``make_train_step`` on the CPU and on the card from one state, C =
    LM_VS_CLIENTS, every client active, LM_TRAIN_ROUNDS rounds, the LDP
    noise below rounding (``privacy_budget_a`` = LM_VS_BUDGET: the two
    devices' generators cannot draw alike); the states held to
    :func:`drift_check` (sign ties may move a weight by alpha_w psi), the
    per-round losses within rtol 1e-4."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.core.fed_state import (fed_state_from_numpy,
                                            init_fed_state, init_lm_tree)
    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch import steps

    cfg = reduce_for_smoke(get_arch(arch))
    C = LM_VS_CLIENTS
    fed = dataclasses.replace(steps.fed_config_for(cfg, C), **LM_TRAIN_KNOBS,
                              privacy_budget_a=LM_VS_BUDGET)
    init = init_fed_state(torch.Generator().manual_seed(0),
                          lambda g: init_lm_tree(g, cfg, "cpu"), fed,
                          device="cpu")
    arrays = {k: None if v is None else _to_numpy(v)
              for k, v in init._asdict().items()}
    raw = lm_batch(np.random.RandomState(1), cfg, C * LM_VS_B, seq)
    act = np.ones((C,), bool)
    out = {}
    for dev in ("cpu", "cuda"):
        state = fed_state_from_numpy(arrays, device=dev)
        batch = {k: torch.from_numpy(v).to(dev).reshape(
            (C, LM_VS_B) + v.shape[1:]) for k, v in raw.items()}
        step = steps.make_train_step(cfg, fed)
        losses = []
        for t in range(LM_TRAIN_ROUNDS):
            state, m = step(state, batch, t, act=act)
            losses.append(float(m["data_loss"]))
        out[dev] = (state, losses)
    worst, n_off = drift_check(f"{key} ({arch})", out["cpu"][0],
                               out["cuda"][0], LM_TRAIN_ROUNDS, fed.alpha_w)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    report[key] = dict(
        arch=cfg.name, seq=seq, max_abs_state_diff=worst[0],
        worst_leaf=worst[1], elements_beyond_drift=n_off,
        data_loss_cpu=out["cpu"][1], data_loss_cuda=out["cuda"][1])
    log(f"{key} ({cfg.name}, C={C}, {LM_VS_B} x {seq} tokens, "
        f"{LM_TRAIN_ROUNDS} rounds): max |state diff| = {worst[0]:.3e} at "
        f"{worst[1]}; {n_off} elements beyond the drift bound; data_loss "
        f"cpu {out['cpu'][1]} cuda {out['cuda'][1]}")


# ---------------------------------------------------------------------------
# The rest of LM training: B4's bf16 backward, B6's backward, Hymba-1.5B
# and SeamlessM4T-medium at full width, the other families at 100m
def bf16_ulp(w: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``w`` (0 at 0)."""
    return torch.exp2(torch.floor(torch.log2(w.float().abs())) - 7)


def fwd_lse_row(fa_k, ref, q, k, v, causal, cpm, tag):
    """B4 with its lse output at one shape, timed: kernel, plain version
    (``with_lse``), SDPA's forward and the bound."""
    row = dict(shape=tag,
               ms=device_ms(lambda: fa_k.flash_attention_fwd(
                   q, k, v, causal=causal), cpm, reps=10, inner=3),
               plain_ms=device_ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal=causal, with_lse=True), cpm, reps=5,
                   inner=1),
               library_ms=device_ms(lambda: sdpa_flash(q, k, v, causal),
                                    cpm, reps=10, inner=3))
    row["bound_ms"], row["bound_by"] = flash_bound(q, k, causal, 0)
    log(f"time flash_attention+lse {tag}: kernel_ms={row['ms']:.6f} "
        f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
        f"plain_ms={row['plain_ms']:.6f} library_ms={row['library_ms']:.6f} "
        "(SDPA forward, enable_gqa)")
    return row


def check_flash_bwd_bf16(report, errs):
    """B4's bf16 forward with and without its lse at BF16_LSE_CASES, bit
    for bit, the lse within LSE_ATOL + LSE_RTOL |lse| of the plain
    version's; B4's bf16 backward at BF16_BWD_CASES against its plain
    version on the same inputs (q, k, v, dO random bf16; out and lse from
    B4): within BWD_ATOL + BWD_RTOL |plain| plus one bf16 ulp of the plain
    value, elementwise, finite, and bit for bit on a second call.  Times
    the bf16 backward at Hymba's training shape (kernel, plain version,
    SDPA's bf16 backward, the bound on the bf16 tensor cores and the CUDA
    cores' roof), and B4 with its lse under autograd at B=1: f32 at
    SmolLM-360M's training shape, bf16 at Hymba's.  Launches here are not
    the main path's."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ref

    bf = torch.bfloat16
    rows = []
    errs["flash_attention_lse_bf16"] = 0.0
    for i, (B, Sq, Sk, H, Hkv, D, causal, window) in enumerate(
            BF16_LSE_CASES):
        q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, bf, 140 + i)
        plain = fa_k.flash_attention(q, k, v, causal=causal, window=window)
        out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal,
                                            window=window)
        _, want = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, with_lse=True)
        torch.cuda.synchronize()
        tag = f"B={B} Sq={Sq} Sk={Sk} H={H}/{Hkv} bf16 causal={causal}"
        if not bits_equal(out, plain):
            raise AssertionError(f"B4 bf16 with lse != without at {tag}")
        excess = float(((lse - want).abs() - LSE_ATOL
                        - LSE_RTOL * want.abs()).max())
        err = max_abs_err(lse, want)
        if not (bool(torch.isfinite(lse).all()) and excess <= 0):
            raise AssertionError(f"B4 bf16 lse at {tag}: max |err| "
                                 f"{err:.3e} past {LSE_ATOL} + {LSE_RTOL} "
                                 "|lse|")
        errs["flash_attention_lse_bf16"] = max(
            errs["flash_attention_lse_bf16"], err)
        rows.append(dict(kernel="flash_attention", shape=tag,
                         lse_output_bit_identical=True, lse_max_abs_err=err))
        log(f"flash_attention bf16 {tag}: output with lse bit-identical, lse "
            f"max |err| {err:.3e} (bound {LSE_ATOL} + {LSE_RTOL} |lse|)")
        del q, k, v, plain, out, lse, want
    errs["flash_attention_bwd_bf16"] = 0.0
    for i, (B, Sq, Sk, H, Hkv, D, causal, window) in enumerate(
            BF16_BWD_CASES):
        q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, bf, 150 + i)
        do = _attn_inputs(B, Sq, Sq, H, H, D, bf, 160 + i)[0]
        out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal,
                                            window=window)
        got = fa_k.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
        again = fa_k.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                         window)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                           window)
        torch.cuda.synchronize()
        tag = (f"B={B} Sq={Sq} Sk={Sk} H={H}/{Hkv} D={D} bf16 "
               f"causal={causal} window={window}")
        used, err = 0.0, 0.0
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            wf = w.float()
            bound = BWD_ATOL + BWD_RTOL * wf.abs() + bf16_ulp(w)
            share = float(((g.float() - wf).abs() / bound).max())
            if not (g.dtype == bf and bool(torch.isfinite(g.float()).all())
                    and share <= 1.0):
                raise AssertionError(
                    f"B4 bf16 backward {tag} {name}: kernel != plain version "
                    f"(max |err| {max_abs_err(g, w):.3e}, {share:.3f} of "
                    "the bound)")
            if not bits_equal(g, a):
                raise AssertionError(f"B4 bf16 backward {tag} {name}: two "
                                     "calls differ")
            used, err = max(used, share), max(err, max_abs_err(g, w))
        errs["flash_attention_bwd_bf16"] = max(
            errs["flash_attention_bwd_bf16"], err)
        rows.append(dict(kernel="flash_attention_bwd_bf16", shape=tag,
                         max_abs_err=err, bound_share=used,
                         deterministic=True))
        log(f"flash_attention_bwd bf16 {tag}: max |err| {err:.3e}, "
            f"{used:.3f} of the bound {BWD_ATOL} + {BWD_RTOL} |plain| + one "
            "bf16 ulp, two calls bit-identical")
        del q, k, v, do, out, lse, got, again, want
    report["flash_bwd_bf16_checks"] = rows

    cpm = sleep_cycles_per_ms()
    B, Sq, Sk, H, Hkv, D, causal, window = BF16_BWD_CASES[0]
    q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, bf, 170)
    do = _attn_inputs(B, Sq, Sq, H, H, D, bf, 171)[0]
    out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal)
    row = dict(shape=f"B={B} S={Sq} H={H}/{Hkv} D={D} bf16 causal",
               ms=device_ms(lambda: fa_k.flash_attention_bwd(
                   q, k, v, out, lse, do, causal, 0), cpm, reps=10, inner=3),
               plain_ms=device_ms(lambda: ref.flash_attention_bwd_ref(
                   q, k, v, out, lse, do, causal, 0), cpm, reps=5, inner=1),
               library_ms=device_ms(sdpa_bwd(q, k, v, causal), cpm, reps=10,
                                    inner=3),
               gflop=bwd_flops(q, k, causal, 0) / 1e9)
    row["bound_ms"], row["bound_by"], row["simt_bound_ms"] = bwd_bound(
        q, k, causal, 0)
    fwd_rows = {"bf16": fwd_lse_row(fa_k, ref, q, k, v, causal, cpm,
                                    row["shape"])}
    del q, k, v, do, out, lse
    report["flash_bwd_bf16_timing"] = row
    log(f"time flash_attention_bwd {row['shape']}: kernel_ms="
        f"{row['ms']:.6f} bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
        f"bf16 tensor cores; {row['gflop']:.2f} GFLOP) simt_bound_ms="
        f"{row['simt_bound_ms']:.6f} (f32 CUDA cores) plain_ms="
        f"{row['plain_ms']:.6f} library_ms={row['library_ms']:.6f} (SDPA "
        "bf16 backward, enable_gqa)")
    B, Sq, Sk, H, Hkv, D, causal, _ = BWD_CASES[0]
    q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, torch.float32, 172)
    fwd_rows["f32"] = fwd_lse_row(
        fa_k, ref, q, k, v, causal, cpm,
        f"B={B} S={Sq} H={H}/{Hkv} D={D} f32 causal")
    report["flash_fwd_lse_timing"] = fwd_rows
    return row, fwd_rows


def bwd_kernel_ms(fn, calls: int = 5) -> dict:
    """Device ms per launch of each of B4's backward kernels (``dq``, the
    per-head ``dkdv``, their ``sum``): the mean over the launches that
    ``torch.profiler``'s raw trace holds for ``calls`` calls of ``fn``
    (the trace can miss the window's first launch); None each when it
    shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = {"dq_ms": [], "dkdv_ms": [], "sum_ms": []}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for key, pat in (("sum_ms", "flash_bwd_dkdv_sum<"),
                         ("dkdv_ms", "flash_bwd_dkdv<"),
                         ("dq_ms", "flash_bwd_dq<")):
            if pat in e.name():
                found[key].append(e.duration_ns() / 1e6)
                break
    return {key: statistics.mean(ms) if ms else None
            for key, ms in found.items()}


def time_flash_bwd_parts(report):
    """B4's backward at BWD_TIMED: the call's device ms (CUDA events),
    each kernel's (profiler), the bound (and the CUDA cores' roof) and
    SDPA's backward on the same inputs.  Launches here are not the main
    path's.  Returns the rows."""
    from repro_torch.kernels import flash_attention as fa_k

    cpm = sleep_cycles_per_ms()
    rows = []
    for i, (model, (B, Sq, Sk, H, Hkv, D, causal), dt) in enumerate(
            BWD_TIMED):
        dtype = getattr(torch, dt)
        q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, dtype, 180 + i)
        do = _attn_inputs(B, Sq, Sq, H, H, D, dtype, 190 + i)[0]
        out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal)
        fn = lambda: fa_k.flash_attention_bwd(q, k, v, out, lse, do,
                                              causal, 0)
        row = dict(model=model, shape=f"B={B} Sq={Sq} Sk={Sk} H={H}/{Hkv} "
                   f"D={D} {dt} causal={causal}",
                   ms=device_ms(fn, cpm, reps=10, inner=3),
                   library_ms=device_ms(sdpa_bwd(q, k, v, causal), cpm,
                                        reps=10, inner=3),
                   **bwd_kernel_ms(fn))
        row["bound_ms"], row["bound_by"], row["simt_bound_ms"] = bwd_bound(
            q, k, causal, 0)
        rows.append(row)
        parts = " ".join(f"{key}=" + ("not measured" if row[key] is None
                                       else f"{row[key]:.6f}")
                         for key in ("dq_ms", "dkdv_ms", "sum_ms"))
        log(f"time flash_attention_bwd {model} {row['shape']}: kernel_ms="
            f"{row['ms']:.6f} ({parts}) bound_ms={row['bound_ms']:.6f} "
            f"({row['bound_by']}) simt_bound_ms={row['simt_bound_ms']:.6f} "
            f"library_ms={row['library_ms']:.6f} (SDPA {dt} backward)")
        del q, k, v, do, out, lse
    report["flash_bwd_parts"] = rows
    return rows


def scan_bwd_bound(a, h0):
    """B6 backward's least time: a, hs, dhs (and h0) read once, da, db
    (and dh0) written once, over 3.35 TB/s; or its three flops per element
    over the f32 rate."""
    n = a.numel()
    nbytes = n * (3 * a.element_size() + 8)
    if h0 is not None:
        nbytes += 8 * h0.numel()
    return _bound(3 * n / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def check_scan_bwd(report):
    """B6's backward against its plain version on the card, bit for bit:
    the shapes of ``check_scan`` (the reference's TPU grid, the chunk, odd
    shapes), f32 and bf16 a, from zeros and from h0, a nonzero gradient on
    every row (the last one too, as the chunk loop adds the next chunk's
    into it); one launch a call; two calls alike.  Times it at
    SCAN_BWD_TIMED against its bytes bound, and B6's forward at the
    training chunk (B=1).  Returns (max |err|, the chunk's timing row)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm_k

    shapes = [(2, S, D, N) for S, D, N in [(128, 64, 8), (256, 256, 16),
                                           (64, 128, 4)]]
    shapes += [SCAN_BWD_TIMED[0], (3, 77, 100, 5), (5, 33, 7, 3),
               (1, 1, 1, 1)]
    n, err = 0, 0.0
    for i, shape in enumerate(shapes):
        for dt in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                a, b, h0 = scan_inputs(*shape, dt, seed=900 + i,
                                       with_h0=with_h0)
                hs = ref.ssm_scan_ref(a, b, h0)
                dhs = torch.randn(shape, device="cuda", generator=torch
                                  .Generator(device="cuda").manual_seed(i))
                ssm_k.reset_launch_counts()
                got = ssm_k.ssm_scan_bwd(a, hs, h0, dhs)
                again = ssm_k.ssm_scan_bwd(a, hs, h0, dhs)
                want = ref.ssm_scan_bwd_ref(a, hs, h0, dhs)
                torch.cuda.synchronize()
                tag = f"ssm_scan_bwd {shape} {dt} h0={with_h0}"
                if ssm_k.LAUNCHES["ssm_scan_bwd"] != 2:
                    raise AssertionError(f"{tag}: {ssm_k.LAUNCHES}")
                for name, g, x, w in zip(("da", "db", "dh0"), got, again,
                                         want):
                    if g.dtype != w.dtype or g.shape != w.shape:
                        raise AssertionError(f"{tag} {name}: {g.dtype}"
                                             f"{tuple(g.shape)}")
                    if not (bits_equal(g, w) and bits_equal(g, x)):
                        raise AssertionError(
                            f"{tag} {name}: kernel != plain version or two "
                            f"calls differ (max |err| {max_abs_err(g, w)})")
                    err = max(err, max_abs_err(g, w))
                n += 1
    report["scan_bwd_checks"] = dict(calls=n, max_abs_err=err)
    log(f"scan backward checks: {n} B6 backward calls equal their plain "
        f"versions bit for bit (max |err| {err}), two calls each "
        f"bit-identical ({len(shapes)} shapes x f32/bf16 x zeros/h0)")

    cpm = sleep_cycles_per_ms()
    rows = []
    for i, shape in enumerate(SCAN_BWD_TIMED):
        a, b, h0 = scan_inputs(*shape, torch.float32, seed=950 + i)
        hs = ssm_k.ssm_scan(a, b, h0)
        dhs = torch.randn(shape, device="cuda")
        inner = 10 if shape[1] == SCAN_CHUNK else 3
        row = dict(shape=shape, ms=device_ms(
            lambda: ssm_k.ssm_scan_bwd(a, hs, h0, dhs), cpm, reps=20,
            inner=inner),
                   plain_ms=device_ms(lambda: ref.ssm_scan_bwd_ref(
                       a, hs, h0, dhs), cpm, reps=5, inner=1),
                   library_ms=None)
        row["bound_ms"], row["bound_by"] = scan_bwd_bound(a, h0)
        if shape[1] == SCAN_CHUNK:
            row["fwd_ms"] = device_ms(lambda: ssm_k.ssm_scan(a, b, h0), cpm,
                                      reps=20, inner=inner)
            row["fwd_plain_ms"] = device_ms(
                lambda: ref.ssm_scan_ref(a, b, h0), cpm, reps=5, inner=1)
            row["fwd_bound_ms"] = scan_bound(a, h0)[0]
        rows.append(row)
        log(f"time ssm_scan_bwd {shape} f32 h0: kernel_ms={row['ms']:.6f} "
            f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.3f} of it) plain_ms="
            f"{row['plain_ms']:.6f} library_ms=null"
            + (f"; forward kernel_ms={row['fwd_ms']:.6f} bound_ms="
               f"{row['fwd_bound_ms']:.6f} plain_ms={row['fwd_plain_ms']:.6f}"
               if "fwd_ms" in row else ""))
        del a, b, h0, hs, dhs
    report["scan_bwd_timings"] = rows
    return err, rows[0]


def lm_train_hymba(specs, report):
    """Hymba-1.5B at full width (32 HYMBA layers, d 1,600, 25/5 x 64, bf16
    compute, f32 params, remat) through ``make_train_step``: C =
    LM_FULL_CLIENTS, one LM_TRAIN_S-token sequence each, LM_TRAIN_ROUNDS
    rounds.  A round launches, for each client and layer, B4 twice (the
    forward and remat's recompute) and its backward once (BWD_LAUNCHES),
    B6 once a 128-step chunk twice (forward, recompute) and its backward
    once a chunk."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa_k

    cfg = get_arch(HYMBA)
    if not (cfg.remat and cfg.compute_dtype == "bfloat16"
            and cfg.param_dtype == "float32" and cfg.n_layers == 32
            and cfg.d_model == 1600 and cfg.resolved_head_dim == 64):
        raise AssertionError(f"{HYMBA}: not the full-width bf16 remat model")
    C, L = LM_FULL_CLIENTS, cfg.n_layers
    chunks = -(-LM_TRAIN_S // SCAN_CHUNK)
    return train_lm(
        "lm_train_hymba", cfg, specs, report, clients=C, batch_rows=1,
        seq=LM_TRAIN_S, rounds=LM_TRAIN_ROUNDS, knobs=LM_TRAIN_KNOBS,
        per_round={"flash_attention": 2 * L * C,
                   "flash_attention_bwd": L * C * fa_k.BWD_LAUNCHES,
                   "ssm_scan": 2 * chunks * L * C,
                   "ssm_scan_bwd": chunks * L * C},
        cuts=f"batch: one {LM_TRAIN_S}-token sequence per client; clients: "
             f"{C}")


def lm_train_seamless(specs, report):
    """SeamlessM4T-medium at full width (12 encoder + 12 decoder layers, d
    1,024, 16/16 x 64, f32, remat) through ``make_train_step``: C =
    LM_FULL_CLIENTS, one LM_TRAIN_S-token sequence beside 1,500 frames
    each, LM_TRAIN_ROUNDS rounds.  A round launches B4 (f32) twice in
    each of the 12 encoder layers (without the mask), 12 decoder
    self-attentions (causal) and 12 cross-attentions (4,096 x 1,500,
    without the mask) for each client, and its backward once in each."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa_k

    cfg = get_arch(SEAMLESS)
    if not (cfg.remat and cfg.compute_dtype == "float32"
            and cfg.n_layers == 12 and cfg.n_enc_layers == 12
            and cfg.d_model == 1024 and cfg.resolved_head_dim == 64):
        raise AssertionError(f"{SEAMLESS}: not the full-width f32 model")
    C = LM_FULL_CLIENTS
    calls = cfg.n_enc_layers + 2 * cfg.n_layers
    return train_lm(
        "lm_train_seamless", cfg, specs, report, clients=C, batch_rows=1,
        seq=LM_TRAIN_S, rounds=LM_TRAIN_ROUNDS, knobs=LM_TRAIN_KNOBS,
        per_round={"flash_attention": 2 * calls * C,
                   "flash_attention_bwd": calls * C * fa_k.BWD_LAUNCHES},
        cuts=f"batch: one {LM_TRAIN_S}-token sequence and "
             f"{cfg.frontend_tokens} frames per client; clients: {C}")


def lm_train_100m(specs, report):
    """Granite-MoE, OLMoE, LLaVA-NeXT-Mistral, Gemma-7B, Phi3-medium and
    xLSTM at the reference example's ``100m`` scale (:func:`lm100m_config`:
    8 layers, d 512, 8/4 x 64, f32, no remat), its defaults: C = 4, batch
    4, seq 128, a Byzantine fraction of 0.25, LM_100M_ROUNDS rounds each.
    A round launches B4 once in each attention layer for each client and
    its backward once (BWD_LAUNCHES); xLSTM only B1.  Returns the summed
    counts."""
    from repro_torch.configs.base import ATTN, SWA
    from repro_torch.kernels import flash_attention as fa_k

    total = {}
    for arch in LM_100M_ARCHS:
        cfg = lm100m_config(arch)
        if not (cfg.n_layers == 8 and cfg.d_model == 512
                and cfg.resolved_head_dim == 64
                and cfg.compute_dtype == "float32"):
            raise AssertionError(f"{arch}: not the example's 100m config")
        n_attn = sum(k in (ATTN, SWA) for k in cfg.pattern())
        per_call = LM_100M_CLIENTS * n_attn
        counts = train_lm(
            f"lm_train_100m/{arch}", cfg, specs, report,
            clients=LM_100M_CLIENTS, batch_rows=LM_100M_B, seq=LM_100M_S,
            rounds=LM_100M_ROUNDS, knobs=LM_100M_KNOBS,
            per_round={"flash_attention": per_call,
                       "flash_attention_bwd": per_call * fa_k.BWD_LAUNCHES},
            cuts="the example's 100m scale (8 layers, d 512, 8/4 x 64)"
                 + (", its 2-entry block pattern tiled to 8 layers"
                    if cfg.block_pattern else ""),
            profile_last=False)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


def bf16_grad_check(report):
    """One client's ``loss_fn`` gradient of Hymba's smoke model with
    ``compute_dtype="bfloat16"`` on the card (B4's bf16 forward and
    backward, B6's forward and backward) against the same model's f32
    gradient on the card, ``e_card = g_bf16 - g_f32``, held by the bf16
    policy's rule (tests/test_torch_bf16_policy.py) against the CPU's
    ``e_cpu`` (the plain versions, which the CPU tests hold to the
    reference's bf16 error): 0.5 <= RMS(e_card) / RMS(e_cpu) <= 1.25 and
    max|e_card| <= 1.5 max|e_cpu|, each leaf scaled by its f32
    gradient's largest |value|."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.core.fed_state import init_lm_tree
    from repro_torch.data.tokens import lm_batch
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves, tree_map

    cfg32 = reduce_for_smoke(get_arch(HYMBA))
    tree = init_lm_tree(torch.Generator().manual_seed(0), cfg32, "cpu")
    raw = lm_batch(np.random.RandomState(4), cfg32, 2, 300)
    grads = {}
    for dev in ("cpu", "cuda"):
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(cfg32, compute_dtype=dt)
            W = tree_map(lambda t: t.to(dev).clone().requires_grad_(True),
                         tree)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
            loss = tr.loss_fn(tr.lm_view(W, cfg), batch, cfg)
            grads[dev, dt] = [
                torch.zeros(w.shape) if g is None else g.float().cpu()
                for g, w in zip(torch.autograd.grad(
                    loss, tree_leaves(W), allow_unused=True),
                    tree_leaves(W))]
    errs = {}
    for dev in ("cpu", "cuda"):
        errs[dev] = torch.cat([
            ((g16 - g32) / max(float(ref32.abs().max()), 1e-30)).reshape(-1)
            for g16, g32, ref32 in zip(grads[dev, "bfloat16"],
                                       grads[dev, "float32"],
                                       grads["cpu", "float32"])])
    rms = lambda e: float(e.pow(2).mean().sqrt())
    rms_ratio = rms(errs["cuda"]) / rms(errs["cpu"])
    max_ratio = float(errs["cuda"].abs().max()) / float(
        errs["cpu"].abs().max())
    report["bf16_grad_check"] = dict(arch=cfg32.name, rms_ratio=rms_ratio,
                                     max_ratio=max_ratio)
    log(f"bf16 gradient on the card ({cfg32.name}, 2 x 300 tokens): RMS "
        f"ratio {rms_ratio:.3f} (0.5-1.25), max ratio {max_ratio:.3f} "
        "(<= 1.5) against the CPU's bf16 error")
    if not (0.5 <= rms_ratio <= 1.25 and max_ratio <= 1.5):
        raise AssertionError(f"bf16 gradient on the card: RMS ratio "
                             f"{rms_ratio:.3f}, max ratio {max_ratio:.3f}")


def lm100m_config(arch: str):
    """The example's ``100m`` config of ``arch`` (``configs.scale_cfg``),
    with a two-entry block pattern tiled to its 8 layers (xLSTM)."""
    from repro_torch.configs import scale_cfg

    cfg = scale_cfg(arch, "100m")
    if cfg.block_pattern and len(cfg.block_pattern) != cfg.n_layers:
        reps = cfg.n_layers // len(cfg.block_pattern)
        cfg = dataclasses.replace(cfg,
                                  block_pattern=cfg.block_pattern * reps)
    return cfg


def lm_round_launches(specs, cfg, fed):
    """Launches one BAFDP round of ``cfg``'s LM clients makes: the
    consensus once (its B1-B3 spec's counter), B4 in every attention layer
    for every client (twice with remat's recompute) and B4's backward
    there (BWD_LAUNCHES each)."""
    from repro_torch.kernels import flash_attention as fa_k

    n = layer_counts(cfg)[0] * fed.n_clients
    return {consensus_spec(specs, fed)["counter"]: 1,
            "flash_attention": n * (2 if cfg.remat else 1),
            "flash_attention_bwd": n * fa_k.BWD_LAUNCHES}


def _states_bitwise(a, b) -> int:
    """Elements that differ between two ``FedState``s leaf for leaf
    (dtypes, shapes and devices must match)."""
    n = 0
    for (path, x), (_, y) in zip(_named_leaves(a._asdict()),
                                 _named_leaves(b._asdict())):
        if x.dtype != y.dtype or x.shape != y.shape or x.device != y.device:
            raise AssertionError(f"{path}: {x.dtype} {tuple(x.shape)} "
                                 f"{x.device} vs {y.dtype} "
                                 f"{tuple(y.shape)} {y.device}")
        n += int((x != y).sum())
    return n


def _quiet_run(fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output logged line by line;
    returns (result, the output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    return out, buf.getvalue()


def lm_resume(specs, report):
    """Checkpoints and resume on the card, in a temporary directory
    removed after.  ``repro_torch.federated_lm_training`` (the example's
    knobs) at the smoke scale for RESUME_STEPS[0] rounds, saving under
    that label; the archive restored onto the final state equals it leaf
    for leaf, bit for bit, on the card; then resumed to RESUME_STEPS[1]:
    it says so and trains only the rounds after the label, and its first
    round, from the restored state, equals the same round from the state
    in memory (bit for bit, else under ``drift_check`` with the count of
    unequal elements).  At the 100m scale RESUME_100M_STEPS rounds under
    each server (quorum, fedbuff): the save and restore seconds and the
    archive's bytes (RESUME_100M_CLIENTS clients).  ``launch.train
    --smoke --ckpt`` for LAUNCH_STEPS[0] rounds, then resumed to
    LAUNCH_STEPS[1].  Every run's launches from its config.  The example
    runs as a user calls it; the phase times its ``Checkpointer`` and
    keeps a round's inputs by wrapping the class and
    ``launch.steps.make_train_step`` for the run.  Returns the counts."""
    import os
    import shutil
    import tempfile

    from repro_torch import federated_lm_training as ex
    from repro_torch.checkpoint import Checkpointer, restore_pytree
    from repro_torch.configs import get_arch, reduce_for_smoke, scale_cfg
    from repro_torch.launch import steps
    from repro_torch.launch import train as launcher
    from repro_torch.tree import tree_map

    total = {}
    out = report.setdefault("lm_resume", {})

    class TimedCheckpointer(Checkpointer):
        """The example's ``Checkpointer``, keeping its last save's seconds,
        path and bytes and its last restore's seconds (the card
        synchronized before and after)."""
        made = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.made.append(self)

        def save(self, tree, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.path = super().save(tree, step)
            self.save_s = time.perf_counter() - t0
            self.bytes = os.path.getsize(self.path)
            return self.path

        def restore_latest(self, template):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = super().restore_latest(template)
            torch.cuda.synchronize()
            self.restore_s = time.perf_counter() - t0
            return got

    def add(counts, fed):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        spec = consensus_spec(specs, fed)
        spec["launches"] += counts[spec["counter"]]

    def run(label, argv, cfg, fed, rounds, keep=None):
        """The example at ``argv``; ``keep[t]`` gets round t's step
        function, batch, keyword arguments and new state (a copy) for
        each t in ``keep``.  Returns (its result, its Checkpointer, its
        output, seconds, launches)."""
        want = {k: v * rounds for k, v in
                lm_round_launches(specs, cfg, fed).items()}
        make = steps.make_train_step

        def recording(c, f):
            step = make(c, f)

            def round_fn(st, batch, seed, **kw):
                new, m = step(st, batch, seed, **kw)
                if keep is not None and seed in keep:
                    keep[seed] = dict(step=step, batch=batch, kw=kw,
                                      new=type(new)(*tree_map(
                                          lambda x: None if x is None
                                          else x.clone(), tuple(new))))
                return new, m
            return round_fn

        TimedCheckpointer.made.clear()
        ex.Checkpointer, steps.make_train_step = TimedCheckpointer, recording
        try:
            torch.cuda.synchronize()
            reset_all_counts()
            t0 = time.perf_counter()
            info, text = _quiet_run(ex.train, ex.parse_args(argv))
            secs = time.perf_counter() - t0
        finally:
            ex.Checkpointer, steps.make_train_step = Checkpointer, make
        counts = all_counts()
        check_path_counts(label, counts, want)
        add(counts, fed)
        return info, TimedCheckpointer.made[-1], text, secs, counts

    def example_fed(cfg, clients=4):
        return dataclasses.replace(
            steps.fed_config_for(cfg, clients), byzantine_frac=0.25,
            attack="sign_flip", alpha_w=2e-2, active_frac=0.75)

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # the smoke scale: save, restore, resume
        cfg = scale_cfg(ARCH, "smoke")
        fed = example_fed(cfg)
        first, last = RESUME_STEPS
        d = f"{root}/smoke"
        a, ck_a, _, secs_a, counts_a = run(
            "example smoke", ["--scale", "smoke", "--steps", str(first),
                              "--ckpt", d], cfg, fed, first)
        if a["rounds"] != list(range(first)) or \
                Checkpointer(d).latest_step() != first:
            raise AssertionError(f"example smoke: rounds {a['rounds']}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = restore_pytree(ck_a.path, a["state"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if _states_bitwise(restored, a["state"]):
            raise AssertionError("example smoke: the restored state differs")
        del restored
        seen = {first: None}
        b, ck_b, text, secs_b, counts_b = run(
            "example smoke resumed", ["--scale", "smoke", "--steps",
                                      str(last), "--ckpt", d],
            cfg, fed, last - first, keep=seen)
        if f"resumed from step {first}" not in text \
                or b["rounds"] != list(range(first, last)):
            raise AssertionError(f"example smoke resumed: rounds "
                                 f"{b['rounds']}")
        r = seen[first]
        mem, _ = r["step"](a["state"], r["batch"], first, **r["kw"])
        n_diff = _states_bitwise(mem, r["new"])
        drift = None
        if n_diff:
            drift = drift_check("example resume round", mem, r["new"], 1,
                                fed.alpha_w)
        out["smoke"] = dict(
            arch=cfg.name, clients=fed.n_clients, rounds=[first, last],
            s=[secs_a, secs_b], save_s=ck_a.save_s, restore_s=restore_s,
            resume_restore_s=ck_b.restore_s, ckpt_bytes=ck_a.bytes,
            state_bytes=state_bytes(a["state"]), restored_bitwise=True,
            resumed_round_unequal=n_diff, drift=drift,
            launches=[counts_a, counts_b])
        log(f"lm_resume example smoke ({cfg.name}, C={fed.n_clients}): "
            f"{first} rounds in {secs_a:.2f} s, archive "
            f"{ck_a.bytes} bytes of {state_bytes(a['state'])} "
            f"(saved in {ck_a.save_s:.3f} s, restored in {restore_s:.3f} s:"
            f" bit for bit on the card); resumed at {first}, rounds "
            f"{b['rounds']} in {secs_b:.2f} s; round {first} from the "
            f"restored state vs from memory: "
            + ("bit for bit" if not n_diff else
               f"{n_diff} elements unequal, drift_check {drift}")
            + f"; launches {counts_a} + {counts_b}")
        del a, b, seen, r, mem

        # the 100m scale under each server
        cfg = scale_cfg(ARCH, "100m")
        fed = example_fed(cfg, RESUME_100M_CLIENTS)
        for server in ("quorum", "fedbuff"):
            d = f"{root}/100m_{server}"
            info, ck, _, secs, counts = run(
                f"example 100m {server}",
                ["--scale", "100m", "--steps", str(RESUME_100M_STEPS),
                 "--server", server, "--clients", str(RESUME_100M_CLIENTS),
                 "--ckpt", d], cfg, fed, RESUME_100M_STEPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored, step = Checkpointer(d).restore_latest(info["state"])
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            if step != RESUME_100M_STEPS or _states_bitwise(restored,
                                                           info["state"]):
                raise AssertionError(f"example 100m {server}: restore")
            raw = state_bytes(info["state"])
            out[f"100m_{server}"] = dict(
                arch=cfg.name, clients=fed.n_clients,
                rounds=RESUME_100M_STEPS, s=secs, save_s=ck.save_s,
                restore_s=restore_s, ckpt_bytes=ck.bytes,
                state_bytes=raw, save_mb_per_s=raw / ck.save_s / 1e6,
                restore_mb_per_s=raw / restore_s / 1e6, launches=counts)
            log(f"lm_resume example 100m --server {server} ({cfg.name}, "
                f"C={fed.n_clients}): {RESUME_100M_STEPS} rounds in "
                f"{secs:.2f} s; archive {ck.bytes} bytes of "
                f"{raw} (np.savez_compressed: saved in "
                f"{ck.save_s:.3f} s = {raw / ck.save_s / 1e6:.1f}"
                f" MB/s, restored in {restore_s:.3f} s = "
                f"{raw / restore_s / 1e6:.1f} MB/s, bit for bit); launches "
                f"{counts}")
            del info, restored
            shutil.rmtree(d)

        # the launcher: its label t
        cfg = reduce_for_smoke(get_arch(ARCH))
        fed = dataclasses.replace(steps.fed_config_for(cfg, 2),
                                  byzantine_frac=0.0, attack="sign_flip",
                                  alpha_w=1e-2)
        d = f"{root}/launch"
        argv = ["--arch", ARCH, "--smoke", "--log-every", "1", "--ckpt", d]
        for n, lo in ((LAUNCH_STEPS[0], 0), (LAUNCH_STEPS[1],
                                             LAUNCH_STEPS[0])):
            want = {k: v * (n - lo) for k, v in
                    lm_round_launches(specs, cfg, fed).items()}
            reset_all_counts()
            rc, text = _quiet_run(launcher.main, argv + ["--steps", str(n)])
            counts = all_counts()
            check_path_counts(f"launch.train --ckpt --steps {n}", counts,
                              want)
            add(counts, fed)
            ran = [int(line.split()[1]) for line in text.splitlines()
                   if line.startswith("step")]
            if rc != 0 or ran != list(range(lo, n)) or (
                    lo and f"resumed at step {lo}" not in text):
                raise AssertionError(f"launch.train --ckpt --steps {n}: "
                                     f"rounds {ran}")
        out["launch_train"] = dict(steps=list(LAUNCH_STEPS),
                                   resumed_at=LAUNCH_STEPS[0])
        log(f"lm_resume launch.train --smoke --ckpt: {LAUNCH_STEPS[0]} "
            f"rounds, then resumed at {LAUNCH_STEPS[0]} and ran rounds "
            f"{LAUNCH_STEPS[0]}-{LAUNCH_STEPS[1] - 1}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False     # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    report = {"card": card}

    t_start = time.perf_counter()
    build_kernels(report)
    # B4's kernels at head dim 64, as dispatched: name and tiles
    b4 = {fn: kernel_label(report, fn, 64)
          for fn in ("dispatch_f32", "dispatch_bf16")}
    # B5's instances on the serving path: D=64, SmolLM-360M's 3 query heads
    # per KV head in f32, Hymba-1.5B's 5 in bf16
    b5 = {label: report["ptxas"][label] for label in
          ("decode_cluster<64,float,3>", "decode_cluster<64,bf16,5>")}

    from repro_torch.configs import MLP_H1, MLP_H24
    from repro_torch.models.forecasting import init_forecaster
    from repro_torch.tree import tree_leaves

    for name, cfg, want in (("MLP_H24", MLP_H24, MAIN_LEAF_D),
                            ("MLP_H1", MLP_H1, PAPER_LEAF_D)):
        leaf_d = [l.numel() for l in tree_leaves(
            init_forecaster(torch.Generator(), cfg))]
        if leaf_d != want:
            raise AssertionError(f"{name} leaves {leaf_d} != {want}")

    specs = kernel_specs()
    t0 = time.perf_counter()
    check_kernels(specs, report)
    check_groups(specs, report)
    time_kernels(specs, report)
    report["kernel_phase_s"] = time.perf_counter() - t0
    log(f"phase: consensus kernels {report['kernel_phase_s']:.1f} s")
    t0 = time.perf_counter()
    train_runs(specs, report)
    cpu_vs_cuda(report)
    report["train_phase_s"] = time.perf_counter() - t0
    log(f"phase: training {report['train_phase_s']:.1f} s")
    t0 = time.perf_counter()
    sparse_runs(specs, report)
    sparse_cpu_vs_cuda(report)
    scale_round(specs, report)
    report["sparse_phase_s"] = time.perf_counter() - t0
    log(f"phase: sparse round and schedules {report['sparse_phase_s']:.1f} s")
    t0 = time.perf_counter()
    robust_runs(specs, report)
    robust_cpu_vs_cuda(report)
    baseline_runs(specs, report)
    report["robust_phase_s"] = time.perf_counter() - t0
    log(f"phase: robust consensus and baselines "
        f"{report['robust_phase_s']:.1f} s")
    t0 = time.perf_counter()
    paper_runs(specs, report)
    report["paper_phase_s"] = time.perf_counter() - t0
    log(f"phase: paper evaluation {report['paper_phase_s']:.1f} s")

    t0 = time.perf_counter()
    errs = check_attention(report)
    errs["flash_attention"] = max(errs["flash_attention"],
                                  check_long_row(report))
    times = time_attention(report)
    time_head_dims(report)
    cfg, params = serve_model(ARCH)
    launches = dict(prefill_run(cfg, params, report))
    for name, n in generate_run(cfg, params, report).items():
        launches[name] += n
    del params
    serve_cpu_vs_cuda(cfg, report)
    report["serve_phase_s"] = time.perf_counter() - t0
    log(f"phase: serving SmolLM-360M {report['serve_phase_s']:.1f} s")

    t0 = time.perf_counter()
    errs["ssm_scan"] = check_scan(report)
    scan = time_scan(report)
    times_hymba = time_attention_hymba(report)
    cfg, params = serve_model(HYMBA)
    for run in (prefill_run, generate_run):
        for name, n in run(cfg, params, report).items():
            launches[name] += n
    hymba_cpu_vs_cuda(cfg, params, report)
    del params
    report["hymba_phase_s"] = time.perf_counter() - t0
    log(f"phase: serving Hymba-1.5B {report['hymba_phase_s']:.1f} s")

    t0 = time.perf_counter()
    moe_rows = moe_attention(report, errs)
    moe_runs(report, launches)
    moe_cpu_vs_cuda(report)
    report["moe_phase_s"] = time.perf_counter() - t0
    log(f"phase: serving MoE {report['moe_phase_s']:.1f} s")

    # the rest of LM serving: xLSTM (no kernel), the encoder-decoder (B4
    # without the mask, B5 over the memory), the VLM (B4/B5 at 32/8 x 128)
    new_rows = {}
    for arch, phase, seed in ((XLSTM, "xlstm_serve", 600),
                              (SEAMLESS, "encdec_serve", 700),
                              (LLAVA, "vlm_serve", 800)):
        t0 = time.perf_counter()
        new_rows[phase] = serve_phase(arch, report, launches, errs, seed)
        report[f"{phase}_phase_s"] = time.perf_counter() - t0
        log(f"phase: {phase} ({arch}) {report[f'{phase}_phase_s']:.1f} s")

    # Gemma-7B (B4/B5 bf16 at head dim 256) and Phi3-medium-14B (at 40/10
    # x 128) at full width, each then through long_500k's windowed decode
    # (the ring of 8,192 slots across its wrap) before it is freed; RoPE's
    # frequencies first, which those positions magnify
    rope_cpu_vs_cuda(report)

    def then(cfg, params, arch, seed):
        # Phi3 then through the placed prefill pair and window decode
        # (placed_serve), its logits held to window_decode's
        keep = []
        rows = window_decode(arch, cfg, params, report, launches, errs,
                             seed, keep=keep)
        if arch in PLACED_PAIRS:
            placed_serve(arch, cfg, params, report, launches, keep, seed)
        return rows

    for arch, phase, seed in ((GEMMA, "dense_serve_gemma", 900),
                              (PHI3, "dense_serve_phi3", 1000)):
        t0 = time.perf_counter()
        new_rows[phase] = serve_phase(
            arch, report, launches, errs, seed,
            then=lambda cfg, params, arch=arch, seed=seed: then(
                cfg, params, arch, seed + 500))
        report[f"{phase}_phase_s"] = time.perf_counter() - t0
        log(f"phase: {phase} ({arch}, with window_decode) "
            f"{report[f'{phase}_phase_s']:.1f} s")

    # LM training: B4's backward alone, then SmolLM-360M at full width
    # through make_train_step (B1, B4 and its backward), then the smoke
    # model on the CPU and on the card; from here on under the allocator
    # policy of the training entry point (launch/train.py)
    from repro_torch.launch.train import use_expandable_segments

    t0 = time.perf_counter()
    use_expandable_segments()
    bwd = check_flash_bwd(report, errs)
    for name, n in lm_train_runs(specs, report).items():
        launches[name] = launches.get(name, 0) + n
    lm_train_cpu_vs_cuda(report)
    report["lm_train_phase_s"] = time.perf_counter() - t0
    log(f"phase: lm_train ({ARCH}) {report['lm_train_phase_s']:.1f} s")

    # Placement: lm_train's rounds again through train_setup on the placed
    # state (bit for bit), then launch.train --variant at full width
    for phase, run in (("placed_train", placed_train),
                       ("variant_train", variant_train)):
        t0 = time.perf_counter()
        for name, n in run(specs, report).items():
            launches[name] = launches.get(name, 0) + n
        report[f"{phase}_phase_s"] = time.perf_counter() - t0
        log(f"phase: {phase} ({ARCH}) {report[f'{phase}_phase_s']:.1f} s")

    # The rest of LM training.  B4's bf16 backward and B6's backward held
    # and timed alone; Hymba-1.5B at full width (bf16: B4 and its bf16
    # backward, B6 and its backward), its smoke model on the CPU and on
    # the card, its bf16 gradient on the card; SeamlessM4T-medium at full
    # width (f32); the other families at the example's 100m scale
    t0 = time.perf_counter()
    bwd16, fwd_lse = check_flash_bwd_bf16(report, errs)
    bwd_parts = {r["model"]: r for r in time_flash_bwd_parts(report)}
    errs["ssm_scan_bwd"], scan_bwd = check_scan_bwd(report)
    for name, n in lm_train_hymba(specs, report).items():
        key = ("flash_attention_bwd_bf16" if name == "flash_attention_bwd"
               else name)
        launches[key] = launches.get(key, 0) + n
    lm_train_cpu_vs_cuda(report, arch=HYMBA, seq=2 * SCAN_CHUNK,
                         key="lm_train_hymba_cpu_vs_cuda")
    bf16_grad_check(report)
    report["lm_train_hymba_phase_s"] = time.perf_counter() - t0
    log(f"phase: lm_train_hymba ({HYMBA}) "
        f"{report['lm_train_hymba_phase_s']:.1f} s")
    for phase, run in (("lm_train_seamless", lm_train_seamless),
                       ("lm_train_100m", lm_train_100m)):
        t0 = time.perf_counter()
        for name, n in run(specs, report).items():
            launches[name] = launches.get(name, 0) + n
        report[f"{phase}_phase_s"] = time.perf_counter() - t0
        log(f"phase: {phase} {report[f'{phase}_phase_s']:.1f} s")

    # Checkpoints: the federated LM example saved, restored and resumed,
    # at the smoke and 100m scales, and launch.train --ckpt
    t0 = time.perf_counter()
    for name, n in lm_resume(specs, report).items():
        launches[name] = launches.get(name, 0) + n
    report["lm_resume_phase_s"] = time.perf_counter() - t0
    log(f"phase: lm_resume {report['lm_resume_phase_s']:.1f} s")

    # B1-B3: per round of the 8 MLP_H24 leaves as one grouped call, with
    # call_ms and the same leaves in eight one-leaf calls beside it, and
    # at the bandwidth shape (C=64, D=4,194,304 f32); the kernel named by
    # ptxas's label of its f32 instance
    kernels = []
    for s in specs:
        flag = "true" if s["weighted"] else "false"
        labels = [f"{s['kernel_name']}<{t},{flag}>" for t in ("float",
                                                               "bf16")]
        if not all(label in report["ptxas"] for label in labels):
            raise AssertionError(f"{s['name']}: no ptxas lines for {labels}")
        kernels.append(dict(
            name=s["name"], route="cuda", source=SOURCE,
            replaces=s["replaces"], launches=s["launches"],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"], library_ms=None,
            kernel=labels[0],
            ptxas={label: report["ptxas"][label] for label in labels},
            call_ms=s["call_ms"], one_leaf_ms=s["one_leaf_ms"],
            one_leaf_call_ms=s["one_leaf_call_ms"],
            bandwidth_ms=s["bandwidth_ms"],
            bandwidth_bound_ms=s["bandwidth_bound_ms"],
            **{k: s[k] for k in ("sparse_block_ms", "sparse_block_bound_ms")
               if k in s}))
    for name, replaces in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:84"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:66")):
        r = times[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"{CSRC}/{name}.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=errs[name], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    # B5: the fields above are at B=8 x 4096 valid positions (f32); the
    # serving rows of SmolLM-360M (f32) and Hymba-1.5B (bf16), and ptxas's
    # registers and spills of the instances they launch
    sv, hd = times["decode_attention_serving"], times_hymba["decode_attention"]
    for rows in (moe_rows, *new_rows.values()):
        for r in rows["decode_attention"]:
            b5[r["kernel"]] = r["ptxas"]
    next(k for k in kernels if k["name"] == "decode_attention").update(
        kernel="decode_cluster<D,T,GP>", ptxas=b5,
        serving_ms=sv["ms"], serving_bound_ms=sv["bound_ms"],
        serving_plain_ms=sv["plain_ms"], serving_library_ms=sv["library_ms"],
        bf16_ms=hd["ms"], bf16_bound_ms=hd["bound_ms"],
        bf16_plain_ms=hd["plain_ms"], bf16_library_ms=hd["library_ms"],
        moe=moe_rows["decode_attention"],
        encdec=new_rows["encdec_serve"]["decode_attention"],
        vlm=new_rows["vlm_serve"]["decode_attention"],
        dense=new_rows["dense_serve_gemma"]["decode_attention"]
        + new_rows["dense_serve_phi3"]["decode_attention"])
    # B4's two kernels: the fields above are the f32 one's (SmolLM-360M's
    # prefill); the bf16 one's at Hymba-1.5B's prefill shape
    hb = times_hymba["flash_attention"]
    next(k for k in kernels if k["name"] == "flash_attention").update(
        autograd_fwd_b1=fwd_lse, f32_kernel=b4["dispatch_f32"],
        simt_bound_ms=times["flash_attention"]["simt_bound_ms"],
        bf16_kernel=b4["dispatch_bf16"],
        bf16_ms=hb["ms"],
        bf16_bound_ms=hb["bound_ms"], bf16_library_ms=hb["library_ms"],
        moe=moe_rows["flash_attention"],
        encdec=new_rows["encdec_serve"]["flash_attention"],
        vlm=new_rows["vlm_serve"]["flash_attention"],
        dense=new_rows["dense_serve_gemma"]["flash_attention"]
        + new_rows["dense_serve_phi3"]["flash_attention"])
    # B4's backward: its kernels (dq, the per-head dK/dV, their sum) with
    # registers and spills; the call's ms and each kernel's at the training
    # shape, and for f32 at SeamlessM4T's decoder and cross shapes
    for name, t, row, model in (
            ("flash_attention_bwd", "float", bwd, "smollm-360m"),
            ("flash_attention_bwd_bf16", "bf16", bwd16, "hymba-1.5b")):
        labels = [label for label in report["ptxas"]
                  if label.startswith("flash_bwd_")
                  and label.endswith(f",{t}>")]
        if len(labels) != 3:
            raise AssertionError(f"{name}: ptxas labels {labels}")
        parts = bwd_parts[model]
        kernels.append(dict(
            name=name, route="cuda", source=f"{CSRC}/flash_attention_bwd.cu",
            replaces="none: no TPU kernel; jax.grad of the reference's "
                     "attention, src/repro/models/attention.py:163",
            launches=launches[name], max_abs_err=errs[name], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            simt_bound_ms=row["simt_bound_ms"], kernel=labels,
            **{key: parts[key] for key in ("dq_ms", "dkdv_ms", "sum_ms")},
            registers={label: ptxas_registers(report["ptxas"][label])
                       for label in labels},
            ptxas={label: report["ptxas"][label] for label in labels}))
    next(k for k in kernels if k["name"] == "flash_attention_bwd").update(
        seamless=[bwd_parts[m] for m in ("seamless-m4t-medium decoder",
                                         "seamless-m4t-medium cross")])
    kernels.append(dict(
        name="ssm_scan", route="cuda", source=f"{CSRC}/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:44",
        launches=launches["ssm_scan"], max_abs_err=errs["ssm_scan"],
        ms=scan["ms"], plain_ms=scan["plain_ms"], bound_ms=scan["bound_ms"],
        bound_by=scan["bound_by"], library_ms=None))
    labels = [label for label in report["ptxas"]
              if label.startswith("ssm_scan_bwd_kernel")]
    kernels.append(dict(
        name="ssm_scan_bwd", route="cuda", source=f"{CSRC}/ssm_scan.cu",
        replaces="none: no TPU kernel; jax.grad of the reference's scan, "
                 "src/repro/models/ssm.py:93 (_assoc_scan)",
        launches=launches["ssm_scan_bwd"], max_abs_err=errs["ssm_scan_bwd"],
        ms=scan_bwd["ms"], plain_ms=scan_bwd["plain_ms"],
        bound_ms=scan_bwd["bound_ms"], bound_by=scan_bwd["bound_by"],
        library_ms=None, kernel=labels,
        ptxas={label: report["ptxas"][label] for label in labels},
        forward_ms_b1=scan_bwd["fwd_ms"],
        forward_plain_ms_b1=scan_bwd["fwd_plain_ms"],
        forward_bound_ms_b1=scan_bwd["fwd_bound_ms"]))
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    log(f"chip_smoke: {report['total_s']:.1f} s in all")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
