#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1] [--seed 0] [--log-dir DIR] [--only 11g|12|13]

Phases, each of which must pass (any failure raises and exits non-zero
before the result line):

1. card: name and power limit, as ``nvidia-smi`` reports them;
2. build: ``nvcc`` compiles the five CUDA sources for sm_90a, in
   parallel (``segment_sum.cu``, ``hash_probe.cu``,
   ``flash_attention.cu``, ``rglru_scan.cu``, ``mlstm_chunkwise.cu``);
   the build times and ptxas's register reports;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the slice's shapes. The segment kernels at n = 6,001,215
   rows, S = 4 as in Q1 and S = 1.5M as in Q18, SUM over every integer
   dtype (int8/int16/int32/int64/uint8, values over the whole range, so
   the sums wrap) and float32/float64, MIN/MAX over
   int8/int32/int64/float32/float64, with invalid lanes, out-of-range
   ids, NaNs, empty segments and tied ``±0.0``: integers, counts and
   MIN/MAX bit for bit (the sign of a zero included) and across two
   launches, float sums within the tolerance below and bitwise across
   two launches; the int64 SUM at S = 1.5M again with the ids in
   runs, as Q18's orders lie in lineitem, and at S = 175, as in Q9;
   MIN/MAX also at S = 16, 17, 175 and 4096, the edges of the atomic
   kernels' three shapes. A row times the wrapper and the kernel alone
   with CUDA events over back-to-back calls (``ms``, ``kernel_only_ms``;
   a float SUM apart its two steps: the run-order partition and the
   reduction kernel), and gives ``device_ms``, the card's own time in
   the source's kernels during the alone call, from ``torch.profiler``
   (the events time the host's launch rate when a call takes longer to
   launch than to run; a row whose kernels show no device time fails).
   The probe kernels at n = 6,001,215 (keys clustered and in random
   order) and n = 1,500,000 lanes into a table of T = 2^23 slots, with
   out-of-range lanes (negative, >= T, the int32 sentinel), empty
   slots, duplicate keys and masked lanes, bit for bit, each
   ``device_ms`` at most its library call's time; and n = 0, T = 0, and
   the 16-byte body's edges
   (n of 1-5 and 4k + 1 to 4k + 3, misaligned views of slots, mask and
   table, masks all false and all true). Times of the kernel, the plain
   version and one PyTorch library call, and the bound;
4. slice: TPC-H SF ``--sf`` generated from ``--seed``, run through
   ``Client.run`` on the default backend (``torch_auto`` on ``cuda``);
   both segment kernels and ``hash_probe`` (Q18's outer join) must have
   launched; every published table must match the port's ``vectorized``
   backend (integers, counts, MIN/MAX and validity exactly, float
   SUM/MEAN to rtol 1e-9); a rerun with ``cache=False`` must reproduce
   every fingerprint; at SF 0.01 the ``reference`` backend must match
   too;
5. queries: two SQL queries through ``Client.sql`` on the same catalog,
   with the default optimizer passes: lineitem joined to orders and
   grouped by customer, then the same with a WHERE on lineitem that
   ``filter_pushdown`` and ``probe_fusion`` turn into a filter-fused
   probe. ``hash_probe`` and ``masked_hash_probe`` must have launched,
   EXPLAIN must show the fusion, and each result must equal the query on
   ``vectorized``, the unoptimized plan and a ``cache=False`` rerun
   (fingerprints); at SF 0.01 the ``reference`` backend must match;
5b. partial aggregation over a list of cards, and the paper's example,
   on the same catalog: (a) Q18's ``order_lines`` aggregate (6,001,215
   rows, int64 key ``l_orderkey``, int64 SUM and COUNT, float64 MIN and
   MAX) through ``PartitionedBackend(device="cuda").group_by_agg`` (every
   visible card), bit for bit against ``vectorized``, with both segment
   kernels launched, and the wall times of ``partitioned``, ``torch``
   and ``vectorized`` for the same call; (b) the same over four
   partitions through the multi-card code (``devices=["cuda:0"] * 4``);
   (c) ``partitioned`` registered over those four, the TPC-H pipeline
   planned with its row counts and optimized: ``order_lines`` carries
   the ``partial_agg`` rewrite, runs as partials through ``Client.run``
   on ``torch_auto``, and its tables equal ``vectorized``'s and phase
   4's unoptimized run, and a ``cache=False`` rerun's fingerprints; the
   one-card factory is registered again after; (d) phase 5's two join
   queries on the four partitions (probe and GROUP BY), each equal to
   ``vectorized``; (e) the paper's running example
   (``configs/paper_pipeline.py``, with the Appendix-A node) after
   ``seed_lake`` through ``Client.run`` on the default backend, at its
   5 rows and at 1,000,000 (the parent's GROUP BY on the card):
   committed, no NULL in ``family_friend.col5``, and the fingerprints
   of ``vectorized``. Every segment kernel call of the partial path in
   (a)-(d), each partition's reduction (n = 6,001,215 rows into S =
   8,388,608 slots on one card) and each owner's combine (4 x 2^21
   partial lanes into 2^21 slots), is held against its plain version on
   the same card tensors, as in phase 3; the heaviest call of each
   kernel is timed again as phase 3's rows are, and gives the
   ``kernels`` line its shape, times and bound;
6. the model stack, recurrentgemma-9b (arXiv:2402.19427 as
   ``repro_torch/configs/recurrentgemma_9b.py`` configures it: 38 layers,
   d_model 4096, 16 heads, one kv head, head dim 256, window 2048):
   a. the flash attention and RG-LRU scan kernels against their plain
      versions at the prefill's shapes (B=4, S=4096) and edge cases,
      with times, bounds and the library yardstick; each flash case
      names the kernel it ran (``wgmma`` for bf16 at hd 64/96/128/256,
      ``simt`` otherwise), the main case must run ``wgmma`` with no
      spill, and its control, the plain version with P rounded to one
      bf16 part before P V, must fail ``FLASH_TOL``;
   b. ``repro_torch.launch.serve.main`` on the card: the pinned-commit
      flow at the smoke config, as ``repro``'s launcher runs it;
   c. the full config, weights drawn on the card from ``--seed``: a
      prefill of 4 prompts x 4096 tokens through ``forward(mode=
      "last_logits", return_kv=True)``; finite logits, 12 flash (all of
      them the wgmma kernel) and 26 RG-LRU launches per forward,
      tokens/s and peak memory;
   e. ``ServeLoop`` at the full config with the launcher's defaults (8
      requests, 4 slots, prompts of 4-12 tokens, 16 new tokens): decode
      step ms and tokens/s, and one decode attention call a step and
      attention block;
   d. the prefill path against the decode path at full size: one
      prompt of 2304 tokens (the 2048-slot ring buffer wraps), prefill
      ``last_logits`` against 2304 teacher-forced ``decode_step``s, and
      the prefill's K/V of the last 2048 positions against the decode
      ring cache (float32 activations over the same weights; the
      tolerances are ``PREFILL_DECODE_LOGITS_RTOL`` and
      ``PREFILL_DECODE_KV_RTOL``); the decode's attention launches
      counted apart from the prefill's;
7. xlstm-350m (arXiv:2405.04517 as ``repro_torch/configs/xlstm_350m.py``
   configures it: 24 layers, (mlstm, slstm) x 12, d_model 1024, 4 heads,
   head dim 256, vocab 50,304 tied):
   a. the chunkwise mLSTM kernel against its plain version (the
      sequential recurrence) at the prefill's shape (B*H = 16, S = 2048,
      hd = 256, bf16) and edge cases, within ``MLSTM_TOL`` and
      ``MLSTM_REL``, with times, the bound, registers and spills; and the
      control: the plain version with its products' operands rounded to
      TF32 and to bf16 must fail ``MLSTM_REL``;
   b. ``repro_torch.launch.serve.main`` with ``--arch xlstm_350m`` on the
      card;
   c. the full config, weights drawn on the card from ``--seed``: a
      prefill of 4 prompts x 2048 tokens through ``forward(mode=
      "last_logits", return_kv=True)``, cold and warm; finite logits, 12
      mLSTM launches per forward and no flash or RG-LRU launch, tokens/s,
      peak memory and the device profile;
   d. one prompt of ``XLSTM_LONG_PROMPT`` tokens, prefill ``last_logits``
      (the kernel path) against as many teacher-forced ``decode_step``s
      (no kernel), float32 activations over the same weights: argmax
      equal, logits within ``XLSTM_PREFILL_DECODE_RTOL``;
   e. ``ServeLoop`` with the launcher's defaults: decode step ms;
   phases 6 and 7 serve under ``torch.no_grad()``, so they build no
   autograd graph;
8. training, xlstm-350m through the mLSTM kernel:
   a. each model kernel's gradient wrapper (its ``autograd.Function``:
      the kernel forward, a plain backward) against autograd of its plain
      version on the same card tensors, the gradients of ``(out *
      g).sum()`` for a fixed random ``g`` with respect to every input,
      within ``GRAD_REL``, with the kernel launched once: the mLSTM
      (bf16, B*H = 16, S = 512, hd = 256), flash attention (bf16, S =
      1024: hd 256, window 2048, one kv head; hd 128, full causal, GQA)
      and the RG-LRU scan (float32, B = 4, S = 1024, W = 4096);
   b. ``repro_torch.launch.train.main(["--steps", "30", "--kill-at",
      "12"])`` on the card at the smoke config, with the launcher's own
      checks (the loss finite and lower, the branch log);
   c. the full config, weights drawn on the card from ``--seed``,
      ``TRAIN_BATCH`` x ``TRAIN_LEN`` batches of a ``markov_corpus``
      pipeline: ``TRAIN_STEPS`` steps with a checkpoint every
      ``TRAIN_CKPT`` through ``CheckpointManager`` (12 mLSTM launches a
      step), then ``resilient_train`` with a ``FailureInjector`` killing
      step ``TRAIN_KILL_AT``: the final losses within
      ``TRAIN_RESUME_TOL``, whether the two runs are bitwise equal, every
      published checkpoint commit holding all four tables, every
      gradient finite and non-zero; step time, tokens/s, peak memory,
      and the device profile of one step at ``TRAIN_PROFILE_LEN``;
   d. one step's loss and the gradients of ``embed``, an mLSTM layer's
      ``wq`` and ``w_if`` and an sLSTM layer's ``w_in`` and ``r`` through
      the kernel against the same step with ``models.xlstm.mlstm``
      patched, in this script alone, to ``repro``'s plain chunk form,
      float32 activations over the run's initial weights: the loss
      within ``TRAIN_LOSS_RTOL``, each gradient within the larger of
      ``TRAIN_GRAD_RTOL`` and twice its own spread under a
      ``TRAIN_PERTURB`` perturbation of the weights;
9. concurrent transactional runs (``repro_torch/examples/
   concurrent_runs.py``; ``repro``'s ``benchmarks/concurrent_publication.py::
   bench_rebase_reexecution`` and ``examples/concurrent_writers.py`` at SF
   ``--sf``), each on a fresh ``Client`` whose ``main`` holds the
   generated ``lineitem`` and an ``l_suppkey`` drawn per TPC-H §4.2.3, on
   the default backend, every run's verifier holding it at a barrier
   until all have executed: (a) eight threads (``AGENTS``), each a one-node
   ``Client.run`` grouping by ``l_orderkey`` or ``l_suppkey`` (SUM of
   ``l_quantity * (i + 1)``, COUNT, MIN and MAX of ``l_extendedprice``):
   every run commits, ``main`` gains one commit per run, no rebase
   re-executes a node, and each table equals the node run alone on
   ``vectorized``, bit for bit; (b) two runs writing one table: one
   commits, one aborts with its branch kept; (c) (a) with a crash injected
   at ``txn.commit.pre_merge`` (budget 1): that run is on no commit of
   ``main``, the rest commit, and ``Catalog.gc`` collects its branch. In
   each, both segment kernels launch and ``chaos.check_history`` finds no
   violation; wall seconds, runs per second, CAS attempts and rebases are
   printed beside the card. Every segment call of (a), recorded on
   ``exec/torch_backend.py`` from the eight threads, is held against its
   plain version on the same card tensors. Then two diagnostics that no
   check reads: the eight runs one after another on the same backend,
   and (a) again under the device profiler, each with the engine's and
   the transaction's spans (``node``, ``verifier``,
   ``publication_attempt``);
10. the model families that reached the port last, and phi4-mini-3b,
   each built on the card from ``--seed`` and freed before the next,
   under ``torch.no_grad()``; every prefill cold and warm, with wall
   seconds, tokens/s, peak memory, flash launches by kernel and argmax
   tokens, then profiled:
   a. flash against its plain version (``FLASH_TOL``) at every shape
      b-f call it with (``family_flash_cases``, from their configs):
      granite's 4 x 4096 at hd 64 and llama4's 2 x 4096 at hd 128 (GQA
      24/8 and 40/8); whisper's encoder (4 x 1500, non-causal), decoder
      (4 x 448, causal) and cross attention (448 over 1500 frames,
      non-causal), hd 64; phi3-vision's 4 x 4096 at hd 96 on the wgmma
      kernel (TMA boxes of 32 columns; no spill, and the one-bf16-P
      control must fail ``FLASH_TOL`` there too); phi4-mini's 4 x 4096
      in bf16 and its float32 1024- and 1088-token prefills (simt, GQA
      24/8, hd 128); then hd 96 in float32 (simt) and a ragged
      Skv=1499 in float32; last DeepSeek-V2-Lite's latent attention at
      its benchmark cell's shape (1 x 32,768, 16 heads, q/k 192, v 128,
      the YaRN scale 0.114721), which no phase serves: one launch of
      ``flash_mla_kernel`` and of no other kernel, no spill, the
      one-bf16-P control failing ``FLASH_TOL``, the plain version one
      head at a time and SDPA with ``is_causal`` (a 32k mask's scores
      would not fit); times, bound (2·(qk + v) a live pair) and SDPA's
      time as in 6a; the ``kernels`` line's flash entry carries the
      latent case under ``mla``;
   b. granite-moe-3b (``configs/granite_moe_3b.py``: 32 layers, d_model
      1536, 40 experts top-8 of d_ff 512, group 512, capacity 128): a 4 x
      4096 prefill (32 flash launches, all wgmma; aux finite; the share
      of (token, slot) pairs dropped by capacity), layer 0's MoE at that
      shape against a plain loop over the experts with the same routing
      (``MOE_LAYER_REL``), and 16 greedy decode steps from the prefill's
      K/V, finite (prefill and decode are not held against each other:
      a 512-token group drops over capacity, a one-token group never);
   c. llama4-scout-17b (``configs/llama4_scout_17b.py``: d_model 5120,
      16 experts top-1 of d_ff 8192 and a shared expert, GQA 40/8 at hd
      128) at full width, its depth cut to ``LLAMA4_LAYERS`` of 48: a 2 x
      4096 prefill, one wgmma launch a layer;
   d. whisper-medium (``configs/whisper_medium.py``: 24 encoder and 24
      decoder layers, d_model 1024, hd 64): 4 x 1500 frame embeddings
      from the seed, encoded, then a 4 x 448 decoder prefill (72 flash
      launches, all wgmma: 24 encoder, 24 self, 24 cross), then 16 greedy
      decode steps against ``init_cache(enc_out=...)``, finite;
   e. phi3-vision-4b (``configs/phi3_vision_4b.py``: 32 layers, d_model
      3072, hd 96): a 4 x 4096 prefill with 576 patch embeddings fused
      over the first positions, 32 flash launches, all wgmma;
   f. phi4-mini-3b (``configs/phi4_mini_3b.py``: 32 layers, d_model
      3072, GQA 24/8 at hd 128, no window): a 4 x 4096 prefill, 32
      wgmma launches; then, in float32 activations over the same
      weights, a 1024-token prefill's K/V as the decode cache and 64
      teacher-forced decode steps, their last logits against the prefill
      of all 1088 tokens within ``PREFILL_DECODE_LOGITS_RTOL`` (the
      argmax too where the top-2 margin exceeds that error).

11. distribution, two ranks on the one card (``RANKS`` processes
   started by ``repro_torch.launch.mesh.run_ranks``: ``spawn``, a gloo
   group through a file rendezvous, a time limit; a rank that raises or
   hangs fails the phase); the kernels were built in 2 and are loaded:
   a. the dry-run (``launch/specs.py``) of 10f's phi4-mini 4 x 4096
      prefill on a one-card ``MeshShape``: its parameters' bytes, as the
      caching allocator counts them, equal to what 10f allocated, and its
      roofline bound (``roofline/``, counted on ``meta``) no larger than
      10f's measured warm prefill (``roofline_fraction``); flash at the
      per-rank shapes of b and c against its plain version
      (``FLASH_TOL``); then which collectives gloo takes for CUDA tensors,
      and what NCCL answers two ranks on one card;
   b. phi4-mini's 2 x 4096 prefill under ``make_rules("prefill")`` on a
      (data 1, model 2) mesh: each rank draws the weights from
      ``--seed``, frees them on the card after a host copy, and reshards
      that onto the mesh (``distributed/elastic.py``); its parameters'
      bytes equal to the dry-run's per-rank bytes, the memory they grew
      by equal to their allocator blocks, each block the dry-run's count
      or, for a shard of 1 MiB or more, its segment's unsplit remainder
      (1 MiB at most) more; 32 flash launches a rank; the last logits
      against one rank's, both against float32 (``SPLIT_OF_OWN``);
   c. phi4-mini in two GPipe stages of 16 layers (``distributed/
      pipeline_parallel.py``), 4 x 4096 in ``PP_MICRO`` microbatches,
      each rank holding its stage's parameters alone: the last hidden
      state against one rank's, as b's (``SPLIT_OF_OWN``);
   d. a data-parallel step of xlstm-350m (float32, 4 x 128, two rows a
      rank) under ``make_rules("train", dp_only=True)``: the loss within
      ``DP_LOSS_RTOL`` and each all-reduced gradient within 8d's kind of
      bound of one rank's; 12 mLSTM launches a rank;
   e. d's model, each rank's gradient reduced by ``compressed_psum_pod``
      over a (pod 2) mesh for two steps: within ``COMPRESS_ATOL_OF_MAX``
      of the plain mean, the error state after step 1 bit for bit;
   f. two DP steps committed to a store on disk, restored here onto a
      one-card mesh at the committed step 2 and trained to step 4: the
      losses within ``DP_LOSS_RTOL`` of the same commit restored without
      a mesh, and against an uninterrupted one-rank run within the larger
      of that and twice the run's own spread under ``TRAIN_PERTURB``;
   g. granite-moe-3b's 2 x 4096 prefill at published width and depth
      under ``make_rules("prefill")`` on a (data 1, model 2) mesh: 20 of
      its 40 experts a rank (expert parallelism) and 12 of its 24 heads,
      drawn and resharded as b's, its parameters' bytes and blocks held
      as b's; 32 flash launches a rank, all ``flash_wgmma``; the operand
      bytes its collectives hand gloo; the last logits against one
      rank's, as b's (``SPLIT_OF_OWN``); layer 0's routing against one
      rank's: the split's own input routed by one rank equal to the
      split's except at float32 ties (``ROUTE_F32_TIE``), and one rank's
      model (whose attention rounds otherwise) differing only at tokens
      near a tie of the probabilities, each count printed; and layer
      0's MoE alone on the split's own layer-0 input with the split's
      routing decisions, under the rules, against one rank's layer with
      the same decisions: each rank's expert products bit for bit, the
      layer within ``MOE_COMBINE_ROUNDINGS`` float32 roundings (the
      logits' ``SPLIT_OF_OWN`` alone cannot catch a wrong split at
      granite's random weights). Run alone with ``--only 11g`` (after
      the build; no result line);
12. (after 9, before 10) bfloat16 keys and the paper's entry points:
   a. ``repro_torch/examples/bf16_keys.py``'s three nodes over phase 4's
      ``lineitem`` (its numeric columns; one discount lane in 1,000 set
      to -0.0, one in 997 to NaN) and an 11-row ``discount_band``, in
      one ``Client.run`` on a branch, merged as one commit, on the
      default backend: a GROUP BY on the bfloat16 (discount, tax) keys
      (COUNT, SUM, MIN, MAX), the inner join read through Q1's ship-date
      filter with the filter fused into the masked probe, and the left
      join. ``torch_auto`` must route the group-by to ``torch`` and
      both joins to ``partitioned``; all four lakehouse kernels must
      launch on that run (the ``kernels`` line's ``bf16_keys`` path);
      each table must equal the same run on ``vectorized`` bit for bit
      (values, NULL masks, key bits, row order); the -0.0 lanes must
      group and join with +0.0, and each NaN lane be its own group,
      join nothing and keep NULL bands in the left join. Then the two
      joins on ``partitioned`` and the group-by on ``torch`` as direct
      calls on the card, each against ``vectorized``; every wall time
      printed;
   b. each of the nine ``repro_torch.examples`` entry points
      (``ENTRY_POINTS``) through its ``main(device="cuda")``, each
      asserting what its root ``examples/*.py`` asserts; their printed
      lines go to ``--log-dir``. Run alone with ``--only 12`` (after the
      build and the data; no result line);
13. (after 10, before 11) decode attention over a ring KV cache: the
    three kernels of ``kernels/decode_attention`` against their plain
    version (``ref.py``, the decode core they replace) at the phi4-mini
    decode cell's shape (96 sessions, 8 kv heads of 3 query heads, hd
    128, a 4096-slot ring, 2048 and 4096 live slots), at granite's hd 64
    and at recurrentgemma's hd 256 with a local window of 2048 in a
    4096-slot ring: the error within the test's first bound
    (``tests/test_decode_attention_kernel.py``) and below a control's
    (the plain version without the bfloat16 rounding of p), times of the
    wrapper, the kernels alone and the plain version, the kernels'
    device time, the launches, and the bound (live K and V, the scores
    written, the output, at the card's memory rate). Run alone with
    ``--only 13`` (after the build; no result line).

The last two lines of standard output are one JSON object of the
kernels' numbers, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N_ROWS = 6_001_215              # lineitem rows at TPC-H SF1
Q18_GROUPS = 1_500_000          # orders at SF1: Q18's group count
Q9_GROUPS = 175                 # TPC-H Q9's (nation, year) groups: the
                                # integer SUM's shared-bin shape
# the H100's memory rate and peak rates (bf16 on the tensor cores,
# float32 on the FMA units: the flash kernel's float32 path), from
# repro_torch/roofline/hw.py, their one source; main() reads them there
HBM_BYTES_PER_S = None
PEAK_FLOPS = None
# Float SUM tolerance per segment, as a multiple of sum(|v|) over the
# segment's valid lanes. Kernel and plain version both add in the value
# dtype, in different orders (the plain version with atomics on the
# card). For zero-mean inputs like these, the rounding error of either
# order is a random walk of eps-sized steps on the partial sums, of the
# order of eps*sum(|v|); the factors leave ~100x (float32) and ~10^4x
# (float64) margin over that.
SUM_RTOL = {"float32": 1e-5, "float64": 1e-12}
REPLACES = {
    "masked_segment_sum": (
        "src/repro/kernels/segment_sum/kernel.py:59"),
    "masked_segment_reduce": (
        "src/repro/kernels/segment_sum/kernel.py:146"),
    "hash_probe": "src/repro/kernels/hash_join/kernel.py:94",
    "masked_hash_probe": "src/repro/kernels/hash_join/kernel.py:146",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:86",
    "rglru_scan": "src/repro/kernels/rglru/kernel.py:52",
    "mlstm_chunkwise": "src/repro/kernels/mlstm/kernel.py:83",
    "decode_attention": ("none: repro's decode attention is plain jnp "
                         "(src/repro/models/layers.py attention_decode)"),
}
SOURCES = {
    "masked_segment_sum":
        "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
    "masked_segment_reduce":
        "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
    "hash_probe": "src/repro_torch/kernels/hash_join/csrc/hash_probe.cu",
    "masked_hash_probe":
        "src/repro_torch/kernels/hash_join/csrc/hash_probe.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "rglru_scan": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
    "mlstm_chunkwise":
        "src/repro_torch/kernels/mlstm/csrc/mlstm_chunkwise.cu",
    "decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
}
Q18_JOIN_LANES = 1_500_000      # Q18's outer join probes one lane per order
ARCH = "recurrentgemma_9b"
PREFILL_BATCH, PREFILL_LEN = 4, 4096
LONG_PROMPT = 2304              # > local_window: the decode ring wraps
# Prefill against teacher-forced decode, float32 activations: the decode
# reads K/V from a bfloat16 cache (kv_dtype, as in repro) where the
# prefill's flash kernel reads them in float32, so attention outputs move
# by up to a bfloat16 step (2^-8 relative) and the logits with them.
# Held as max|prefill - decode| / max|decode|. The logits read 5.7e-4 on
# the H100 and are held at 5e-3; the K/V, which carry that step through
# every earlier layer, read 3.5e-3 and are held at 2e-2.
PREFILL_DECODE_LOGITS_RTOL = 5e-3
PREFILL_DECODE_KV_RTOL = 2e-2
# kernel against plain version, as torch.allclose's (rtol, atol): both
# compute in float32 and round once to the output dtype. float32: sums of
# up to 4096 products in another order. bfloat16: the two float32 results
# may straddle a rounding boundary, so they may differ by one bfloat16
# step, at most 2^-7 of the value; the atol covers the float32 order on
# outputs near zero.
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -7, 1e-5)}
XLSTM = "xlstm_350m"
XLSTM_BATCH, XLSTM_LEN = 4, 2048   # the xLSTM paper's training context
XLSTM_LONG_PROMPT = 1024           # four of repro's 256-token chunks
XLSTM_PREFILL = f"xlstm_prefill_{XLSTM_BATCH}x{XLSTM_LEN}"
MLSTM_STATE_CHUNK = 64   # the CUDA kernel's chunk: one chunk skips the
                         # state launch
# The mLSTM kernel (chunkwise form, float32) against its plain version
# (the sequential recurrence, float32), as torch.allclose's (rtol, atol):
# repro's own tolerance for the two forms (tests/test_kernels.py). Inputs
# in bf16 are cast to float32 on entry on both sides.
MLSTM_TOL = (2e-4, 2e-4)
# ... and max|kernel - plain| / max|plain|. A typical |h| is ~5e-3 at the
# main case's draw, so MLSTM_TOL alone would pass products rounded to
# TF32 or bf16, which change the results; this gate must not, and the
# main case shows it on a control (mlstm_rounded).
MLSTM_REL = 1e-5
# xlstm prefill (the mLSTM kernel) against teacher-forced decode (the
# plain chunk on one token), float32 activations, both float32 all
# through: max|prefill - decode| / max|decode| of the last logits.
XLSTM_PREFILL_DECODE_RTOL = 1e-3
# Phase 8, training. Each kernel's autograd.Function (the kernel forward,
# a plain backward) against autograd of the plain version, on the same
# card tensors, as max|function - plain| / max|plain| per input's
# gradient, by the gradient's dtype. bfloat16: both sides compute the
# gradient in float32 and round it once to the input's dtype, so they may
# differ by a bfloat16 step (2^-8 of the value, at most 3.9e-3 of the max)
# plus their float32 differences: flash's backward takes the kernel's
# bfloat16 output for the softmax's row sums where the plain version's
# autograd has its float32 output (2^-9 relative). float32: the mLSTM's
# two algebras (chunk-parallel recompute, sequential oracle) differ in
# summation order as their forwards do (5.5e-6 of max|h|, PERF.md), over
# sums of S terms; the RG-LRU's Function recomputes with the very
# operations of the plain version, so it may differ only by the order in
# which autograd adds a step's two contributions.
GRAD_REL = {"bfloat16": 2e-2, "float32": 1e-4}
GRAD_MLSTM = dict(BH=16, S=512, hd=256, dtype="bfloat16", gates="paper")
GRAD_FLASH = [dict(B=1, H=16, K=1, S=1024, hd=256, window=2048),
              dict(B=1, H=24, K=8, S=1024, hd=128, window=None)]
GRAD_RGLRU = dict(B=4, S=1024, W=4096)
# 8c: xlstm-350m at full width, B x S tokens a step (the mLSTM at B*H =
# 16, S = 512), TRAIN_STEPS steps with a checkpoint every TRAIN_CKPT
# steps, and a second run killed at TRAIN_KILL_AT
TRAIN_BATCH, TRAIN_LEN = 4, 512
# (4 steps, not 6, to make room for phase 11 in the time limit: run B
# still resumes at the step-2 commit after the kill at 3)
TRAIN_STEPS, TRAIN_CKPT, TRAIN_KILL_AT = 4, 2, 3
TRAIN_PATH = f"xlstm_train_{TRAIN_BATCH}x{TRAIN_LEN}_{TRAIN_STEPS}_steps"
TRAIN_RESUME_TOL = 1e-4     # |loss_A - loss_B|, repro's example's check
# the device profile of one step is taken at TRAIN_PROFILE_LEN tokens a
# sequence: at TRAIN_LEN a step issues ~467,000 device ops, whose trace
# takes ~97 s to read (NVIDIA H100 80GB HBM3, 700.00 W)
TRAIN_PROFILE_LEN = 128
# 8d: one step through the kernel against the same step through the
# plain chunk form of repro's model (chunk 256), float32 activations over
# the run's initial weights (drawn from --seed): the two mLSTM forms agree
# to ~1e-5 of max|h| per layer (7a), and the step's loss is a mean over
# 2048 tokens, held at 1e-5 of itself. The gradients, each held as
# max|kernel - plain| / max|plain|: the loss's barrier rounds the
# cotangent entering the model to bfloat16 (as repro's does), so an
# element whose two float32 cotangents straddle a rounding boundary moves
# by a bfloat16 step, 2^-8 = 3.9e-3 of itself, and carries that through
# 24 layers back: TRAIN_GRAD_RTOL. But at this depth and length float32
# does not pin the gradient that closely: a relative perturbation of
# TRAIN_PERTURB of every weight moves the gradients by 5.5-18% at the
# initial weights and by 17.5-30% after 6 steps at lr 3e-3, where the
# two plain forms (chunk and two-pass) differ from each other by 10-24%
# (examples/grad_spread.py; NVIDIA H100 80GB HBM3, 700.00 W; the
# gradient norm is 151 at the initial weights, clipped to 1). So the
# phase measures that spread, the gradients of the kernel path at the
# perturbed weights against its own, and holds each gradient at the
# larger of TRAIN_GRAD_RTOL and twice the spread: a difference below
# that cannot be told from float32 rounding, and a wrong backward (a
# gate's gradient lost, say) is off by ~100%.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-2
TRAIN_PERTURB = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def expect(cond, *what) -> None:
    """A check of this run; raises (and so fails the script) when false."""
    if not cond:
        raise AssertionError(" ".join(map(str, what)))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_cols(fn, name: str, launches: int) -> dict:
    """``device_ms``, the device time per call of ``fn`` in the kernels
    of ``name``'s source, by name, from torch.profiler over 5 calls, and
    what goes with it (``obs.device_time.device_ms``). ``launches`` is
    the number of the source's kernels one call launches: a traced
    window that shows another count is traced again, and the row fails
    when none shows it, as when the profiler shows no device time."""
    from repro_torch.obs.device_time import device_ms
    cols = device_ms(fn, os.path.join(ROOT, SOURCES[name]),
                     launches=launches)
    expect(cols["device_launches"] == launches, name, "device launches",
           cols, launches)
    return cols


def segment_launches(op: str, dtype) -> int:
    """The kernels of ``segment_sum.cu`` that one alone call launches: an
    integer SUM its atomic kernel, and a truncation to values narrower
    than 4 bytes; a float SUM's reduction three (init, tiles, carries);
    MIN/MAX the atomic kernel and the finish."""
    from repro_torch.kernels.segment_sum.kernel import INT_DTYPES
    if op != "sum":
        return 2
    if dtype in INT_DTYPES:
        return 1 if dtype.itemsize >= 4 else 2
    return 3


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_inputs(torch, dtype, num_segments: int, kind: str, g):
    dev = DEVICE
    n = N_ROWS
    used = num_segments - 1 if num_segments <= 8 else num_segments
    ids = torch.randint(0, used, (n,), generator=g, device=dev,
                        dtype=torch.int32)   # small S: the last is empty
    r = torch.rand(n, generator=g, device=dev)
    ids[r < 5e-4] = -1                       # out of range: contribute
    ids[r > 1 - 5e-4] = num_segments         # nothing
    if kind == "runs":          # a group's rows together, as Q18's orders
        ids = torch.sort(ids).values         # lie in lineitem
    valid = torch.rand(n, generator=g, device=dev) >= 0.1
    if dtype.is_floating_point:
        if kind == "zeros":                  # every tie is a signed zero
            v = torch.where(torch.rand(n, generator=g, device=dev) < 0.5,
                            -0.0, 0.0).to(dtype)
        else:
            v = (torch.randn(n, generator=g, device=dev, dtype=torch.float64)
                 * 100).to(dtype)
            r = torch.rand(n, generator=g, device=dev)
            v[r < 0.02] = 0.0
            v[(r >= 0.02) & (r < 0.04)] = -0.0
            if kind == "nan":
                v[r > 1 - 1e-5] = float("nan")
    else:
        info = torch.iinfo(dtype)
        v = torch.randint(info.min, info.max, (n,), generator=g, device=dev,
                          dtype=dtype)
    return v, ids, valid


def bits(torch, t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def check_config(torch, kernel, ops, ref, op, dtype, num_segments, kind,
                 g):
    """One (op, dtype, S) case on generated inputs (``check_case``)."""
    log(f"kernel check: {op} {str(dtype).split('.')[1]} S={num_segments} "
        f"{kind}")
    v, ids, valid = make_inputs(torch, dtype, num_segments, kind, g)
    return check_case(torch, kernel, ops, ref, op, v, ids, valid,
                      num_segments, kind)


def parity(torch, ref, op, v, ids, valid, num_segments, got, got_n,
           label: str) -> float:
    """A wrapper's output against its plain version on the same inputs:
    counts, integers and MIN/MAX bit for bit, a float SUM within
    ``SUM_RTOL`` of its segment's mass. Returns the float SUM's largest
    error (0 otherwise)."""
    dtype = v.dtype
    if op == "sum":
        want, want_n = ref.masked_segment_sum_ref(v, ids, valid,
                                                  num_segments)
    else:
        want, want_n = ref.masked_segment_reduce_ref(v, ids, valid,
                                                     num_segments, op)
    expect(torch.equal(got_n, want_n), label, "counts")
    expect(got.dtype == dtype and got.shape == (num_segments,), label,
           "output", got.dtype, got.shape)
    if op == "sum" and dtype.is_floating_point:
        mass, _ = ref.masked_segment_sum_ref(v.abs(), ids, valid,
                                             num_segments)
        diff = (got.double() - want.double()).abs()
        tol = SUM_RTOL[str(dtype).split(".")[1]] * mass.double()
        bad = int((diff > tol).sum())
        expect(bad == 0, label, f"{bad} sums off")
        return float(diff.max()) if len(diff) else 0.0
    expect(torch.equal(bits(torch, got), bits(torch, want)), label,
           "values differ")
    return 0.0


def segment_bound_ms(n: int, num_segments: int, item: int) -> float:
    """Each input read once (values, int32 ids, bool valid), each output
    written once (values, int32 counts), at the card's memory rate."""
    nbytes = n * (item + 4 + 1) + num_segments * (item + 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_case(torch, kernel, ops, ref, op, v, ids, valid, num_segments,
               kind: str) -> dict:
    """One case on the card: parity with the plain version,
    repeatability, and times."""
    from repro_torch.kernels.segment_sum.kernel import INT_DTYPES
    dtype = v.dtype
    label = f"{op} {dtype} S={num_segments} {kind}"
    if op == "sum":
        call = lambda: ops.masked_segment_sum(v, ids, valid, num_segments)
        plain = lambda: ref.masked_segment_sum_ref(v, ids, valid,
                                                   num_segments)
    else:
        call = lambda: ops.masked_segment_reduce(v, ids, valid,
                                                 num_segments, op=op)
        plain = lambda: ref.masked_segment_reduce_ref(v, ids, valid,
                                                      num_segments, op)
    got, got_n = call()
    again, _ = call()
    torch.cuda.synchronize()
    expect(torch.equal(bits(torch, got), bits(torch, again)),
           label, "not bitwise repeatable")
    err = parity(torch, ref, op, v, ids, valid, num_segments, got, got_n,
                 label)

    # times: the wrapper, the kernel alone (a float SUM's two steps
    # apart: the run-order partition, then the reduction kernel on its
    # output; integer SUMs and MIN/MAX have no partition), the plain
    # version, and one PyTorch library call on inputs prepared for it
    # (ids in range, masked lanes at the identity)
    partition = None
    if op == "sum" and dtype not in INT_DTYPES:
        partition = lambda: kernel.run_order(v, ids, valid, num_segments)
        ordered = partition()
    inside = (ids >= 0) & (ids < num_segments)
    safe = torch.where(inside, ids, 0).long()
    if op == "sum":
        alone = (lambda: kernel.segment_sum_atomic(v, ids, valid,
                                                   num_segments)) \
            if partition is None else \
            (lambda: kernel.segment_sum(*ordered, num_segments))
        vm = torch.where(valid & inside, v,
                         torch.zeros((), dtype=dtype, device=DEVICE))
        lib = lambda: torch.zeros(num_segments, dtype=dtype,
                                  device=DEVICE).index_add_(0, safe, vm)
    else:
        alone = lambda: kernel.segment_reduce(v, ids, valid, num_segments,
                                              op)
        ident = ref.reduce_identity(ref.numpy_dtype(dtype), op).item()
        vm = torch.where(valid & inside, v,
                         torch.full((), ident, dtype=dtype, device=DEVICE))
        red = "amin" if op == "min" else "amax"
        lib = lambda: torch.full((num_segments,), ident, dtype=dtype,
                                 device=DEVICE).scatter_reduce_(
            0, safe, vm, reduce=red)
    if dtype.itemsize < 4:
        lib = None      # 1- and 2-byte atomics serialize on shared words
    n = v.numel()
    return {
        "op": op, "dtype": str(dtype).split(".")[1], "S": num_segments,
        "n": n, "kind": kind, "max_abs_err": err,
        "ms": cuda_ms(torch, call),
        **({} if partition is None
           else {"partition_ms": cuda_ms(torch, partition)}),
        "kernel_only_ms": cuda_ms(torch, alone),
        **device_cols(alone, "masked_segment_sum" if op == "sum"
                      else "masked_segment_reduce",
                      segment_launches(op, dtype)),
        "plain_ms": cuda_ms(torch, plain, reps=3),
        "library_ms": None if lib is None else cuda_ms(torch, lib, reps=3),
        "bound_ms": segment_bound_ms(n, num_segments, v.element_size()),
        "bound_by": "bytes",
    }


def phase_kernels(torch):
    from repro_torch.kernels.segment_sum import kernel, ops, ref
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    rows = []
    dtypes = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
              torch.float32, torch.float64)
    for num_segments in (4, Q18_GROUPS):
        for dtype in dtypes:
            ops_ = ("sum", "min", "max")
            if dtype in (torch.int16, torch.uint8):
                ops_ = ("sum",)         # every integer dtype's SUM
            for op in ops_:
                kinds = ["plain"]
                if dtype.is_floating_point and op != "sum":
                    kinds += ["nan", "zeros"]
                if (op, dtype, num_segments) == ("sum", torch.int64,
                                                 Q18_GROUPS):
                    kinds += ["runs"]
                for kind in kinds:
                    row = check_config(torch, kernel, ops, ref, op, dtype,
                                       num_segments, kind, g)
                    rows.append(row)
                    log("kernel " + json.dumps(row))
    rows.append(check_config(torch, kernel, ops, ref, "sum", torch.int64,
                             Q9_GROUPS, "plain", g))
    log("kernel " + json.dumps(rows[-1]))
    # MIN/MAX at the edges of the atomic kernels' shapes (registers to
    # S = 16, shared bins to 4096) and at Q9's 175 groups
    for num_segments in (16, 17, Q9_GROUPS, 4096):
        for dtype in (torch.int8, torch.int32, torch.int64, torch.float32,
                      torch.float64):
            kinds = ["plain"] + (["nan", "zeros"]
                                 if dtype.is_floating_point else [])
            for op in ("min", "max"):
                for kind in kinds:
                    rows.append(check_config(torch, kernel, ops, ref, op,
                                             dtype, num_segments, kind, g))
                    log("kernel " + json.dumps(rows[-1]))
    v, ids, valid = make_inputs(torch, torch.float64, Q18_GROUPS, "plain", g)
    profile_device(torch, "run-order partition, float64, S=1.5M, x5",
                   lambda: [kernel.run_order(v, ids, valid, Q18_GROUPS)
                            for _ in range(5)])
    return rows


def h2d_ms(torch, np) -> float:
    """Host->device copy of one slice column set (float64 values, int32
    ids, bool validity) from pageable memory, median of 5."""
    cols = [np.random.default_rng(0).random(N_ROWS),
            np.zeros(N_ROWS, np.int32), np.ones(N_ROWS, bool)]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in cols:
            torch.from_numpy(c).to(DEVICE)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[2]


# ---------------------------------------------------------------------------
# phase 3, continued: the probe kernels against their plain versions
# ---------------------------------------------------------------------------

def check_probe(torch, kernel, ops, ref, masked: bool, n: int, order: str,
                g):
    """One probe case: bit-for-bit parity, the lanes it must cover, and
    times."""
    from repro_torch.kernels.hash_join.inputs import (INT32_MAX,
                                                      PROBE_SLOTS,
                                                      probe_inputs)
    name = "masked_hash_probe" if masked else "hash_probe"
    log(f"kernel check: {name} n={n} T={PROBE_SLOTS} {order}")
    ts, tc, slots, mask = probe_inputs(n, order, g, device=DEVICE)
    if masked:
        call = lambda: ops.masked_hash_probe(ts, tc, slots, mask)
        alone = lambda: kernel.masked_hash_probe(ts, tc, slots, mask)
        plain = lambda: ref.masked_hash_probe_ref(ts, tc, slots, mask)
    else:
        call = lambda: ops.hash_probe(ts, tc, slots)
        alone = lambda: kernel.hash_probe(ts, tc, slots)
        plain = lambda: ref.hash_probe_ref(ts, tc, slots)
    (gs, gc), (ws, wc) = call(), plain()
    torch.cuda.synchronize()
    expect(torch.equal(gs, ws) and torch.equal(gc, wc), name, n, order,
           "differs from its plain version")
    inr = (slots >= 0) & (slots < PROBE_SLOTS)
    live = inr & mask if masked else inr
    expect(bool((gc[~live] == 0).all()) and bool((gs[~live] == 0).all()),
           name, "a dead lane (out of range or masked) is not (0, 0)")
    expect(bool((~inr).any()) and bool((slots == INT32_MAX).any())
           and bool((gc[live] == 0).any()) and bool((gc > 1).any()),
           name, "the inputs miss out-of-range, sentinel, empty-slot or "
           "duplicate lanes")
    err = float(max((gs - ws).abs().max(), (gc - wc).abs().max()))

    def library():     # two gathers at clamped slots plus a where
        ok = live
        idx = slots.clamp(0, PROBE_SLOTS - 1)
        return (torch.where(ok, ts.index_select(0, idx), 0),
                torch.where(ok, tc.index_select(0, idx), 0))

    # bytes this run needs: every lane's 8 output bytes, the slot of
    # every lane that reads one (all, or the kept ones), the mask, and
    # 8 table bytes per distinct slot the live lanes touch
    reads = int(mask.sum()) if masked else n
    touched = int(torch.unique(slots[live]).numel())
    nbytes = 8 * n + 4 * reads + (n if masked else 0) + 8 * touched
    row = {
        "op": name, "n": n, "T": PROBE_SLOTS, "order": order,
        "max_abs_err": err, "ms": cuda_ms(torch, call),
        "kernel_only_ms": cuda_ms(torch, alone),
        **device_cols(alone, name, 1),
        "plain_ms": cuda_ms(torch, plain, reps=3),
        "library_ms": cuda_ms(torch, library, reps=3),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bound_bytes": nbytes,
    }
    expect(row["device_ms"] <= row["library_ms"], name, n, order,
           "device_ms above the library call's time", row)
    return row


PROBE_EDGE_LANES = (1, 2, 3, 4, 5, 4001, 4002, 4003, 4004)


def probe_edges(torch, ops, ref) -> None:
    """On the card, bit for bit against the plain version: n = 0 lanes, a
    table of T = 0 slots, and the 16-byte body's edges: n of 1-5 and 4k +
    1 to 4k + 3, slots, mask and table as views at an element offset of
    1 (and the slots and mask both at 1 and at 3), and masks all false
    and all true."""
    from repro_torch.kernels.hash_join.inputs import INT32_MAX
    dev = DEVICE
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    table = torch.arange(8, dtype=torch.int32, device=dev)
    slots = torch.tensor([-1, 0, 7, 8, INT32_MAX], dtype=torch.int32,
                         device=dev)
    keep = torch.tensor([True, False, True, True, True], device=dev)
    cases = [
        ("n=0", table, table, empty, keep[:0]),
        ("T=0", empty, empty, slots, keep),
        ("T=8", table, table + 1, slots, keep),
    ]
    T = 3000
    ts = torch.randint(0, 10**6, (T + 1,), generator=g, device=dev,
                       dtype=torch.int32)
    tc = torch.randint(0, 4, (T + 1,), generator=g, device=dev,
                       dtype=torch.int32)
    for n in PROBE_EDGE_LANES:
        s = torch.randint(-50, T + 50, (n + 3,), generator=g, device=dev,
                          dtype=torch.int32)
        s[::7] = INT32_MAX
        m = torch.rand(n + 3, generator=g, device=dev) < 0.5
        cases += [(f"n={n}", ts[:T], tc[:T], s[:n], m[:n]),
                  (f"n={n} slots[1:]", ts[:T], tc[:T], s[1:n + 1], m[:n]),
                  (f"n={n} mask[1:]", ts[:T], tc[:T], s[:n], m[1:n + 1]),
                  (f"n={n} slots[1:] mask[1:]", ts[:T], tc[:T], s[1:n + 1],
                   m[1:n + 1]),
                  (f"n={n} slots[3:] mask[3:]", ts[:T], tc[:T], s[3:n + 3],
                   m[3:n + 3]),
                  (f"n={n} table[1:]", ts[1:], tc[1:], s[:n], m[:n]),
                  (f"n={n} mask all false", ts[:T], tc[:T], s[:n],
                   torch.zeros_like(m[:n])),
                  (f"n={n} mask all true", ts[:T], tc[:T], s[:n],
                   torch.ones_like(m[:n]))]
    for label, a, b, c, m in cases:
        for got, want in ((ops.hash_probe(a, b, c),
                           ref.hash_probe_ref(a, b, c)),
                          (ops.masked_hash_probe(a, b, c, m),
                           ref.masked_hash_probe_ref(a, b, c, m))):
            torch.cuda.synchronize()
            expect(all(torch.equal(x, y) for x, y in zip(got, want)),
                   "probe edge case", label, got, want)
    log(f"kernel check: {len(cases)} probe edge cases match (n=0, T=0, "
        f"T=8; n in {PROBE_EDGE_LANES}, misaligned views, masks all "
        f"false and all true)")


def phase_probe_kernels(torch, ptxas: dict):
    from repro_torch.kernels.hash_join import kernel, ops, ref
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    probe_edges(torch, ops, ref)
    rows = []
    for n, order in ((N_ROWS, "clustered"), (N_ROWS, "random"),
                     (Q18_JOIN_LANES, "clustered")):
        for masked in (False, True):
            row = {**check_probe(torch, kernel, ops, ref, masked, n, order,
                                 g),
                   **ptxas_of(ptxas, "hash_probe",
                              f"probe_kernelILb{int(masked)}E")}
            rows.append(row)
            log("kernel " + json.dumps(row))
    return rows


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

FLOAT_AGGS = {"sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
              "avg_price", "avg_disc"}


def run_pipeline(data, backend=None, *, cache=True, plan_=None):
    """The TPC-H pipeline through ``Client.run`` (``plan_``, or the plan
    of ``build_pipeline()``): published tables, runtime, wall seconds."""
    import torch
    from repro_torch.core.planner import plan
    from repro_torch.core.runner import Client
    from repro_torch.data.tables import Table
    from repro_torch.exec import use_backend
    from repro_torch.examples.tpch import build_pipeline, run_slice
    client = Client()
    for name, cols in data.items():
        client.write_source_table("main", name, Table(cols))
    pl = plan(build_pipeline()) if plan_ is None else plan_
    t0 = time.perf_counter()
    if backend is None:
        result = run_slice(client, pl, cache=cache)
    else:
        with use_backend(backend):
            result = run_slice(client, pl, cache=cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect(result.state.status == "committed", result.state)
    tables = {t: client.read_table("main", t) for t in sorted(result.tables)}
    return tables, pl._runtime, wall


def assert_same(np, got, want, label: str, floats=FLOAT_AGGS) -> None:
    expect(sorted(got) == sorted(want), label)
    for name in got:
        a, b = got[name], want[name]
        expect(a.column_names() == b.column_names(), label, name)
        expect(len(a) == len(b), label, name)
        for c in a.column_names():
            expect(np.array_equal(a.validity(c), b.validity(c)),
                   label, name, c)
            x, y = a.column(c), b.column(c)
            if c in floats:
                np.testing.assert_allclose(x, y, rtol=1e-9, atol=0,
                                           err_msg=f"{label} {name}.{c}")
            elif x.dtype == object:
                expect(x.tolist() == y.tolist(), label, name, c)
            else:
                expect(x.dtype == y.dtype, label, name, c)
                expect(x.tobytes() == y.tobytes(), label, name, c)


def wrappers():
    """The four kernel wrappers of the main path, by kernel name."""
    from repro_torch.kernels.hash_join import ops as hops
    from repro_torch.kernels.segment_sum import ops as sops
    return {"masked_segment_sum": sops.masked_segment_sum,
            "masked_segment_reduce": sops.masked_segment_reduce,
            "hash_probe": hops.hash_probe,
            "masked_hash_probe": hops.masked_hash_probe}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def phase_slice(torch, np, data, seed: int):
    from repro_torch import exec as exec_backends
    from repro_torch.examples.tpch import generate

    expect(exec_backends.active_backend().name == "torch_auto",
           "the default backend is not torch_auto")
    log(f"slice backend: {exec_backends.active_backend().cache_token()}")

    reset_launches()
    tables, runtime, wall = run_pipeline(data)
    launches = read_launches()
    log(f"slice launches: {json.dumps(launches)}")
    need = ("masked_segment_sum", "masked_segment_reduce", "hash_probe")
    expect(all(launches[k] > 0 for k in need),
           "a kernel of the path never launched", launches)
    log(f"slice torch_auto run: wall_s={wall:.3f}")
    for name, rec in sorted(runtime.items()):
        log(f"slice node {name}: wall_s={rec['wall_s']:.3f} "
            f"rows_out={rec['rows_out']} cache={rec['cache']}")

    host, _, host_wall = run_pipeline(data, "vectorized")
    assert_same(np, tables, host, "torch_auto vs vectorized")
    log(f"slice vectorized run: wall_s={host_wall:.3f}; tables match")

    again, _, again_wall = run_pipeline(data, cache=False)
    fp = {t: tables[t].fingerprint() for t in tables}
    fp2 = {t: again[t].fingerprint() for t in again}
    expect(fp == fp2, "rerun changed fingerprints", fp, fp2)
    log(f"slice cache=False rerun: wall_s={again_wall:.3f}; "
        f"fingerprints identical {json.dumps(fp)}")
    del host, again

    small = generate(0.01, seed)
    t_small, _, _ = run_pipeline(small)
    assert_same(np, t_small, run_pipeline(small, "vectorized")[0],
                "sf0.01 torch_auto vs vectorized")
    assert_same(np, t_small, run_pipeline(small, "reference")[0],
                "sf0.01 torch_auto vs reference")
    log("slice sf0.01: torch_auto matches vectorized and reference")
    for name, t in sorted(tables.items()):
        log(f"slice table {name}: rows={len(t)} fp={t.fingerprint()}")
    return launches, tables


# ---------------------------------------------------------------------------
# phase 5: the query path
# ---------------------------------------------------------------------------

QUERY = ("SELECT o_custkey, SUM(l_quantity) AS qty, "
         "SUM(l_extendedprice) AS revenue, COUNT(l_quantity) AS n_lines "
         "FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
         "{where}GROUP BY o_custkey")
QUERIES = {      # label -> (query, the probe kernel it must reach)
    "join": (QUERY.format(where=""), "hash_probe"),
    "join_where": (QUERY.format(where="WHERE l_discount >= 0.05 "),
                   "masked_hash_probe"),
}
QUERY_FLOATS = {"revenue"}


def sql_client(data):
    from repro_torch.core.runner import Client
    from repro_torch.data.tables import Table
    client = Client()
    for name, cols in data.items():
        client.write_source_table("main", name, Table(cols))
    return client


def run_query(client, query: str, backend=None, **kw):
    import torch
    from repro_torch.exec import use_backend
    t0 = time.perf_counter()
    if backend is None:
        result = client.sql(query, **kw)
    else:
        with use_backend(backend):
            result = client.sql(query, **kw)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def find_join(op):
    from repro_torch.core.logical import Join
    if isinstance(op, Join):
        return op
    for child in op.children():
        found = find_join(child)
        if found is not None:
            return found
    return None


def phase_queries(torch, np, data, seed: int):
    from repro_torch.examples.tpch import generate
    from repro_torch.exec.partitioned import PartitionedBackend

    client = sql_client(data)
    launches = {}
    for label, (query, probe) in QUERIES.items():
        reset_launches()
        result, wall = run_query(client, query)
        got = read_launches()
        launches[label] = got
        log(f"query {label}: launches {json.dumps(got)}")
        expect(got[probe] > 0, label, probe, "never launched", got)
        log(f"query {label} torch_auto: wall_s={wall:.3f} "
            f"rows={len(result.table)} executed={result.executed}")
        for name, rec in sorted(result.plan._runtime.items()):
            log(f"query {label} node {name}: wall_s={rec['wall_s']:.3f} "
                f"rows_out={rec['rows_out']}")
        explain = result.describe(analyze=True)
        for line in explain.splitlines():
            log(f"query {label} explain: {line}")
        join = find_join(result.plan.steps[-1].logical)
        log(f"query {label} join: {join.describe()}")
        if label == "join_where":
            expect("probe_fusion: fused" in explain, label,
                   "EXPLAIN shows no probe_fusion rewrite")
            expect(join.left_pred is not None and join.right_pred is None
                   and join.left.scan_tables() == {"lineitem"}, label,
                   "the WHERE is not fused into the lineitem probe side")
        want = {"q": result.table}
        host, host_wall = run_query(client, query, "vectorized",
                                    cache=False)
        assert_same(np, want, {"q": host.table},
                    f"{label} torch_auto vs vectorized", QUERY_FLOATS)
        raw, raw_wall = run_query(client, query, optimizer_passes=(),
                                  cache=False)
        assert_same(np, want, {"q": raw.table},
                    f"{label} optimized vs unoptimized", QUERY_FLOATS)
        again, again_wall = run_query(client, query, cache=False)
        expect(again.fingerprint() == result.fingerprint(), label,
               "cache=False rerun changed the fingerprint")
        log(f"query {label}: vectorized wall_s={host_wall:.3f}, "
            f"unoptimized wall_s={raw_wall:.3f}, cache=False rerun "
            f"wall_s={again_wall:.3f}; all match; fingerprint "
            f"{result.fingerprint()}")

    small = sql_client(generate(0.01, seed))
    for label, (query, _) in QUERIES.items():
        want = {"q": run_query(small, query, "reference")[0].table}
        for be in (None, PartitionedBackend(device=DEVICE)):
            got = run_query(small, query, be, cache=False)[0]
            assert_same(np, {"q": got.table}, want,
                        f"sf0.01 {label} {be or 'torch_auto'} vs reference",
                        QUERY_FLOATS)
    log("query sf0.01: torch_auto and partitioned match reference")
    return launches


# ---------------------------------------------------------------------------
# phase 5b: partial aggregation over a list of cards, the paper's example
# ---------------------------------------------------------------------------

# Q18's order_lines aggregate (examples/tpch.py): one int64 key, int64
# SUM and COUNT, float64 MIN and MAX
ORDER_LINES = ("l_orderkey", (("sum", "l_quantity", "sum_qty"),
                              ("count", "l_quantity", "n_lines"),
                              ("min", "l_extendedprice", "min_price"),
                              ("max", "l_extendedprice", "max_price")))
FOUR_CARDS = ["cuda:0"] * 4     # four partitions through the multi-card
                                # code, every one on the one card
PAPER_ROWS = 1_000_000          # the paper's example at a size that
                                # takes torch_auto's card row


def same_columns(np, got, want, label: str) -> None:
    """Two group-by results bit for bit (``assert_same``, no float
    tolerance)."""
    from repro_torch.data.tables import Table
    assert_same(np, {"q": Table._from_cols(got)},
                {"q": Table._from_cols(want)}, label, floats=())


@contextlib.contextmanager
def segment_calls(calls: list, part):
    """Records the inputs and outputs, on the card, of every segment
    kernel call made through the names that the module ``part`` imported
    (``exec/partitioned.py``'s ``_reduce`` and ``_combine``, or
    ``exec/torch_backend.py``'s group-by, from any thread), for
    ``check_calls``. Each call still goes through the wrapper, which
    counts its launch as before."""
    seg_sum, seg_reduce = part.masked_segment_sum, part.masked_segment_reduce

    def rec_sum(values, ids, valid, num_segments):
        out = seg_sum(values, ids, valid, num_segments)
        calls.append(("sum", values, ids, valid, num_segments, out))
        return out

    def rec_reduce(values, ids, valid, num_segments, *, op):
        out = seg_reduce(values, ids, valid, num_segments, op=op)
        calls.append((op, values, ids, valid, num_segments, out))
        return out

    part.masked_segment_sum = rec_sum
    part.masked_segment_reduce = rec_reduce
    try:
        yield calls
    finally:
        part.masked_segment_sum = seg_sum
        part.masked_segment_reduce = seg_reduce


def check_calls(torch, calls: list, label: str, heaviest: dict) -> None:
    """Every recorded call against its plain version on the same card
    tensors (``parity``); ``heaviest`` keeps, per kernel, the largest
    error and the call with the largest bound, for ``path_rows``."""
    from repro_torch.kernels.segment_sum import ref
    shapes = {}
    for op, v, ids, valid, num_segments, (got, got_n) in calls:
        name = ("masked_segment_sum" if op == "sum"
                else "masked_segment_reduce")
        what = (f"{label}: {op} {str(v.dtype).split('.')[1]} "
                f"n={v.numel()} S={num_segments}")
        err = parity(torch, ref, op, v, ids, valid, num_segments, got,
                     got_n, what)
        shapes[what] = shapes.get(what, 0) + 1
        bound = segment_bound_ms(v.numel(), num_segments, v.element_size())
        top = heaviest.setdefault(name, {"err": 0.0, "bound": -1.0})
        top["err"] = max(top["err"], err)
        if bound > top["bound"]:
            top.update(bound=bound, call=(op, v, ids, valid, num_segments),
                       kind=f"path {label}")
    calls.clear()
    expect(shapes, label, "no segment call was recorded")
    log(f"{label}: every segment call matches its plain version: "
        f"{json.dumps(shapes)}")


def path_rows(torch, heaviest: dict) -> dict:
    """Per kernel, its heaviest call of the partial path, checked and
    timed again as phase 3's rows are (``check_case``)."""
    from repro_torch.kernels.segment_sum import kernel, ops, ref
    out = {}
    for name, top in heaviest.items():
        row = check_case(torch, kernel, ops, ref, *top["call"], top["kind"])
        row["max_abs_err"] = max(row["max_abs_err"], top["err"])
        log("kernel " + json.dumps(row))
        out[name] = row
    return out


def partial_spans(rec) -> list:
    return [dict(s.attrs, s=s.t1 - s.t0) for s in rec.spans("kernel")
            if s.attrs.get("op") == "partitioned.partial_agg"]


def group_by_timed(torch, be, cols, reps: int = 2):
    """``reps`` calls of Q18's aggregate on ``be``: the first call's
    result, and each call's wall seconds (synchronized)."""
    key, specs = ORDER_LINES
    out, walls = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = be.group_by_agg(cols, [key], specs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        out = got if out is None else out
    return out, walls


def routed_plan(data):
    """The TPC-H pipeline, planned with the sources' row counts and
    optimized with the default passes (``partial_agg`` among them)."""
    from repro_torch.core.planner import plan
    from repro_torch.examples.tpch import build_pipeline
    from repro_torch.exec.stats import TableStats
    from repro_torch.optimizer import optimize
    stats = {t: TableStats(n_rows=len(next(iter(cols.values()))))
             for t, cols in data.items()}
    return optimize(plan(build_pipeline(), table_stats=stats))


def phase_partial(torch, np, data, slice_tables):
    """5b: (a) Q18's aggregate on ``partitioned`` over the card(s), (b)
    the same over four partitions, (c) the pipeline with ``partial_agg``
    routing it there, (d) the join queries over four partitions, (e) the
    paper's running example. Every segment kernel call of the partial
    path in (a)-(d) is held against its plain version on the same card
    tensors. Returns each path's launches, and per segment kernel the
    row of its heaviest call there (``path_rows``)."""
    from repro_torch import exec as exec_backends
    from repro_torch.configs.paper_pipeline import build_pipeline, seed_lake
    from repro_torch.core.planner import plan
    from repro_torch.core.runner import Client
    from repro_torch.exec import partitioned
    from repro_torch.exec.partitioned import PartitionedBackend
    from repro_torch.exec.torch_backend import TorchBackend
    from repro_torch.exec.vectorized import VectorizedBackend
    from repro_torch.obs import tracing

    launches, heaviest, calls = {}, {}, []
    key, specs = ORDER_LINES
    li = data["lineitem"]
    cols = {c: (li[c], None) for c in (key, "l_quantity", "l_extendedprice")}
    want, host_walls = group_by_timed(torch, VectorizedBackend(), cols)

    # (a) one card (every visible card: one on this machine)
    one = PartitionedBackend(device=DEVICE)
    reset_launches()
    with tracing() as rec, segment_calls(calls, partitioned):
        got, part_walls = group_by_timed(torch, one, cols, reps=1)
    launches["partial_1card"] = read_launches()
    check_calls(torch, calls, "partial a", heaviest)
    log(f"partial a: {one.cache_token()} launches "
        f"{json.dumps(launches['partial_1card'])} spans "
        f"{json.dumps(partial_spans(rec))}")
    expect(launches["partial_1card"]["masked_segment_sum"] > 0
           and launches["partial_1card"]["masked_segment_reduce"] > 0,
           "partial a: a segment kernel never launched")
    expect(len(partial_spans(rec)) == 1, "partial a: no partial_agg span")
    same_columns(np, got, want, "partial a: partitioned vs vectorized")
    again, walls = group_by_timed(torch, one, cols)
    same_columns(np, again, want, "partial a: second call")
    part_walls += walls
    _, torch_walls = group_by_timed(torch, TorchBackend(device=DEVICE), cols)
    log(f"partial a: rows={len(li[key])} groups={len(want[key][0])} "
        f"wall_s partitioned={part_walls} torch={torch_walls} "
        f"vectorized={host_walls}; bit for bit")
    profile_device(torch, "partial a partitioned",
                   lambda: one.group_by_agg(cols, [key], specs))

    # (b) four partitions through the multi-card code
    four = PartitionedBackend(devices=FOUR_CARDS)
    reset_launches()
    with tracing() as rec, segment_calls(calls, partitioned):
        got, walls = group_by_timed(torch, four, cols, reps=1)
    launches["partial_4"] = read_launches()
    check_calls(torch, calls, "partial b", heaviest)
    spans = partial_spans(rec)
    log(f"partial b: {four.cache_token()} launches "
        f"{json.dumps(launches['partial_4'])} spans {json.dumps(spans)}")
    expect(len(spans) == 1 and spans[0]["partitions"] == 4,
           "partial b: the partial path did not run on four partitions")
    same_columns(np, got, want, "partial b: 4 partitions vs vectorized")
    _, more = group_by_timed(torch, four, cols)
    log(f"partial b: wall_s {walls + more}; bit for bit")

    # (c) the routing: partial_agg sends order_lines to the registered
    # partitioned backend, four partitions
    exec_backends.register("partitioned",
                           lambda: PartitionedBackend(devices=FOUR_CARDS))
    try:
        pl = routed_plan(data)
        step = next(s for s in pl.steps if s.node.name == "order_lines")
        expect("strategy=partial" in step.logical.describe()
               and any("partial_agg" in m for m in step.provenance),
               "partial c: no partial_agg rewrite", step.provenance)
        log(f"partial c: order_lines provenance {list(step.provenance)}")
        reset_launches()
        with tracing() as rec, segment_calls(calls, partitioned):
            routed, _, wall = run_pipeline(data, plan_=pl)
        launches["partial_route"] = read_launches()
        check_calls(torch, calls, "partial c", heaviest)
        spans = partial_spans(rec)
        log(f"partial c: launches {json.dumps(launches['partial_route'])} "
            f"spans {json.dumps(spans)} wall_s={wall:.3f}")
        expect(any(sp["partitions"] == 4 for sp in spans),
               "partial c: order_lines did not run as partials")
        host, _, host_wall = run_pipeline(data, "vectorized")
        assert_same(np, routed, host, "partial c: routed vs vectorized")
        assert_same(np, routed, slice_tables,
                    "partial c: routed vs the unoptimized plan (phase 4)")
        again, _, again_wall = run_pipeline(data, plan_=routed_plan(data),
                                            cache=False)
        fp = {t: routed[t].fingerprint() for t in routed}
        expect(fp == {t: again[t].fingerprint() for t in again},
               "partial c: cache=False rerun changed fingerprints")
        log(f"partial c: vectorized wall_s={host_wall:.3f}, cache=False "
            f"rerun wall_s={again_wall:.3f}; tables match; fingerprints "
            f"identical")
        del host, again, routed
    finally:
        exec_backends.register("partitioned",
                               exec_backends._partitioned_factory)
    expect(exec_backends.get_backend("partitioned").cards
           == torch.cuda.device_count(), "partial c: registry not restored")

    # (d) the join queries over four partitions
    client = sql_client(data)
    for label, (query, probe) in QUERIES.items():
        reset_launches()
        with tracing() as rec, segment_calls(calls, partitioned):
            result, wall = run_query(client, query, four, cache=False)
        path = f"partial_{label}"
        launches[path] = read_launches()
        check_calls(torch, calls, f"partial d {label}", heaviest)
        spans = partial_spans(rec)
        expect(launches[path][probe] > 0, path, probe, "never launched")
        expect(len(spans) == 1 and spans[0]["partitions"] == 4, path,
               "the GROUP BY did not run as partials")
        host, host_wall = run_query(client, query, "vectorized",
                                    cache=False)
        assert_same(np, {"q": result.table}, {"q": host.table},
                    f"{path} vs vectorized", QUERY_FLOATS)
        log(f"partial d {label}: launches {json.dumps(launches[path])} "
            f"wall_s={wall:.3f} vectorized wall_s={host_wall:.3f}; match")

    # (e) the paper's running example on the default backend
    for rows in (5, PAPER_ROWS):
        fps = []
        for backend in (None, "vectorized"):
            c = Client()
            seed_lake(c, rows=rows)
            pl = plan(build_pipeline(with_friend=True))
            reset_launches()
            t0 = time.perf_counter()
            if backend is None:
                res = c.run(pl, "main")
                launches[f"paper_{rows}"] = read_launches()
            else:
                with exec_backends.use_backend(backend):
                    res = c.run(pl, "main")
            wall = time.perf_counter() - t0
            expect(res.state.status == "committed", "paper", rows, backend,
                   res.state)
            names = [s.node.name for s in pl.steps]
            expect(names[:3] == ["parent_table", "child_table",
                                 "grand_child"]
                   and "family_friend" in names, "paper steps", names)
            expect(not c.read_table("main", "family_friend")
                   .has_nulls("col5"), "paper: NULL in family_friend.col5")
            fps.append({t: c.read_table("main", t).fingerprint()
                        for t in sorted(res.tables)})
            log(f"partial e: paper pipeline rows={rows} "
                f"{backend or 'torch_auto'} wall_s={wall:.3f} committed")
        expect(fps[0] == fps[1], "paper: torch_auto vs vectorized", fps)
        log(f"partial e: rows={rows} fingerprints match vectorized "
            f"{json.dumps(fps[0])}; launches "
            f"{json.dumps(launches[f'paper_{rows}'])}")
    expect(launches[f"paper_{PAPER_ROWS}"]["masked_segment_sum"] > 0,
           "paper: the parent's GROUP BY never reached the card")
    return launches, path_rows(torch, heaviest)


# ---------------------------------------------------------------------------
# phase 6: the model stack (recurrentgemma-9b)
# ---------------------------------------------------------------------------

def model_wrappers():
    """The model path's four kernel wrappers, by kernel name."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mlstm import ops as mops
    from repro_torch.kernels.rglru import ops as rops
    return {"flash_attention": fops.flash_attention,
            "rglru_scan": rops.rglru_scan,
            "mlstm_chunkwise": mops.mlstm,
            "decode_attention": dops.decode_attention}


def attn_layers(cfg) -> int:
    """The attention blocks of ``cfg``: one decode attention call each a
    decode step."""
    return sum(cfg.block_pattern[i % cfg.pattern_len] in ("attn", "local")
               for i in range(cfg.num_layers))


def reset_model_launches() -> None:
    for fn in model_wrappers().values():
        fn.launches = 0
    by_kernel = model_wrappers()["flash_attention"].launches_by_kernel
    for name in by_kernel:
        by_kernel[name] = 0


def read_model_launches() -> dict:
    """Launches by wrapper, and ``flash_wgmma``: how many of the flash
    launches ran the wgmma kernel."""
    wrap = model_wrappers()
    return {**{name: fn.launches for name, fn in wrap.items()},
            "flash_wgmma":
                wrap["flash_attention"].launches_by_kernel["wgmma"]}


def rel_err(torch, got, want) -> float:
    """max|got - want| / max|want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def flash_one_bf16_p(torch, q, k, v, *, causal: bool, window, scale=None):
    """The control for ``FLASH_TOL``: the plain version of
    ``kernels/flash_attention/ref.py`` with P = exp(s - max) rounded to
    bf16 before P V; the row sums stay float32. One query head at a time,
    so 32k-token scores fit."""
    from repro_torch.kernels.flash_attention import ref
    H, K, S, hd = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    mask = ref.band_mask(S, k.shape[2], causal=causal, window=window,
                         device=q.device)
    out = q.new_empty(q.shape[:3] + v.shape[3:])
    for b in range(q.shape[0]):
        for h in range(H):
            s = q[b, h].float() @ k[b, h // (H // K)].float().T * scale
            s = torch.where(mask, s, ref.NEG_INF)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            l = p.sum(-1, keepdim=True)
            o = p.bfloat16().float() @ v[b, h // (H // K)].float()
            out[b, h] = (o / l.clamp_min(1e-30)).to(q.dtype)
            del s, p
    return out


# above this many bytes of float32 scores the plain version takes one
# query head at a time
PLAIN_SCORE_BYTES = 16 << 30


def flash_plain(torch, q, k, v, **kw):
    """``ref.flash_attention_ref``; one query head at a time where the
    whole (B, H, Sq, Skv) float32 score matrix would pass
    ``PLAIN_SCORE_BYTES``."""
    from repro_torch.kernels.flash_attention import ref
    B, H, S = q.shape[:3]
    if B * H * S * k.shape[2] * 4 <= PLAIN_SCORE_BYTES:
        return ref.flash_attention_ref(q, k, v, **kw)
    g = H // k.shape[1]
    return torch.cat([ref.flash_attention_ref(
        q[:, h:h + 1], k[:, h // g:h // g + 1], v[:, h // g:h // g + 1],
        **kw) for h in range(H)], dim=1)


def flash_case(torch, case: dict, g, *, control: bool = False):
    """One flash attention case: the kernel against its plain version,
    and times of the wrapper, the kernel, the plain version and SDPA;
    with ``control``, the plain version with one bf16 P must fail
    ``FLASH_TOL`` on the same inputs."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    import torch.nn.functional as F
    B, H, K, S, hd = (case[k] for k in ("B", "H", "K", "S", "hd"))
    skv = case.get("Skv", S)        # cross attention: keys of the encoder
    hd_v = case.get("hd_v", hd)     # latent attention: v narrower than q
    scale = case.get("scale")       # None: 1/sqrt(hd)
    causal, window, dt = case["causal"], case["window"], case["dtype"]
    dtype = getattr(torch, dt)
    log(f"kernel check: flash_attention {json.dumps(case)}")
    q = torch.randn(B, H, S, hd, generator=g, device=DEVICE, dtype=dtype)
    k = torch.randn(B, K, skv, hd, generator=g, device=DEVICE, dtype=dtype)
    v = torch.randn(B, K, skv, hd_v, generator=g, device=DEVICE, dtype=dtype)
    mkw = dict(causal=causal, window=window, scale=scale)
    call = lambda: ops.flash_attention(q, k, v, **mkw)
    alone = lambda: kernel.flash_attention(q, k, v, **mkw)[0]
    name = kernel.kernel_for(dtype, hd, hd_v)
    before = dict(ops.flash_attention.launches_by_kernel)
    plain = lambda: flash_plain(torch, q, k, v, **mkw)
    mask = ref.band_mask(S, skv, causal=causal, window=window,
                         device=DEVICE)
    if B * H * S * skv * q.element_size() > PLAIN_SCORE_BYTES:
        # SDPA's masked form would hold the whole score matrix
        expect(causal and window is None and S == skv,
               "SDPA needs a mask at this size", case)
        library = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=K != H)
    else:
        library = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=K != H)
    got, want, lib = call(), plain(), library()
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in
           ops.flash_attention.launches_by_kernel.items()}
    expect(ran == {k: int(k == name) for k in ran}, "flash launches", ran,
           name)
    rtol, atol = FLASH_TOL[dt]
    err = float((got.float() - want.float()).abs().max())
    expect(got.dtype == dtype and got.shape == (B, H, S, hd_v),
           "flash output", got.dtype, got.shape)
    expect(bool(torch.isfinite(got).all()), "flash output not finite")
    expect(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
           "flash kernel differs from its plain version", case, err)
    pairs = int(mask.sum())             # the (query, key) pairs this run needs
    # q k^T and P v: 2·(hd + hd_v) a live pair (4·hd at one head dim)
    flops = 2 * (hd + hd_v) * pairs * B * H
    # q in and out, k and v: (B·H·S + B·K·Skv)·(hd + hd_v) elements
    nbytes = (B * H * S + B * K * skv) * (hd + hd_v) * q.element_size()
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    one_p = None
    if control:
        # P rounded to one bf16 part before P V, as a kernel that fed it
        # to the tensor cores so would read it: it must fail the gate
        # that the kernel's split form (P = hi + lo) passes
        one = flash_one_bf16_p(torch, q, k, v, **mkw)
        one_p = {"max_abs_err": float((one.float() - want.float())
                                      .abs().max()),
                 "passes": bool(torch.allclose(one.float(), want.float(),
                                               rtol=rtol, atol=atol))}
        log(f"flash control, one bf16 P: {json.dumps(one_p)}")
        expect(not one_p["passes"], "the one-bf16-P control passes "
               "FLASH_TOL: the gate cannot tell the two forms apart", case)
        del one
    del got, want
    return {
        "op": "flash_attention", **case, "kernel": name,
        "launches_by_kernel": ran,
        "control_one_bf16_p": one_p, "max_abs_err": err,
        "library_err": float((lib.float() - plain().float()).abs().max()),
        "ms": cuda_ms(torch, call, reps=5),
        "kernel_only_ms": cuda_ms(torch, alone, reps=5),
        **device_cols(alone, "flash_attention", 1),
        "plain_ms": cuda_ms(torch, plain, reps=2),
        "library_ms": cuda_ms(torch, library, reps=5),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def rglru_case(torch, case: dict, g):
    """One RG-LRU scan case: the kernel bit for bit against its plain
    version, and times."""
    from repro_torch.kernels.rglru import kernel, ops, ref
    B, S, W, with_h0 = case["B"], case["S"], case["W"], case["h0"]
    log(f"kernel check: rglru_scan {json.dumps(case)}")
    a = torch.sigmoid(torch.randn(B, S, W, generator=g, device=DEVICE))
    b = torch.randn(B, S, W, generator=g, device=DEVICE)
    h0 = torch.randn(B, W, generator=g, device=DEVICE) if with_h0 else None
    call = lambda: ops.rglru_scan(a, b, h0)
    alone = lambda: kernel.rglru_scan(a, b)
    plain = lambda: ref.rglru_scan_ref(a, b, h0)
    got, want = call(), plain()
    torch.cuda.synchronize()
    expect(torch.equal(got, want), "RG-LRU kernel differs from its plain "
           "version", case, float((got - want).abs().max()))
    nbytes = 3 * B * S * W * 4
    return {
        "op": "rglru_scan", **case, "max_abs_err": 0.0,
        "ms": cuda_ms(torch, call), "kernel_only_ms": cuda_ms(torch, alone),
        **device_cols(alone, "rglru_scan", 1),
        "plain_ms": cuda_ms(torch, plain, reps=2), "library_ms": None,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": nbytes,
    }


FLASH_MAIN = dict(B=PREFILL_BATCH, H=16, K=1, S=PREFILL_LEN, hd=256,
                  causal=True, window=2048, dtype="bfloat16")
FLASH_CASES = [
    FLASH_MAIN,                                    # every local block's call
    {**FLASH_MAIN, "window": None},                # causal, no window
    {**FLASH_MAIN, "causal": False, "window": None},
    {**FLASH_MAIN, "K": 8, "hd": 128},             # GQA
    {**FLASH_MAIN, "K": 4, "hd": 64},              # GQA, the smallest wgmma hd
    {**FLASH_MAIN, "S": 4000},                     # ragged S
    {**FLASH_MAIN, "dtype": "float32"},
]
RGLRU_MAIN = dict(B=PREFILL_BATCH, S=PREFILL_LEN, W=4096, h0=False)
RGLRU_CASES = [RGLRU_MAIN, {**RGLRU_MAIN, "S": 4093},
               {**RGLRU_MAIN, "h0": True}]


def ptxas_of(ptxas: dict, stem: str, tag: str) -> dict:
    """Registers and spill bytes of the kernel whose name holds ``tag``."""
    regs, spill = next(v for k, v in ptxas[stem].items() if tag in k)
    return {"registers": regs, "spill_bytes": spill}


def flash_tag(case: dict) -> str:
    """The mangled-name fragment of the instantiation a case runs:
    ``flash_wgmma_kernel<hd>``, ``flash_mla_kernel`` or
    ``flash_fwd_kernel<T, hd>``, as the dispatch table picks."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    hd = case["hd"]
    name = kernel.kernel_for(getattr(torch, case["dtype"]), hd,
                             case.get("hd_v"))
    if name == "mla":
        return "flash_mla_kernel"
    if name == "wgmma":
        return f"flash_wgmma_kernelILi{hd}EE"
    elem = "13__nv_bfloat16" if case["dtype"] == "bfloat16" else "f"
    return f"flash_fwd_kernelI{elem}Li{hd}E"


def phase_model_kernels(torch, ptxas: dict):
    g = torch.Generator(device=DEVICE)
    g.manual_seed(2)
    rows = []
    for case in FLASH_CASES:
        rows.append({**flash_case(torch, case, g,
                                  control=case == FLASH_MAIN),
                     **ptxas_of(ptxas, "flash_attention", flash_tag(case))})
        log("kernel " + json.dumps(rows[-1]))
    main = rows[0]
    expect(main["kernel"] == "wgmma" and main["spill_bytes"] == 0,
           "the main flash case", main["kernel"], main["spill_bytes"])
    for case in RGLRU_CASES:
        rows.append({**rglru_case(torch, case, g), **ptxas_of(
            ptxas, "rglru_scan", "rglru_scan_kernel")})
        log("kernel " + json.dumps(rows[-1]))
    return rows


def phase_launcher(torch, arch: str = ARCH) -> dict:
    """6b and 7b: ``repro_torch.launch.serve`` on the card, smoke
    config."""
    from repro_torch.launch import serve
    reset_model_launches()
    t0 = time.perf_counter()
    rc = serve.main(["--arch", arch, "--device", DEVICE])
    torch.cuda.synchronize()
    launches = read_model_launches()
    expect(rc == 0, "the launcher returned", rc)
    from repro_torch.configs import get_smoke_config
    attn = attn_layers(get_smoke_config(arch))
    expect(launches["flash_attention"] == 0, "launcher: decode launched "
           "flash", launches)
    expect(launches["decode_attention"] % max(attn, 1) == 0
           and (launches["decode_attention"] > 0) == (attn > 0),
           "launcher: decode attention launches", attn, launches)
    log(f"launcher {arch}: rc={rc} wall_s={time.perf_counter() - t0:.3f} "
        f"launches {json.dumps(launches)}")
    return launches


def full_model(torch, seed: int, arch: str = ARCH, layers: int | None = None):
    """The full config of ``arch`` (its depth cut to ``layers`` when
    given), weights drawn on the card from ``seed``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    model = Model(cfg, device=DEVICE).init_params(g)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kinds = [b.kind for b in model.layers]
    counts = ", ".join(f"{k} {kinds.count(k)}" for k in sorted(set(kinds)))
    log(f"model: {cfg.name} layers={cfg.num_layers} ({counts}) "
        f"d_model={cfg.d_model} params {nbytes / 1e9:.3f} GB, drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, model


def forward_launches(model) -> dict:
    """The kernel launches of one prefill forward, from the layer kinds:
    one flash call per attention block (two with an encoder: self and
    cross attention) and per encoder layer, one scan per RG-LRU block,
    one mLSTM call per mLSTM block."""
    kinds = [b.kind for b in model.layers]
    cfg = model.cfg
    attn = sum(k in ("attn", "local") for k in kinds)
    return {"flash_attention": attn * (2 if cfg.encoder_layers else 1)
            + cfg.encoder_layers,
            "rglru_scan": kinds.count("rglru"),
            "mlstm_chunkwise": kinds.count("mlstm"),
            "decode_attention": 0}


def phase_prefill(torch, cfg, model, seed: int, want: dict,
                  batch: int = PREFILL_BATCH, length: int = PREFILL_LEN,
                  label: str = "prefill", extra: dict | None = None,
                  keep: bool = False) -> dict:
    """6c, 7c and 10b-10f: the serving prefill at full width; ``want``
    the launches per forward, by kernel, and ``flash_wgmma`` how many of
    the flash launches must run the wgmma kernel. ``extra``: the model's
    other inputs (audio or vision embeddings). ``keep``: also return the
    warm run's tokens, logits and K/V (``out["last"]``)."""
    extra = extra or {}
    expect(forward_launches(model) == {k: n for k, n in want.items()
                                       if k != "flash_wgmma"},
           "layer kinds", forward_launches(model), want)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, length),
                           generator=g, device=DEVICE)
    out = {}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        reset_model_launches()
        t0 = time.perf_counter()
        logits, aux, kvs = model(tokens, mode="last_logits", return_kv=True,
                                 **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_model_launches()
        expect(launches == want, "launches per forward", launches)
        expect(logits.shape == (batch, 1, cfg.padded_vocab)
               and logits.dtype == torch.float32, "logits", logits.shape)
        expect(bool(torch.isfinite(logits).all()), "non-finite logits")
        expect(bool(torch.isfinite(aux)), "non-finite aux loss")
        live = [kv for kv in kvs if kv is not None]
        expect(len(live) == sum(b.kind in ("attn", "local")
                                for b in model.layers) and all(
            kv[0].shape == (batch, cfg.num_kv_heads, length, cfg.head_dim)
            for kv in live), "prefill K/V")
        peak = torch.cuda.max_memory_allocated()
        toks = batch * length
        log(f"{label} {run}: {batch}x{length} tokens in "
            f"{wall:.4f} s = {toks / wall:.1f} tokens/s; launches "
            f"{json.dumps(launches)}; peak memory {peak / 1e9:.3f} GB; "
            f"aux {float(aux):.6f}; argmax "
            f"{logits[:, 0, :cfg.vocab_size].argmax(-1).tolist()}")
        out = {"prefill_s": wall, "tokens_per_s": toks / wall,
               "peak_gb": peak / 1e9, "launches": launches,
               "aux": float(aux)}
        if keep and run == "warm":
            out["last"] = (tokens, logits, kvs)
        del logits, kvs, live     # the warm run holds no K/V of the cold one
    out["profile"] = profile_device(
        torch, label, lambda: model(tokens, mode="last_logits", **extra))
    return out


def profile_device(torch, label: str, fn) -> dict | None:
    """Device time by kernel, and the device's busy share, over one call
    of ``fn`` (a diagnostic: no check depends on it). Only the profiler
    may fail quietly; a failure of ``fn`` fails the run. It traces the
    card alone: the host operators' trace is not read, and for a call of
    ~500,000 small kernels (xlstm's prefill) it takes minutes to read."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:
        log(f"{label} profile: not measured ({type(e).__name__}: {e})")
        return None
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    except BaseException:
        try:
            prof.stop()
        except Exception:
            pass
        raise
    wall = time.perf_counter() - t0
    try:
        prof.stop()
        rows = sorted(
            ((ev.self_device_time_total, ev.key, ev.count)
             for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA
             and ev.self_device_time_total > 0
             and not ev.key.startswith("Command Buffer")), reverse=True)
    except Exception as e:
        log(f"{label} profile: not measured ({type(e).__name__}: {e})")
        return None
    busy = sum(r[0] for r in rows) / 1e6
    n = sum(r[2] for r in rows)
    log(f"{label} profile: wall {wall:.4f} s, {n} device ops busy "
        f"{busy:.4f} s ({100 * busy / wall:.1f}% of the wall time); trace "
        f"read in {time.perf_counter() - t0 - wall:.1f} s")
    for dev_us, key, count in rows[:12]:
        log(f"{label} profile: {dev_us / 1e3:9.3f} ms  x{count:<5d} "
            f"{key[:90]}")
    return {"wall_s": wall, "busy_s": busy, "device_ops": n,
            "top": [(k[:90], us / 1e3, c) for us, k, c in rows[:12]]}


def phase_serve_loop(torch, np, cfg, model, seed: int,
                     label: str = "serve loop") -> dict:
    """6e and 7e: continuous batching at full width with the launcher's
    defaults."""
    from repro_torch.serving.serve_loop import Request, ServeLoop
    loop = ServeLoop(cfg, model, batch_slots=4, max_len=128)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=rng.integers(4, 12)).astype(np.int32),
        max_new=16) for i in range(8)]
    for r in reqs:
        loop.submit(r)
    reset_model_launches()
    loop.step()                  # first step: cuBLAS set-up, not timed
    torch.cuda.synchronize()
    steps, t0 = 0, time.perf_counter()
    while loop.queue or any(loop.active):
        loop.step()
        steps += 1
    wall = time.perf_counter() - t0
    launches = read_model_launches()
    # every step, the untimed first too, is one decode step
    expect(launches["flash_attention"] == 0 and launches["decode_attention"]
           == (steps + 1) * attn_layers(cfg), label, "decode launches",
           steps + 1, launches)
    expect(all(r.done and len(r.out) == 16 for r in reqs),
           "not every request finished with 16 tokens")
    expect(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
           "a token outside the vocabulary")
    slot_tokens = steps * loop.B
    generated = sum(len(r.out) for r in reqs)
    log(f"{label}: {len(reqs)} requests, {loop.B} slots, {steps} timed "
        f"steps in {wall:.3f} s = {1e3 * wall / steps:.2f} ms per decode "
        f"step, {slot_tokens / wall:.1f} slot-tokens/s, {generated} "
        f"generated tokens; launches {json.dumps(launches)}; first outputs "
        f"{reqs[0].out[:8]}")
    caches = model.init_cache(loop.B, 128)
    tokens = loop.tokens

    def five_steps():
        nonlocal caches
        for _ in range(5):
            _, caches = model.decode_step(tokens, caches)

    prof = profile_device(torch, f"{label} decode 5 steps", five_steps)
    return {"decode_step_ms": 1e3 * wall / steps, "steps": steps,
            "slot_tokens_per_s": slot_tokens / wall, "launches": launches,
            "profile": prof}


def ring_from_prefill(torch, kv, window: int):
    """The decode ring cache's content, from the prefill's (B, K, S, hd):
    position p sits in slot p mod window, for the last window positions."""
    S = kv.shape[2]
    slots = torch.arange(S - window, S, device=kv.device) % window
    ring = torch.empty_like(kv[:, :, :window])
    ring[:, :, slots] = kv[:, :, S - window:]
    return ring


def phase_prefill_vs_decode(torch, cfg, model, seed: int,
                            length: int = LONG_PROMPT,
                            rtol: float = PREFILL_DECODE_LOGITS_RTOL,
                            label: str = "prefill vs decode") -> dict:
    """6d and 7d: the prefill path (flash + RG-LRU scan, or the mLSTM
    kernel) against the decode path (the decode attention kernels over
    the ring cache, one recurrence step) on one prompt of ``length``
    tokens, in float32 activations over the same weights (upcast once;
    bfloat16 to float32 is exact). The prefill's K/V of an attention
    layer are held against the decode's ring cache."""
    import dataclasses
    from repro_torch.models.model import Model
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    m32 = Model(cfg32, device=DEVICE)
    m32.load_state_dict(model.state_dict())
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 2)
    tokens = torch.randint(0, cfg.vocab_size, (1, length), generator=g,
                           device=DEVICE)
    reset_model_launches()
    t0 = time.perf_counter()
    want_logits, _, kvs = m32(tokens, mode="last_logits", return_kv=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = read_model_launches()
    caches = m32.init_cache(1, length)
    reset_model_launches()
    t0 = time.perf_counter()
    for t in range(length):
        logits, caches = m32.decode_step(tokens[:, t:t + 1], caches)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = read_model_launches()
    expect(decode_launches["flash_attention"] == 0
           and decode_launches["decode_attention"]
           == length * attn_layers(cfg), label, "decode launches",
           decode_launches)
    V = cfg.vocab_size
    p, d = want_logits[0, 0, :V], logits[0, 0, :V]
    err = rel_err(torch, p, d)
    top2 = torch.topk(d, 2).values
    log(f"{label}: {length} tokens; prefill {prefill_s:.3f} s "
        f"(launches {json.dumps(launches)}), {length} decode steps "
        f"{decode_s:.3f} s ({1e3 * decode_s / length:.2f} ms/step, "
        f"launches {json.dumps(decode_launches)}); "
        f"argmax {int(p.argmax())} vs {int(d.argmax())}, top-2 margin "
        f"{float(top2[0] - top2[1]):.5f}; logits rel err {err:.3e}")
    expect(int(p.argmax()) == int(d.argmax()), "prefill and decode argmax "
           "differ")
    expect(err <= rtol, label, "logits", err)
    kv_errs = []
    for i, kv in enumerate(kvs):
        if kv is None:
            continue
        cache = caches[i]["attn"]
        expect(cache["len"] == length, "cache length", cache["len"])
        window = cache["k"].shape[2]
        for name, pre, dec in (("k", kv[0], cache["k"]),
                               ("v", kv[1], cache["v"])):
            e = rel_err(torch, ring_from_prefill(torch, pre, window), dec)
            kv_errs.append(e)
            expect(e <= PREFILL_DECODE_KV_RTOL, f"layer {i} {name}: prefill "
                   f"K/V vs the decode ring", e)
    if kv_errs:
        log(f"{label}: K/V of the last {window} positions in "
            f"{len(kv_errs) // 2} local layers match the decode ring; max "
            f"rel err {max(kv_errs):.3e}")
    del m32, caches, kvs
    return {"prefill_s": prefill_s, "decode_step_ms":
            1e3 * decode_s / length, "logits_rel_err": err,
            "kv_rel_err": max(kv_errs, default=None), "launches": launches,
            "decode_launches": decode_launches}


def phase_model(torch, np, seed: int) -> dict:
    """6b-6e on one set of full-size weights; returns what the kernel line
    and the log need."""
    out = {"launcher": phase_launcher(torch)}
    cfg, model = full_model(torch, seed)
    out["prefill"] = phase_prefill(torch, cfg, model, seed, want={
        "flash_attention": 12, "rglru_scan": 26, "mlstm_chunkwise": 0,
        "decode_attention": 0, "flash_wgmma": 12})
    out["serve"] = phase_serve_loop(torch, np, cfg, model, seed)
    out["long"] = phase_prefill_vs_decode(torch, cfg, model, seed)
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: xlstm-350m
# ---------------------------------------------------------------------------

MLSTM_MAIN = dict(BH=XLSTM_BATCH * 4, S=XLSTM_LEN, hd=256,   # 4 heads
                  dtype="bfloat16", gates="paper")
MLSTM_CASES = [
    MLSTM_MAIN,                              # every mLSTM block's call
    {**MLSTM_MAIN, "dtype": "float32"},
    {**MLSTM_MAIN, "S": 64},                 # one chunk
    {**MLSTM_MAIN, "BH": 1},
    {**MLSTM_MAIN, "hd": 64},
    {**MLSTM_MAIN, "S": 2000},               # not a multiple of the chunk
    {**MLSTM_MAIN, "gates": "extreme"},
]


def mlstm_inputs(torch, case: dict, g):
    """q, k ~ N(0, 1/hd), v ~ N(0, 1) in the case's dtype; ``paper``
    gates as repro's tests draw them (log_i <= 0, log_f = log
    sigmoid(N(2, 1))), ``extreme`` ones log_f in [-31, -29] and log_i in
    [-10, 10]."""
    import torch.nn.functional as F
    BH, S, hd = case["BH"], case["S"], case["hd"]
    dt = getattr(torch, case["dtype"])
    n = lambda *shape: torch.randn(*shape, generator=g, device=DEVICE)
    q = (n(BH, S, hd) / hd ** 0.5).to(dt)
    k = (n(BH, S, hd) / hd ** 0.5).to(dt)
    v = n(BH, S, hd).to(dt)
    if case["gates"] == "extreme":
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(
            BH, S, generator=g, device=DEVICE)
        return q, k, v, u(-10.0, 10.0), u(-31.0, -29.0)
    return q, k, v, -F.softplus(-n(BH, S)), -F.softplus(-n(BH, S) - 2.0)


def mlstm_bound(case: dict, itemsize: int) -> dict:
    """The least time for one call, whatever the tiling: per step the
    state costs 4 hd^2 flops (q C and the update of C) and a tile of L
    steps adds 2 hd (L + 1) for the two masked products over its lower
    triangle, least at L = 1, so 4 hd^2 + 4 hd per (b*h, step) at the
    float32 FMA peak; against q, k, v read once, the float32 gates read
    and h written once."""
    BH, S, hd = case["BH"], case["S"], case["hd"]
    flops = BH * S * (4 * hd * hd + 4 * hd)
    nbytes = BH * S * (3 * hd * itemsize + 2 * 4 + hd * 4)
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def tf32(torch, x):
    """float32 x rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero, as a float32 operand enters the tensor cores."""
    bits_ = x.contiguous().view(torch.int32)
    return ((bits_ + 0x1000) & -0x2000).view(torch.float32)


def mlstm_rounded(torch, rnd, q, k, v, log_i, log_f):
    """The control for ``MLSTM_REL``: the plain recurrence of
    ``kernels/mlstm/ref.py`` with the operands of every product rounded
    by ``rnd``, as a kernel with its products in TF32 or bf16 reads them."""
    BH, S, hd = q.shape
    q, k, v = rnd(q.float() * hd ** -0.5), rnd(k.float()), rnd(v.float())
    C = torch.zeros(BH, hd, hd, device=q.device)
    n = torch.zeros(BH, hd, device=q.device)
    m = torch.zeros(BH, device=q.device)
    out = torch.empty(BH, S, hd, device=q.device)
    for t in range(S):
        m_new = torch.maximum(log_f[:, t] + m, log_i[:, t])
        i_p = torch.exp(log_i[:, t] - m_new)[:, None]
        f_p = torch.exp(log_f[:, t] + m - m_new)[:, None]
        C = f_p[..., None] * C + (i_p * k[:, t])[:, :, None] * v[:, t, None]
        n = f_p * n + i_p * k[:, t]
        num = torch.einsum("bde,bd->be", rnd(C), q[:, t])
        den = torch.einsum("bd,bd->b", rnd(n), q[:, t]).abs()
        out[:, t] = num / torch.maximum(den, torch.exp(-m_new))[:, None]
        m = m_new
    return out


def mlstm_case(torch, case: dict, g):
    """One mLSTM case: the kernel against the sequential recurrence,
    repeatability, and times of the wrapper, the kernel and the plain
    version; at the main case, the control of ``MLSTM_REL``."""
    from repro_torch.kernels.mlstm import kernel, ops, ref
    log(f"kernel check: mlstm_chunkwise {json.dumps(case)}")
    args = mlstm_inputs(torch, case, g)
    chunk = 256 if case["S"] % 256 == 0 else case["S"]
    call = lambda: ops.mlstm(*args, chunk=chunk)
    alone = lambda: kernel.mlstm_chunkwise(*args)
    plain = lambda: ref.mlstm_ref(*args)
    got, again, want = call(), alone(), plain()
    torch.cuda.synchronize()
    rtol, atol = MLSTM_TOL
    err = float((got - want).abs().max())
    peak = float(want.abs().max())
    expect(got.dtype == torch.float32 and got.shape == args[0].shape,
           "mLSTM output", got.dtype, got.shape)
    expect(bool(torch.isfinite(got).all()), "mLSTM output not finite", case)
    expect(torch.allclose(got, want, rtol=rtol, atol=atol),
           "mLSTM kernel differs from its plain version", case, err)
    expect(err <= MLSTM_REL * peak, "mLSTM kernel differs from its plain "
           "version by more than MLSTM_REL of max|h|", case, err, peak)
    expect(torch.equal(got, again), "mLSTM kernel not bitwise repeatable")
    control = {}
    if case == MLSTM_MAIN:
        for name, rnd in (("tf32", lambda x: tf32(torch, x)),
                          ("bf16", lambda x: x.bfloat16().float())):
            wrong = mlstm_rounded(torch, rnd, *args)
            rel = float((wrong - want).abs().max()) / peak
            expect(rel > MLSTM_REL, f"the {name} control passes MLSTM_REL",
                   rel)
            control[f"control_{name}_rel_err"] = rel
            del wrong
    del got, again, want
    return {
        "op": "mlstm_chunkwise", **case, "max_abs_err": err,
        "rel_err": err / peak, "max_abs_h": peak, **control,
        "ms": cuda_ms(torch, call, reps=5),
        "kernel_only_ms": cuda_ms(torch, alone, reps=5),
        **device_cols(alone, "mlstm_chunkwise",
                      3 if case["S"] > MLSTM_STATE_CHUNK else 2),
        "plain_ms": cuda_ms(torch, plain, reps=2), "library_ms": None,
        **mlstm_bound(case, args[0].element_size()),
    }


def mlstm_tag(case: dict, kernel: str) -> str:
    """The mangled-name fragment of the instantiation a case runs of the
    ``state`` or ``output`` kernel."""
    elem = {"bfloat16": "13__nv_bfloat16", "float32": "f"}[case["dtype"]]
    return f"mlstm_{kernel}_kernelI{elem}Li{case['hd']}E"


def phase_mlstm_kernels(torch, ptxas: dict):
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    rows = []
    for case in MLSTM_CASES:
        state = ptxas_of(ptxas, "mlstm_chunkwise", mlstm_tag(case, "state"))
        rows.append({**mlstm_case(torch, case, g), **ptxas_of(
            ptxas, "mlstm_chunkwise", mlstm_tag(case, "output")),
            **{f"state_{k}": x for k, x in state.items()}})
        log("kernel " + json.dumps(rows[-1]))
    return rows


def phase_xlstm(torch, np, seed: int) -> dict:
    """7b-7e on one set of full-size xlstm-350m weights."""
    out = {"launcher": phase_launcher(torch, XLSTM)}
    cfg, model = full_model(torch, seed, XLSTM)
    out["prefill"] = phase_prefill(
        torch, cfg, model, seed, want={
            "flash_attention": 0, "rglru_scan": 0, "mlstm_chunkwise": 12,
            "decode_attention": 0, "flash_wgmma": 0},
        batch=XLSTM_BATCH, length=XLSTM_LEN, label="xlstm prefill")
    out["long"] = phase_prefill_vs_decode(
        torch, cfg, model, seed, length=XLSTM_LONG_PROMPT,
        rtol=XLSTM_PREFILL_DECODE_RTOL, label="xlstm prefill vs decode")
    out["serve"] = phase_serve_loop(torch, np, cfg, model, seed,
                                    label="xlstm serve loop")
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

def grad_compare(torch, label: str, fn, plain, inputs, wrapper) -> dict:
    """8a: the gradients of ``(out * g).sum()`` with respect to every
    input, once through ``fn`` (the kernel's autograd.Function) and once
    through autograd of ``plain``, on the same card tensors; ``wrapper``
    must count one launch for ``fn``'s forward and none for its
    backward."""
    inputs = [t.detach().requires_grad_(True) for t in inputs]
    for _ in range(2):       # the second call is timed: fwd, then bwd
        before = wrapper.launches
        t0 = time.perf_counter()
        out = fn(*inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        expect(out.grad_fn is not None, label, "the kernel's output has "
               "no grad_fn: its gradient would be lost")
        g = torch.randn(out.shape, generator=torch.Generator(device=DEVICE)
                        .manual_seed(5), device=DEVICE, dtype=out.dtype)
        t2 = time.perf_counter()
        got = torch.autograd.grad((out * g).sum(), inputs)
        torch.cuda.synchronize()
        fwd_s, bwd_s = t1 - t0, time.perf_counter() - t2
        launches = wrapper.launches - before
    t0 = time.perf_counter()
    want = torch.autograd.grad((plain(*inputs) * g).sum(), inputs)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    errs = []
    for x, a, b in zip(inputs, got, want):
        expect(a.dtype == b.dtype == x.dtype and a.shape == x.shape, label,
               "gradient dtype or shape", a.dtype, b.dtype, x.dtype)
        expect(bool(torch.isfinite(a).all()), label, "non-finite gradient")
        dt = str(x.dtype).removeprefix("torch.")
        errs.append((dt, rel_err(torch, a, b)))
        expect(errs[-1][1] <= GRAD_REL[dt], label, "gradient differs from "
               "the plain version's", errs[-1], GRAD_REL[dt])
    expect(launches == 1, label, "kernel launches", launches)
    row = {"op": label, "launches": launches, "grad_rel_err": errs,
           "fwd_s": fwd_s, "bwd_s": bwd_s, "plain_fwd_bwd_s": plain_s}
    log("grad " + json.dumps(row))
    return row


def phase_kernel_grads(torch) -> list:
    """8a: each model kernel's gradient wrapper against autograd of its
    plain version."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mlstm import ops as mops
    from repro_torch.kernels.mlstm.ref import mlstm_ref
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    g = torch.Generator(device=DEVICE)
    g.manual_seed(8)
    rows = [grad_compare(torch, f"mlstm_chunkwise {json.dumps(GRAD_MLSTM)}",
                         mops.mlstm, mlstm_ref,
                         mlstm_inputs(torch, GRAD_MLSTM, g), mops.mlstm)]
    for case in GRAD_FLASH:
        B, H, K, S, hd = (case[k] for k in ("B", "H", "K", "S", "hd"))
        qkv = [torch.randn(B, n, S, hd, generator=g, device=DEVICE,
                           dtype=torch.bfloat16) for n in (H, K, K)]
        kw = dict(causal=True, window=case["window"])
        rows.append(grad_compare(
            torch, f"flash_attention {json.dumps(case)}",
            lambda q, k, v: fops.flash_attention(q, k, v, **kw),
            lambda q, k, v: flash_attention_ref(q, k, v, **kw), qkv,
            fops.flash_attention))
    B, S, W = (GRAD_RGLRU[k] for k in ("B", "S", "W"))
    a = torch.sigmoid(torch.randn(B, S, W, generator=g, device=DEVICE))
    b = torch.randn(B, S, W, generator=g, device=DEVICE)
    rows.append(grad_compare(torch, f"rglru_scan {json.dumps(GRAD_RGLRU)}",
                             rops.rglru_scan, rglru_scan_ref, [a, b],
                             rops.rglru_scan))
    return rows


def phase_train_launcher(torch) -> dict:
    """8b: ``repro_torch.launch.train`` on the card at the smoke config,
    killed at step 12 and restarted, with its own checks."""
    from repro_torch.launch import train as launch_train
    reset_model_launches()
    t0 = time.perf_counter()
    rc = launch_train.main(["--steps", "30", "--kill-at", "12"])
    torch.cuda.synchronize()
    launches = read_model_launches()
    expect(rc == 0, "the train launcher returned", rc)
    expect(launches["mlstm_chunkwise"] > 0, "the train launcher ran no "
           "mLSTM kernel", launches)
    log(f"train launcher: rc={rc} wall_s={time.perf_counter() - t0:.3f} "
        f"launches {json.dumps(launches)}")
    return launches


def plain_mlstm(torch, X):
    """The mLSTM through repro's plain chunk form (``_mlstm_chunk`` over
    chunks of 256, the state carried), with the wrapper's signature: the
    kernel-free path of 8d."""
    def mlstm(q, k, v, log_i, log_f, *, chunk: int = 256):
        BH, S, hd = q.shape
        C = torch.zeros(1, BH, hd, hd, device=q.device)
        n = torch.zeros(1, BH, hd, device=q.device)
        m = torch.zeros(1, BH, device=q.device)
        outs = []
        for lo in range(0, S, chunk):
            part = [t[None, :, lo:lo + chunk] for t in (q, k, v, log_i,
                                                        log_f)]
            out, C, n, m = X._mlstm_chunk(*part, C, n, m)
            outs.append(out[0])
        return torch.cat(outs, dim=1)
    return mlstm


def train_setup(torch, np, cfg, seed: int):
    """The corpus and pipeline factory of 8c: a Markov corpus over the
    full vocabulary, TRAIN_BATCH x TRAIN_LEN batches."""
    from repro_torch.data.pipeline import DataPipeline, TokenDataset
    from repro_torch.data.synthetic import markov_corpus
    B, S = TRAIN_BATCH, TRAIN_LEN
    tokens = markov_corpus(B * S * 32, cfg.vocab_size, seed=seed)
    ds = TokenDataset(tokens, shard_tokens=B * S * 2)
    return lambda: DataPipeline(ds, batch=B, seq_len=S, seed=seed)


def published_complete(ckpt) -> int:
    """Every committed checkpoint run's commit holds all four tables;
    returns how many there are."""
    published = [r for r in ckpt.registry.runs() if r.status == "committed"]
    expect(published, "no checkpoint was published")
    for r in published:
        tables = set(ckpt.catalog.commit(r.final_commit).tables)
        expect({"params", "opt_state", "data_state", "metrics"} <= tables,
               "torn checkpoint", r.run_id, sorted(tables))
    return len(published)


def phase_train(torch, np, seed: int) -> dict:
    """8c and 8d: xlstm-350m at full width, trained through the mLSTM
    kernel with transactional checkpoints, killed and resumed; then one
    step through the kernel against the same step without it."""
    import dataclasses
    from repro_torch.checkpoints.checkpointing import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.catalog import Catalog
    from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                         resilient_train)
    from repro_torch.models import xlstm as X
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig, make_grad_fn,
                                                 make_train_step, train)
    cfg = get_config(XLSTM)
    pipeline = train_setup(torch, np, cfg, seed)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    tc = TrainConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT, seed=seed,
                     device=DEVICE)
    n_mlstm = sum(k == "mlstm" for k in cfg.block_pattern) \
        * cfg.n_scan_blocks
    out = {"batch": TRAIN_BATCH, "seq_len": TRAIN_LEN}

    # 8c, run A: uninterrupted, a checkpoint every TRAIN_CKPT steps
    torch.cuda.reset_peak_memory_stats()
    reset_model_launches()
    ckpt_a = CheckpointManager(Catalog())
    t0 = time.perf_counter()
    res_a = train(cfg, pipeline=pipeline(), opt_cfg=opt, tc=tc, ckpt=ckpt_a)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches = read_model_launches()
    hist = res_a["history"]
    steps = [h["step_time_s"] for h in hist]
    warm = steps[1:]
    toks = TRAIN_BATCH * TRAIN_LEN
    out["run_a"] = {
        "wall_s": wall_a, "step_s": steps, "losses": [h["loss"] for h in
                                                      hist],
        "warm_step_s_mean": sum(warm) / len(warm),
        "tokens_per_s": toks * len(warm) / sum(warm),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "published": published_complete(ckpt_a)}
    log(f"train A: {json.dumps(out['run_a'])}")
    expect(launches["mlstm_chunkwise"] == n_mlstm * TRAIN_STEPS,
           "mLSTM launches in run A", launches, n_mlstm * TRAIN_STEPS)
    expect(launches["flash_attention"] == launches["rglru_scan"] == 0,
           "xlstm launched flash or RG-LRU", launches)
    expect(all(np.isfinite(h["loss"]) for h in hist), "non-finite loss")
    expect(hist[-1]["loss"] < hist[0]["loss"], "loss did not decrease",
           hist[0]["loss"], hist[-1]["loss"])
    expect(ckpt_a.latest_step() == TRAIN_STEPS, "run A's last checkpoint",
           ckpt_a.latest_step())
    del ckpt_a

    # run B: killed at TRAIN_KILL_AT, restarted from the branch head
    ckpt_b = CheckpointManager(Catalog())
    inj = FailureInjector(fail_at=(TRAIN_KILL_AT,))
    t0 = time.perf_counter()
    res_b = resilient_train(cfg, pipeline_factory=pipeline, opt_cfg=opt,
                            tc=tc, ckpt=ckpt_b, injector=inj)
    torch.cuda.synchronize()
    loss_a, loss_b = hist[-1]["loss"], res_b["history"][-1]["loss"]
    bitwise = loss_a == loss_b and all(
        torch.equal(res_a["params"][k], res_b["params"][k])
        for k in res_a["params"])
    out["run_b"] = {
        "wall_s": time.perf_counter() - t0, "killed_at": sorted(inj._fired),
        "resumed_from": res_b["history"][0]["step"], "loss_a": loss_a,
        "loss_b": loss_b, "drift": abs(loss_a - loss_b),
        "bitwise_equal": bitwise, "published": published_complete(ckpt_b)}
    log(f"train B: {json.dumps(out['run_b'])}")
    expect(inj._fired == {TRAIN_KILL_AT}, "the injected kill did not fire")
    expect(out["run_b"]["resumed_from"] == TRAIN_KILL_AT // TRAIN_CKPT
           * TRAIN_CKPT, "run B resumed from", out["run_b"]["resumed_from"])
    expect(abs(loss_a - loss_b) < TRAIN_RESUME_TOL, "resumed loss drifts",
           loss_a, loss_b)
    del ckpt_b, res_b

    # one step's gradients: finite and non-zero for every parameter, and
    # the step's launches and device profile
    params, batch = res_a["params"], pipeline().next_batch()
    inputs, targets = (torch.from_numpy(x).to(DEVICE) for x in batch)
    del res_a
    grad_fn = make_grad_fn(cfg, tc)
    reset_model_launches()
    (loss, _), grads = grad_fn(params, inputs, targets)
    out["step_launches"] = read_model_launches()
    expect(out["step_launches"]["mlstm_chunkwise"] == n_mlstm,
           "mLSTM launches in one forward and backward",
           out["step_launches"])
    for name, gr in grads.items():
        expect(bool(torch.isfinite(gr).all()), "non-finite gradient", name)
        expect(bool((gr != 0).any()), "all-zero gradient", name)
    log(f"train grads: {len(grads)} parameters, every gradient finite and "
        f"non-zero; loss {float(loss):.6f}; launches "
        f"{json.dumps(out['step_launches'])}")
    del grads
    step = make_train_step(cfg, opt, tc)
    opt_state = adamw_init(params)
    short = inputs[:, :TRAIN_PROFILE_LEN], targets[:, :TRAIN_PROFILE_LEN]
    step(params, opt_state, *short)             # warm at the profile's shape
    out["profile"] = profile_device(
        torch, f"train step {TRAIN_BATCH}x{TRAIN_PROFILE_LEN}",
        lambda: step(params, opt_state, *short))
    del opt_state

    # 8d: one step at the run's initial weights, float32 activations,
    # through the kernel and through repro's plain chunk form
    del params
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p32 = {k: v.detach().float() for k, v in Model(cfg, device=DEVICE)
           .init_params(gen).state_dict().items()}
    grad32 = make_grad_fn(cfg32, tc)
    picks = ["embed", "layers.0.mix.wq", "layers.0.mix.w_if",
             "layers.1.mix.w_in", "layers.1.mix.r"]
    reset_model_launches()
    (l_k, _), g_k = grad32(p32, inputs, targets)
    expect(read_model_launches()["mlstm_chunkwise"] == n_mlstm,
           "8d: the kernel path launched", read_model_launches())
    g_k = {k: g_k[k] for k in picks}
    gen.manual_seed(seed + 3)
    _, g_s = grad32({k: v * (1 + TRAIN_PERTURB * torch.randn(
        v.shape, generator=gen, device=DEVICE)) for k, v in p32.items()},
        inputs, targets)
    sensitivity = {k: rel_err(torch, g_s[k], g_k[k]) for k in picks}
    del g_s
    kernel_mlstm = X.mlstm
    X.mlstm = plain_mlstm(torch, X)
    try:
        reset_model_launches()
        (l_p, _), g_p = grad32(p32, inputs, targets)
        expect(read_model_launches()["mlstm_chunkwise"] == 0,
               "8d: the plain path launched", read_model_launches())
    finally:
        X.mlstm = kernel_mlstm
    loss_err = abs(float(l_k) - float(l_p)) / abs(float(l_p))
    grad_errs = {k: rel_err(torch, g_k[k], g_p[k]) for k in picks}
    out["kernel_vs_plain"] = {"loss_kernel": float(l_k),
                              "loss_plain": float(l_p),
                              "loss_rel_err": loss_err,
                              "grad_rel_err": grad_errs,
                              "grad_sensitivity": sensitivity}
    log(f"train kernel vs plain: {json.dumps(out['kernel_vs_plain'])}")
    expect(loss_err <= TRAIN_LOSS_RTOL, "8d loss", loss_err)
    for k, e in grad_errs.items():
        expect(e <= max(TRAIN_GRAD_RTOL, 2 * sensitivity[k]), "8d gradient",
               k, e, "spread", sensitivity[k])
    del p32, g_k, g_p
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: concurrent transactional runs
# ---------------------------------------------------------------------------

TXN_SPANS = ("node", "verifier", "publication_attempt")


def span_totals(rec) -> dict:
    """Count, summed and longest seconds of the engine's node spans and
    the transaction's verifier and publication spans (a verifier span of
    phase 9 includes its wait at the gate)."""
    out = {}
    for name in TXN_SPANS:
        secs = [sp.t1 - sp.t0 for sp in rec.spans(name)]
        out[name] = {"n": len(secs), "sum_s": sum(secs),
                     "max_s": max(secs, default=0.0)}
    return out


def phase_concurrent(torch, sf: float, seed: int, card: str
                     ) -> tuple[dict, dict]:
    """Phase 9: ``examples/concurrent_runs.py``'s three scenarios on the
    default backend; each must launch both segment kernels, and every
    segment call of (a) is held against its plain version. Then the
    diagnostics: the runs one after another, and (a) profiled. Returns
    the kernels' launches by scenario, and per segment kernel the
    largest error of (a)'s calls."""
    from repro_torch import exec as exec_backends
    from repro_torch.examples import concurrent_runs as cr
    from repro_torch.exec import torch_backend
    from repro_torch.obs import tracing
    from repro_torch.obs.device_time import kernel_names

    expect(exec_backends.active_backend().name == "torch_auto",
           "the default backend is not torch_auto")
    t0 = time.perf_counter()
    lineitem = cr.lineitem_with_suppkey(sf, seed)
    plans = [cr.agent_plan(i) for i in range(cr.AGENTS)]
    want = cr.reference(lineitem, plans)
    log(f"concurrent: lineitem {len(lineitem['l_orderkey'])} rows, "
        f"{ {k: len(t) for k, t in want.items()} } groups; vectorized "
        f"references in {time.perf_counter() - t0:.2f} s")
    launches, heaviest, calls = {}, {}, []
    for path, run in (
            ("concurrent_a", lambda: cr.disjoint(lineitem, want=want)),
            ("concurrent_b", lambda: cr.same_table(lineitem, want=want)),
            ("concurrent_c", lambda: cr.crash_one(lineitem, seed=seed,
                                                  want=want))):
        reset_launches()
        with (segment_calls(calls, torch_backend) if path == "concurrent_a"
              else contextlib.nullcontext()):
            summary = run()
            torch.cuda.synchronize()
        launches[path] = read_launches()
        expect(launches[path]["masked_segment_sum"] > 0
               and launches[path]["masked_segment_reduce"] > 0,
               path, "a segment kernel never launched", launches[path])
        log(f"{path}: {json.dumps(summary)} launches "
            f"{json.dumps(launches[path])} ({card})")
        if path == "concurrent_a":
            check_calls(torch, calls, "concurrent a", heaviest)

    # diagnostics: the same runs one after another, then (a) profiled
    t0 = time.perf_counter()
    with tracing() as rec:
        cr.reference(lineitem, plans, exec_backends.active_backend())
        torch.cuda.synchronize()
    log(f"concurrent serial: {cr.AGENTS} runs one after another in "
        f"{time.perf_counter() - t0:.4f} s; spans "
        f"{json.dumps(span_totals(rec))} ({card})")
    reset_launches()
    got = {}
    with tracing() as rec:
        prof = profile_device(
            torch, "concurrent a profiled",
            lambda: got.update(cr.disjoint(lineitem, want=want)))
    names = kernel_names(os.path.join(ROOT, SOURCES["masked_segment_sum"]))
    seen = sum(c for k, _, c in (prof or {}).get("top", ())
               if any(f"{n}<" in k or f"{n}(" in k for n in names))
    log(f"concurrent a profiled: {json.dumps(got)} launches "
        f"{json.dumps(read_launches())}, kernels of segment_sum.cu in the "
        f"trace {seen}; spans {json.dumps(span_totals(rec))} ({card})")
    return launches, {k: v["err"] for k, v in heaviest.items()}


# ---------------------------------------------------------------------------
# phase 12: bfloat16 keys at SF1, and the paper's entry points on the card
# ---------------------------------------------------------------------------

BF16_PATH = "bf16_keys"
ENTRY_POINTS = ("quickstart", "agent_branch_workflow", "incremental_reruns",
                "optimized_pipeline", "sql_queries", "traced_run",
                "concurrent_writers", "agent_swarm", "serve_pinned_commit")
PHASE12_BUDGET_S = 40.0         # logged against, not enforced


def auto_decisions(rec) -> list:
    """Every ``auto_decision`` event of a traced run: (op, choice)."""
    events = list(rec.orphan_events())
    for sp in rec.spans():
        events += sp.events
    return [(e["op"], e["choice"]) for e in events
            if e["name"] == "auto_decision"]


def phase_bf16_keys(torch, np, li: dict, card: str) -> dict:
    """12a: ``examples/bf16_keys.py``'s three nodes over ``li``, SF1's
    lineitem as ``lineitem_for_keys`` gives it (phase 4's), through one
    ``Client.run`` on the default backend; the four
    lakehouse kernels must launch on that run, every join and group-by
    node must be routed to a device delegate, each table must equal the
    same run on ``vectorized`` bit for bit, and the key facts must hold
    (``check_keys``). Then the joins and the group-by as direct calls on
    ``partitioned`` and ``torch`` over the card, against ``vectorized``.
    Returns the main path's launches."""
    from repro_torch import exec as exec_backends
    from repro_torch.core.planner import plan
    from repro_torch.data.tables import Table
    from repro_torch.examples import bf16_keys as bk
    from repro_torch.examples.tpch import Q1_SHIPDATE
    from repro_torch.exec.partitioned import PartitionedBackend
    from repro_torch.exec.torch_backend import TorchBackend
    from repro_torch.exec.vectorized import VectorizedBackend
    from repro_torch.obs import tracing

    expect(exec_backends.active_backend().name == "torch_auto",
           "the default backend is not torch_auto")
    client = bk.fresh_client(li)
    pl = plan(bk.build_pipeline())
    reset_launches()
    with tracing() as rec:
        t0 = time.perf_counter()
        result, tables = bk.run(client, pl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    decisions = auto_decisions(rec)
    log(f"12a bf16 keys: status {result.state.status} in {wall:.3f} s; "
        f"launches {json.dumps(launches)}; auto decisions {decisions} "
        f"({card})")
    expect(result.state.status == "committed", "12a run", result.state)
    expect(all(n > 0 for n in launches.values()),
           "12a a kernel of the path never launched", launches)
    expect(sorted(decisions) == [("group_by_agg", "torch"),
                                 ("hash_join", "partitioned"),
                                 ("masked_hash_join", "partitioned")],
           "12a torch_auto routed a node off the card", decisions)
    for name, r in sorted(pl._runtime.items()):
        log(f"12a node {name}: wall_s={r['wall_s']:.3f} "
            f"rows_out={r['rows_out']}")

    host = bk.fresh_client(li)
    t0 = time.perf_counter()
    with exec_backends.use_backend("vectorized"):
        _, want = bk.run(host, plan(bk.build_pipeline()))
    log(f"12a vectorized run: {time.perf_counter() - t0:.3f} s")
    assert_same(np, tables, want, "12a vs vectorized", floats=())
    checked = bk.check_keys(tables, li)
    log(f"12a tables equal vectorized's bit for bit; keys: "
        f"{json.dumps(checked)}")
    del want, tables, host, client

    # direct calls over the card, each against vectorized
    lk = bk.keyed(Table(li), bk.BF16_API)._to_cols()
    band = bk.keyed(Table(bk.discount_band()), bk.BF16_API)._to_cols()
    keep = li["l_shipdate"] <= np.datetime64(Q1_SHIPDATE, "ns")
    on = ("l_disc_key",)
    specs = (("count", "l_quantity", "n"), ("sum", "l_quantity", "q"),
             ("min", "l_extendedprice", "lo"),
             ("max", "l_extendedprice", "hi"))
    calls = {
        "partitioned inner masked": (
            PartitionedBackend(device=DEVICE), lambda be: be.masked_hash_join(
                lk, band, on, "inner", left_mask=keep)),
        "partitioned left": (
            PartitionedBackend(device=DEVICE),
            lambda be: be.hash_join(lk, band, on, "left")),
        "torch group-by": (
            TorchBackend(device=DEVICE), lambda be: be.group_by_agg(
                lk, ("l_disc_key", "l_tax_key"), specs)),
    }
    for label, (be, fn) in calls.items():
        t0 = time.perf_counter()
        got = fn(be)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = fn(VectorizedBackend())
        t2 = time.perf_counter()
        same_columns(np, got, want, f"12a direct {label}")
        rows = len(next(iter(got.values()))[0])
        log(f"12a direct {label}: {t1 - t0:.3f} s, vectorized "
            f"{t2 - t1:.3f} s, {rows} rows, equal ({card})")
    del lk, band
    return launches


def phase12(torch, np, li: dict, log_dir: "str | None", card: str
            ) -> dict:
    """12a then 12b; returns 12a's main-path launches."""
    t0 = time.perf_counter()
    launches = phase_bf16_keys(torch, np, li, card)
    t1 = time.perf_counter()
    walls = phase_entry_points(log_dir, card)
    t2 = time.perf_counter()
    log(f"12 wall: 12a {t1 - t0:.1f} s, 12b {t2 - t1:.1f} s "
        f"(budget {PHASE12_BUDGET_S:.0f} s); entry points "
        f"{json.dumps(walls)}")
    return launches


def phase_entry_points(log_dir: "str | None", card: str) -> dict:
    """12b: each port example's ``main(device="cuda")``; each asserts what
    its root counterpart asserts, and any that raises fails the phase.
    Their printed lines go to ``log_dir`` when given."""
    import importlib
    import io
    out = {}
    for name in ENTRY_POINTS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(device=DEVICE)
        out[name] = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        log(f"12b {name}: {out[name]:.3f} s, {len(lines)} lines; last: "
            f"{lines[-1][:160] if lines else ''} ({card})")
        if log_dir:
            with open(os.path.join(log_dir, f"example-{name}.txt"),
                      "w") as f:
                f.write(buf.getvalue())
    return out


# ---------------------------------------------------------------------------
# phase 10: the model families that reached the port last, and phi4-mini
# ---------------------------------------------------------------------------

FAMILY_BATCH, FAMILY_LEN = 4, 4096
LLAMA4_LAYERS, LLAMA4_BATCH = 8, 2   # 48 layers hold ~212 GB of bf16
WHISPER_LEN = 448                    # whisper's decoder positions
FAMILY_DECODE_STEPS = 16
PHI4_PROMPT, PHI4_DECODE = 1024, 64
MLA_LEN = 32768      # DeepSeek-V2-Lite's benchmark prompt (10a only)
# One full-width MoE layer (granite, bf16) against a plain loop over the
# experts that takes the same routing decisions, as max|port - plain| /
# max|plain|. Both round each expert product to bf16 (cuBLAS, in batched
# and in single products, which may round an element one bf16 step apart:
# 2^-8 relative, in h and again in the expert's output) and the port
# rounds the gate-sum to bf16 once more (2^-9); summed over 8 slots.
MOE_LAYER_REL = 2e-2


def family_flash_cases() -> list:
    """10a's cases: every shape at which 10b-10f call flash, read from
    the configs and the batch and lengths those phases use, then two
    that no path runs: hd 96 in float32, and a ragged key length in
    float32; last DeepSeek-V2-Lite's latent attention at the benchmark
    cell's one 32,768-token prompt (qk 192, v 128, the YaRN scale),
    which no phase serves."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import mla_softmax_scale

    def attn(arch, B, S, dtype="bfloat16", causal=True, Skv=None):
        c = get_config(arch)
        case = dict(B=B, H=c.num_heads, K=c.num_kv_heads, S=S,
                    hd=c.head_dim, causal=causal, window=None, dtype=dtype)
        return case if Skv is None else {**case, "Skv": Skv}

    frames = get_config("whisper_medium").num_source_positions
    ds = get_config("deepseek-v2-lite")
    phi3 = attn("phi3_vision_4b", FAMILY_BATCH, FAMILY_LEN)
    cross = attn("whisper_medium", FAMILY_BATCH, WHISPER_LEN, causal=False,
                 Skv=frames)
    return [
        attn("granite_moe_3b", FAMILY_BATCH, FAMILY_LEN),         # 10b
        attn("llama4_scout_17b", LLAMA4_BATCH, FAMILY_LEN),       # 10c
        attn("whisper_medium", FAMILY_BATCH, frames, causal=False),  # 10d
        attn("whisper_medium", FAMILY_BATCH, WHISPER_LEN),
        cross,
        phi3,                                                     # 10e
        attn("phi4_mini_3b", FAMILY_BATCH, FAMILY_LEN),           # 10f
        attn("phi4_mini_3b", 1, PHI4_PROMPT, "float32"),
        attn("phi4_mini_3b", 1, PHI4_PROMPT + PHI4_DECODE, "float32"),
        {**phi3, "dtype": "float32"},
        {**cross, "Skv": frames - 1, "dtype": "float32"},
        {**attn("deepseek-v2-lite", 1, MLA_LEN),
         "hd": ds.mla.qk_head_dim, "hd_v": ds.mla.v_head_dim,
         "scale": mla_softmax_scale(ds)},
    ]


def phase_family_kernels(torch, ptxas: dict) -> list:
    """10a: flash at the new families' shapes against its plain
    version; at phi3-vision's hd 96 in bf16 (wgmma, 32-column boxes) and
    at latent attention's qk 192 / v 128 (``flash_mla_kernel``, one
    launch of it and of no other kernel) the one-bf16-P control too, and
    no spill."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(10)
    rows = []
    for case in family_flash_cases():
        mla = "hd_v" in case
        hd96 = case["hd"] == 96 and case["dtype"] == "bfloat16"
        rows.append({**flash_case(torch, case, g, control=hd96 or mla),
                     **ptxas_of(ptxas, "flash_attention", flash_tag(case))})
        log("kernel " + json.dumps(rows[-1]))
        want = ("mla" if mla else "simt" if case["dtype"] == "float32"
                else "wgmma")
        expect(rows[-1]["kernel"] == want, "flash kernel", case)
        if hd96 or mla:
            expect(rows[-1]["spill_bytes"] == 0, f"{flash_tag(case)} "
                   "spills", rows[-1]["registers"], rows[-1]["spill_bytes"])
        if mla:
            expect(rows[-1]["launches_by_kernel"]["mla"] == 1,
                   "flash_mla_kernel launches", rows[-1]["launches_by_kernel"])
    return rows


@contextlib.contextmanager
def moe_drops(stats: list):
    """Count, on the card, the (token, slot) pairs each MoE call keeps:
    appends (kept, pairs) tensors to ``stats``."""
    from repro_torch.models import moe
    route = moe.route

    def counted(p, xg, cfg):
        out = route(p, xg, cfg)
        stats.append((out[3].sum(), out[3].numel()))
        return out

    moe.route = counted
    try:
        yield
    finally:
        moe.route = route


def moe_plain(torch, p, x, cfg):
    """A MoE layer as a plain loop over the experts: the port's routing
    decisions (``moe.route``), then each expert's MLP on the tokens it
    kept, in bf16 products, gate-weighted and summed over the slots in
    float32."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_forward
    B, S, d = x.shape
    g = moe.group_size(cfg, S)
    n = S // g
    xg = x.reshape(B, n, g, d).transpose(0, 1).reshape(n * B, g, d)
    _, idx, _, keep, gates = moe.route(p, xg, cfg)
    y = torch.zeros(*idx.shape, d, dtype=torch.float32, device=x.device)
    xb = xg.to(torch.bfloat16)
    ew = p["experts"]
    for e in range(cfg.moe.num_experts):
        n_i, t_i, j_i = (keep & (idx == e)).nonzero(as_tuple=True)
        xe = xb[n_i, t_i]
        if "w_gate" in ew:
            h = F.silu(xe @ ew["w_gate"][e]) * (xe @ ew["w_up"][e])
        else:
            h = F.gelu(xe @ ew["w_up"][e], approximate="tanh")
        y[n_i, t_i, j_i] = (h @ ew["w_down"][e]).float() \
            * gates[n_i, t_i, j_i, None]
    out = y.sum(2).to(x.dtype).reshape(n, B, g, d).transpose(0, 1)
    out = out.reshape(B, S, d)
    if "shared" in p:
        out = out + mlp_forward(p["shared"], x, cfg)
    return out


def moe_layer_check(torch, cfg, model, seed: int) -> dict:
    """10b: layer 0's MoE at the prefill's shape, the port's batched
    dispatch against ``moe_plain``."""
    from repro_torch.models import moe
    ffn = model.layers[0].ffn
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 3)
    x = torch.randn(FAMILY_BATCH, FAMILY_LEN, cfg.d_model, generator=g,
                    device=DEVICE, dtype=torch.bfloat16)
    got, aux = moe.moe_forward(ffn, x, cfg)
    want = moe_plain(torch, ffn, x, cfg)
    torch.cuda.synchronize()
    err = rel_err(torch, got, want)
    row = {"shape": [FAMILY_BATCH, FAMILY_LEN, cfg.d_model],
           "rel_err": err, "aux": float(aux),
           "ms": cuda_ms(torch, lambda: moe.moe_forward(ffn, x, cfg), reps=3),
           "plain_ms": cuda_ms(torch, lambda: moe_plain(torch, ffn, x, cfg),
                               reps=1)}
    log(f"granite MoE layer vs its plain per-expert loop: {json.dumps(row)}")
    expect(err <= MOE_LAYER_REL, "MoE layer differs from its plain loop",
           err)
    return row


def cache_from_prefill(torch, model, kvs, batch: int, max_len: int,
                       enc_out=None) -> list:
    """Decode caches holding a prefill's K/V at positions 0..S-1 (S <=
    max_len: no wrap), with the cross placeholders for ``enc_out``."""
    caches = model.init_cache(batch, max_len, enc_out=enc_out)
    for cache, kv in zip(caches, kvs):
        S = kv[0].shape[2]
        expect(S <= max_len, "the prefill does not fit the cache", S)
        for name, t in zip(("k", "v"), kv):
            cache["attn"][name][:, :, :S] = t.to(cache["attn"][name].dtype)
        cache["attn"]["len"] = S
    return caches


def greedy_decode(torch, cfg, model, caches, logits, label: str,
                  steps: int = FAMILY_DECODE_STEPS) -> dict:
    """``steps`` greedy decode steps from a prefill's last logits; every
    step's logits finite. Decode reaches no flash kernel, and the decode
    attention kernels once a step and attention layer."""
    V = cfg.vocab_size
    nxt = logits[:, -1, :V].argmax(-1, keepdim=True)
    reset_model_launches()
    torch.cuda.synchronize()
    t0, toks = time.perf_counter(), []
    for _ in range(steps):
        out, caches = model.decode_step(nxt, caches)
        expect(bool(torch.isfinite(out).all()), label, "non-finite logits")
        nxt = out[:, -1, :V].argmax(-1, keepdim=True)
        toks.append(nxt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_model_launches()
    expect(launches["flash_attention"] == 0, label, "decode launched flash")
    expect(launches["decode_attention"] == steps * attn_layers(cfg), label,
           "decode attention launches", launches)
    first = torch.cat(toks, 1)[0].tolist()
    log(f"{label}: {steps} greedy steps in {wall:.3f} s = "
        f"{1e3 * wall / steps:.2f} ms/step; tokens of request 0 {first}")
    return {"decode_step_ms": 1e3 * wall / steps, "tokens": first,
            "launches": launches}


def family_prefill(torch, cfg, model, seed: int, want: dict, label: str,
                   **kw) -> dict:
    """A prefill of phase 10, its flash launches split by kernel."""
    out = phase_prefill(torch, cfg, model, seed, want=want, label=label,
                        keep=True, **kw)
    la = out["launches"]
    out["flash_by_kernel"] = {"wgmma": la["flash_wgmma"],
                              "simt": la["flash_attention"]
                              - la["flash_wgmma"]}
    log(f"{label}: flash by kernel {json.dumps(out['flash_by_kernel'])}")
    return out


def only_flash(n: int, wgmma: int) -> dict:
    return {"flash_attention": n, "rglru_scan": 0, "mlstm_chunkwise": 0,
            "decode_attention": 0, "flash_wgmma": wgmma}


def summary(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "last"}


def phase_granite(torch, seed: int) -> dict:
    """10b: granite-moe-3b, all 32 layers, 40 experts top-8."""
    cfg, model = full_model(torch, seed, "granite_moe_3b")
    drops = []
    with moe_drops(drops):
        pre = family_prefill(torch, cfg, model, seed,
                             only_flash(cfg.num_layers, cfg.num_layers),
                             "granite prefill", batch=FAMILY_BATCH,
                             length=FAMILY_LEN)
    kept = sum(int(k) for k, _ in drops)
    pairs = sum(n for _, n in drops)
    pre["dropped_share"] = 1 - kept / pairs
    log(f"granite prefill: {pairs - kept} of {pairs} (token, slot) pairs "
        f"dropped by capacity ({100 * pre['dropped_share']:.3f}%)")
    out = {"prefill": pre, "moe_layer": moe_layer_check(torch, cfg, model,
                                                        seed)}
    tokens, logits, kvs = pre["last"]
    caches = cache_from_prefill(torch, model, kvs, FAMILY_BATCH,
                                FAMILY_LEN + FAMILY_DECODE_STEPS)
    out["decode"] = greedy_decode(torch, cfg, model, caches, logits,
                                  "granite decode")
    out["prefill"] = summary(pre)
    del model, caches, kvs, logits, pre
    torch.cuda.empty_cache()
    return out


def phase_llama4(torch, seed: int) -> dict:
    """10c: llama4-scout-17b at full width, depth cut to 8 of 48 layers:
    top-1 of 16 experts plus the shared expert, GQA 40/8 at hd 128."""
    cfg, model = full_model(torch, seed, "llama4_scout_17b",
                            layers=LLAMA4_LAYERS)
    pre = family_prefill(torch, cfg, model, seed,
                         only_flash(cfg.num_layers, cfg.num_layers),
                         "llama4 prefill", batch=LLAMA4_BATCH,
                         length=FAMILY_LEN)
    del model
    torch.cuda.empty_cache()
    return {"prefill": summary(pre)}


def phase_whisper(torch, seed: int) -> dict:
    """10d: whisper-medium, 24 encoder and 24 decoder layers: 4 x 1500
    frames encoded, a 4 x 448 decoder prefill, then greedy decode steps
    against the cross placeholders (R10)."""
    cfg, model = full_model(torch, seed, "whisper_medium")
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 4)
    audio = torch.randn(FAMILY_BATCH, cfg.num_source_positions, cfg.d_model,
                        generator=g, device=DEVICE, dtype=torch.bfloat16)
    n = cfg.num_layers
    pre = family_prefill(torch, cfg, model, seed,
                         only_flash(2 * n + cfg.encoder_layers,
                                    2 * n + cfg.encoder_layers),
                         "whisper prefill", batch=FAMILY_BATCH,
                         length=WHISPER_LEN, extra={"audio_embeds": audio})
    tokens, logits, kvs = pre["last"]
    enc = model.encode(audio)
    caches = cache_from_prefill(torch, model, kvs, FAMILY_BATCH,
                                WHISPER_LEN + FAMILY_DECODE_STEPS,
                                enc_out=enc)
    out = {"prefill": summary(pre),
           "decode": greedy_decode(torch, cfg, model, caches, logits,
                                   "whisper decode")}
    del model, caches, kvs, logits, pre, enc
    torch.cuda.empty_cache()
    return out


def phase_phi3_vision(torch, seed: int) -> dict:
    """10e: phi3-vision-4b, all 32 layers: 576 patch embeddings fused over
    the first positions, flash at hd 96 on the wgmma kernel."""
    cfg, model = full_model(torch, seed, "phi3_vision_4b")
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 5)
    vision = torch.randn(FAMILY_BATCH, cfg.num_source_positions,
                         cfg.d_model, generator=g, device=DEVICE,
                         dtype=torch.bfloat16)
    pre = family_prefill(torch, cfg, model, seed,
                         only_flash(cfg.num_layers, cfg.num_layers),
                         "phi3-vision prefill", batch=FAMILY_BATCH,
                         length=FAMILY_LEN, extra={"vision_embeds": vision})
    del model
    torch.cuda.empty_cache()
    return {"prefill": summary(pre)}


def phi4_prefill_vs_decode(torch, cfg, model, seed: int) -> dict:
    """10f: a 1024-token prefill's K/V as the decode cache, 64
    teacher-forced decode steps, their last logits against the prefill of
    all 1088 tokens; float32 activations over the same weights, as 6d."""
    import dataclasses
    from repro_torch.models.model import Model
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    m32 = Model(cfg32, device=DEVICE)
    m32.load_state_dict(model.state_dict())
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 6)
    total = PHI4_PROMPT + PHI4_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=g,
                           device=DEVICE)
    reset_model_launches()
    t0 = time.perf_counter()
    want, _ = m32(tokens, mode="last_logits")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = read_model_launches()
    expect(launches == only_flash(cfg.num_layers, 0),
           "phi4 float32 prefill launches", launches)
    _, _, kvs = m32(tokens[:, :PHI4_PROMPT], mode="last_logits",
                    return_kv=True)
    caches = cache_from_prefill(torch, m32, kvs, 1, total)
    reset_model_launches()
    t0 = time.perf_counter()
    for t in range(PHI4_PROMPT, total):
        logits, caches = m32.decode_step(tokens[:, t:t + 1], caches)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = read_model_launches()
    expect(decode_launches["flash_attention"] == 0
           and decode_launches["decode_attention"]
           == PHI4_DECODE * attn_layers(cfg), "phi4 float32 decode launches",
           decode_launches)
    V = cfg.vocab_size
    p, d = want[0, 0, :V], logits[0, 0, :V]
    err = rel_err(torch, p, d)
    top2 = torch.topk(d, 2).values
    margin = float(top2[0] - top2[1])
    log(f"phi4 prefill vs decode: {PHI4_PROMPT}-token prefill as the cache, "
        f"{PHI4_DECODE} decode steps {decode_s:.3f} s "
        f"({1e3 * decode_s / PHI4_DECODE:.2f} ms/step), {total}-token "
        f"prefill {prefill_s:.3f} s (launches {json.dumps(launches)}); "
        f"argmax {int(p.argmax())} vs {int(d.argmax())}, top-2 margin "
        f"{margin:.5f}; logits rel err {err:.3e}")
    expect(err <= PREFILL_DECODE_LOGITS_RTOL, "phi4 prefill vs decode", err)
    if margin > 2 * err * float(d.abs().max()):
        expect(int(p.argmax()) == int(d.argmax()), "phi4 prefill and decode "
               "argmax differ beyond their tolerance")
    del m32, caches, kvs
    torch.cuda.empty_cache()
    return {"prefill_s": prefill_s, "decode_step_ms":
            1e3 * decode_s / PHI4_DECODE, "logits_rel_err": err,
            "top2_margin": margin, "launches": launches,
            "decode_launches": decode_launches}


def phase_phi4(torch, seed: int) -> dict:
    """10f: phi4-mini-3b, all 32 layers: a dense decoder at hd 128, full
    causal attention (no window), GQA 24/8."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cfg, model = full_model(torch, seed, "phi4_mini_3b")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before   # 11a reads it
    pre = family_prefill(torch, cfg, model, seed,
                         only_flash(cfg.num_layers, cfg.num_layers),
                         "phi4 prefill", batch=FAMILY_BATCH,
                         length=FAMILY_LEN)
    pre.pop("last")
    out = {"prefill": pre, "param_bytes_allocated": grown,
           "long": phi4_prefill_vs_decode(torch, cfg, model, seed)}
    del model
    torch.cuda.empty_cache()
    return out


FAMILY_PATHS = {      # phase 10's model paths: the prefill of each
    "granite_prefill_4x4096": ("granite", "prefill"),
    "llama4_8_layers_prefill_2x4096": ("llama4", "prefill"),
    "whisper_prefill_4x448": ("whisper", "prefill"),
    "phi3_vision_prefill_4x4096": ("phi3_vision", "prefill"),
    "phi4_prefill_4x4096": ("phi4", "prefill"),
    "phi4_prefill_1088_f32": ("phi4", "long"),
}


def phase_families(torch, seed: int) -> dict:
    """10b-10f, one model on the card at a time, under no_grad."""
    out = {}
    for name, fn in (("granite", phase_granite), ("llama4", phase_llama4),
                     ("whisper", phase_whisper),
                     ("phi3_vision", phase_phi3_vision),
                     ("phi4", phase_phi4)):
        t0 = time.perf_counter()
        with torch.no_grad():
            out[name] = fn(torch, seed)
        out[name]["wall_s"] = time.perf_counter() - t0
        log(f"phase 10 {name}: {out[name]['wall_s']:.1f} s; "
            f"{json.dumps(out[name])}")
    return out


# ---------------------------------------------------------------------------
# phase 11: distribution, two ranks on the one card
# ---------------------------------------------------------------------------

RANKS = 2
RANK_TIMEOUT_S = 420            # the phase-11 group, start to join
PROBE_TIMEOUT_S = 60            # each probe group
TP_BATCH = 2                    # 11b: 2 x 4096 on a (data 1, model 2) mesh
PP_MICRO = 4                    # 11c: 4 x 4096 in 4 microbatches, 2 stages
DP_BATCH, DP_LEN = 4, 128       # 11d-f: xlstm-350m, 2 rows a rank
# 11b and 11c against one rank, bf16 activations. The split rounds
# otherwise: tensor parallelism leaves each rank a bf16 partial sum of
# every row-parallel product (the attention's and the MLP's output
# projections, 64 in all), which the all-reduce adds and rounds again; a
# microbatch of one row may take another cuBLAS algorithm than four rows.
# Rounding of the same kind and size as the one rank's own bf16 rounding,
# so both are held against the float32 forward of the same weights and
# tokens, max|x - f32| / max|f32|: the split within SPLIT_OF_OWN times
# the one rank's own distance (on the H100, NVIDIA H100 80GB HBM3 at
# 700.00 W, 11b's split read 2.05e-2 from one rank directly, 2.14e-2
# from float32 against the one rank's 1.76e-2). The argmax
# too, where the top-2 margin exceeds the error, as 10f holds it.
SPLIT_OF_OWN = 2.0
# 11g: layer 0's routing of the split's own input by one rank, against
# the split's (the same float32 router product of the same bf16 tokens):
# a token may differ only where two of its k + 1 largest probabilities
# lie within float32 rounding of each other (a few ulps of ~1/E)
ROUTE_F32_TIE = 1e-6
# 11g: layer 0's MoE alone, on the split's own layer-0 input in float32
# and with the split's routing decisions, under the rules against one
# rank's layer. Each rank's expert products are the same bf16 operations
# on the same dispatched rows as one rank's products of those experts:
# held bit for bit. The combine sums each token's k gated outputs in
# float32: one product and at most k - 1 additions round, and the split
# adds the two ranks' partial sums once more, so each side is within
# (k + 1) float32 roundings (2^-24 of the sum of |gate * output|, at most
# max|expert output| since the gates sum to 1 or less) of the exact sum,
# and the two within MOE_COMBINE_ROUNDINGS = 2 (k + 1) = 18 of them at
# granite's k = 8. An expert lost or counted twice moves a token by a
# whole expert output, ~10^6 times that.
MOE_COMBINE_ROUNDINGS = 18
MOE_TOP_K = 8
# 11d: the DP step against one rank's step on the same weights and the
# same four rows, float32 activations (8d's): the loss, a mean over 512
# tokens, within 1e-5 of itself; each gradient, as max|dp - one| /
# max|one|, within the larger of TRAIN_GRAD_RTOL and twice its own
# spread under a TRAIN_PERTURB perturbation of the weights, as 8d derives
# its bound: each rank's two rows run at another batch size than four,
# so cuBLAS may take other algorithms (another summation order), and the
# loss's bf16 barrier turns a float32 difference in the cotangent into a
# bf16 step (2^-8) of an element, carried back through 24 layers.
# 11f holds the resumed losses the same way: within DP_LOSS_RTOL of the
# same commit restored without a mesh, and against the uninterrupted
# one-rank run within the larger of DP_LOSS_RTOL and twice that run's
# own spread under TRAIN_PERTURB. AdamW's first steps move each weight
# by about lr whatever its gradient's size, so gradients as close as
# 11d's (2.2e-3 relative, a bf16 step of the cotangent) still flip some
# weights' updates: on the H100 the resumed losses read 7.1e-4 and
# 4.1e-4 from the uninterrupted run's (NVIDIA H100 80GB HBM3, 700.00 W).
DP_LOSS_RTOL = 1e-5
# 11e: the reference's gate (tests/test_multidevice.py): each reduced
# leaf within max|mean|/100 of the plain mean of what the ranks send
# (each rank's gradient plus the residual it carries: error feedback
# adds step 1's rounding to step 2 on purpose)
COMPRESS_ATOL_OF_MAX = 1e-2


def to_host_gathered(torch, t):
    """A DTensor's global value on the host: each local shard copied to
    the host and gathered over gloo there, then the shards concatenated
    (the explicit host copy of a CUDA tensor); a plain tensor's host
    copy. Returns (tensor, host bytes sent)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return t.detach().cpu(), 0
    out, sent = t.to_local().detach().cpu(), 0
    for md in reversed(range(t.device_mesh.ndim)):
        p = t.placements[md]
        if not isinstance(p, Shard):
            continue
        n = t.device_mesh.size(md)
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out, group=t.device_mesh.get_group(md))
        sent += out.numel() * out.element_size()
        out = torch.cat(parts, dim=p.dim)
    return out, sent


def dryrun_param_bytes(torch, arch: str, batch: int, length: int,
                       sizes: tuple) -> dict:
    """The dry-run of ``arch``'s prefill at batch x length on a (data,
    model) ``MeshShape`` of ``sizes``: its parameters' bytes on one rank,
    exact and as the CUDA caching allocator counts them
    (``specs.allocated_bytes``: each leaf's 512-byte block, and the
    segment of a large leaf whose remainder is too small to split)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch.specs import arg_bytes_per_device, build_cell
    mesh = MeshShape(("data", "model"), sizes)
    plan = build_cell(get_config(arch), ShapeConfig(
        f"prefill_{batch}x{length}", length, batch, "prefill"), mesh)
    return {"bytes": arg_bytes_per_device(plan, mesh, only=(0,)),
            "allocated": arg_bytes_per_device(plan, mesh, only=(0,),
                                              allocated=True),
            "plan": plan, "mesh": mesh}


def phase_roofline(torch, families: dict, ptxas: dict) -> dict:
    """11a: the dry-run and roofline of phase 10's phi4-mini prefill (4 x
    4096) on one card, against what the card measured; then flash at the
    per-rank shapes of 11b, 11c and 11g against its plain version."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import arg_bytes_per_device
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import roofline_terms
    phi4 = families["phi4"]
    cell = dryrun_param_bytes(torch, "phi4_mini_3b", FAMILY_BATCH,
                              FAMILY_LEN, (1, 1))
    grown = phi4["param_bytes_allocated"]
    log(f"11a dry-run: phi4-mini 4x{FAMILY_LEN} prefill on one card: "
        f"parameters {cell['bytes']} B, {cell['allocated']} B as the "
        f"caching allocator counts them; phase 10 allocated {grown} B")
    expect(cell["allocated"] == grown, "dry-run parameter bytes differ "
           "from what phase 10 allocated", cell["allocated"], grown)
    t0 = time.perf_counter()
    cost = dryrun.trace_cell(cell["plan"], cell["mesh"])
    trace_s = time.perf_counter() - t0
    args = arg_bytes_per_device(cell["plan"], cell["mesh"])
    rl = roofline_terms(arch="phi4_mini_3b", shape="prefill", mesh="1x1",
                        chips=1, hlo_flops=cost.flops,
                        model_flops=cell["plan"].model_flops,
                        hbm_bytes=args + dryrun.output_bytes(cost.out),
                        collective_bytes=cost.collective_bytes)
    bound = max(rl.compute_s, rl.memory_s)
    measured = phi4["prefill"]["prefill_s"]
    out = {"flops": cost.flops, "kernel_flops": cost.kernel_flops,
           "model_flops": rl.model_flops, "compute_s": rl.compute_s,
           "memory_s": rl.memory_s, "bound_s": bound,
           "measured_s": measured, "roofline_fraction": bound / measured,
           "param_bytes": cell["bytes"], "param_bytes_allocated": grown,
           "trace_s": trace_s, "peak_flops": hw.PEAK_FLOPS_BF16,
           "hbm_bw": hw.HBM_BW}
    log(f"11a roofline: {json.dumps(out)}")
    expect(bound <= measured, "the roofline bound exceeds the measured "
           "prefill: a count or a constant is wrong", bound, measured)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(11)
    rows = []
    for case in split_flash_cases():
        rows.append({**flash_case(torch, case, g), **ptxas_of(
            ptxas, "flash_attention", flash_tag(case))})
        log("kernel " + json.dumps(rows[-1]))
        expect(rows[-1]["kernel"] == "wgmma", "flash kernel", case)
    out["flash_rows"] = rows
    return out


def split_flash_cases() -> list:
    """The per-rank shapes flash runs at in 11b (phi4-mini's heads split
    over two ranks), 11c (one row a microbatch) and 11g (granite's
    heads split over two ranks)."""
    from repro_torch.configs import get_config

    def whole(c):
        return dict(H=c.num_heads, K=c.num_kv_heads, S=FAMILY_LEN,
                    hd=c.head_dim, causal=True, window=None,
                    dtype="bfloat16")

    def split(c):
        return {**whole(c), "B": TP_BATCH, "H": c.num_heads // RANKS,
                "K": c.num_kv_heads // RANKS}
    phi4, granite = get_config("phi4_mini_3b"), get_config("granite_moe_3b")
    return [split(phi4), {**whole(phi4), "B": FAMILY_BATCH // PP_MICRO},
            split(granite)]


def gloo_probe(rank, world, path):
    """Which collectives this torch's gloo accepts for CUDA tensors; the
    answers go to ``path`` as they come (a probe that hangs loses only
    what follows it)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    out = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "accepted"
        except Exception as e:  # the answer, recorded
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        if rank == 0:
            with open(path, "w") as f:
                json.dump(out, f)

    x = torch.full((1024,), float(rank + 1), device=DEVICE)
    attempt("all_reduce", lambda: dist.all_reduce(x.clone()))
    attempt("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty(1024 * world, device=DEVICE), x))
    attempt("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty(1024 // world, device=DEVICE), x))
    attempt("broadcast", lambda: dist.broadcast(x.clone(), src=0))
    attempt("all_to_all_single", lambda: dist.all_to_all_single(
        torch.empty_like(x), x))

    def p2p():
        buf = x.clone()
        op = dist.isend if rank == 0 else dist.irecv
        op(buf, 1 - rank).wait()
        if rank == 1:
            expect(bool((buf == 1).all()), "send/recv delivered other bytes")
    attempt("send_recv", p2p)
    return out


def nccl_probe(rank, world):
    """Two NCCL ranks on one card: an all-reduce (NCCL's own reason goes
    to standard error)."""
    import torch
    import torch.distributed as dist
    os.environ["NCCL_DEBUG"] = "WARN"     # read when the communicator starts
    torch.cuda.set_device(0)
    x = torch.ones(1024, device=DEVICE)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return float(x[0])


def draw_model(torch, cfg, seed: int):
    """``cfg``'s model on the card, weights from ``seed``, as
    ``full_model`` draws them."""
    from repro_torch.models.model import Model
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return Model(cfg, device=DEVICE).init_params(g)


def allocator_blocks(torch, tensors: dict) -> dict:
    """{name: the size of the caching allocator's block that holds the
    tensor's storage}, from ``torch.cuda.memory_snapshot()``."""
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                blocks[addr] = b["size"]
            addr += b["size"]
    return {k: blocks[t.untyped_storage().data_ptr()]
            for k, t in tensors.items()}


def float32_forward(torch, model, fn):
    """``fn`` of ``model``'s float32 copy (float32 activations over the
    same weights, as 10f's), the copy freed after."""
    import dataclasses
    from repro_torch.models.model import Model
    cfg32 = dataclasses.replace(model.cfg, dtype="float32",
                                param_dtype="float32")
    m32 = Model(cfg32, device=DEVICE)
    m32.load_state_dict(model.state_dict())
    out = fn(m32)
    del m32
    torch.cuda.empty_cache()
    return out


def split_check(torch, got, want, want32, label: str) -> dict:
    """11b and 11c: a split computation against one rank's, both against
    the float32 forward (``SPLIT_OF_OWN``)."""
    err, own = rel_err(torch, got, want32), rel_err(torch, want, want32)
    out = {"rel_err_one_rank": rel_err(torch, got, want),
           "rel_err_f32": err, "one_rank_rel_err_f32": own}
    if got.dim() == 3 and got.shape[1] == 1:       # last logits
        top2 = torch.topk(want.float(), 2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min())
        out["top2_margin"] = margin
        if margin > 2 * out["rel_err_one_rank"] * float(want.abs().max()):
            expect(bool((got.argmax(-1) == want.argmax(-1)).all()),
                   label, "argmax differs beyond the tolerance")
    expect(bool(torch.isfinite(got).all()), label, "not finite")
    expect(err <= SPLIT_OF_OWN * own, label, "further from float32 than "
           "the one rank", err, own)
    return out


def rank_pipeline(torch, rank: int, seed: int) -> dict:
    """11c: phi4-mini's 32 layers in two stages of 16 (embedding on stage
    0, final norm and head on stage 1), 4 x 4096 in PP_MICRO
    microbatches; the last hidden state against one rank's forward."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import pipeline_parallel as PP
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    cfg = get_config("phi4_mini_3b")
    mesh = make_host_mesh(pipe=RANKS, device=DEVICE)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 12)
    tokens = torch.randint(0, cfg.vocab_size, (FAMILY_BATCH, FAMILY_LEN),
                           generator=g, device=DEVICE)
    model = draw_model(torch, cfg, seed)
    with torch.no_grad():
        want = want32 = None
        if rank == 0:
            want = model(tokens, mode="hidden")[0]
            want32 = float32_forward(torch, model, lambda m: m(
                tokens, mode="hidden")[0])
        per = cfg.num_layers // RANKS
        mine = model.layers[rank * per:(rank + 1) * per]
        # this stage's parameters alone stay on the card
        if rank == 0:
            model._parameters["lm_head"] = None
        else:
            model._parameters["embed"] = None
        model.layers = mine
        torch.cuda.empty_cache()
        held = sum(p.numel() * p.element_size() for p in model.parameters())
        x = (model._embed(tokens) if rank == 0 else torch.zeros(
            FAMILY_BATCH, FAMILY_LEN, cfg.d_model, device=DEVICE,
            dtype=getattr(torch, cfg.dtype)))

        def stage(layers, h):
            for layer in layers:
                h = layer(h)[0]
            return h

        for k in PP.HOST_COPY_BYTES:
            PP.HOST_COPY_BYTES[k] = 0
        reset_model_launches()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        h = PP.pipeline_forward(stage, mine, x, mesh=mesh,
                                num_microbatches=PP_MICRO)
        got = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
        logits = (model._logits(got[:, -1:]) if rank == RANKS - 1 else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_model_launches()
        out = {"wall_s": wall, "launches": launches,
               "stage_param_bytes": held,
               "host_copy_bytes": dict(PP.HOST_COPY_BYTES),
               "bubble": (RANKS - 1) / (PP_MICRO + RANKS - 1),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        expect(launches["flash_attention"] == per * PP_MICRO and
               launches["flash_wgmma"] == per * PP_MICRO,
               "11c flash launches a stage (its layers, each microbatch)",
               launches)
        if logits is not None:
            expect(bool(torch.isfinite(logits).all()), "11c logits")
        if rank == 0:
            out.update(split_check(torch, got, want, want32,
                                   "11c pipeline hidden"))
    del model, mine, x, h, got, want, want32
    torch.cuda.empty_cache()
    return out


def place_shards(torch, cfg, full: dict, mesh, rules, label: str):
    """The card keeps only this rank's shards of the host checkpoint
    ``full``, each in a fresh segment (no cached block of another size
    to fit it into): what specs.allocated_bytes counts. Returns the
    placed DTensors, a meta model bound to them, and their bytes: exact,
    as memory_allocated grew, and the blocks off the allocator's count."""
    from repro_torch.distributed.elastic import reshard
    from repro_torch.launch.specs import allocated_bytes
    from repro_torch.models.model import Model
    from repro_torch.training.train_loop import _bind
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    placed = reshard(full, mesh, rules)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    # what the allocator gave each shard, against its own count
    locals_ = {k: v.to_local() for k, v in placed.items()}
    got = allocator_blocks(torch, locals_)
    nbytes = {k: t.numel() * t.element_size() for k, t in locals_.items()}
    odd = {k: (n, got[k]) for k, n in nbytes.items()
           if got[k] != allocated_bytes(n)}
    shell = Model(cfg, device="meta")
    _bind(shell, placed)
    out = {"param_bytes": sum(nbytes.values()),
           "param_bytes_allocated": held,
           "blocks_off_the_count": odd}
    expect(held == sum(got.values()), label, "memory grew by other than "
           "the parameters' blocks", held, sum(got.values()))
    # a block the allocator did not split keeps its segment's remainder,
    # at most 1 MiB (kSmallSize), with a request of 1 MiB or more; every
    # other block is the count's
    expect(all(n >= 1 << 20 and 0 < b - allocated_bytes(n) <= 1 << 20
               for n, b in odd.values()), label, "a shard's block is none "
           "the allocator gives its size", odd)
    return placed, shell, out


def rank_tensor_parallel(torch, rank: int, seed: int) -> dict:
    """11b: phi4-mini's prefill, 2 x 4096, under make_rules("prefill")
    on a (data 1, model 2) mesh: each rank draws the whole weights and
    reshards them from a host copy; its parameters' memory, its prefill
    time and flash launches, and the last logits against one rank's
    prefill."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_rules, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config("phi4_mini_3b")
    mesh = make_host_mesh(1, RANKS, device=DEVICE)
    rules = make_rules("prefill", mesh)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, (TP_BATCH, FAMILY_LEN),
                           generator=g, device=DEVICE)
    model = draw_model(torch, cfg, seed)
    with torch.no_grad():
        want = want32 = None
        if rank == 0:
            want = model(tokens, mode="last_logits")[0].cpu()
            want32 = float32_forward(torch, model, lambda m: m(
                tokens, mode="last_logits")[0].cpu())
        # the drawn weights as a logical checkpoint on the host
        full = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model
        placed, shell, out = place_shards(torch, cfg, full, mesh, rules,
                                          "11b")
        del full
        for run in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            reset_model_launches()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_rules(rules):
                logits, _ = shell(tokens, mode="last_logits")
            torch.cuda.synchronize()
            out[f"{run}_s"] = time.perf_counter() - t0
            out["launches"] = read_model_launches()
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        expect(out["launches"]["flash_attention"] == cfg.num_layers and
               out["launches"]["flash_wgmma"] == cfg.num_layers,
               "11b flash launches a rank", out["launches"])
        out["placements"] = str(logits.placements)
        got, sent = to_host_gathered(torch, logits)
        out["host_gather_bytes"] = sent
        if rank == 0:
            out.update(split_check(torch, got, want, want32,
                                   "11b tensor-parallel logits"))
    del placed, shell, logits, want
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def first_route(record: dict):
    """Record the first MoE call's routing (layer 0's): ``record`` gets
    its input groups and all five of ``route``'s outputs (on the card),
    and its float32 probabilities, expert_idx and keep, on the host."""
    from repro_torch.models import moe
    route = moe.route

    def recorded(p, xg, cfg):
        out = route(p, xg, cfg)
        if not record:
            record.update(xg=xg.detach(), probs=out[0].detach().cpu(),
                          idx=out[1].cpu(), keep=out[3].cpu(),
                          decisions=tuple(t.detach() for t in out))
        return out

    moe.route = recorded
    try:
        yield record
    finally:
        moe.route = route


def route_flips(torch, got: dict, want: dict, k: int) -> dict:
    """Layer 0's routing on the split against one rank's, both (n, B, g,
    k). The split's layer-0 input is rounded otherwise (its attention's
    output projection is summed over the ranks), so the router's
    probabilities differ by ``dp`` = max|p_split - p_one| of a token: a
    token whose experts differ, or come in another order, must have two
    neighbours among its k + 1 largest probabilities within 2 dp of each
    other (a near-tie). A flip moves
    the queue places of later tokens of its group, so a token whose
    experts agree may still keep or drop otherwise, but only in a group
    with a flip."""
    moved = (got["idx"] != want["idx"]).any(-1)
    kept = (got["keep"] != want["keep"]).any(-1) & ~moved
    dp = (got["probs"] - want["probs"]).abs().amax(-1)
    top = torch.sort(want["probs"], dim=-1, descending=True).values
    gaps = top[..., :k] - top[..., 1:k + 1]
    near = gaps.amin(-1) <= 2 * dp
    flipped_group = moved.any(-1, keepdim=True)
    out = {"tokens": int(moved.numel()),
           "tokens_other_experts": int(moved.sum()),
           "near_tie_tokens": int(near.sum()),
           "tokens_other_keep_only": int(kept.sum()),
           "max_dprob": float(dp.max())}
    expect(bool((near | ~moved).all()), "11g routing differs from one "
           "rank's away from a near-tie", out)
    expect(bool((flipped_group | ~kept).all()), "11g keep differs from "
           "one rank's in a group without a flip", out)
    return out


def same_input_route(torch, got: dict, router, cfg) -> dict:
    """One rank's routing of the split's own layer-0 input (the whole
    router, no rules) against the split's: equal, except at a token
    whose k + 1 largest probabilities have two neighbours within
    ROUTE_F32_TIE (float32 rounding of the router's product)."""
    from repro_torch.models import moe
    k = cfg.moe.experts_per_token
    probs, idx, _, keep, _ = moe.route({"router": router}, got["xg"], cfg)
    want = {"probs": probs.cpu(), "idx": idx.cpu(), "keep": keep.cpu()}
    moved = ((got["idx"] != want["idx"]) | (got["keep"] != want["keep"])
             ).any(-1)
    top = torch.sort(want["probs"], dim=-1, descending=True).values
    near = (top[..., :k] - top[..., 1:k + 1]).amin(-1) <= ROUTE_F32_TIE
    out = {"tokens": int(moved.numel()), "tokens_differing": int(moved.sum()),
           "float32_tie_tokens": int(near.sum()),
           "max_dprob": float((got["probs"] - want["probs"]).abs().max())}
    expect(bool((near | ~moved).all()), "11g routing of the same input "
           "differs from one rank's away from a float32 tie", out)
    return out


def nested(flat: dict) -> dict:
    """``{"a.b": t}`` as ``{"a": {"b": t}}``."""
    out: dict = {}
    for k, v in flat.items():
        *head, last = k.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def moe_layer_split(torch, cfg, mesh, rules, shell, layer0: dict,
                    got: dict, rank: int) -> dict:
    """11g: layer 0's MoE alone on the split's own layer-0 input (in
    float32, so the combine's sum is not rounded again) with the split's
    routing decisions, under the rules, against one rank's layer
    (``layer0``, its whole parameters on the card) with the same
    decisions: this rank's expert products bit for bit, the layer within
    ``MOE_COMBINE_ROUNDINGS`` float32 roundings of max|expert output|."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import placements, use_rules
    from repro_torch.models import moe
    expect(cfg.moe.experts_per_token == MOE_TOP_K, "11g top-k")
    n, B, g, d = got["xg"].shape
    x = got["xg"].transpose(0, 1).reshape(B, n * g, d).float()
    decisions, eouts = got["decisions"], []
    route, down = moe.route, moe._down

    def recorded_down(h, w):
        out = down(h, w)
        eouts.append(out)
        return out

    moe.route = lambda p, xg, cfg_: decisions
    moe._down = recorded_down
    try:
        with use_rules(rules):
            xd = distribute_tensor(x, mesh, placements(
                rules.resolve("batch", "seq", "embed"), mesh))
            split, _ = moe.moe_forward(shell.layers[0].ffn, xd, cfg)
            split = split.full_tensor()
        split_eout = eouts.pop()
        one, _ = moe.moe_forward(layer0, x, cfg)
        one_eout = eouts.pop()
    finally:
        moe.route, moe._down = route, down
    E_l = split_eout.shape[1]
    e0 = rank * E_l
    scale = float(one_eout.abs().max().float())
    bound = MOE_COMBINE_ROUNDINGS * 2.0 ** -24 * scale
    err = float((split - one).abs().max())
    out = {"experts": [e0, e0 + E_l],
           "products_bitwise": bool(torch.equal(
               split_eout, one_eout[:, e0:e0 + E_l])),
           "products_max_abs_diff": float(
               (split_eout.float() - one_eout[:, e0:e0 + E_l].float())
               .abs().max()),
           "layer_max_abs_err": err, "layer_bound": bound,
           "max_abs_expert_out": scale}
    expect(bool(torch.isfinite(split).all()), "11g MoE layer not finite")
    expect(out["products_bitwise"], "11g a rank's expert products differ "
           "from one rank's", out)
    expect(err <= bound, "11g MoE layer differs from one rank's beyond "
           "float32 rounding of the combine", out)
    del x, split, one, split_eout, one_eout, eouts
    return out


def rank_expert_parallel(torch, rank: int, seed: int) -> dict:
    """11g: granite-moe-3b's prefill, 2 x 4096, under make_rules("prefill")
    on a (data 1, model 2) mesh: 20 of the 40 experts a rank (expert
    parallelism) and 12 of the 24 heads; each rank draws the whole
    weights and reshards them from a host copy, as 11b. Its parameters'
    memory, its prefill time and flash launches, the bytes its
    collectives hand gloo, the last logits against one rank's prefill
    and layer 0's routing against one rank's."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_rules, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.roofline.analysis import analyze_step
    cfg = get_config("granite_moe_3b")
    mesh = make_host_mesh(1, RANKS, device=DEVICE)
    rules = make_rules("prefill", mesh)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 17)
    tokens = torch.randint(0, cfg.vocab_size, (TP_BATCH, FAMILY_LEN),
                           generator=g, device=DEVICE)
    model = draw_model(torch, cfg, seed)
    want_route, got_route = {}, {}
    with torch.no_grad():
        want = want32 = None
        if rank == 0:
            with first_route(want_route):
                want = model(tokens, mode="last_logits")[0].cpu()
            want32 = float32_forward(torch, model, lambda m: m(
                tokens, mode="last_logits")[0].cpu())
        full = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model
        layer0 = nested({k.removeprefix("layers.0.ffn."): v.to(DEVICE)
                         for k, v in full.items()
                         if k.startswith("layers.0.ffn.")})
        placed, shell, out = place_shards(torch, cfg, full, mesh, rules,
                                          "11g")
        del full
        E, H = cfg.moe.num_experts, cfg.num_heads
        held = {"experts": placed["layers.0.ffn.experts.w_up"]
                .to_local().shape[0],
                "heads": placed["layers.0.mix.wq"].to_local().shape[1]
                // cfg.head_dim}
        out["rank_holds"] = held
        expect(held == {"experts": E // RANKS, "heads": H // RANKS},
               "11g a rank's experts and heads", held)
        for run in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            reset_model_launches()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_rules(rules), first_route(got_route):
                logits, _ = shell(tokens, mode="last_logits")
            torch.cuda.synchronize()
            out[f"{run}_s"] = time.perf_counter() - t0
            out["launches"] = read_model_launches()
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            got_route = {} if run == "cold" else got_route
        expect(out["launches"]["flash_attention"] == cfg.num_layers and
               out["launches"]["flash_wgmma"] == cfg.num_layers,
               "11g flash launches a rank", out["launches"])
        # the operand bytes of every collective one prefill issues, which
        # gloo stages through the host for CUDA tensors (untimed: the
        # tally runs Python on every op)
        dist.barrier()
        with use_rules(rules):
            cost = analyze_step(lambda t: shell(t, mode="last_logits")[0],
                                tokens)
        out["exchange_bytes"] = cost.collective_bytes
        out["exchange_ops"] = cost.collective_ops
        out["placements"] = str(logits.placements)
        got, sent = to_host_gathered(torch, logits)
        out["host_gather_bytes"] = sent
        if rank == 0:
            out.update(split_check(torch, got, want, want32,
                                   "11g expert-parallel logits"))
            out["routing"] = route_flips(torch, got_route, want_route,
                                         cfg.moe.experts_per_token)
            out["routing_same_input"] = same_input_route(
                torch, got_route, placed["layers.0.ffn.router"].to_local(),
                cfg)
        dist.barrier()
        out["moe_layer"] = moe_layer_split(torch, cfg, mesh, rules, shell,
                                           layer0, got_route, rank)
    del placed, shell, logits, want, cost, got_route, want_route, layer0
    torch.cuda.empty_cache()
    return out


def xlstm_f32(torch, seed: int):
    """xlstm-350m at full width, float32 activations and weights (8d's),
    drawn from ``seed``; its parameters and a DP_BATCH x DP_LEN batch
    pair per step."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(XLSTM), dtype="float32",
                              param_dtype="float32")
    model = draw_model(torch, cfg, seed)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 13)
    batches = [torch.randint(0, cfg.vocab_size, (DP_BATCH, DP_LEN + 1),
                             generator=g, device=DEVICE) for _ in range(2)]
    return cfg, params, [(b[:, :-1].int(), b[:, 1:].int()) for b in batches]


def grad_rel(torch, got: dict, want: dict) -> dict:
    return {k: rel_err(torch, got[k], want[k]) for k in want}


def rank_data_parallel(torch, rank: int, seed: int) -> dict:
    """11d: xlstm-350m's train step (loss and gradients) under
    make_rules("train", dp_only=True) on a (data 2, model 1) mesh, each
    rank two of the four rows; the all-reduced gradients and the loss
    against one rank's step on the same weights and rows."""
    from repro_torch.distributed.elastic import reshard
    from repro_torch.distributed.sharding import (make_rules, placements,
                                                  use_rules)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.training.train_loop import TrainConfig, make_grad_fn
    from torch.distributed.tensor import Replicate, distribute_tensor
    cfg, params, batches = xlstm_f32(torch, seed)
    inputs, targets = batches[0]
    tc = TrainConfig(device=DEVICE)
    grad_fn = make_grad_fn(cfg, tc, model=Model(cfg, device="meta"))
    out = {}
    if rank == 0:                      # one rank: the reference, its spread
        (loss1, _), g1 = grad_fn(params, inputs, targets)
        bumped = {k: v * (1 + TRAIN_PERTURB) for k, v in params.items()}
        _, g2 = grad_fn(bumped, inputs, targets)
        spread = grad_rel(torch, g2, g1)
        del bumped, g2
    mesh = make_host_mesh(RANKS, 1, device=DEVICE)
    rules = make_rules("train", mesh, dp_only=True)
    placed = reshard(params, mesh, rules)
    rows = placements(rules.resolve("batch", None), mesh)
    t_in, t_tgt = (distribute_tensor(t, mesh, rows, src_data_rank=None)
                   for t in (inputs, targets))
    reset_model_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_rules(rules):
        (loss, _), grads = grad_fn(placed, t_in, t_tgt)
        whole = {k: g.redistribute(mesh, [Replicate()] * mesh.ndim)
                 .to_local() for k, g in grads.items()}   # the all-reduce
        loss = float(loss.full_tensor())
    torch.cuda.synchronize()
    out.update(step_s=time.perf_counter() - t0,
               launches=read_model_launches(), loss=loss,
               local_rows=int(t_in.to_local().shape[0]))
    expect(out["launches"]["mlstm_chunkwise"] == 12, "11d mLSTM launches a "
           "rank", out["launches"])
    expect(out["local_rows"] == DP_BATCH // RANKS, "11d rows a rank")
    if rank == 0:
        err = grad_rel(torch, whole, g1)
        bound = {k: max(TRAIN_GRAD_RTOL, 2 * spread[k]) for k in err}
        worst = max(err, key=lambda k: err[k] / bound[k])
        out.update(loss_one_rank=float(loss1),
                   loss_rel=abs(loss - float(loss1)) / abs(float(loss1)),
                   grad_rel_max=max(err.values()), worst_leaf=worst,
                   worst_err=err[worst], worst_bound=bound[worst])
        expect(out["loss_rel"] <= DP_LOSS_RTOL, "11d loss",
               out["loss_rel"])
        bad = {k: (err[k], bound[k]) for k in err if err[k] > bound[k]}
        expect(not bad, "11d gradients differ from one rank's", bad)
        del g1
    del placed, grads, whole
    torch.cuda.empty_cache()
    return out


def rank_compressed(torch, rank: int, seed: int) -> dict:
    """11e: two steps of 11d's model, each rank's own rows' gradient
    reduced by compressed_psum_pod over a (pod 2) mesh with error
    feedback, against the plain mean; the error state after step 1 bit
    for bit."""
    from repro_torch.distributed.grad_compression import (
        compressed_psum_pod, dequantize_int8, psum_mean, quantize_int8)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                adamw_update)
    from repro_torch.training.train_loop import TrainConfig, make_grad_fn
    cfg, params, batches = xlstm_f32(torch, seed)
    mesh = make_host_mesh(1, 1, pod=RANKS, device=DEVICE)
    grad_fn = make_grad_fn(cfg, TrainConfig(device=DEVICE),
                           model=Model(cfg, device="meta"))
    opt, opt_cfg = adamw_init(params), AdamWConfig(lr=3e-3)
    rows = slice(rank * DP_BATCH // RANKS, (rank + 1) * DP_BATCH // RANKS)
    err, out = None, {"steps": []}
    reset_model_launches()
    for step, (inputs, targets) in enumerate(batches):
        _, g = grad_fn(params, inputs[rows], targets[rows])
        t0 = time.perf_counter()
        red, new_err = compressed_psum_pod(g, mesh, error=err)
        torch.cuda.synchronize()
        reduce_s = time.perf_counter() - t0
        sent = {k: gk.float() + (err[k] if err is not None else 0)
                for k, gk in g.items()}
        mean = psum_mean(sent, mesh, "pod")
        worst = max((float((red[k].float() - mean[k]).abs().max())
                     / max(float(mean[k].abs().max()), 1e-30), k)
                    for k in g)
        expect(worst[0] <= COMPRESS_ATOL_OF_MAX, "11e compressed mean",
               step, worst)
        if step == 0:
            for k, gk in g.items():
                gf = gk.float()
                q, s = quantize_int8(gf)
                want = gf - dequantize_int8(q.to(torch.int32), s,
                                            gf.numel(), gf.shape)
                expect(torch.equal(new_err[k], want), "11e error state "
                       "after step 1 differs from gf - deq(quant(gf))", k)
        out["steps"].append({"worst_rel": worst[0], "worst_leaf": worst[1],
                             "reduce_s": reduce_s,
                             "payload_bytes": 4 * sum(
                                 -(-v.numel() // 256) * 256
                                 for v in g.values())})
        with torch.no_grad():
            params, opt, _ = adamw_update(opt_cfg, red, opt, params)
        err = new_err
    out["launches"] = read_model_launches()
    expect(out["launches"]["mlstm_chunkwise"] == 12 * len(batches),
           "11e mLSTM launches", out["launches"])
    return out


def elastic_pipeline(seed: int, cfg):
    """11f's data: DP_BATCH x DP_LEN batches of a Markov corpus."""
    from repro_torch.data.pipeline import DataPipeline, TokenDataset
    from repro_torch.data.synthetic import markov_corpus
    tokens = markov_corpus(DP_BATCH * DP_LEN * 32, cfg.vocab_size, seed=seed)
    return DataPipeline(TokenDataset(tokens,
                                     shard_tokens=DP_BATCH * DP_LEN * 2),
                        batch=DP_BATCH, seq_len=DP_LEN, seed=seed)


def elastic_train(torch, cfg, seed: int, mesh, root: str | None, steps: int,
                  head: dict | None, perturb: float = 0.0):
    """xlstm-350m (float32) trained to ``steps`` under the DP rules on
    ``mesh`` (None: one rank, no rules), committing every two steps to a
    catalog over the store at ``root`` whose ``main`` starts at ``head``'s
    tables, its initial weights scaled by ``1 + perturb``; returns the
    run's history and its head."""
    from repro_torch.checkpoints.checkpointing import CheckpointManager
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.store import FileStore
    from repro_torch.distributed.elastic import reshard
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_sharded_train_step,
                                                 train)
    opt = AdamWConfig(lr=3e-3)
    tc = TrainConfig(steps=steps, ckpt_every=2, device=DEVICE)
    ckpt = None
    if root is not None:
        catalog = Catalog(FileStore(root))
        if head:
            catalog.write_tables("main", head, message="restore head")
        ckpt = CheckpointManager(catalog)
    params = {k: v.detach() * (1 + perturb) for k, v in
              draw_model(torch, cfg, seed).state_dict().items()}
    kw = {"params": params}
    if mesh is not None:
        rules = make_rules("train", mesh, dp_only=True)
        kw = {"params": reshard(params, mesh, rules),
              "opt_state": reshard(adamw_init(params), mesh, rules),
              "jit_fn": make_sharded_train_step(
                  cfg, opt, tc, mesh, rules, model=Model(cfg, device="meta"))}
    reset_model_launches()
    res = train(cfg, pipeline=elastic_pipeline(seed, cfg), opt_cfg=opt,
                tc=tc, ckpt=ckpt, **kw)
    return {"history": [(h["step"], h["loss"], h["step_time_s"])
                        for h in res["history"]],
            "launches": read_model_launches(),
            "head": dict(ckpt.catalog.head("main").tables) if ckpt else None}


def rank_elastic(torch, rank: int, seed: int, root: str) -> dict:
    """11f, first part: two DP steps on the two ranks, committed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    cfg = dataclasses.replace(get_config(XLSTM), dtype="float32",
                              param_dtype="float32")
    mesh = make_host_mesh(RANKS, 1, device=DEVICE)
    out = elastic_train(torch, cfg, seed, mesh,
                        os.path.join(root, f"rank{rank}"), 2, None)
    expect([h[0] for h in out["history"]] == [0, 1], "11f steps",
           out["history"])
    return out


def phase11_rank(rank, world, seed, root, only=None):
    """The phase-11 group's rank: 11c, 11b, 11g, 11d, 11e, 11f's first
    part, one after another, each freeing what it drew; or the one path
    named ``only``."""
    import torch
    torch.cuda.set_device(0)            # both ranks share the one card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, fn in (("pipeline", rank_pipeline),
                     ("tensor_parallel", rank_tensor_parallel),
                     ("expert_parallel", rank_expert_parallel),
                     ("data_parallel", rank_data_parallel),
                     ("compressed", rank_compressed)):
        if only not in (None, name):
            continue
        t0 = time.perf_counter()
        out[name] = fn(torch, rank, seed)
        out[name]["phase_s"] = time.perf_counter() - t0
        log(f"11 rank {rank} {name}: {json.dumps(out[name])}")
        torch.cuda.empty_cache()
    if only is not None:
        return out
    t0 = time.perf_counter()
    out["elastic"] = rank_elastic(torch, rank, seed, root)
    out["elastic"]["phase_s"] = time.perf_counter() - t0
    log(f"11 rank {rank} elastic: {json.dumps(out['elastic'])}")
    return out


def phase_distributed(torch, seed: int, families: dict, ptxas: dict
                      ) -> dict:
    """11: 11a in this process; the probes and 11b-11f's ranks in groups
    of RANKS processes on the one card; 11f's restore here."""
    import dataclasses
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_ranks, make_host_mesh, run_ranks
    out = {"roofline": phase_roofline(torch, families, ptxas)}
    tmp = tempfile.mkdtemp(prefix="phase11-")
    try:
        # which collectives gloo takes for CUDA tensors; NCCL, two ranks
        probe_file = os.path.join(tmp, "gloo_probe.json")
        try:
            run_ranks(gloo_probe, RANKS, probe_file, backend="gloo",
                      timeout_s=PROBE_TIMEOUT_S)
        except RuntimeError as e:
            log(f"11 gloo probe group failed: {str(e)[:300]}")
        out["gloo_cuda"] = (json.load(open(probe_file))
                            if os.path.exists(probe_file) else {})
        log(f"11 gloo with CUDA tensors: {json.dumps(out['gloo_cuda'])}")
        try:
            got = run_ranks(nccl_probe, RANKS, backend="nccl",
                            timeout_s=PROBE_TIMEOUT_S)
            out["nccl_two_ranks_one_card"] = f"accepted: {got}"
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines()
                     if "Duplicate" in ln or "ncclInvalidUsage" in ln]
            out["nccl_two_ranks_one_card"] = " | ".join(lines[-2:])[:600]
        log(f"11 NCCL, two ranks on one card: "
            f"{out['nccl_two_ranks_one_card']}")

        t0 = time.perf_counter()
        ranks = run_ranks(phase11_rank, RANKS, seed, tmp, backend="gloo",
                          timeout_s=RANK_TIMEOUT_S)
        out["group_s"] = time.perf_counter() - t0
        for name in ("pipeline", "tensor_parallel", "expert_parallel",
                     "data_parallel", "compressed", "elastic"):
            out[name] = [r[name] for r in ranks]
        # 11f: the parent restores the ranks' head onto a one-card mesh
        cfg = dataclasses.replace(get_config(XLSTM), dtype="float32",
                                  param_dtype="float32")
        head = out["elastic"][0]["head"]
        root = os.path.join(tmp, "rank0")
        init_ranks(0, 1, os.path.join(tmp, "parent-rendezvous"), "gloo")
        try:
            mesh = make_host_mesh(1, 1, device=DEVICE)
            resumed = elastic_train(torch, cfg, seed, mesh, root, 4, head)
        finally:
            dist.destroy_process_group()
        # the same commit restored without a mesh; one rank throughout,
        # and the same at weights moved by TRAIN_PERTURB: the spread
        # float32 leaves a run's losses after AdamW steps
        plain = elastic_train(torch, cfg, seed, None, root, 4, head)
        straight = elastic_train(torch, cfg, seed, None, None, 4, None)
        bumped = elastic_train(torch, cfg, seed, None, None, 4, None,
                               perturb=TRAIN_PERTURB)

        def rel(a, b):
            return [abs(x[1] - y[1]) / abs(y[1]) for x, y in zip(a, b)]
        steps = [h[0] for h in resumed["history"]]
        out["restore"] = {
            "dp_steps": out["elastic"][0]["history"],
            "resumed": resumed["history"], "plain_resume": plain["history"],
            "uninterrupted": straight["history"],
            "rel_plain": rel(resumed["history"], plain["history"]),
            "rel_uninterrupted": rel(resumed["history"],
                                     straight["history"][2:]),
            "spread": rel(bumped["history"], straight["history"])[2:],
            "launches": resumed["launches"]}
        log(f"11f restore: {json.dumps(out['restore'])}")
        r = out["restore"]
        expect(steps == [2, 3] and [h[0] for h in plain["history"]]
               == [2, 3], "11f resumed at", steps)
        expect(max(r["rel_plain"]) <= DP_LOSS_RTOL, "11f the one-card "
               "mesh's steps differ from the plain restore's",
               r["rel_plain"])
        bound = [max(DP_LOSS_RTOL, 2 * x) for x in r["spread"]]
        expect(all(a <= b for a, b in zip(r["rel_uninterrupted"], bound)),
               "11f resumed losses differ from the uninterrupted run",
               r["rel_uninterrupted"], bound)
        tp_want = dryrun_param_bytes(torch, "phi4_mini_3b", TP_BATCH,
                                     FAMILY_LEN, (1, RANKS))
        out["tp_dryrun_param_bytes"] = tp_want["allocated"]
        for r, tp in enumerate(out["tensor_parallel"]):
            expect(tp["param_bytes"] == tp_want["bytes"], "11b rank", r,
                   "parameter bytes differ from the dry-run's",
                   tp["param_bytes"], tp_want["bytes"])
            log(f"11b rank {r}: parameters {tp['param_bytes']} B (dry-run "
                f"{tp_want['bytes']}); memory_allocated grew "
                f"{tp['param_bytes_allocated']} B, the dry-run's allocator "
                f"count {tp_want['allocated']}; blocks off the count "
                f"{tp['blocks_off_the_count']}")
        out["ep_dryrun_param_bytes"] = expert_parallel_bytes(
            torch, out["expert_parallel"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("pipeline", "tensor_parallel", "expert_parallel",
                 "data_parallel", "compressed", "elastic"):
        log(f"11 {name}: {json.dumps(out[name])}")
    return out


def expert_parallel_bytes(torch, ranks: list) -> int:
    """11g: each rank's parameter bytes against the dry-run's count of
    the same cell; returns the dry-run's allocator count."""
    want = dryrun_param_bytes(torch, "granite_moe_3b", TP_BATCH, FAMILY_LEN,
                              (1, RANKS))
    for r, ep in enumerate(ranks):
        expect(ep["param_bytes"] == want["bytes"], "11g rank", r,
               "parameter bytes differ from the dry-run's",
               ep["param_bytes"], want["bytes"])
        log(f"11g rank {r}: parameters {ep['param_bytes']} B (dry-run "
            f"{want['bytes']}); memory_allocated grew "
            f"{ep['param_bytes_allocated']} B, the dry-run's allocator "
            f"count {want['allocated']}; collectives' operand bytes "
            f"{ep['exchange_bytes']}")
    return want["allocated"]


def phase_expert_parallel(torch, seed: int) -> dict:
    """11g alone (``--only 11g``): its group of RANKS ranks on the card."""
    import tempfile
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phase11g-") as tmp:
        ranks = run_ranks(phase11_rank, RANKS, seed, tmp, "expert_parallel",
                          backend="gloo", timeout_s=RANK_TIMEOUT_S)
    out = {"group_s": time.perf_counter() - t0,
           "expert_parallel": [r["expert_parallel"] for r in ranks]}
    out["ep_dryrun_param_bytes"] = expert_parallel_bytes(
        torch, out["expert_parallel"])
    log(f"11 expert_parallel: {json.dumps(out['expert_parallel'])}")
    return out


def phase11_paths(dist_out: dict) -> dict:
    """{kernel: {path: launches}} of phase 11, each path's launches over
    its ranks."""
    def total(name, kernel):
        return sum(r["launches"][kernel] for r in dist_out[name])
    return {"flash_attention": {
                f"tp_prefill_{TP_BATCH}x{FAMILY_LEN}":
                    total("tensor_parallel", "flash_attention"),
                f"ep_prefill_{TP_BATCH}x{FAMILY_LEN}":
                    total("expert_parallel", "flash_attention"),
                f"gpipe_{FAMILY_BATCH}x{FAMILY_LEN}":
                    total("pipeline", "flash_attention")},
            "mlstm_chunkwise": {
                f"dp_step_{DP_BATCH}x{DP_LEN}":
                    total("data_parallel", "mlstm_chunkwise"),
                "compressed_2_steps": total("compressed", "mlstm_chunkwise"),
                "elastic_2_dp_steps": total("elastic", "mlstm_chunkwise"),
                "elastic_restore_2_steps":
                    dist_out["restore"]["launches"]["mlstm_chunkwise"]}}


# phase 13: at phi4-mini's decode cell (96 sessions, 24 heads over 8, hd
# 128, a 4096-slot ring) with 2048 and 4096 live slots, at granite's hd
# 64, and recurrentgemma's hd 256 (16 heads over 1) with its local window
# of 2048 in a 4096-slot ring
DECODE_MAIN = dict(B=96, K=8, g=3, hd=128, smax=4096, pos=2047, window=None)
DECODE_CASES = [DECODE_MAIN, {**DECODE_MAIN, "pos": 4095},
                dict(B=32, K=8, g=3, hd=64, smax=4096, pos=3071, window=None),
                dict(B=4, K=1, g=16, hd=256, smax=4096, pos=3000,
                     window=2048)]
DECODE_FLIPS = 4                # tests/test_decode_attention_kernel.py


def decode_case(torch, case: dict, g) -> dict:
    """One decode attention case: the kernels against their plain
    version, within the test's bound and below the control's error (the
    plain version with p left in float32), and the times."""
    import math
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    B, K, gq, hd, smax, pos, window = (case[k] for k in (
        "B", "K", "g", "hd", "smax", "pos", "window"))
    log(f"kernel check: decode_attention {json.dumps(case)}")
    q = torch.randn(B, K, gq, hd, generator=g, device=DEVICE
                    ).to(torch.bfloat16)
    k = torch.randn(B, K, smax, hd, generator=g, device=DEVICE
                    ).to(torch.bfloat16)
    v = torch.randn(B, K, smax, hd, generator=g, device=DEVICE
                    ).to(torch.bfloat16)
    lo, hi = ops.live_range(pos, smax, window)
    live = hi - lo + 1
    qf = q.float()
    call = lambda: ops.decode_attention(q, k, v, pos=pos, window=window)
    alone = lambda: kernel.decode_attention(q, k, v, lo=lo, live=live)
    plain = lambda: ref.decode_attention_ref(q, k, v, pos=pos, window=window)
    before = ops.decode_attention.launches
    got, want = call(), plain()
    torch.cuda.synchronize()
    expect(ops.decode_attention.launches == before + 1, "decode launches")
    expect(got.shape == q.shape and got.dtype == torch.float32,
           "decode output", got.shape, got.dtype)
    expect(torch.equal(got, call()), "decode attention is not repeatable")
    s = torch.einsum("bkgd,bksd->bkgs", qf, k.float()) / math.sqrt(hd)
    s = torch.where(ref.valid_slots(pos, smax, window, q.device), s,
                    ref.NEG_INF)
    p = torch.softmax(s, -1)
    control = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    pmax, vmax = float(p.max()), float(v.float().abs().max())
    del s, p
    atol = DECODE_FLIPS * 2 ** -7 * pmax * vmax + 1e-5 * vmax
    err = float((got - want).abs().max())
    control_err = float((control - want).abs().max())
    del control
    expect(err <= atol, "decode kernel differs from its plain version",
           case, err, atol)
    expect(err < control_err, "decode kernel no closer to the plain "
           "version than the control without bf16 p", err, control_err)
    BK = B * K
    nbytes = (2 * BK * live * hd * 2 + BK * gq * live * 4
              + BK * gq * hd * 4)
    flops = 4 * BK * gq * live * hd
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    del got, want
    return {
        "op": "decode_attention", **case, "live": live,
        "max_abs_err": err, "atol": atol, "control_err": control_err,
        "ms": cuda_ms(torch, call, reps=10),
        "kernel_only_ms": cuda_ms(torch, alone, reps=10),
        **device_cols(alone, "decode_attention", len(kernel.KERNELS)),
        "plain_ms": cuda_ms(torch, plain, reps=3),
        "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
        "flops": flops, "launches_per_call": len(kernel.KERNELS),
    }


def phase_decode_attention(torch, ptxas: dict) -> list:
    g = torch.Generator(device=DEVICE)
    g.manual_seed(13)
    reset_model_launches()
    rows = []
    for case in DECODE_CASES:
        hd = case["hd"]
        rows.append({**decode_case(torch, case, g), **{
            f"{name}_{k}": v for name in ("scores", "weights")
            for k, v in ptxas_of(ptxas, "decode_attention",
                                 f"decode_{name}_kernelILi{hd}EE").items()}})
        log("kernel " + json.dumps(rows[-1]))
        torch.cuda.empty_cache()
    rows[0]["phase_launches"] = read_model_launches()["decode_attention"]
    return rows


def ptxas_kernels(report: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from
    ``nvcc -Xptxas -v`` output."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = [0, 0]
        elif name and "bytes spill stores" in line:
            out[name][1] = int(line.split("bytes stack frame, ")[1].split()[0])
        elif name and "Used " in line and "registers" in line:
            out[name][0] = int(line.split("Used ")[1].split()[0])
    return {k: tuple(v) for k, v in out.items()}


def build_all(args) -> dict:
    """Build the six kernel libraries at once (one nvcc each) and report
    what ptxas says of each kernel; returns {library stem: {kernel:
    (registers, spill bytes)}}."""
    from repro_torch.kernels.decode_attention import kernel as dkernel
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.hash_join import kernel as hkernel
    from repro_torch.kernels.mlstm import kernel as mkernel
    from repro_torch.kernels.rglru import kernel as rkernel
    from repro_torch.kernels.segment_sum import kernel as skernel

    def timed(mod):
        t0 = time.perf_counter()
        lib, report = mod.build(ptxas_report=True)
        return lib, report, time.perf_counter() - t0

    mods = (skernel, hkernel, fkernel, rkernel, mkernel, dkernel)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        built = list(pool.map(timed, mods))
    found = {}
    for lib, report, secs in built:
        stem = lib.name.split("-")[0].removeprefix("lib")
        kernels = found[stem] = ptxas_kernels(report)
        spills = {k: v[1] for k, v in kernels.items() if v[1]}
        most = max((v[0] for v in kernels.values()), default=0)
        log(f"build: {lib.name} in {secs:.1f} s; {len(kernels)} kernels; "
            f"max registers {most}; spilling: {spills or 'none'}")
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            with open(os.path.join(args.log_dir, f"ptxas-lib{stem}.txt"),
                      "w") as f:
                f.write(report)
    return found


def xlstm_paths(xlstm: dict, name: str) -> dict:
    """A kernel's launches on each path of phase 7."""
    return {XLSTM_PREFILL: xlstm["prefill"]["launches"][name],
            f"xlstm_prefill_{XLSTM_LONG_PROMPT}_f32":
                xlstm["long"]["launches"][name],
            "xlstm_serve_loop": xlstm["serve"]["launches"][name],
            "xlstm_launcher": xlstm["launcher"][name]}


def phase_done(name: str, since: float) -> float:
    """Log the host seconds a phase took (against the script's 1200 s
    limit); returns the clock for the next phase."""
    now = time.perf_counter()
    log(f"phase {name}: {now - since:.1f} s")
    return now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None,
                    help="also write ptxas's reports and the kernel table "
                         "here")
    ap.add_argument("--only", choices=["11g", "12", "13"], default=None,
                    help="build the kernels and run this phase alone "
                         "(prints no result line)")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch.kernels.build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not in this checkout ({e})",
              file=sys.stderr)
        return 1
    from repro_torch.examples.tpch import generate
    from repro_torch.roofline import hw
    global HBM_BYTES_PER_S, PEAK_FLOPS
    HBM_BYTES_PER_S = hw.HBM_BW
    PEAK_FLOPS = {"bfloat16": hw.PEAK_FLOPS_BF16,
                  "float32": hw.PEAK_FLOPS_FP32}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    clock = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    ptxas = build_all(args)
    clock = phase_done("1-2 (card, build)", clock)
    if args.only == "11g":
        phase_expert_parallel(torch, args.seed)
        phase_done("11g (expert parallelism)", clock)
        return 0
    if args.only == "13":
        phase_decode_attention(torch, ptxas)
        phase_done("13 (decode attention)", clock)
        return 0
    from repro_torch.examples.bf16_keys import lineitem_for_keys
    if args.only == "12":
        phase12(torch, np, lineitem_for_keys(
            generate(args.sf, args.seed)["lineitem"]), args.log_dir, card)
        phase_done("12 (bfloat16 keys, entry points)", clock)
        return 0

    # 3. kernels
    rows = phase_kernels(torch)
    probe_rows = phase_probe_kernels(torch, ptxas)
    copy_ms = h2d_ms(torch, np)
    log(f"h2d copy of one column set (float64 + int32 ids + bool, "
        f"{N_ROWS} rows, pageable): {copy_ms:.3f} ms")
    if args.log_dir:
        with open(os.path.join(args.log_dir, "kernels.jsonl"), "w") as f:
            for row in rows + probe_rows:
                f.write(json.dumps(row) + "\n")

    clock = phase_done("3 (lakehouse kernels)", clock)

    # 4. the slice, and 5. the query path, on one generated catalog
    t0 = time.perf_counter()
    data = generate(args.sf, args.seed)
    log(f"data: sf={args.sf} seed={args.seed} rows="
        f"{ {k: len(next(iter(v.values()))) for k, v in data.items()} } "
        f"generated in {time.perf_counter() - t0:.2f} s")
    by_path = {}
    by_path["slice"], slice_tables = phase_slice(torch, np, data, args.seed)
    by_path.update(phase_queries(torch, np, data, args.seed))
    clock = phase_done("4-5 (slice, queries)", clock)

    # 5b. partial aggregation over a list of cards, the paper's example
    partial_launches, partial_rows = phase_partial(torch, np, data,
                                                   slice_tables)
    by_path.update(partial_launches)
    if args.log_dir:
        with open(os.path.join(args.log_dir, "kernels.jsonl"), "a") as f:
            for row in partial_rows.values():
                f.write(json.dumps(row) + "\n")
    del slice_tables
    clock = phase_done("5b (partial aggregation, paper example)", clock)

    # 6. the model stack (phase 12 keeps lineitem's numeric columns)
    bf16_lineitem = lineitem_for_keys(data["lineitem"])
    del data
    torch.cuda.empty_cache()
    model_rows = phase_model_kernels(torch, ptxas)
    if args.log_dir:
        with open(os.path.join(args.log_dir, "kernels.jsonl"), "a") as f:
            for row in model_rows:
                f.write(json.dumps(row) + "\n")
    with torch.no_grad():           # serving: no autograd graph
        model = phase_model(torch, np, args.seed)
    log(f"model summary: {json.dumps(model)}")
    clock = phase_done("6 (recurrentgemma-9b)", clock)

    # 7. xlstm-350m
    mlstm_rows = phase_mlstm_kernels(torch, ptxas)
    if args.log_dir:
        with open(os.path.join(args.log_dir, "kernels.jsonl"), "a") as f:
            for row in mlstm_rows:
                f.write(json.dumps(row) + "\n")
    with torch.no_grad():
        xlstm = phase_xlstm(torch, np, args.seed)
    log(f"xlstm summary: {json.dumps(xlstm)}")
    clock = phase_done("7 (xlstm-350m)", clock)

    # 8. training
    grad_rows = phase_kernel_grads(torch)
    train_launches = phase_train_launcher(torch)
    training = phase_train(torch, np, args.seed)
    log(f"train summary: {json.dumps(training)}")
    clock = phase_done("8 (training)", clock)

    # 9. concurrent transactional runs
    concurrent_launches, concurrent_err = phase_concurrent(
        torch, args.sf, args.seed, card)
    by_path.update(concurrent_launches)
    clock = phase_done("9 (concurrent runs)", clock)

    # 12. bfloat16 keys at SF1, and the paper's entry points
    by_path[BF16_PATH] = phase12(torch, np, bf16_lineitem, args.log_dir,
                                 card)
    del bf16_lineitem
    clock = phase_done("12 (bfloat16 keys, entry points)", clock)

    # 10. the model families that reached the port last, and phi4-mini
    torch.cuda.empty_cache()
    family_rows = phase_family_kernels(torch, ptxas)
    if args.log_dir:
        with open(os.path.join(args.log_dir, "kernels.jsonl"), "a") as f:
            for row in family_rows:
                f.write(json.dumps(row) + "\n")
    families = phase_families(torch, args.seed)
    clock = phase_done("10 (model families)", clock)

    # 13. decode attention over the ring cache
    torch.cuda.empty_cache()
    decode_rows = phase_decode_attention(torch, ptxas)
    if args.log_dir:
        with open(os.path.join(args.log_dir, "kernels.jsonl"), "a") as f:
            for row in decode_rows:
                f.write(json.dumps(row) + "\n")
    clock = phase_done("13 (decode attention)", clock)

    # 11. distribution: two ranks on the one card
    torch.cuda.empty_cache()
    dist_out = phase_distributed(torch, args.seed, families, ptxas)
    phase11 = phase11_paths(dist_out)
    phase_done("11 (distribution)", clock)

    kernels = []
    for name, ops_ in (("masked_segment_sum", ("sum",)),
                       ("masked_segment_reduce", ("min", "max"))):
        # the heaviest call each kernel gets on the main path: 5b's
        row = partial_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            "max_abs_err": max([r["max_abs_err"] for r in rows
                                if r["op"] in ops_]
                               + [row["max_abs_err"],
                                  concurrent_err[name]]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel_only_ms": row["kernel_only_ms"],
            "device_ms": row["device_ms"],
            "shape": (f"n={row['n']} S={row['S']} {row['dtype']} "
                      f"{row['op']} ({row['kind']})"),
            "h2d_ms": copy_ms,
        })
    for name in ("hash_probe", "masked_hash_probe"):
        row = next(r for r in probe_rows if (r["op"], r["n"], r["order"])
                   == (name, N_ROWS, "clustered"))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in probe_rows
                               if r["op"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel_only_ms": row["kernel_only_ms"],
            "device_ms": row["device_ms"],
            "shape": f"n={N_ROWS} T={row['T']} clustered",
            "registers": row["registers"], "spill_bytes": row["spill_bytes"],
        })

    grad_launches = {r["op"].split()[0]: 0 for r in grad_rows}
    for r in grad_rows:
        grad_launches[r["op"].split()[0]] += r["launches"]
    for name, main_case, krows, main_path in (
            ("flash_attention", FLASH_MAIN, model_rows, "prefill_4x4096"),
            ("rglru_scan", RGLRU_MAIN, model_rows, "prefill_4x4096"),
            ("mlstm_chunkwise", MLSTM_MAIN, mlstm_rows, XLSTM_PREFILL)):
        row = next(r for r in krows if r["op"] == name
                   and all(r[k] == v for k, v in main_case.items()))
        by_path = {"prefill_4x4096": model["prefill"]["launches"][name],
                   "prefill_2304_f32": model["long"]["launches"][name],
                   "serve_loop": model["serve"]["launches"][name],
                   "launcher": model["launcher"][name],
                   **xlstm_paths(xlstm, name),
                   "grad_check": grad_launches[name],
                   "train_launcher": train_launches[name],
                   TRAIN_PATH: training["run_a"]["launches"][name]}
        family = {path: families[m][k]["launches"][name]
                  for path, (m, k) in FAMILY_PATHS.items()}
        by_path.update(family)
        # phase 11 is this slice's path: its launches, over its ranks
        by_path.update(phase11.get(name, {}))
        launches = (sum(phase11[name].values()) if name in phase11
                    else by_path[main_path])
        extra = {}
        if name == "flash_attention":
            # with phase 10's and 11a's cases
            krows = krows + family_rows + dist_out["roofline"]["flash_rows"]
            extra["phase10_wgmma"] = sum(
                families[m][k]["launches"]["flash_wgmma"]
                for m, k in FAMILY_PATHS.values())
            # phi3-vision's bf16 hd 96 (wgmma), beside float32 hd 96 at
            # the same shape, which stays on simt
            hd96, simt96 = (next(r for r in family_rows if r["hd"] == 96
                                 and r["dtype"] == dt)
                            for dt in ("bfloat16", "float32"))
            extra["hd96"] = {k: hd96[k] for k in (
                "ms", "kernel_only_ms", "device_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "max_abs_err",
                "kernel", "registers", "spill_bytes",
                "control_one_bf16_p")}
            extra["hd96"]["float32"] = {k: simt96[k] for k in (
                "ms", "device_ms", "library_ms", "bound_ms", "kernel")}
            # DeepSeek-V2-Lite's latent attention, qk 192 / v 128
            mla = next(r for r in family_rows if r.get("hd_v") == 128)
            extra["mla"] = {k: mla[k] for k in (
                "ms", "kernel_only_ms", "device_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "max_abs_err",
                "kernel", "registers", "spill_bytes", "launches_by_kernel",
                "control_one_bf16_p", "scale")}
            extra["mla"]["shape"] = json.dumps(
                {k: mla[k] for k in ("B", "H", "K", "S", "hd", "hd_v")})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches,
            "launches_by_path": by_path, **extra,
            "max_abs_err": max(r["max_abs_err"] for r in krows
                               if r["op"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel_only_ms": row["kernel_only_ms"],
            "device_ms": row["device_ms"],
            "shape": json.dumps(main_case), "registers": row["registers"],
            "spill_bytes": row["spill_bytes"],
            **({"kernel": row["kernel"]} if "kernel" in row else {}),
        })
    row = decode_rows[0]
    name = "decode_attention"
    by_path = {"prefill_4x4096": model["prefill"]["launches"][name],
               "serve_loop": model["serve"]["launches"][name],
               f"decode_{LONG_PROMPT}_f32":
                   model["long"]["decode_launches"][name],
               "launcher": model["launcher"][name],
               "xlstm_serve_loop": xlstm["serve"]["launches"][name],
               f"xlstm_decode_{XLSTM_LONG_PROMPT}_f32":
                   xlstm["long"]["decode_launches"][name],
               "xlstm_launcher": xlstm["launcher"][name],
               **{f"{m}_decode_{FAMILY_DECODE_STEPS}_steps":
                  families[m]["decode"]["launches"][name]
                  for m in ("granite", "whisper")},
               f"phi4_decode_{PHI4_DECODE}_f32":
                   families["phi4"]["long"]["decode_launches"][name],
               "kernel_check_13": row["phase_launches"]}
    kernels.append({
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name],
        # the serving path: ServeLoop's decode steps
        "launches": by_path["serve_loop"], "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in decode_rows),
        **{k: row[k] for k in ("launches_per_call", "ms", "plain_ms",
                               "bound_ms", "bound_by",
                               "kernel_only_ms", "device_ms",
                               "scores_registers", "weights_registers",
                               "scores_spill_bytes", "weights_spill_bytes")},
        "library_ms": None, "shape": json.dumps(DECODE_MAIN),
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
