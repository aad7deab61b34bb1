#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` into ``build/``
and then, printing one JSON line per phase:

1. build     — compiles the kernels; prints the build time, the card, and
               the registers and spills (``-Xptxas -v``) of B1's 20
               instantiations (5 pack widths × 1, 2, 4, 8 rows a
               group; none may spill), B8's tensor-core kernel, B3, B6's
               kernels, the batched crop planner and B5;
2. extract   — the main path at ECMWF's regular Gaussian F320 grid
               (640 × 1280) × ERA5's 37 pressure levels × 8 datetimes,
               float64 (1.94 GB on the card):
               ``PolytopeExtractor(cube, device_planner=True,
               burst_gather=True)`` on country, seam-box and
               all-levels requests; plans must equal the host
               ``Slicer``'s and values ``flat[plan.offsets]``, byte for
               byte, and every request must launch the planning kernel
               once and gather_plan_runs (B2) once, gather_rows never;
3. serve     — ``ExtractionService(cube).submit_batch`` over 64
               Zipf-drawn requests in 4 windows with the payload on the
               card: one gather_union_slices launch per window with a
               non-empty plan, gather_rows never; then a plain extract
               (``burst_gather=False``) of Germany over all levels,
               whose read is one gather_rows (B1) launch;
4. kernels   — holds each kernel byte for byte against its plain
               PyTorch version on the card, on the inputs the main path
               gave it: gather_plan_runs on every plan of phase 2 (and
               on runs that end at the payload's last element, of
               length 1, longer than 128, and whose source and output
               are not congruent mod 16), gather_union_slices on every
               window of phase 3, plan_runs_2d on the jobs of the
               country, seam and all-levels requests in float64 and
               float32;
5. bfs_layer — one BFS layer of Algorithm 1 as a batch: every
               (triangle, latitude row) pair of phase 2's country and
               seam-box polygons on the F320 grid, packed with
               ``pack_polytopes`` and cut by slice_batch at k = 0; the
               kernel must equal its plain version byte for byte, and
               ``unpack_sliced`` the host ``slice_vertices`` +
               ``convex_hull_prune`` on every pair;
6. batched   — ``batched_plan_2d``, ``batched_plan_runs_2d`` and
               ``batched_extract_2d`` on one F320 field (float32), 256
               country-triangle crops at seeded random shifts
               (``batched_crops``), the axes handed over as numpy
               arrays; the lattice and the extract must each be one
               launch of the batched crop planner (``batched_plan_2d``,
               B4's cut inside it) and nothing else, the runs one
               plan_runs_2d (B3); lattice, runs and values byte-equal to
               the plain versions (the same calls with ``device="cpu"``),
               values equal to ``field[offsets]``, and each planner
               launch and B3 byte-equal on the inputs the path gave
               them; B4 on its own (on no path now) byte-equal on the
               path's (polytope, row) cuts built directly (``b4_cuts``);
7. sharded_serve — the port's launcher (``repro_torch.launch.serve``,
               extract mode) in-process at O1280 (4 times × 4 levels,
               105,594,880 float64 elements, 0.84 GB on the card), 8
               client threads, 4 shards, 512 Zipf-drawn requests through
               the ``AdmissionQueue``; one gather_union_slices launch
               per window with a non-empty plan (the windows counted
               from the service's calls), gather_rows never, each launch
               byte-equal to its plain version; every served value
               byte-equal to a fresh single-threaded
               ``PolytopeExtractor`` on the same payload;
8. recsys_serve — DLRM-RM2 (26 tables × 10⁶ rows × 64, 6.66 GB of
               float32 tables) and then DeepFM (39 × 10⁶ × 10 and its
               width-1 first-order tables, 1.72 GB) at full published
               width on the card, seeded random weights, each serving
               one untimed ``serve_p99`` batch of 512, 8 timed ones,
               one ``serve_bulk`` batch of 262,144 and one
               ``retrieval_cand`` batch of 1,048,576 candidate rows for
               one user (DLRM's dense features of its first row on every
               row) from a ``ClickStream``, with TF32 off; every
               EmbeddingBag is
               one gather_rows_bag (B6) launch: DLRM's 64-wide rows on
               B6's wide kernel, DeepFM's on its tiled kernel for narrow
               rows, each path asserted to take its own.  Every B6
               call of the path must equal B6's plain version byte for
               byte, and so
               must the logits of the same batches with the plain
               version in B6's place; B6 is also held on the DLRM bulk
               ids padded to L = 8; the first p99 batch's logits and
               4,096 seeded rows of the retrieval batch's must agree
               with the port's float64 CPU forward (on the rows the
               batch reads and the weights copied to the host) within
               rtol = atol = 1e-4.  Each model is freed before the next;
8b. recsys_retrieval — two-tower retrieval (10⁶ users and 10⁶ items ×
               256, towers 1024-512-256, 2.05 GB of float32 tables) and
               then BERT4Rec (vocab 2²⁰ × 64, 2 layers, 200 learned
               positions, no causal mask) at full published width,
               seeded random weights drawn on the card, TF32 off, each
               freed before the next.  Two-tower: one untimed and 8
               timed ``serve_p99`` calls (512 users × 512 items) and
               ``retrieval_cand`` calls (one user × 2²⁰ candidates),
               each tower's lookup one gather_rows (B1) launch on 1 KB
               rows; every B1 call byte-equal to its plain version, and
               so the scores with the plain version in B1's place; the
               p99 scores and 4,096 seeded candidates within
               ``TT_F64_MAX`` of a float64 CPU forward, two planted
               faults (ids shifted by one, no L2 norm) outside it; one
               profiled ``retrieval_cand`` call.  BERT4Rec: 1 + 8
               ``serve_p99`` calls ((512, 200) histories → (512, 2²⁰)
               logits) and ``retrieval_cand`` calls ((1, 200)), each
               two B1 launches (the items' and positions' embeddings),
               the rest plain PyTorch and cuBLAS; every B1 call
               byte-equal to its plain version, and so the logits with
               the plain version in B1's place; 9 rows within
               ``BERT_F64_MAX`` of a float64 CPU forward (a gap over it
               fails, after both forwards run once more to say which
               side moved), two planted faults (a causal mask, no
               learned positions) outside it; one profiled p99 call;
               then 4 requests behind ``ServeEngine`` within the 200
               positions, each decode round one B8 launch a layer on
               its CUDA-core kernel (float32, G = 1, Dh = 32), the
               tokens equal to a run with B8's plain version.
               ``serve_bulk`` is cut for both (its outputs: 275 GB and
               1.1 TB);
8c. recsys_train — DLRM-RM2, DeepFM and two-tower trained at published
               width on the card, one at a time, seeded random weights,
               the configurations' AdamW, ``train_batch`` = 65,536 rows
               a step drawn step by step from ``ClickStream`` /
               ``InteractionStream``, TF32 off: ``make_train_step``
               under ``Supervisor`` for 1 untimed and 8 timed steps,
               each step's tables looked up by B6 (DLRM: one wide
               launch; DeepFM: two tiled launches) or B1 (two-tower: two
               launches), their backward plain PyTorch (``index_add_``
               into a dense zero table), no restart.  The first step is
               held (a) byte for byte against the same step with the
               plain B6 or B1 in deterministic mode (loss, gradients,
               parameters, moments, metrics) and (b) against a float64
               recompute (``first_step_f64``) within ``TRAIN_F64``, two
               planted faults outside it; the last step's kernel calls
               against the plain version.  DeepFM's state (6.9 GB) is
               checkpointed and restored byte for byte.  It prints the
               step's p50 and max, samples/s, the bound (the dense
               AdamW sweep's bytes, the GEMMs' operations), a profiled
               step (kernels by group, idle share), the peak memory and
               each step's loss, then runs ``python -m
               repro_torch.launch.train --arch dlrm-rm2 --steps 20`` at
               smoke width (exit 0).  ``chip_train.py --seeds 0 1 2``
               runs it alone;
8d. train_more — NequIP, BERT4Rec and GLM-4 trained at published width,
               TF32 off, one at a time.  NequIP (``_cfg()``) on phase
               9's ``molecule`` (energies + 100 × forces against drawn
               force targets: the forces' backward is differentiated
               again, so B7 runs in the backward of its backward) and
               ``minibatch_lg`` (node classes), 1 + 8 AdamW steps under
               ``Supervisor``, B7 in every forward and recomputed layer:
               the first step byte-equal with the plain B7 in
               deterministic mode (loss, gradients, forces) and within
               ``NEQUIP_TRAIN_F64`` of the float64 CPU recompute, two
               planted faults (the forces' sign, one edge's destination)
               outside; B7's launches counted in the loss and in the
               weights' backward, each of the latter checked against the
               plain version.  BERT4Rec (vocab 2²⁰ × 64, 200 positions)
               at 4,096 cloze rows a step (``train_batch`` cut from
               65,536), 1 + 3 steps: the first step's chunked tied
               cross-entropy within ``CE_F64`` of a float64 recompute on
               the card (labels shifted by one item outside), its
               backward's peak beside one (rows · 48, 2²⁰) float32
               logits tensor.  GLM-4 9B cut to 8 layers, bf16, 8 rows of
               4,096 tokens a step in 8 microbatches read from a
               ``TokenCube`` on the card, 1 + 3 steps: one
               gather_union_slices launch a step and no gather_rows,
               every step's tokens byte-equal to the corpus's windows,
               the first microbatch's loss and gradient norm within
               ``LM_F32`` of float32 (labels unshifted outside).  Each
               prints the step's p50 and max, samples or tokens/s, the
               bound, a profiled step and the peak memory.  Then
               ``python -m repro_torch.launch.train --arch <id> --steps
               20`` for glm4-9b, nequip, bert4rec and deepseek-v3-671b
               (exit 0), granite, Yi, Arctic and DeepSeek-V3 through the
               launcher's parts in-process, and a DeepSeek-V3 checkpoint
               restored byte for byte.  ``chip_train.py --models nequip
               bert4rec glm4-9b`` runs it alone;
9. gnn       — NequIP at its published width (5 layers, 32 channels,
               l_max = 2; seeded random weights carried from a numpy
               tree with ``carry.nequip_from_params``) on three graph
               shapes from the port's data plane: 128 padded molecules
               (energies and forces), the Cora-sized full graph and a
               sampled Reddit-sized minibatch (node classes), each with
               one untimed and 8 timed forwards, with TF32 off; every
               message sum and the energy readout is one segment_sum
               (B7) launch, 15 per node-class forward and 16 per energy
               forward, and the forces' backward sums the source rows'
               gradients of layers 2-5 through B7 (12 more), all reading
               the forward's segment plans of the destination and the
               source ids (one more, of the graph ids, for the energy
               readout: 2 or 3 ``segment_plan`` builds a forward,
               counted).  Every B7 call of the path must equal B7's plain
               version byte for byte, and so must the outputs with the
               plain version in B7's place; B7 is also held on the
               minibatch's l = 2 sum with the padding edges clamped onto
               node 0 (the JAX package's ids: an 80,417-edge segment);
               the first timed outputs must agree with the float64 CPU
               forward of the same weights within rtol = atol = 1e-4;
10. lm_serve — GLM-4 9B at its published width (40 layers, d 4096, 32
               heads over 2 KV heads, vocab 151,552; 8.78 B parameters,
               17.6 GB of bf16 weights drawn on the card from the run's
               seed) behind ``ServeEngine`` (16 slots, 4096 pages of 16
               tokens, 2.68 GB of K/V pool), serving 24 requests with
               prompts of 512-2048 tokens and 16-48 new tokens each, so
               admission runs mid-stream; every decode round is one
               paged_decode_attention (B8) launch per layer, every one of
               them on B8's tensor-core kernel, and one gather_rows (B1)
               launch a prefill and a round for the token embeddings,
               each held byte for byte against B1's plain version when
               it is made (the ids' span comes from the engine's host
               copy: nothing is read back to check them).  Every B8
               call is held against B8's plain version inside the call
               (the pool changes after it) within the bf16 tolerance of
               the JAX kernel tests; the first round's logits with the
               plain version in B8's place, and the logits of two
               requests against a teacher-forced ``forward`` over their
               prompt and generated tokens, must agree within the stated
               bf16 bounds; then the launcher's lm mode (smoke config)
               in-process (float32: B8's CUDA-core kernel); then B8's
               timings at the last and the first round's shapes and at
               ``decode_32k``'s per-layer shape (128 × 32,768 tokens, a
               4.29 GB pool, shuffled page ids): the tensor-core kernel
               at its automatic split and at 1-32 splits, the CUDA-core
               kernel on the same bf16 inputs at its automatic split and
               at one, the plain version, SDPA and the bound;
11. lm_moe   — DeepSeek-V3 (5 of its 61 layers: the 3 dense layers and
               2 MoE layers; MLA, 256 experts top 8 and a shared expert;
               26.38 B parameters, 52.8 GB) and then Arctic (2 of its 35
               layers, both MoE with the dense residual; 56 heads over 8
               KV heads; 27.45 B parameters, 54.9 GB) at published width
               in bf16, seeded random weights drawn on the card, each
               freed before the next (GLM-4's weights and pools freed
               first).  Each serves 12 requests (prompts of 256-1024
               tokens, half a multiple of 32 so that prefill routes 32
               groups, half not so that it routes one; 8-24 new tokens)
               through ``ServeEngine`` with 8 slots, so admission runs
               mid-stream.  Arctic's decode rounds are one B8 launch a
               layer, every one on the tensor-core kernel at G = 7 and
               held against B8's plain version inside the call;
               DeepSeek's path launches no kernel of the port but B1
               (the token embeddings, one launch a prefill and a round,
               each held against its plain version; MLA's absorbed
               paged decode and the MoE layers are plain PyTorch and
               cuBLAS).  The routing of every MoE layer at the first
               prefill of each group branch and at the first decode
               round is byte-equal to the same routing run on the CPU
               from the card's float32 logits; the first decode
               round's MoE layers agree with a plain per-token
               formulation within ``MOE_LAYER_*`` and two planted faults
               (a dropped second choice, swapped gates) fall outside;
               two requests served dropless agree with a teacher-forced
               ``forward`` within ``MOE_LOGITS_*`` away from routing
               flips at near ties, and a forward that drops falls
               outside.  It prints the init and prefill time, the p50
               round, tokens/s, the replayed round's idle share and top
               kernels, the peak memory, the prefill's dropped share and
               the round's bound (the weights a round reads, once);
11b. distributed — the port's distribution on an NCCL process group of
               one rank (a ``FileStore`` in a temporary directory, no
               TCP) and ``make_host_mesh(1, 1)`` on "cuda":
               ``quantized_psum`` of a seeded float32 tensor (2²⁴
               elements) byte-equal to its plain CPU arithmetic, and the
               same with the scale halved (a planted fault) unequal, and
               timed; the JAX distributed test's linear AdamW step with
               ``DTensor`` params P(None, "model"), moments P("data",
               "model") and a P("data", None) batch within 1e-5 of the
               step on plain tensors; DLRM-RM2's published train state
               (AdamW, 20 GB, the moments drawn) placed by
               ``named(mesh, sanitize_specs(...))`` of its lowering's
               specs, saved as a sharded checkpoint under ``build/`` and
               restored onto the mesh with ``shardings``, every local
               tensor byte-equal to the source; after it is freed, fault
               C14: one run (0, 2³¹) of a 2³¹-element uint8 payload
               through ``gather_plan_runs`` (one B2 launch, the path's
               count) byte-equal to the payload, and timed; each
               piece's seconds.  After the group is gone: the dry run
               of all 40 cells on both production meshes with its trace
               (``python -m repro_torch.launch.dryrun --all
               --both-meshes --cost``, started after the build in a
               process of its own beside the card's phases, each decoder
               cut to one layer a layer group, 3 cells at once): 80
               records, all ``ok``, each with FLOPs and bytes accessed
               per device above 0, the five collective kinds and the
               temporary, output and alias bytes; the largest
               per-device ``argument_bytes`` of each family and
               DeepSeek-V3's and Arctic's ``train_4k``, each with its
               ``flops_per_device``, ``temp_bytes`` and collective
               bytes;
11b2. sharded_models — on a new NCCL group of one rank, ``make_host_mesh(1,
               1)``: DLRM-RM2 ``train_batch`` (published width, 65,536
               rows, 3 steps), two-tower ``serve_p99`` (512) and
               ``retrieval_cand`` (2²⁰ candidates), NequIP
               ``minibatch_lg`` (3 steps), each through its cell's
               ``Lowering.fn`` on DTensors under the cell's specs
               (``carry.distribute_state``) and, first, on the
               plain-tensor path from the same seed, both in
               deterministic mode: parameters or outputs byte-equal
               (a mesh of one reduces nothing), the same launches of
               B6, B1, B7 and ``segment_plan``, every kernel call of the
               mesh runs' first step or forward held against its plain
               version when it is made; each run's seconds, step times
               and peak memory; then one more DLRM-RM2 step, traced on
               fake copies of its shards by the dry run's counting (its
               peak of live bytes) and run (uncounted) beside
               ``torch.cuda.max_memory_allocated``, and their ratio;
11b3. sharded_lm — on another NCCL group of one rank, ``make_host_mesh(1,
               1)``, the decoders' cells through their ``Lowering.fn``,
               first on plain tensors and then on the same tensors
               wrapped as DTensors (``on_one_rank``: no copy; a cache
               or a train state drawn again from the seed), both in
               deterministic mode: GLM-4 9B at published width, bf16
               (``long_500k`` at full size, 524,288 positions and 21.5
               GB of cache; ``decode_32k`` with 8 rows; ``prefill_32k``
               with 1 row, on the first 8 layers; ``train_4k`` at 8
               layers and 8 rows of 4,096),
               DeepSeek-V3 and Arctic at the depths of phase 11
               (``long_500k``, ``decode_32k`` 8 rows, ``prefill_32k`` 1
               row with a q chunk of ``SHARDED_MOE_Q_CHUNK``;
               ``train_4k`` at smoke width), BERT4Rec at published
               width (``serve_p99``, ``retrieval_cand``, ``serve_bulk``
               cut to ``SHARDED_BERT_BULK`` rows, ``train_batch`` at
               ``BERT_TRAIN_ROWS``): logits, caches, scores or
               parameters byte-equal, the same B1 launches, every B1
               call of a mesh run held against its plain version when
               it is made; each run's seconds and peak memory;
11c. analysis — the port's CLI gate, ``python -m repro_torch.analysis
               --all --device cuda``, in process from a temporary working
               directory: the lint, the lock checker and the self-check,
               whose plans come from the card's B3 (2 launches, each
               byte-equal to B3's plain version) and must verify clean;
11d. examples — each ``examples/torch_*.py``'s ``main(argv)`` in process
               on the card: quickstart (O128) and extract_weather (O96,
               and the 160 × 320 irregular cube through the extraction
               service) with every extraction's values byte-equal to
               ``flat[plan.offsets]`` of the host ``Slicer``'s plan;
               serve_lm's 10 requests of 12 tokens, the page pool empty
               after the drain, every B8 call (float32, the CUDA-core
               kernel) within ``B8_F32`` of its plain version inside the
               call; train_lm at its 100m preset for ``EXAMPLE_STEPS``
               steps with a preemption at ``EXAMPLE_PREEMPT`` (one
               restart from the checkpoint of step 49) and train_recsys
               for ``EXAMPLE_STEPS`` steps, each loss's last 10 steps'
               mean below its first 10's; the kernels each example
               launched (``path_launches["examples"]``, and by example),
               each call of B2 and the union slices and the last of B6
               byte-equal to the plain version;
12. timing   — each kernel at the shapes its path gave it, with CUDA
               events: kernel, plain version, one library call where one
               computes the same function, and the card's bound (B1 at
               the plain extract's read, with two-tower's candidate and
               p99 item lookups timed in phase 8b and its training
               lookups (with their plain backward) in 8c as variants, and a
               row-width sweep as variants: float32 rows of 8, 32, 64,
               128, 256, 512, 1000, 1024 and 4096 bytes and 1024 one
               element off
               16-byte alignment, 512 MB of output each, each byte-equal
               to the plain version, with its layout, B1's and
               ``index_select``'s device times and the bound; B1 and
               ``index_select`` are both timed by device time too; B2 at
               the all-levels request,
               the batched crop planner at phase 6's extract and its
               lattice, B4 on phase 6's cuts, B5 at phase 5's layer;
               B1, the planner, B4 and B5 also by device time,
               ``torch.profiler``), the union slices at phase 3's last window; B3's
               with the device time of each kernel and memset of a call,
               by ``torch.profiler``, at the all-levels request and at
               Germany's; B6's at
               the DLRM ``serve_bulk`` shape, timed in phase 8 while the
               tables are on the card, with DeepFM's D = 10 and D = 1
               bulk calls, the padded L = 8 bags, each model's
               retrieval_cand calls (B = 1,048,576) and phase 8c's
               training calls (with their plain backward) as variants, each
               with the sector floor beside its bound and the kernel it
               took; B7's at
               the minibatch's l = 2 sum, timed in phase 9 (the walk over
               a built plan, the plan's build, and a call on the ids),
               with its l = 0 and l = 1 sums, the energy readout and the
               hub as variants; B8's timed in phase 10);
13. the kernels line, with the launch counts of the paths.

The launch counters are reset just before each path (phases 2-3, the
plain extract, 5, 6, 7, each model of 8, two-tower, BERT4Rec and
BERT4Rec's engine in 8b, each model's supervised steps in 8c and 8d,
each shape of 9, the engine and the launcher of 10, each model of 11,
11b, each mesh run of 11b2 and 11b3, 11c, each example of 11d)
and read just after it, so the counts show that each path ran through
its kernels; checks against the plain versions come after the counts
are read, except B8's, which run inside each call (and phase 11's
routing records), and 11b2's and 11b3's, made at each call of a mesh
run's first step.  ``chip_lm_moe.py`` runs phase 11 alone at several
seeds, ``chip_retrieval.py`` phase 8b.  The last line is
``{"ok": true, "device": {...}}``; any failure raises and the exit
code is non-zero.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import functools
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP64_FLOPS = 34e12             # H100 SXM data sheet, FP64 outside tensor cores
FP32_FLOPS = 67e12             # H100 SXM data sheet, FP32 outside tensor cores
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2: gathered bytes start cold
B8_FLUSH_BYTES = 1 << 30       # ~0.32 ms of memset: outlasts B8's launch
SERVE_REQUESTS = 512           # the sharded_serve phase's Zipf draws
# Sources whose registers and spills the build row prints (-Xptxas -v):
# B8's tensor-core kernel, B3, B6's two kernels, the batched crop
# planner and B5.
PTXAS_SOURCES = ("paged_attn_tc", "plan_runs_2d", "gather", "batched_plan",
                 "slice_batch")
SECTOR_BYTES = 32              # the unit in which the card reads memory
# The recsys_retrieval phase (and phase 8's retrieval_cand batches):
# rows of a 2^20-row output checked against a float64 CPU forward, and
# the timed calls after one untimed call, at each shape.
RETRIEVAL_SAMPLE = 4096
RETRIEVAL_TIMED = 8
BERT_SAMPLE_ROWS = 8           # BERT4Rec serve_p99 rows checked in float64
# Card float32 (TF32 off) against the float64 CPU forward of the same
# weights and inputs: two-tower's scores (cosines of 256-wide unit
# vectors, each tower's products summed by cuBLAS in its own order) and
# BERT4Rec's last-position logits.  Over seeds 0-2 (H100,
# chip_retrieval.py) the gaps reached 2.20e-7 and 1.10e-6; the planted
# faults gave 0.165-0.249 (two-tower) and 0.365-1.153 (BERT4Rec).  The
# bounds are twice the gaps' largest readings.
TT_F64_MAX = 4.41e-7
BERT_F64_MAX = 2.21e-6
# BERT4Rec behind the engine: 4 requests within its 200 positions (B8's
# CUDA-core kernel at G = 1, Dh = 32, float32).
BERT_ENGINE = dict(max_batch=4, max_seq=208, page_size=16, n_pages=64)
BERT_REQUESTS = 4
BERT_PROMPT = (64, 180)
BERT_NEW = (8, 16)
# The recsys_train phase: DLRM-RM2, DeepFM and two-tower at published
# width and train_batch rows, 1 untimed and TRAIN_STEPS timed steps each.
TRAIN_STEPS = 8
TRAIN_UNTOUCHED = 4096         # untouched table rows checked a table
TT_F64_CHUNK = 4096            # rows of the float64 in-batch logits at once
# The first step (card float32, TF32 off, deterministic mode) against
# its float64 recompute: the loss relative to itself and the gradients
# (the largest difference over the largest float64 element: grad_gap)
# against first_step_f64; the update p1 - p0 and the moments m1, v1 (per
# tensor, relative to its largest float64 value) and sampled untouched
# rows' p1 (float32 ulps) against AdamW written out in float64 on the
# card's gradients (adamw_first_step).  Over seeds 0-2 (H100,
# chip_train.py) the gaps reached loss 1.03e-7, grad 1.93e-4 (two-tower),
# update 0.0222 (DeepFM's width-1 table: p up to ~5, whose float32 ulp
# is 5% of the 1e-5 step), moments 1.84e-7, untouched 0.5000002 ulps.
# The planted faults gave grad 0.0023-0.98 and update 1.97-2.0 (the
# gradient into the next row), update 1.0-1.01 and untouched 1.75 ulps
# (the learning rate one step ahead).  The bounds are twice the gaps'
# largest readings.
TRAIN_F64 = {"loss": 2.1e-7, "grad": 3.9e-4, "update": 0.045,
             "moments": 3.7e-7, "untouched_ulps": 1.0}
# NequIP's graph shapes (GNN_SHAPES of the configuration), in the order
# the gnn phase serves them, each with one untimed and 8 timed forwards.
GNN_RUNS = ("molecule", "full_graph_sm", "minibatch_lg")
GNN_FORWARDS = 8
GNN_F64 = dict(rtol=1e-4, atol=1e-4)   # card float32 vs CPU float64
BF16_FLOPS = 989e12            # H100 SXM data sheet, bf16 tensor cores, dense
# The lm_serve phase: GLM-4 9B at full width behind the engine's smoke
# pool size scaled to 16 live sequences of up to 4096 tokens.
LM_ENGINE = dict(max_batch=16, max_seq=4096, page_size=16, n_pages=4096)
LM_REQUESTS = 24               # against 16 slots: admission mid-stream
LM_PROMPT = (512, 2048)        # prompt tokens, drawn with the run's seed
LM_NEW = (16, 48)              # max_new_tokens, drawn likewise
LM_REPLAYS = 8                 # unchecked replays of the first round
# B8 against its plain version in bf16: the JAX kernel tests' bf16
# tolerance (tests/test_kernels.py); both sum in float32 in their own
# order and round the output to bf16, so they differ by an ulp or so.
B8_BF16 = dict(rtol=2e-2, atol=2e-2)
# B8 in float32 (the CUDA-core kernel) against its plain version: the
# card tests' float32 tolerance (tests/test_torch_cuda.py).
B8_F32 = dict(rtol=2e-5, atol=2e-5)
# A second bound that scales with the output: both versions round float32
# results to bf16, so an element may differ by one bf16 ulp of itself,
# at most 2^-7 of the largest |output|.  B8_BF16's atol alone cannot see
# much at decode_32k, whose N(0, 1) data over 32,768 tokens give |out|
# of ~0.01.
B8_REL = 2.0 ** -7
# KV splits at which B8's tensor-core kernel is timed besides its own
# rule's (kernel.split_for_tc), at each timed shape.
B8_SPLITS = (1, 2, 4, 8, 16, 32)
# Logits of two computations of the same bf16 model (the decode with B8
# against the decode with its plain version; the engine's decode against
# a teacher-forced forward): each of the 40 layers rounds its bf16
# residual stream (|x| up to ~10, an ulp of 2^-7 x |x|) after products
# that cuBLAS and B8 sum in other orders, so the final-normed states
# differ by a few bf16 ulps; through the tied head (151,552 rows of
# N(0, 0.02²) x 4096) logits of std ~1.3 then differ by up to ~0.1.
# Over seeds 0-2 (H100) the gaps reached max 0.139, mean 0.0187; B8 with
# the newest token dropped gave max 0.48-0.56, with the last split
# dropped mean 0.26-0.29.  The bounds are twice the gaps' largest
# readings, below both faults.
LM_LOGITS_MAX = 0.28           # max |difference| of any logit
LM_LOGITS_MEAN = 0.0375        # mean |difference| over all logits
# The lm_moe phase: DeepSeek-V3 and Arctic at their published widths in
# bf16, cut in depth to fit one card: (arch, layers, parameters), the
# counts from jax.eval_shape over the JAX init_params at the cut.
# DeepSeek keeps its 3 dense layers and 2 MoE layers (52.8 GB; 3 MoE
# layers would be 75.7 GB), Arctic 2 MoE layers with the dense residual
# (54.9 GB).
MOE_MODELS = (("deepseek-v3-671b", 5, 26_377_966_592),
              ("arctic-480b", 2, 27_451_755_520))
MOE_ENGINE = dict(max_batch=8, max_seq=1056, page_size=16, n_pages=1024)
MOE_REQUESTS = 12              # against 8 slots: admission mid-stream
MOE_PROMPT = (256, 1024)       # prompt tokens, half a multiple of 32
MOE_NEW = (8, 24)              # max_new_tokens
MOE_REPLAYS = 8                # unchecked replays of the first round
# The first decode round's MoE layers against the plain per-token
# formulation (moe_plain_layer), bf16: both take the same routing and
# sum in choice order; the batched cuBLAS product over experts and the
# per-token matrix-vector products sum their float32 terms in other
# orders, so an element of an expert's output may round to the other
# bf16 neighbour.  Over seeds 0-2 (H100, chip_lm_moe.py) the gaps reached
# max 0.015625 (one bf16 ulp of an output in [2, 4)), mean 9.0e-5; the
# planted faults gave max 0.33-1.45, mean 0.040-0.212.  The bounds are
# twice the gaps' largest readings.
MOE_LAYER_MAX = 0.03125
MOE_LAYER_MEAN = 1.8e-4
# Logits of two requests served dropless through the paged engine (for
# DeepSeek the absorbed latent decode) against a teacher-forced forward
# (expanded K and V, the expert buffers of the whole sequence), bf16,
# at the positions whose routing agrees: over seeds 0-2 the gaps reached
# max 0.125, mean 0.0191; the forward with the configuration's own
# capacity (slots dropped) gave max 1.60-7.64, mean 0.239-0.992.  The
# bounds are twice the gaps' largest readings.
MOE_LOGITS_MAX = 0.25
MOE_LOGITS_MEAN = 0.0383
# A teacher-forced position whose routing differs from the served one
# (0-7 of 8-22 positions a request over seeds 0-2) is left out of those
# bounds if, in the forward, the k-th and (k+1)-th router logits of
# every MoE layer whose choice differs are closer than this: a near tie
# that bf16 noise flips (margins 0.0003-0.041 over seeds 0-2, twice the
# largest).  A flip off a near tie fails the phase.
MOE_FLIP_MARGIN = 0.082
# The train_more phase: NequIP on two of phase 9's graphs, BERT4Rec and
# GLM-4 trained at published width, 1 untimed and MORE_STEPS timed steps
# each, then the launcher at smoke width.
MORE_GNN = ("molecule", "minibatch_lg")
MORE_STEPS = {"nequip": 8, "bert4rec": 3, "glm4-9b": 3}
MINIBATCH_SEEDS = 1024          # minibatch_lg's labelled (seed) nodes
BERT_TRAIN_ROWS = 4096          # train_batch cut from 65,536
BERT_MASK_RATE = 0.2            # cloze positions drawn a history
# GLM-4 cut to 8 of its 40 layers and 8 of train_4k's 256 rows of 4096
# tokens (one row a microbatch: the configuration's LM_ACCUM of 8 kept),
# its corpus 32 documents of 8192 tokens on the card.
LM_TRAIN = dict(layers=8, rows=8, seq=4096, n_docs=32, doc_len=8192)
MORE_LAUNCHED = ("glm4-9b", "nequip", "bert4rec", "deepseek-v3-671b")
MORE_IN_PROCESS = ("granite-3-8b", "yi-34b", "arctic-480b",
                   "deepseek-v3-671b")
# NequIP's first training step (card float32, TF32 off) against the
# float64 CPU recompute of the same weights.  The loss, the model's
# outputs (per-node logits, or per-graph energies) and the forces: phase
# 9's GNN_F64 (rtol = atol = 1e-4) carried to training, each gap
# close_ratio's max |card - f64| / (atol + rtol |f64|), at most 1 where
# np.allclose(card, f64, **GNN_F64) holds.  The gradients, whose
# elements span many orders of magnitude: grads_gap, the largest
# difference over the model's largest float64 element (TRAIN_F64's
# measure and bound).  Over seeds 0-2 (H100, chip_train.py) the gaps
# reached loss 5.45e-4, outputs 4.48e-3, forces 0.203 and gradients
# 1.89e-4 (minibatch_lg); one edge's destination shifted gave outputs
# 2.96-251, the forces' sign flipped forces 53-165.
NEQUIP_TRAIN_F64 = {"loss": 1.0, "out": 1.0, "forces": 1.0,
                    "grad": 3.9e-4}
# BERT4Rec's chunked cross-entropy on the first step's inputs against
# its float64 recompute on the card (ce_f64): the loss relative to
# itself, dh, dtable and dtable's label rows, each over its largest
# float64 element.  Over seeds 0-2 (H100, chip_train.py) the gaps
# reached loss 1.26e-7, dh 5.11e-6, dtable 5.57e-6; the labels shifted
# by one item gave loss 2.5e-5-4.9e-5, dh 1.28-1.35, dtable 1.02-1.03.
# The bounds are twice the gaps' largest readings.
CE_F64 = {"loss": 2.6e-7, "dh": 1.1e-5, "dtable": 1.2e-5,
          "dtable_label_rows": 1.2e-5}
# GLM-4's first microbatch in bf16 against the same microbatch in
# float32 on the card: the loss and the global gradient norm, each
# relative to the float32 value.  Over seeds 0-2 (H100, chip_train.py)
# the gaps reached loss 2.52e-5, gradient norm 4.53e-4; the labels left
# unshifted gave loss 0.0578-0.0587, gradient norm 0.0537-0.101.  The
# bounds are twice the gaps' largest readings.
LM_F32 = {"loss": 5.1e-5, "grad_norm": 9.1e-4}


# The examples phase: the train examples' steps, and the step at which
# train_lm is preempted (past its checkpoint of step 49).
EXAMPLE_STEPS = 120
EXAMPLE_PREEMPT = 70


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def bytes_equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or tuple(a.shape) != tuple(b.shape):
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def max_abs_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    its own pair of CUDA events after an L2 flush of ``flush_bytes``
    (the last call's times stay in ``last``).
    The flush must outlast the host's work of launching ``fn`` (else the
    card idles between the events): 256 MB takes ~80 µs."""

    def __init__(self, device, flush_bytes: int = L2_FLUSH_BYTES):
        import torch

        self.torch = torch
        self.flush = torch.empty(flush_bytes, dtype=torch.uint8,
                                 device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        self.last = [s.elapsed_time(e) for s, e in pairs]
        return sum(self.last) / iters


def ptxas_usage(source: str) -> dict:
    """Registers and spill bytes of each kernel of ``csrc/<source>.cu``,
    from ``-Xptxas -v`` on a second compile with the build's own flags
    (into a temporary directory; the built library is not touched),
    keyed by the kernel's name and template arguments."""
    import re

    from repro_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(_build.CSRC / f"{source}.cu")],
            capture_output=True, text=True, check=True)
    usage, name = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        if "Compiling entry function" in line:
            # _Z<len><name>..., or _ZN<len><scope>...<len><name>... for
            # a kernel in a namespace (the anonymous one included): the
            # kernel's own name is the last component.
            mangled = line.split("'")[1]
            nested = mangled.startswith("_ZN")
            end = 3 if nested else 2
            while (digits := re.match(r"\d+", mangled[end:])):
                start = end + digits.end()
                end = start + int(digits.group())
                name = mangled[start:end]
                if not nested:
                    break
            # Its template arguments: types (float, double or a word of
            # 1-8 bytes) and integers, in order.
            args, at = [], end + 1
            while mangled[end:end + 1] == "I" and at < len(mangled):
                if mangled[at] in TYPE_CODES:
                    args.append(TYPE_CODES[mangled[at]])
                    at += 1
                elif (lit := re.match(r"Li(\d+)E", mangled[at:])):
                    args.append(lit.group(1))
                    at += lit.end()
                else:
                    break
            if args:
                name += f"<{', '.join(args)}>"
            usage[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


# Itanium mangling's codes of the types the kernels are templated on.
TYPE_CODES = {"f": "float", "d": "double", "h": "uint8_t", "t": "uint16_t",
              "j": "uint32_t", "m": "uint64_t"}


def zipf_draw(rng, n_items: int, n_draws: int, s: float = 1.1):
    import numpy as np

    w = 1.0 / np.arange(1, n_items + 1) ** s
    return rng.choice(n_items, size=n_draws, p=w / w.sum())


def plan_flops(verts, valid, sv0, eps0, tol_rel, n1) -> int:
    """Floating-point operations plan_runs_2d does on these jobs: per
    live (job, row), V distance tests, 5 per (below, above) pair lerp,
    and 3 binary searches over the minor axis."""
    import numpy as np

    total = 0
    log_n1 = int(np.ceil(np.log2(n1 + 1)))
    for j in range(verts.shape[0]):
        m = valid[j]
        x, v = verts[j, m, 0], int(m.sum())
        i0 = np.searchsorted(sv0, x.min() - eps0, side="left")
        i1 = np.searchsorted(sv0, x.max() + eps0, side="right")
        if i1 <= i0:
            continue
        tol = tol_rel * max(1.0, float(np.abs(x).max()))
        d = x[None, :] - sv0[i0:i1, None]
        pairs = ((d < -tol).sum(1) * ((d > tol).sum(1))).sum()
        total += int(pairs) * 5 + int(i1 - i0) * (3 * v + 3 * log_n1)
    return total


def slice_batch_cost(verts, mask) -> tuple[int, int]:
    """Bytes slice_batch must move (vertices, mask and planes read once;
    candidates and their mask written once) and the float operations
    these inputs need: per polytope the scale (2 per vertex, 1 for the
    tolerance) and one distance per vertex; per crossing pair the
    denominator, the quotient and 3 per kept coordinate."""
    p, v, d = verts.shape
    slots = v + v * v
    n_bytes = p * v * d * 4 + p * v + p * 4 + p * slots * d * 4 + p * slots
    pairs = int(mask[:, v:].sum())
    return n_bytes, p * (3 * v + 1) + pairs * (2 + 3 * (d - 1))


def extents_cost(x, valid, planes, tol) -> tuple[int, int]:
    """Bytes slice_minor_extents must move (x, y, mask, planes, tol read
    once; lo, hi and hit written once) and the float operations these
    inputs need: one distance per (polytope, plane, vertex) and 5 per
    (below, above) pair lerp."""
    b, v = x.shape
    r = planes.shape[1]
    e = x.element_size()
    n_bytes = 2 * b * v * e + b * v + b * r * e + b * e + b * r * (2 * e + 1)
    dist = x[:, None, :] - planes[:, :, None]                 # (B, R, V)
    below = (valid[:, None, :] & (dist < -tol[:, None, None])).sum(-1)
    above = (valid[:, None, :] & (dist > tol[:, None, None])).sum(-1)
    pairs = int((below * above).sum())
    return n_bytes, b * r * v + 5 * pairs


def batched_plan_cost(verts, valid, axis0, axis1, n0: int, n1: int,
                      rows: int, cols: int, field=None) -> dict:
    """Bytes the batched crop planner must move and the float operations
    these inputs need, for one call of ``sk.batched_plan_2d``: the
    vertices, mask and axes read once, the lattice and the counts written
    once, and with a field each live value read once and every value
    written once; per live (polytope, row) a distance per vertex and 5
    per (below, above) pair lerp (``extents_cost``)."""
    from repro_torch.kernels.slice import ref as sref

    off, npts, _ = sref.batched_plan_2d(verts, valid, axis0, axis1, n0, n1,
                                        rows, cols)
    slots, live = off.numel(), int(npts.sum())
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (verts, valid, axis0, axis1)) + slots * 4 \
        + npts.numel() * 4
    if field is not None:
        n_bytes += (live + slots) * field.element_size()
    live_rows = (off >= 0).any(2)
    x4, _, valid4, planes4, tol4 = b4_cuts(verts, valid, axis0, rows)
    dist = x4[:, None, :] - planes4[:, :, None]
    below = (valid4[:, None, :] & (dist < -tol4[:, None, None])).sum(-1)
    above = (valid4[:, None, :] & (dist > tol4[:, None, None])).sum(-1)
    flops = int((live_rows * (verts.shape[1] + 5 * below * above)).sum())
    return {"bytes": int(n_bytes), "flops": flops, "slots": slots,
            "n_points": live, "live_rows": int(live_rows.sum()),
            "field": None if field is None else
            str(field.dtype).removeprefix("torch.")}


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.<name>`` replaced by ``fn`` while the block runs."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def uncounted():
    """Kernel launches made while the block runs (a path step run again
    to compare it with its plain version) left out of ``LAUNCHES``."""
    from repro_torch.kernels import LAUNCHES

    saved = dict(LAUNCHES)
    try:
        yield
    finally:
        for name in list(LAUNCHES):
            LAUNCHES[name] = saved.get(name, 0)


@contextlib.contextmanager
def recording(module, name: str, results: bool = False):
    """Record the arguments of every call to ``module.<name>`` while the
    block runs (the inputs a path hands a kernel, for the checks and
    timings after it), with what it returned if ``results``, then
    restore the function."""
    fn = getattr(module, name)
    calls = []

    def rec(*a, **kw):
        out = fn(*a, **kw)
        calls.append((a, kw, out) if results else (a, kw))
        return out

    with swapped(module, name, rec):
        yield calls


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms while the block runs (warning
    only where an operation has none)."""
    import torch

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def tf32_off(phase: str) -> dict:
    """The process's float32 matmul settings, which the models inherit;
    fails if TF32 is on, since the float64 comparisons are stated for
    full float32 products."""
    import torch

    matmul = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "float32_matmul_precision":
                  torch.get_float32_matmul_precision()}
    assert not matmul["allow_tf32"] and \
        matmul["float32_matmul_precision"] == "highest", \
        f"{phase}: TF32 is on ({matmul})"
    return matmul


def recsys_serve(dev, seed: int, card: str, check,
                 path_launches: dict) -> dict:
    """Phase 8: serve DLRM-RM2 and then DeepFM at their published widths
    on the card, one at a time, check each, and return B6's timing at
    the DLRM ``serve_bulk`` shape (a kernels-line entry without its
    counts), with the other timed shapes under ``variants``."""
    import torch

    matmul = tf32_off("recsys_serve")
    timings = []
    for kind, cfg, cls in recsys_models():
        row, timed = serve_recsys_model(dev, seed, kind, cfg, cls, check,
                                        path_launches, extras=kind == "dlrm")
        timings += timed
        emit({"phase": "recsys_serve", **row, "matmul": matmul,
              "card": card})
        torch.cuda.empty_cache()        # the model is gone: free its tables
    return {**timings[0], "variants": timings[1:]}


def recsys_models() -> list:
    """(kind, config, model class) of phase 8's models at their published
    widths: DLRM-RM2, then DeepFM."""
    from repro_torch.configs import deepfm, dlrm_rm2
    from repro_torch.models.recsys import DLRM, DeepFM

    return [("dlrm", dlrm_rm2._cfg(), DLRM),
            ("deepfm", deepfm._cfg(), DeepFM)]


def serve_recsys_model(dev, seed: int, kind: str, cfg, cls, check,
                       path_launches: dict, extras: bool):
    """One model of phase 8: one untimed ``serve_p99`` batch, 8 timed
    ``serve_p99`` batches and one ``serve_bulk`` batch, then the checks
    and B6's timing at each bulk call; with ``extras`` also B6 on padded
    bags, checked and timed.  Returns (the phase row, the timings)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref
    from repro_torch.models.recsys import EmbeddingBag

    p99_batch = RECSYS_SHAPES["serve_p99"]["batch"]
    bulk_batch = RECSYS_SHAPES["serve_bulk"]["batch"]

    def bag_modules(model):
        return [m for m in model.modules() if isinstance(m, EmbeddingBag)]

    def host_forward(model, batch):
        """The port's float64 CPU forward of ``batch``: each table cut to
        the rows the batch reads (ids renumbered), every other weight
        copied to the host."""
        bags = batch["bags"]
        ids = [np.unique(col[col >= 0]) for col in bags.transpose(1, 0, 2)]
        local = np.full_like(bags, -1)
        for t, u in enumerate(ids):
            col = bags[:, t]
            local[:, t] = np.where(col >= 0, np.searchsorted(u, col), -1)
        cfg64 = dataclasses.replace(model.cfg, dtype=torch.float64,
                                    rows=max(1, max(map(len, ids))))
        host = type(model)(cfg64, device="cpu", seed=seed)
        for src, dst in zip(bag_modules(model), bag_modules(host)):
            dst.tables.zero_()
            for t, u in enumerate(ids):
                rows = torch.from_numpy(u).to(src.tables.device).long()
                dst.tables[t, :len(u)] = src.tables[t, rows].double().cpu()
        own = dict(model.named_parameters())
        for name, param in host.named_parameters():
            if not name.endswith("tables"):
                param.copy_(own[name].double().cpu())
        *dense, _ = recsys_inputs(host, batch, "cpu", torch.float64)
        return host(*dense, torch.from_numpy(local)).numpy()

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        model = cls(cfg, device=dev, seed=seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        table_bytes = sum(m.tables.numel() * m.tables.element_size()
                          for m in bag_modules(model))
        batches = recsys_batches(cfg)
        n_cand = RECSYS_SHAPES["retrieval_cand"]["n_cand"]
        reset_launches()
        logits, secs = [], []
        with recording(gk, "gather_rows_bag", results=True) as b6_calls:
            for batch in batches:
                t0 = time.perf_counter()
                logits.append(model(*recsys_inputs(model, batch, dev)))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        path_launches[f"recsys_{kind}"] = dict(LAUNCHES)
        # Each call launched the B6 kernel its row's width names: the
        # tiled one below the wrapper's NARROW_ROW_BYTES (DeepFM's D = 10
        # and 1), the wide one above (DLRM's D = 64).
        n_narrow = sum(a[0].shape[1] * a[0].element_size()
                       < gk.NARROW_ROW_BYTES for a, _, _ in b6_calls)
        assert b6_calls and \
            LAUNCHES["gather_rows_bag_tiled"] == n_narrow and \
            LAUNCHES["gather_rows_bag"] == len(b6_calls) - n_narrow, \
            f"{kind}: the embedding bags did not launch the B6 kernels " \
            f"their widths name"
        # Every B6 call of the path against the plain version.
        for a, kw, out in b6_calls:
            check("gather_rows_bag", out, gref.gather_rows_bag(*a, **kw),
                  f"{kind} path")
        # The same module call sequence with the plain version in B6's
        # place: the logits must not move by a bit.
        with swapped(gk, "gather_rows_bag", gref.gather_rows_bag):
            for batch, got in zip(batches, logits):
                want = model(*recsys_inputs(model, batch, dev))
                assert bytes_equal(got, want), \
                    f"{kind}: logits with B6 != with its plain version"
        for got in logits:
            assert bool(torch.isfinite(got).all()), f"{kind}: non-finite"
        assert tuple(logits[1].shape) == (p99_batch,)
        assert tuple(logits[-2].shape) == (bulk_batch,)
        assert tuple(logits[-1].shape) == (n_cand,)
        # The first timed p99 batch (step 0), and a seeded sample of
        # RETRIEVAL_SAMPLE rows of the retrieval_cand batch, against the
        # float64 CPU forward.
        host_err = {}
        sample = np.sort(np.random.default_rng(seed).choice(
            n_cand, RETRIEVAL_SAMPLE, replace=False))
        for what, batch, got in (
                ("serve_p99", batches[1], logits[1]),
                ("retrieval_cand", {k: v[sample] for k, v in
                                    batches[-1].items()},
                 logits[-1][torch.from_numpy(sample).to(dev)])):
            host = host_forward(model, batch)
            card64 = got.double().cpu().numpy()
            host_err[what] = float(np.abs(card64 - host).max())
            assert np.allclose(card64, host, rtol=1e-4, atol=1e-4), \
                f"{kind} {what}: card logits != float64 CPU forward " \
                f"({host_err[what]})"
        p99_ms = [t * 1e3 for t in secs[1:9]]
        row = {"model": cfg.name, "tables_bytes": table_bytes,
               "init_s": init_s, "warmup_batch_ms": secs[0] * 1e3,
               "p99_batch_ms": p99_ms,
               "p99_batch_ms_p50": float(np.median(p99_ms)),
               "p99_batch_ms_max": max(p99_ms),
               "bulk_batch": bulk_batch, "bulk_s": secs[9],
               "bulk_samples_per_s": bulk_batch / secs[9],
               "retrieval_cand_rows": n_cand,
               "retrieval_cand_ms": secs[10] * 1e3,
               "retrieval_cand_rows_per_s": n_cand / secs[10],
               "host_f64_max_abs_err": host_err,
               "host_f64_retrieval_sample": RETRIEVAL_SAMPLE,
               "b6_calls_checked": len(b6_calls),
               "launches": path_launches[f"recsys_{kind}"]}
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        # B6 at the bulk batch's calls, then at the retrieval batch's
        # (the path's outputs freed first).
        n_batch = len(b6_calls) // len(batches)
        bulk_args = [a for a, _, _ in b6_calls[-2 * n_batch:-n_batch]]
        cand_args = [a for a, _, _ in b6_calls[-n_batch:]]
        del b6_calls, logits
        timings = b6_bulk_timings(dev, seed, cfg.name, bulk_args, check,
                                  padded=extras)
        if extras:
            row["padded_bags"] = timings[-1]["shape"]["bags"]
        timings += [bag_timing(dev, *a, f"{cfg.name} retrieval_cand")
                    for a in cand_args]
    row["seconds"] = time.perf_counter() - start
    return row, timings


def recsys_batches(cfg, retrieval: bool = True) -> list:
    """Phase 8's batches for a model of ``cfg``: step 9 first (untimed: the
    model's first call sets up cuBLAS and the allocator, which is not
    serving), steps 0-7 at ``serve_p99``, step 8 at ``serve_bulk`` and,
    with ``retrieval``, step 10 at ``retrieval_cand``: 2²⁰ candidate rows
    scored for one user, so the dense features (DLRM's) of its first row
    are repeated on every row and the sparse ids are the stream's."""
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.dataplane.recsys import ClickStream

    stream = ClickStream(n_sparse=cfg.n_sparse, rows=cfg.rows, seed=0)
    batches = [stream.batch(step, RECSYS_SHAPES["serve_p99"]["batch"])
               for step in (9, *range(8))]
    batches.append(stream.batch(8, RECSYS_SHAPES["serve_bulk"]["batch"]))
    if retrieval:
        cand = stream.batch(10, RECSYS_SHAPES["retrieval_cand"]["n_cand"])
        cand["dense"][:] = cand["dense"][0]
        batches.append(cand)
    return batches


def recsys_inputs(model, batch, device, dtype=None) -> tuple:
    """The model's call arguments for ``batch`` on ``device``: the bags,
    after the dense features (in ``dtype``, float32 by default) for DLRM."""
    import torch

    from repro_torch.models.recsys import DLRM

    bags = torch.from_numpy(batch["bags"]).to(device)
    if not isinstance(model, DLRM):
        return (bags,)
    dense = torch.from_numpy(batch["dense"]).to(dtype or torch.float32)
    return dense.to(device), bags


def b6_bulk_timings(dev, seed: int, name: str, bulk_calls: list, check,
                    padded: bool) -> list:
    """B6's timing at each (table, ids) call of a bulk batch: DLRM's one
    (D = 64), DeepFM's two (D = 10, then its D = 1 first-order bag).  With
    ``padded`` also on the last call's ids (offset into the stacked
    tables) reshaped to L = 8 with a seeded quarter of slots -1, checked
    against the plain version first."""
    import torch

    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref

    timings = [bag_timing(dev, *a, f"{name} serve_bulk") for a in bulk_calls]
    if padded:
        table_v, bulk_ids = bulk_calls[-1]
        gen = torch.Generator(device=dev).manual_seed(seed)
        ids = bulk_ids.reshape(-1, 8).clone()
        ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.25] = -1
        check("gather_rows_bag", gk.gather_rows_bag(table_v, ids),
              gref.gather_rows_bag(table_v, ids), "padded L = 8")
        timings.append(bag_timing(dev, table_v, ids,
                                  f"{name} serve_bulk padded"))
    return timings


def bag_timing(dev, table, bags, what: str) -> dict:
    """B6, its plain version and ``F.embedding_bag`` on the same bags;
    the bound counts each id, each distinct row read and each output
    element once (Zipf traffic re-reads hot rows from L2), the sector
    floor the whole sectors those rows touch."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref

    valid = bags >= 0
    clamped, weights = bags.clamp(min=0), valid.to(table.dtype)
    rows = torch.unique(bags[valid])
    distinct = int(rows.numel())
    n, d = bags.shape[0], table.shape[1]
    size = table.element_size()
    n_bytes = bags.numel() * 4 + distinct * d * size + n * d * size
    # The sector floor reads each distinct row as the whole 32-byte
    # sectors it touches (from its address), the ids and the output as
    # before.
    start = table.data_ptr() + rows.long() * (d * size)
    sectors = int(((start + d * size - 1) // SECTOR_BYTES
                   - start // SECTOR_BYTES + 1).sum())
    sector_bytes = bags.numel() * 4 + sectors * SECTOR_BYTES + n * d * size
    before = dict(LAUNCHES)                     # which B6 kernel runs here
    gk.gather_rows_bag(table, bags)
    kernel = [k for k, n_ in LAUNCHES.items() if n_ != before[k]]
    timer = Timer(dev)
    return {
        "ms": timer(lambda: gk.gather_rows_bag(table, bags)),
        "plain_ms": timer(lambda: gref.gather_rows_bag(table, bags)),
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "sector_floor_ms": sector_bytes / HBM_BYTES_PER_S * 1e3,
        "library_ms": timer(lambda: F.embedding_bag(
            clamped, table, mode="sum", per_sample_weights=weights)),
        "kernel": kernel,
        "shape": {"what": what, "bags": n, "L": int(bags.shape[1]), "D": d,
                  "N": int(table.shape[0]), "distinct_rows": distinct,
                  "bytes": n_bytes, "sector_bytes": sector_bytes}}


def model_bound(flops: int, n_bytes: int) -> dict:
    """The least time the card could take for a float32 model call: the
    larger of its operations at the float32 peak and its bytes at the
    memory rate."""
    t_flops = flops / FP32_FLOPS * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "flops": int(flops), "bytes": int(n_bytes)}


def peak_of(fn) -> tuple:
    """(``fn()``, the device memory its call allocated at its peak above
    what was held before it)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = fn()
    return out, torch.cuda.max_memory_allocated() - held


def timed_calls(fn, n: int, keep=None) -> tuple[list, list]:
    """``fn()`` ``n`` times, each timed on the host clock to a
    synchronize: (outputs, milliseconds).  With ``keep``, only the
    output of call ``keep`` is kept (the others are None)."""
    import torch

    outs, ms = [], []
    for i in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out if keep is None or i == keep else None)
        del out
    return outs, ms


def latency(ms: list, bound: dict) -> dict:
    """p50 and max of the timed calls (the first, untimed, left out),
    beside the bound."""
    import numpy as np

    timed = ms[1:]
    return {"warmup_ms": ms[0], "ms": timed,
            "ms_p50": float(np.median(timed)), "ms_max": max(timed),
            **bound}


def b1_timing(timer, table, idx, what: str) -> dict:
    """B1, its plain version and ``torch.index_select`` on the same rows
    (CUDA events after an L2 flush; B1's launches also by their median,
    ``ms_p50``, which one stalled launch does not move), and the device
    time of B1 and of ``index_select`` by the same clock
    (``kernel_breakdown``: B1's under ``device_ms``, the library's under
    ``library_device_ms``); the layout B1 took; the bound reads each
    index and its row once and writes the row once."""
    import numpy as np
    import torch

    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref

    library = kernel_breakdown(lambda: torch.index_select(table, 0, idx))
    ms = timer(lambda: gk.gather_rows(table, idx))
    return {
        "ms": ms, "ms_p50": float(np.median(timer.last)),
        "plain_ms": timer(lambda: gref.gather_rows(table, idx)),
        **b1_bound(table, idx),
        "library_ms": timer(lambda: torch.index_select(table, 0, idx)),
        **kernel_breakdown(lambda: gk.gather_rows(table, idx)),
        "library_device_ms": library["device_ms"],
        "library_kernels": library["kernels"],
        "layout": b1_layout(table, idx),
        "shape": {"what": what, **b1_shape(table, idx)}}


def b1_bound(table, idx) -> dict:
    """B1's bound: each id read once, each row read once and written
    once, over the memory rate."""
    n_bytes = idx.numel() * (4 + 2 * table.shape[1] * table.element_size())
    return {"bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": n_bytes}


def b1_shape(table, idx) -> dict:
    return {"M": idx.numel(), "D": int(table.shape[1]),
            "N": int(table.shape[0]),
            "row_bytes": int(table.shape[1]) * table.element_size(),
            "dtype": str(table.dtype).removeprefix("torch."),
            "table_offset_bytes": table.data_ptr() % 16}


def b1_layout(table, idx) -> dict:
    """The layout ``rows_layout`` gives B1 on this table, for an output
    on a 16-byte boundary (as ``torch.empty`` allocates it)."""
    from repro_torch.kernels.gather import kernel as gk

    vec, group, rows = gk.rows_layout(table.shape[1], table.element_size(),
                                      idx.numel(), table.data_ptr(), 0)
    return {"vec_bytes": vec, "group": group, "rows_per_group": rows}


def b1_candidate_case(dev, seed: int) -> tuple:
    """Two-tower's ``retrieval_cand`` lookup as B1 sees it, drawn on the
    card: (a 10^6 x 256 float32 table of random normals, 2^20 int32 ids:
    a seeded permutation of the rows padded with draws from it)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    n, m = 10 ** 6, 1 << 20
    table = torch.randn(n, 256, generator=gen, device=dev)
    perm = torch.randperm(n, generator=gen, device=dev)
    pad = perm[torch.randint(0, n, (m - n,), generator=gen, device=dev)]
    return table, torch.cat([perm, pad]).int()


# Phase 12's row-width sweep of B1: (row bytes, float32 elements, the
# table's offset in elements from a 16-byte boundary); each entry's
# output, and its table, is B1_SWEEP_BYTES.
B1_SWEEP = ((8, 2, 0), (32, 8, 0), (64, 16, 0), (128, 32, 0),
            (256, 64, 0), (512, 128, 0), (1000, 250, 0), (1024, 256, 0),
            (4096, 1024, 0), (1024, 256, 1))
B1_SWEEP_BYTES = 512 << 20


def b1_sweep_cases(dev, seed: int):
    """B1's row-width sweep, one case at a time: (label, table, ids), a
    float32 table of B1_SWEEP_BYTES (random normal; a view one element in
    where the case says so) and as many seeded random ids into it, drawn
    on the card.  Each case is freed before the next is made."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    for row_bytes, d, shift in B1_SWEEP:
        n = B1_SWEEP_BYTES // row_bytes
        flat = torch.randn(n * d + shift, generator=gen, device=dev)
        table = flat[shift:].view(n, d)
        idx = torch.randint(0, n, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        yield f"{row_bytes} B" + (f", {shift} element off" if shift else ""), \
            table, idx
        del flat, table, idx
        torch.cuda.empty_cache()


def b1_sweep(dev, seed: int) -> list:
    """Phase 12's row-width sweep: at each case of ``b1_sweep_cases``, B1
    byte-equal to its plain version, the layout it took, its device time
    and ``index_select``'s (``kernel_breakdown``), and the bound."""
    import torch

    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref

    out = []
    for label, table, idx in b1_sweep_cases(dev, seed):
        assert bytes_equal(gk.gather_rows(table, idx),
                           gref.gather_rows(table, idx)), \
            f"gather_rows != plain version (sweep, {label})"
        out.append({
            "what": f"sweep, {label}", **b1_shape(table, idx),
            "layout": b1_layout(table, idx),
            "device_ms": kernel_breakdown(
                lambda: gk.gather_rows(table, idx))["device_ms"],
            "library_device_ms": kernel_breakdown(
                lambda: torch.index_select(table, 0, idx))["device_ms"],
            **b1_bound(table, idx), "equal": True})
    return out


def tower_f64(table, mlp, ids):
    """One tower of two-tower in float64 on the CPU, written out: the
    rows of ``ids``, the dense layers with ReLU between them, the L2
    norm."""
    import torch

    x = table[torch.as_tensor(ids, device=table.device).long()]
    x = x.double().cpu()
    last = len(mlp.layers) - 1
    for i, layer in enumerate(mlp.layers):
        x = x @ layer.w.double().cpu() + layer.b.double().cpu()
        if i < last:
            x = torch.relu(x)
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-6)


def two_tower_f64(model, users, items):
    """Two-tower's scores of ``users`` × ``items`` in float64 on the CPU."""
    return tower_f64(model.user_embed, model.user_tower, users) \
        @ tower_f64(model.item_embed, model.item_tower, items).T


def recsys_retrieval(dev, seed: int, card: str, check,
                     path_launches: dict) -> list:
    """Phase recsys_retrieval: two-tower retrieval and then BERT4Rec at
    their published widths on the card, with TF32 off, each freed
    before the next.  Fails on a failed check.  Returns B1's timings at
    two-tower's shapes (variants of B1's kernels-line entry)."""
    import torch

    matmul = tf32_off("recsys_retrieval")
    b1_variants = []
    for serve in (serve_two_tower, serve_bert4rec):
        row, timed = serve(dev, seed, check, path_launches)
        emit({"phase": "recsys_retrieval", **row, "matmul": matmul,
              "card": card})
        assert not row["failed"], f"{row['model']}: {row['failed']}"
        b1_variants += timed
        gc.collect()
        torch.cuda.empty_cache()        # the model is gone: free it
    return b1_variants


def serve_two_tower(dev, seed: int, check, path_launches: dict):
    """Two-tower at published width (10⁶ users and 10⁶ items × 256,
    towers 1024-512-256): one untimed and 8 timed ``serve_p99`` calls
    (512 users × 512 items) and ``retrieval_cand`` calls (one user ×
    2²⁰ candidates: a seeded permutation of the 10⁶ items, padded with
    48,576 ids drawn from it), each lookup one B1 launch.  Checks: every
    B1 call of the path byte-equal to its plain version; the scores with
    the plain version in B1's place byte-equal; the p99 batch and a
    seeded sample of candidates within ``TT_F64_MAX`` of the float64 CPU
    forward, and two planted faults (ids shifted by one, the L2 norm
    left out) outside it.  Returns (the row, B1's timings)."""
    import numpy as np
    import torch

    from repro_torch.configs import two_tower_retrieval
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref
    from repro_torch.models import recsys

    start = time.perf_counter()
    cfg = two_tower_retrieval._cfg()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    with torch.no_grad():
        t0 = time.perf_counter()
        model = recsys.TwoTower(cfg, device=dev, seed=seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_p99 = RECSYS_SHAPES["serve_p99"]["batch"]
        n_cand = RECSYS_SHAPES["retrieval_cand"]["n_cand"]
        rng = np.random.default_rng(seed)
        p99_ids = [(rng.integers(0, cfg.n_users, n_p99).astype(np.int32),
                    rng.integers(0, cfg.n_items, n_p99).astype(np.int32))
                   for _ in range(1 + RETRIEVAL_TIMED)]
        perm = rng.permutation(cfg.n_items)
        cand_np = np.concatenate([perm, rng.choice(
            perm, n_cand - cfg.n_items)]).astype(np.int32)
        user_np = rng.integers(0, cfg.n_users, 1).astype(np.int32)
        cand = torch.from_numpy(cand_np).to(dev)
        user = torch.from_numpy(user_np).to(dev)
        # The request ids arrive from the host (checked there); the
        # candidate set lives on the card.
        p99_iter = iter(p99_ids)

        reset_launches()
        with recording(gk, "gather_rows", results=True) as b1_calls:
            p99, p99_ms = timed_calls(
                lambda: model.score_candidates(*next(p99_iter)),
                1 + RETRIEVAL_TIMED)
            cands, cand_ms = timed_calls(
                lambda: model.score_candidates(user, cand),
                1 + RETRIEVAL_TIMED)
        path_launches["retrieval_two_tower"] = dict(LAUNCHES)
        n_calls = 2 * 2 * (1 + RETRIEVAL_TIMED)
        assert LAUNCHES["gather_rows"] == n_calls == len(b1_calls), \
            f"two-tower: {LAUNCHES['gather_rows']} B1 launches, " \
            f"{len(b1_calls)} calls, expected {n_calls}"
        assert sum(LAUNCHES.values()) == n_calls, LAUNCHES
        path_peak = torch.cuda.max_memory_allocated() - held_before
        for got in (*p99, *cands):
            assert bool(torch.isfinite(got).all()), "two-tower: non-finite"
        assert tuple(p99[1].shape) == (n_p99, n_p99)
        assert tuple(cands[1].shape) == (1, n_cand)
        assert all(bytes_equal(c, cands[1]) for c in cands), \
            "two-tower: retrieval_cand scores differ between calls"
        # Every B1 call of the path against the plain version.
        for i, (a, kw, out) in enumerate(b1_calls):
            check("gather_rows", out, gref.gather_rows(*a, **kw),
                  f"two-tower call {i}, M = {a[1].numel()}")
        b1_args = {"retrieval_cand": b1_calls[-1][0],
                   "serve_p99": b1_calls[3][0]}
        del b1_calls
        # The same calls with the plain version in B1's place.
        with swapped(gk, "gather_rows", gref.gather_rows):
            assert bytes_equal(model.score_candidates(*p99_ids[1]),
                               p99[1]), "two-tower p99: B1 != plain"
            assert bytes_equal(model.score_candidates(user, cand),
                               cands[1]), "two-tower cand: B1 != plain"
        # Against the float64 CPU forward: the first timed p99 batch and
        # a seeded sample of the candidates; then the planted faults.
        sample = np.sort(rng.choice(n_cand, RETRIEVAL_SAMPLE,
                                    replace=False))
        host_p99 = two_tower_f64(model, *p99_ids[1])
        host_cand = two_tower_f64(model, user_np, cand_np[sample])

        def gap(got, want):
            return float((got.double().cpu() - want).abs().max())

        f64 = {"serve_p99": gap(p99[1], host_p99),
               "retrieval_cand_sample": gap(
                   cands[1][:, torch.from_numpy(sample).to(dev)],
                   host_cand)}
        shifted = (cand_np[sample] + 1) % cfg.n_items
        with swapped(recsys, "_l2n", lambda x: x):
            no_l2 = model.score_candidates(user_np, cand_np[sample])
        faults = {"item ids shifted by one": gap(
                      model.score_candidates(user_np, shifted), host_cand),
                  "L2 norm left out": gap(no_l2, host_cand)}
        failed = [f"f64 {k}: {v} > {TT_F64_MAX}" for k, v in f64.items()
                  if not v <= TT_F64_MAX]
        failed += [f"fault {k}: {v} within {TT_F64_MAX}"
                   for k, v in faults.items() if not v > TT_F64_MAX]

        # Bounds: the towers' products, the scores' product, the rows
        # and the weights read once, the scores written once.
        d = cfg.embed_dim
        dims = [d, *cfg.tower]
        macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        w_bytes = 2 * sum((a + 1) * b for a, b in zip(dims[:-1],
                                                      dims[1:])) * 4

        def bound(b, n):
            return model_bound(
                2 * (b + n) * macs + 2 * b * n * cfg.tower[-1],
                (b + n) * (4 + d * 4) + w_bytes + b * n * 4)

        profiled, call_peak = peak_of(lambda: device_profile(
            lambda: model.score_candidates(user, cand),
            named=("b1_kernel_ms", "gather_rows")))
        timer = Timer(dev)
        timings = [b1_timing(timer, *b1_args[k], f"two-tower {k}")
                   for k in ("retrieval_cand", "serve_p99")]
    row = {"model": cfg.name, "seed": seed, "init_s": init_s,
           "tables_bytes": (cfg.n_users + cfg.n_items) * d * 4,
           "serve_p99": latency(p99_ms, bound(n_p99, n_p99)),
           "retrieval_cand": latency(cand_ms, bound(1, n_cand)),
           "retrieval_cand_profile": profiled,
           "cut": "serve_bulk: (262,144 x 262,144) float32 scores, 275 GB",
           "host_f64_max_abs_err": f64, "bound": TT_F64_MAX,
           "faults": faults, "failed": failed,
           "b1_calls_checked": n_calls, "path_peak_bytes": path_peak,
           "call_peak_bytes": call_peak,
           "launches": path_launches["retrieval_two_tower"],
           "seconds": time.perf_counter() - start}
    return row, timings


def decoder_flops(cfg, b: int, s: int) -> int:
    """Floating-point operations of a dense GQA decoder's trunk over
    (b, s) tokens with every position attending to all s (no causal
    mask): the projections, the GLU FFN and the scores and their V
    products."""
    hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    per_token = 2 * cfg.d_model * (2 * hd + 2 * kvd) \
        + 3 * 2 * cfg.d_model * cfg.d_ff + 2 * 2 * s * hd
    return b * s * cfg.n_layers * per_token


def serve_bert4rec(dev, seed: int, check, path_launches: dict):
    """BERT4Rec at published width (vocab 2²⁰ × 64, 2 layers, 2 heads of
    32, d_ff 256, 200 learned positions, no causal mask): one untimed and
    8 timed ``serve_p99`` calls ((512, 200) item histories → (512, 2²⁰)
    next-item logits) and ``retrieval_cand`` calls ((1, 200) → (1, 2²⁰)),
    plain PyTorch and cuBLAS; then 4 requests within the 200 positions
    behind ``ServeEngine``, each decode round one B8 launch a layer on
    its CUDA-core kernel.  Checks: every B1 call of the timed calls
    byte-equal to its plain version, and the logits with the plain
    version in B1's place byte-equal; ``BERT_SAMPLE_ROWS`` rows of the
    p99 logits and the retrieval logits within ``BERT_F64_MAX`` of the
    float64 CPU forward (each row's gap kept), and two planted faults (a
    causal mask, the learned positions left out) outside it; the
    engine's tokens equal to a run with B8's plain version in its place.
    A gap over the bound fails, and both forwards then run once more on
    the same inputs (``f64_recheck``: whether the card's and the host's
    logits came out the same bytes again, and the gap then), so that the
    row says which side moved.  Returns (the row, [])."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import bert4rec
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.dataplane.recsys import InteractionStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref
    from repro_torch.kernels.paged_attn import kernel as pak
    from repro_torch.kernels.paged_attn import ref as paref
    from repro_torch.models import recsys
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    start = time.perf_counter()
    cfg = bert4rec._cfg()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    n_p99 = RECSYS_SHAPES["serve_p99"]["batch"]
    s = cfg.max_seq
    mask_token = cfg.vocab - 2
    stream = InteractionStream(n_items=mask_token, seed=seed)

    def histories(step: int, b: int) -> torch.Tensor:
        """(b, 200) item histories ending in the mask token: the
        position whose item BERT4Rec predicts."""
        items = stream.sequences(step, b, s, mask_prob=0.0)["items"]
        items[:, -1] = mask_token
        return torch.from_numpy(items).to(dev)

    with torch.no_grad():
        t0 = time.perf_counter()
        params = recsys.bert4rec_init(cfg, device=dev, seed=seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        p99_in = [histories(step, n_p99) for step in range(
            1 + RETRIEVAL_TIMED)]
        one = histories(100, 1)
        p99_iter = iter(p99_in)

        reset_launches()
        # Only the first timed call's (512, 2²⁰) logits are kept.
        with recording(gk, "gather_rows", results=True) as b1_calls:
            p99, p99_ms = timed_calls(
                lambda: recsys.bert4rec_score(params, cfg, next(p99_iter)),
                1 + RETRIEVAL_TIMED, keep=1)
            cands, cand_ms = timed_calls(
                lambda: recsys.bert4rec_score(params, cfg, one),
                1 + RETRIEVAL_TIMED)
        path_launches["retrieval_bert4rec"] = dict(LAUNCHES)
        # B1 twice a forward (the items' and the positions' embeddings);
        # the rest plain PyTorch and cuBLAS.
        n_calls = 2 * (1 + RETRIEVAL_TIMED)
        assert {k: v for k, v in LAUNCHES.items() if v} == \
            {"gather_rows": 2 * n_calls} and \
            len(b1_calls) == 2 * n_calls, (LAUNCHES, len(b1_calls))
        path_peak = torch.cuda.max_memory_allocated() - held_before
        # Every B1 call of the path against the plain version.
        for i, (a, kw, out) in enumerate(b1_calls):
            check("gather_rows", out, gref.gather_rows(*a, **kw),
                  f"bert4rec call {i}, M = {a[1].numel()}")
        del b1_calls
        logits = p99[1]
        del p99
        assert tuple(logits.shape) == (n_p99, cfg.vocab)
        assert tuple(cands[1].shape) == (1, cfg.vocab)
        assert bool(torch.isfinite(logits).all()) and \
            bool(torch.isfinite(cands[1]).all()), "bert4rec: non-finite"
        assert all(bytes_equal(c, cands[1]) for c in cands), \
            "bert4rec: retrieval_cand logits differ between calls"
        # The same calls with the plain version in B1's place.
        with swapped(gk, "gather_rows", gref.gather_rows):
            assert bytes_equal(recsys.bert4rec_score(
                params, cfg, p99_in[1]), logits), "bert4rec p99: B1 != plain"
            assert bytes_equal(recsys.bert4rec_score(params, cfg, one),
                               cands[1]), "bert4rec cand: B1 != plain"
        # Against the float64 CPU forward; then the planted faults.
        rows = np.sort(np.random.default_rng(seed).choice(
            n_p99, BERT_SAMPLE_ROWS, replace=False))
        rows_t = torch.from_numpy(rows).to(dev)
        sample = torch.cat([p99_in[1][rows_t], one])
        got = torch.cat([logits[rows_t], cands[1]])
        del logits
        cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
        params64 = tree_map(lambda t: t.double().cpu(), params)
        host = recsys.bert4rec_score(params64, cfg64, sample.cpu())

        def gap(card):
            return float((card.double().cpu() - host).abs().max())

        f64 = gap(got)
        f64_rows = [float(g) for g in
                    (got.double().cpu() - host).abs().amax(dim=1)]
        recheck = None
        if not f64 <= BERT_F64_MAX:
            # Both forwards once more on the same inputs: which moved.
            again = torch.cat([
                recsys.bert4rec_score(params, cfg, p99_in[1])[rows_t],
                recsys.bert4rec_score(params, cfg, one)])
            host_again = recsys.bert4rec_score(params64, cfg64,
                                               sample.cpu())
            recheck = {"card_bytes_equal": bytes_equal(again, got),
                       "host_bytes_equal": bytes_equal(host_again, host),
                       "gap": float((again.double().cpu() - host_again)
                                    .abs().max())}
            del again, host_again
        causal = dataclasses.replace(cfg, causal=True)
        no_pos = dataclasses.replace(cfg, learned_pos=False)
        faults = {
            "causal mask": gap(recsys.bert4rec_score(params, causal,
                                                     sample)),
            "learned positions left out": gap(recsys.bert4rec_score(
                {k: v for k, v in params.items() if k != "pos_embed"},
                no_pos, sample))}
        failed = [] if f64 <= BERT_F64_MAX else \
            [f"f64: {f64} > {BERT_F64_MAX}"]
        failed += [f"fault {k}: {v} within {BERT_F64_MAX}"
                   for k, v in faults.items() if not v > BERT_F64_MAX]
        del params64, host

        profiled, call_peak = peak_of(lambda: device_profile(
            lambda: recsys.bert4rec_score(params, cfg, p99_in[1]),
            named=("gemm_ms", "gemm")))
        n_params = tf.count_params(params)

        def bound(b):
            return model_bound(
                decoder_flops(cfg, b, s) + 2 * b * cfg.d_model * cfg.vocab,
                n_params * 4 + b * s * 4 + b * cfg.vocab * 4)

        # The engine: 4 requests within the 200 positions.
        rng = np.random.default_rng(seed)
        lens = rng.integers(BERT_PROMPT[0], BERT_PROMPT[1] + 1,
                            BERT_REQUESTS)
        news = rng.integers(BERT_NEW[0], BERT_NEW[1] + 1, BERT_REQUESTS)
        prompts = [rng.integers(0, mask_token, int(n)).astype(np.int32)
                   for n in lens]

        def serve():
            eng = ServeEngine(params, cfg, EngineConfig(**BERT_ENGINE),
                              device=dev)
            for rid, (p, m) in enumerate(zip(prompts, news)):
                eng.submit(Request(prompt=p, rid=rid,
                                   max_new_tokens=int(m)))
            done = eng.run()
            torch.cuda.synchronize()
            return {r.rid: r.out_tokens for r in done}

        reset_launches()
        t0 = time.perf_counter()
        tokens = serve()
        engine_s = time.perf_counter() - t0
        path_launches["retrieval_bert4rec_engine"] = dict(LAUNCHES)
        b8 = LAUNCHES["paged_decode_attention_simt"]
        assert b8 > 0 and b8 % cfg.n_layers == 0 and \
            LAUNCHES["paged_decode_attention"] == 0, LAUNCHES
        with swapped(pak, "paged_decode_attention",
                     lambda *a, **kw: paref.paged_decode_attention(*a)):
            plain = serve()
        if plain != tokens:
            failed.append("engine: tokens with B8 != with its plain version")
    row = {"model": cfg.name, "seed": seed, "init_s": init_s,
           "params": n_params,
           "serve_p99": latency(p99_ms, bound(n_p99)),
           "serve_p99_profile": profiled,
           "retrieval_cand": latency(cand_ms, bound(1)),
           "cut": "serve_bulk: (262,144 x 2^20) float32 logits, 1.1 TB",
           "host_f64_max_abs_err": f64, "host_f64_rows": len(rows) + 1,
           "host_f64_by_row": f64_rows, "f64_recheck": recheck,
           "bound": BERT_F64_MAX, "faults": faults, "failed": failed,
           "engine": {**BERT_ENGINE, "requests": BERT_REQUESTS,
                      "prompt_tokens": [int(n) for n in lens],
                      "new_tokens": [int(m) for m in news],
                      "tokens": sum(map(len, tokens.values())),
                      "seconds": engine_s, "b8_launches": b8},
           "path_peak_bytes": path_peak, "call_peak_bytes": call_peak,
           "launches": path_launches["retrieval_bert4rec"],
           "seconds": time.perf_counter() - start}
    return row, []


def recsys_train(dev, seed: int, card: str, check,
                 path_launches: dict) -> tuple[list, list]:
    """Phase recsys_train: DLRM-RM2, DeepFM and two-tower trained at their
    published widths on the card, one at a time, with TF32 off; then the
    training launcher at smoke width.  Fails on a failed check.  Returns
    (B6's, B1's) timings at the training shapes (kernels-line
    variants)."""
    import torch

    matmul = tf32_off("recsys_train")
    b6, b1 = [], []
    for arch_id, cfg in train_models():
        row, timed = train_recsys_model(dev, seed, arch_id, cfg, check,
                                        path_launches)
        emit({"phase": "recsys_train", **row, "matmul": matmul,
              "card": card})
        assert not row["failed"], f"{row['model']}: {row['failed']}"
        (b1 if arch_id == "two-tower-retrieval" else b6).extend(timed)
        gc.collect()
        torch.cuda.empty_cache()        # the model is gone: free it
    emit({"phase": "recsys_train", **train_launcher(), "card": card})
    return b6, b1


def same_bytes(a, b) -> bool:
    """``bytes_equal`` for tensors of any rank (0-d too) that may require
    a gradient."""
    return bytes_equal(a.detach().reshape(-1), b.detach().reshape(-1))


def train_models() -> list:
    """(arch id, published configuration) of the recsys_train phase."""
    from repro_torch.configs import deepfm, dlrm_rm2, two_tower_retrieval

    return [("dlrm-rm2", dlrm_rm2._cfg()), ("deepfm", deepfm._cfg()),
            ("two-tower-retrieval", two_tower_retrieval._cfg())]


def train_batches(kind: str, cfg, n: int, seed: int) -> list:
    """Steps 0 .. n-1 of the model's stream at ``train_batch`` rows, as
    numpy dicts: ``ClickStream.batch`` (DLRM: dense, bags, labels;
    DeepFM: bags, labels) or ``InteractionStream.pairs`` (two-tower)."""
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.dataplane.recsys import ClickStream, InteractionStream

    b = RECSYS_SHAPES["train_batch"]["batch"]
    if kind == "twotower":
        stream = InteractionStream(n_users=cfg.n_users, n_items=cfg.n_items,
                                   seed=seed)
        return [stream.pairs(step, b) for step in range(n)]
    stream = ClickStream(n_sparse=cfg.n_sparse, rows=cfg.rows, seed=seed,
                         **({"n_dense": cfg.n_dense, "bag_size": cfg.bag_size}
                            if kind == "dlrm" else {}))
    keep = ("dense", "bags", "labels") if kind == "dlrm" else ("bags",
                                                               "labels")
    return [{k: v for k, v in stream.batch(step, b).items() if k in keep}
            for step in range(n)]


def train_bound(kind: str, model, params: dict, b: int) -> dict:
    """The least time of a training step: the dense AdamW sweep's bytes
    (each parameter's p, g, m and v read and p, m and v written, the
    gradient's zero-fill and the norm's read: 9 float32 passes) against
    the MLPs', the interaction's and the logits' operations forward and
    backward (3 × the forward's)."""
    def macs(mlp):
        return sum(layer.w.numel() for layer in mlp.layers)

    cfg = model.cfg
    if kind == "dlrm":
        fwd = 2 * b * (macs(model.bot) + macs(model.top)) \
            + 2 * b * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
    elif kind == "deepfm":
        fwd = 2 * b * macs(model.deep) + 4 * b * cfg.n_sparse * cfg.embed_dim
    else:
        fwd = 2 * b * (macs(model.user_tower) + macs(model.item_tower)) \
            + 2 * b * b * cfg.tower[-1]
    n_bytes = 9 * sum(p.numel() * p.element_size() for p in params.values())
    return model_bound(3 * fwd, n_bytes)


def touched_rows(kind: str, batch: dict) -> dict:
    """{table path: (the distinct ids each table reads, as the index
    tuple of its (T, R, D) or (N, D) parameter; per table the sorted ids;
    the batch's ids renumbered into them)}."""
    import numpy as np

    if kind == "twotower":
        out = {}
        for path, key in (("user_embed/table", "user_ids"),
                          ("item_embed/table", "item_ids")):
            u, local = np.unique(batch[key], return_inverse=True)
            out[path] = ((u,), [u], local.astype(np.int32))
        return out
    bags = batch["bags"]
    ids = [np.unique(col[col >= 0]) for col in bags.transpose(1, 0, 2)]
    local = np.full_like(bags, -1)
    for t, u in enumerate(ids):
        col = bags[:, t]
        local[:, t] = np.where(col >= 0, np.searchsorted(u, col), -1)
    index = (np.concatenate([np.full(len(u), t) for t, u in enumerate(ids)]),
             np.concatenate(ids))
    paths = ("bags/tables",) if kind == "dlrm" else ("bags/tables",
                                                     "linear/tables")
    return {path: (index, ids, local) for path in paths}


def first_step_f64(kind: str, model, p0: dict, batch: dict, rows: dict,
                   opt, dev) -> dict:
    """The first training step's loss and gradients recomputed in
    float64 on the card, independently of the port's train step: every
    dense parameter's gradient and those of the rows the batch reads
    (each table cut to those rows, in the order of ``rows``' index
    tuples).  B6 and B1 run their plain versions."""
    import dataclasses

    import torch

    from repro_torch.carry import model_params
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref

    f64 = torch.float64
    cfg = model.cfg
    if kind == "twotower":
        (uu,), _, lu = rows["user_embed/table"]
        (ui,), _, li = rows["item_embed/table"]
        cfg64 = dataclasses.replace(cfg, dtype=f64, n_users=len(uu),
                                    n_items=len(ui))
        cut = {"user_embed/table": uu, "item_embed/table": ui}
    else:
        _, ids, local = next(iter(rows.values()))
        cfg64 = dataclasses.replace(cfg, dtype=f64,
                                    rows=max(1, max(map(len, ids))))
    host = type(model)(cfg64, device=dev, seed=0)
    own = model_params(host)
    with torch.no_grad():
        for path, p in own.items():
            if path in rows and kind != "twotower":
                p.zero_()
                for t, u in enumerate(ids):
                    rr = torch.from_numpy(u).to(dev)
                    p[t, :len(u)] = p0[path][t, rr].double()
            elif path in rows:
                p.copy_(p0[path][torch.from_numpy(cut[path]).to(dev)])
            else:
                p.copy_(p0[path].double())
    with swapped(gk, "gather_rows_bag", gref.gather_rows_bag), \
            swapped(gk, "gather_rows", gref.gather_rows), \
            torch.enable_grad():
        if kind == "twotower":
            loss = two_tower_loss_backward(
                host, torch.from_numpy(lu).to(dev),
                torch.from_numpy(li).to(dev),
                torch.from_numpy(batch["item_logq"]).to(dev, f64))
        else:
            bags = torch.from_numpy(local).to(dev)
            x = host(torch.from_numpy(batch["dense"]).to(dev, f64), bags) \
                if kind == "dlrm" else host(bags)
            y = torch.from_numpy(batch["labels"]).to(dev, f64)
            # The losses' binary cross-entropy, in float64 throughout.
            loss = torch.mean(torch.clamp(x, min=0) - x * y
                              + torch.log1p(torch.exp(-x.abs())))
            loss.backward()
    grads = {path: p.grad for path, p in own.items()}
    out = {"loss": float(loss.detach()), "grads": {}}
    for path, g in grads.items():
        if path in rows and kind != "twotower":
            # The cut table's rows, in the order of the index tuple.
            g = torch.cat([g[t, :len(u)] for t, u in enumerate(ids)])
        out["grads"][path] = g
    return out


def adamw_first_step(opt, p0: dict, grads: dict, ndims: dict) -> dict:
    """AdamW's first step written out in float64, independently of the
    port's optimizer, on the tensors given (a parameter's touched rows,
    or all of it): the clip by the global norm of ``grads`` (every
    nonzero gradient), the learning rate of step 1, the bias corrections,
    decay on tensors of two or more dimensions (``ndims``).  Returns
    {"p1", "m1", "v1"} keyed as ``grads``, and ``"lr"``."""
    import math

    import torch

    norm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
    scale = min(1.0, opt.grad_clip / max(norm, 1e-6))
    warm = min(1.0, 1 / max(opt.warmup_steps, 1))
    prog = min(max((1 - opt.warmup_steps)
                   / max(opt.total_steps - opt.warmup_steps, 1), 0.0), 1.0)
    lr = opt.lr * warm * (opt.min_lr_ratio + (1 - opt.min_lr_ratio)
                          * 0.5 * (1 + math.cos(math.pi * prog)))
    out = {"p1": {}, "m1": {}, "v1": {}, "lr": lr, "norm": norm}
    for path, g in grads.items():
        g = g * scale
        p = p0[path]
        m = (1 - opt.b1) * g
        v = (1 - opt.b2) * g * g
        delta = (m / (1 - opt.b1)) / (torch.sqrt(v / (1 - opt.b2))
                                      + opt.eps)
        if ndims[path] >= 2:
            delta = delta + opt.weight_decay * p
        out["p1"][path], out["m1"][path], out["v1"][path] = \
            p - lr * delta, m, v
    return out


def two_tower_loss_backward(host, users, items, logq) -> "torch.Tensor":
    """Two-tower's in-batch softmax loss in float64 and its backward into
    ``host``'s parameters, the (B, B) logits never whole: TT_F64_CHUNK
    rows of them at a time give the loss and the gradients of the
    normalised towers' outputs, which then flow back through the
    towers."""
    import torch

    u = host.user(users)
    i = host.item(items)
    temp = host.cfg.temperature
    n = u.shape[0]
    du = torch.zeros_like(u)
    di = torch.zeros_like(i)
    total = 0.0
    with torch.no_grad():
        for lo in range(0, n, TT_F64_CHUNK):
            hi = min(n, lo + TT_F64_CHUNK)
            logits = u[lo:hi] @ i.T / temp - logq[None, :]
            lse = torch.logsumexp(logits, dim=1)
            diag = torch.arange(lo, hi, device=u.device)
            total += float((lse - logits[diag - lo, diag]).sum())
            g = torch.exp(logits - lse[:, None])
            g[diag - lo, diag] -= 1.0
            g /= n
            du[lo:hi] = g @ i / temp
            di += g.T @ u[lo:hi] / temp
    torch.autograd.backward([u, i], [du, di])
    return torch.tensor(total / n, dtype=torch.float64)


def first_step_gaps(state: dict, loss, ref: dict, rows: dict, p0: dict,
                    untouched: dict) -> dict:
    """The first step's result in ``state`` against ``ref`` (the float64
    loss, and AdamW written out in float64 on the card's gradients): the
    loss (relative); the update p1 - p0 and the moments m1, v1 at the
    touched rows and every dense parameter (per tensor the largest
    difference over the largest float64 value, the worst tensor); the
    sampled untouched rows' p1 in float32 ulps of the float64 p1."""
    import torch

    def rel(got, want):
        scale = float(want.abs().max())
        return float((got.double() - want).abs().max()) / scale \
            if scale else float(got.abs().max())

    def at(t, path):
        if path in rows:
            return t[tuple(torch.from_numpy(a).to(t.device)
                           for a in rows[path][0])]
        return t

    params, opt = state["params"], state["opt"]
    gaps = {"loss": abs(float(loss) - ref["loss"]) / abs(ref["loss"]),
            "update": 0.0, "moments": 0.0, "untouched_ulps": 0.0}
    for path in params:
        p0_at = at(p0[path], path).double()
        gaps["update"] = max(gaps["update"], rel(
            at(params[path].detach(), path).double() - p0_at,
            ref["p1"][path] - p0_at))
        for k in ("m", "v"):
            gaps["moments"] = max(gaps["moments"], rel(
                at(opt[k][path], path), ref[f"{k}1"][path]))
    for path, (index, want) in untouched.items():
        a = want.abs().float()
        ulp = (torch.nextafter(a, torch.full_like(a, float("inf")))
               - a).double()
        gaps["untouched_ulps"] = max(gaps["untouched_ulps"], float(
            ((params[path].detach()[index].double() - want).abs()
             / ulp).max()))
    return gaps


def grad_gap(grads: dict, rows: dict, want: dict) -> float:
    """The largest difference of any gradient element (a table's at the
    touched rows) from the float64 one, over the largest float64 element
    of any tensor.  Not per tensor: a tensor whose gradient is a sum that
    nearly cancels (a tower's last bias) has float32 noise far above its
    own largest element."""
    import torch

    worst = 0.0
    for path, w in want.items():
        g = grads[path]
        if path in rows:
            g = g[tuple(torch.from_numpy(a).to(g.device)
                        for a in rows[path][0])]
        worst = max(worst, float((g.double() - w).abs().max()))
    return worst / max(float(w.abs().max()) for w in want.values())


def untouched_sample(kind: str, params: dict, rows: dict, p0: dict, ref,
                     opt, seed: int, dev) -> dict:
    """{table path: (an index tuple of TRAIN_UNTOUCHED rows no id of the
    batch reads, drawn with ``seed``; their float64 p1 = p0 - lr·wd·p0,
    the AdamW step of a zero gradient)}."""
    import numpy as np
    import torch

    # Not default_rng(seed): the data streams draw their ids from it, so
    # its first draws are the batch's own rows.
    rng = np.random.default_rng([seed, TRAIN_UNTOUCHED])
    out = {}
    for path, (index, _, _) in rows.items():
        shape = params[path].shape[:-1]
        flat = np.ravel_multi_index(index, shape)
        draw = np.empty(0, np.int64)
        while draw.size < TRAIN_UNTOUCHED:
            more = rng.integers(0, int(np.prod(shape)), 2 * TRAIN_UNTOUCHED)
            draw = np.concatenate([draw, more[~np.isin(more, flat)]])
        draw = draw[:TRAIN_UNTOUCHED]
        sel = tuple(torch.from_numpy(a).to(dev)
                    for a in np.unravel_index(draw, shape))
        p = p0[path][sel].double()
        out[path] = (sel, p - ref["lr"] * opt.weight_decay * p)
    return out


def train_recsys_model(dev, seed: int, arch_id: str, cfg, check,
                       path_launches: dict) -> tuple:
    """One model of phase recsys_train at published width and
    ``train_batch`` rows: the first step checked in deterministic mode,
    (a) byte for byte against the same step with B6 or B1 swapped for its
    plain version (loss, every gradient, parameters, moments, metrics)
    and (b) within ``TRAIN_F64`` of its float64 recompute (the loss and
    gradients of ``first_step_f64``; the update and moments of
    ``adamw_first_step`` on the card's gradients), with two planted
    faults outside the bounds; then, from the
    same initial state, 1 untimed and TRAIN_STEPS timed steps of
    ``make_train_step`` under ``Supervisor`` with the launch counters
    reset (B6 once a step for DLRM, twice for DeepFM; B1 twice for
    two-tower; every call of the path byte-equal to the plain version
    afterwards), one profiled step, DeepFM's checkpoint written and
    restored byte for byte, and B6's or B1's timings at the path's
    shapes with their plain backward (``index_add_``).  Returns (the
    row, the timings)."""
    import torch

    from repro_torch.configs import train as train_cfgs
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.dataplane.pipeline import device_put
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as optim
    from repro_torch.train.train_state import value_and_grad

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    setup = train_cfgs.train(arch_id, cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model, state, step, kind, opt = (setup[k] for k in (
        "model", "state", "step", "kind", "opt"))
    params = state["params"]
    kname = "gather_rows" if kind == "twotower" else "gather_rows_bag"
    plain = getattr(gref, kname)
    per_step = {"dlrm": {"gather_rows_bag": 1},
                "deepfm": {"gather_rows_bag_tiled": 2},
                "twotower": {"gather_rows": 2}}[kind]
    t0 = time.perf_counter()
    host = train_batches(kind, cfg, 1 + TRAIN_STEPS, seed)
    batches = [device_put(b, dev) for b in host]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    p0 = {k: p.detach().clone() for k, p in params.items()}
    opt_leaves = list(ckpt.flatten_tree(state["opt"]).values())

    def reset_state():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(p0[k])
            for t in opt_leaves:
                t.zero_()

    loss_fn = train_cfgs.loss_for(kind, model)
    failed = []
    # (a) the first step against itself with the plain version of the
    # kernel, in deterministic mode: loss and gradients, then the step.
    with deterministic():
        loss_k, _, g_k = value_and_grad(loss_fn, params, batches[0])
        with swapped(gk, kname, plain):
            loss_r, _, g_r = value_and_grad(loss_fn, params, batches[0])
        same = {"loss": same_bytes(loss_k, loss_r),
                "grads": all(same_bytes(g_k[k], g_r[k]) for k in g_k)}
        del g_r
        rows = touched_rows(kind, host[0])
        ref = first_step_f64(kind, model, p0, host[0], rows, opt, dev)
        g_at, p0_at = {}, {}
        for path in ref["grads"]:
            sel = tuple(torch.from_numpy(a).to(dev) for a in rows[path][0]) \
                if path in rows else ...
            g_at[path] = g_k[path][sel].double()
            p0_at[path] = p0[path][sel].double()
        clean_grad_gap = grad_gap(g_k, rows, ref["grads"])
        del g_k
        # The update against AdamW written out in float64 on the card's
        # own gradients: the first step divides each gradient by its own
        # size, so one within float32 noise of zero (about eps) may step
        # either way, and float64 gradients would not tell the update's
        # arithmetic from that noise.
        ref.update(adamw_first_step(opt, p0_at, g_at, {
            path: p.ndim for path, p in params.items()}))
        del g_at, p0_at
        untouched = untouched_sample(kind, params, rows, p0, ref, opt, seed,
                                     dev)
        _, m_k = step(state, batches[0])
        gaps = {**first_step_gaps(state, m_k["loss"], ref, rows, p0,
                                  untouched), "grad": clean_grad_gap}
        snap = {k: v.detach().to("cpu")
                for k, v in ckpt.flatten_tree(state).items()}
        reset_state()
        with swapped(gk, kname, plain):
            _, m_r = step(state, batches[0])
        same["state"] = all(same_bytes(v, snap[k].to(dev))
                            for k, v in ckpt.flatten_tree(state).items())
        same["metrics"] = all(same_bytes(m_k[k], m_r[k]) for k in m_k)
        del snap
        # Planted faults: the table gradient added into the next row;
        # the learning rate of the step after.  Each must leave a gap
        # outside the bounds.
        back = "gather_rows_backward" if kind == "twotower" \
            else "gather_rows_bag_backward"
        real_back, real_sched = getattr(gref, back), optim.schedule

        def next_row(grad_out, ids, n_rows):
            return real_back(grad_out, torch.where(
                ids >= 0, (ids + 1) % n_rows, ids), n_rows)

        faults = {}
        for what, mod, name, fn in (
                ("gradient into the next row", gref, back, next_row),
                ("learning rate one step ahead", optim, "schedule",
                 lambda c, s: real_sched(c, s + 1))):
            reset_state()
            with swapped(mod, name, fn):
                _, _, g_f = value_and_grad(loss_fn, params, batches[0])
                fault_grad_gap = grad_gap(g_f, rows, ref["grads"])
                del g_f
                _, m_f = step(state, batches[0])
            faults[what] = {**first_step_gaps(state, m_f["loss"], ref, rows,
                                              p0, untouched),
                            "grad": fault_grad_gap}
    failed += [f"plain {k}: not byte-equal" for k, ok in same.items()
               if not ok]
    failed += [f"f64 {k}: {v} > {TRAIN_F64[k]}" for k, v in gaps.items()
               if not v <= TRAIN_F64[k]]
    failed += [f"fault {what}: within the bounds"
               for what, g in faults.items()
               if all(v <= TRAIN_F64[k] for k, v in g.items())]

    # The main path: from the same initial state, 1 + TRAIN_STEPS steps
    # under the supervisor, the launch counters reset just before.
    reset_state()
    del p0
    state, run, calls = supervised_run(
        step, state, lambda i: batches[i], 1 + TRAIN_STEPS,
        f"recsys_train_{kind}", path_launches,
        {k: n * (1 + TRAIN_STEPS) for k, n in per_step.items()}, failed,
        record=lambda: recording(gk, kname))
    phase_peak = torch.cuda.max_memory_allocated() - held_before
    # The last step's calls, checked on their inputs as they are now (the
    # optimizer has moved the tables since the calls ran).
    timed_args = [a for a, _ in calls[-sum(per_step.values()):]]
    del calls
    with torch.no_grad():
        for i, a in enumerate(timed_args):
            check(kname, getattr(gk, kname)(*a), plain(*a),
                  f"{cfg.name} train_batch call {i}")
    b = RECSYS_SHAPES["train_batch"]["batch"]
    bound = train_bound(kind, model, params, b)
    # B6 or B1 and the backward's index kernels by name, wherever they
    # rank (the top 8 are the optimizer's passes and the GEMMs).
    profiled = profile_step(lambda: step(state, batches[-1]),
                            ("gather_rows", "indexFunc", "index_put",
                             "indexing_backward"),
                            named=(f"{kname}_ms", kname))

    row = {"model": cfg.name, "seed": seed, "batch": b, "init_s": init_s,
           "data_s": data_s,
           "params": sum(p.numel() for p in params.values()),
           "state_bytes": sum(t.numel() * t.element_size() for t in
                              ckpt.flatten_tree(state).values()),
           **run, "samples_per_s": b / (run["step_ms_p50"] / 1e3),
           **bound, "profiled_step": profiled,
           "first_step": {"plain_byte_equal": same, "f64_gaps": gaps,
                          "bounds": TRAIN_F64, "faults": faults,
                          "grad_norm": float(m_k["grad_norm"]),
                          "f64_norm": ref["norm"], "lr": float(m_k["lr"]),
                          "touched_rows": {k: int(len(v[0][-1]))
                                           for k, v in rows.items()}},
           "phase_peak_bytes": phase_peak, "failed": failed}
    if kind == "deepfm":
        row["checkpoint"] = checkpoint_round_trip(
            arch_id, cfg, state, dev, seed, 1 + TRAIN_STEPS)
        if not row["checkpoint"]["byte_equal"]:
            failed.append("checkpoint: restored state differs")
    timer = Timer(dev)
    timings = []
    with torch.no_grad():
        for a in timed_args:
            t = bag_timing(dev, *a, f"{cfg.name} train_batch") \
                if kname == "gather_rows_bag" else \
                b1_timing(timer, *a, f"{cfg.name} train_batch")
            timings.append({**t, "backward": backward_timing(timer, kname,
                                                             *a)})
    row["seconds"] = time.perf_counter() - start
    return row, timings


def supervised_run(step, state, source, n: int, key: str,
                   path_launches: dict, want: dict, failed: list,
                   record=contextlib.nullcontext) -> tuple:
    """The main path of a training phase: ``n`` steps of ``step`` from
    ``state`` under ``Supervisor`` (``source(i)`` the i-th batch, no
    checkpoint), the launch counters reset just before and read into
    ``path_launches[key]`` just after, with ``record()`` (a recording
    of kernel calls) around the run.  Appends to ``failed`` the launches
    that differ from ``want`` (every nonzero count), any restart and any
    loss that is not finite.  Returns (state, the run's fields of the
    phase row, what ``record()`` gave)."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train.fault import FaultConfig, Supervisor

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as unused:
        sup = Supervisor(FaultConfig(ckpt_dir=unused, ckpt_every=1 << 30),
                         step, source)
        losses = []
        reset_launches()
        with record() as calls:
            state = sup.run(state, n,
                            on_metrics=lambda i, m: losses.append(m["loss"]))
        launches = path_launches[key] = dict(LAUNCHES)
    if {k: c for k, c in launches.items() if c} != want:
        failed.append(f"launches {launches}, expected {want}")
    if sup.restarts:
        failed.append(f"{sup.restarts} restarts")
    path_peak = torch.cuda.max_memory_allocated() - held
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        failed.append(f"losses {losses}")
    step_ms = [t * 1e3 for t in sup.monitor.times]
    return state, {"step_ms": step_ms,
                   "step_ms_p50": float(np.median(step_ms[1:])),
                   "step_ms_max": max(step_ms[1:]), "losses": losses,
                   "restarts": sup.restarts, "path_peak_bytes": path_peak,
                   "launches": launches}, calls


def profile_step(fn, parts: tuple = (), **kw) -> dict:
    """One more training step under the profiler (``device_profile``,
    ``kw`` passed on): the top 8 device kernels, every kernel's time by
    group, and under ``named`` those whose names hold one of ``parts``,
    wherever they rank."""
    profiled = device_profile(fn, top=1 << 16, **kw)
    profiled["by_group"] = profiled_groups(profiled["top"])
    if parts:
        profiled["named"] = [k for k in profiled["top"]
                             if any(part in k["name"] for part in parts)]
    profiled["top"] = profiled["top"][:8]
    return profiled


def profiled_groups(kernels: list) -> dict:
    """A profiled step's kernels summed by what they are: B6 or B1, the
    backward's index kernels, the GEMMs, elementwise passes (the
    optimizer's, and the forward's and backward's), reductions, the
    rest."""
    groups = {"gather": 0.0, "segment": 0.0, "index": 0.0, "gemm": 0.0,
              "elementwise": 0.0, "reduce": 0.0, "other": 0.0}
    for k in kernels:
        name = k["name"].lower()
        key = ("gather" if "gather_rows" in name or "union" in name else
               "segment" if "segment_sum" in name else
               "index" if "index" in name or "scatter" in name else
               "gemm" if any(s in name for s in ("gemm", "nvjet", "cutlass",
                                                 "xmma")) else
               "elementwise" if "elementwise" in name else
               "reduce" if "reduce" in name else "other")
        groups[key] += k["ms"]
    return groups


def backward_timing(timer, kname: str, table, ids) -> dict:
    """The plain backward of B6 or B1 at a path call's shape (a dense
    zero table and ``index_add_`` of a seeded grad_out at the ids): CUDA
    events and the device time by kernel; the bound writes the table's
    zeros once and reads and adds each grad_out row once."""
    import torch

    from repro_torch.kernels.gather import ref as gref

    gen = torch.Generator(device=table.device).manual_seed(0)
    n, d = table.shape
    grad_out = torch.randn((ids.shape[0], d), generator=gen,
                           device=table.device, dtype=table.dtype)
    if kname == "gather_rows":
        fn = lambda: gref.gather_rows_backward(grad_out, ids, n)  # noqa: E731
    else:
        fn = lambda: gref.gather_rows_bag_backward(  # noqa: E731
            grad_out, ids, n)
    size = table.element_size()
    n_bytes = n * d * size + ids.numel() * (4 + 3 * d * size)
    return {"ms": timer(fn), "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", **kernel_breakdown(fn, iters=5)}


def checkpoint_round_trip(arch_id, cfg, state, dev, seed: int,
                          step: int) -> dict:
    """Write ``state`` as a checkpoint (async: the host copy on this
    thread, the files on another) into a temporary directory under
    ``build/``, restore it into a fresh state of the same model and
    compare byte for byte; the directory is removed."""
    import torch

    from repro_torch.configs import train as train_cfgs
    from repro_torch.train import checkpoint as ckpt

    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        thread = ckpt.save_checkpoint(d, step, state, blocking=False)
        out["snapshot_s"] = time.perf_counter() - t0
        thread.join()
        out["write_s"] = time.perf_counter() - t0
        out["bytes"] = sum(f.stat().st_size for f in Path(d).rglob("*")
                           if f.is_file())
        fresh = train_cfgs.train(arch_id, cfg, device=dev, seed=seed + 1)
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(d, step, fresh["state"])
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        got = ckpt.flatten_tree(fresh["state"])
        out["byte_equal"] = all(same_bytes(got[k], v) for k, v in
                                ckpt.flatten_tree(state).items())
        out["leaves"] = len(got)
        del fresh, got
    return out


def train_launcher() -> dict:
    """``python -m repro_torch.launch.train --arch dlrm-rm2 --steps 20`` at
    smoke width on the card, its checkpoints in a temporary directory
    under ``build/``; it must exit 0."""
    import os

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "dlrm-rm2", "--steps", "20", "--ckpt-dir", d]
        t0 = time.perf_counter()
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=600, cwd=ROOT,
                             env={**os.environ, "PYTHONPATH": str(
                                 ROOT / "src")})
        seconds = time.perf_counter() - t0
        ckpts = sorted(p.name for p in Path(d).glob("step_*"))
    assert out.returncode == 0, f"training launcher: exit {out.returncode}" \
        f"\n{out.stderr[-2000:]}"
    return {"launcher": argv[2:-2], "exit": out.returncode,
            "seconds": seconds, "checkpoints": ckpts,
            "said": out.stdout.splitlines()}


def train_more(dev, seed: int, card: str, check,
               path_launches: dict) -> tuple[list, list]:
    """Phase train_more: NequIP (``molecule``, ``minibatch_lg``),
    BERT4Rec and GLM-4 trained at published width on the card, one at a
    time, TF32 off; then the launcher at smoke width for the LM, GNN and
    BERT4Rec families.  Fails on a failed check.  Returns (B7's timings
    at the training shapes, the union read's at the LM batch: kernels-
    line variants)."""
    import torch

    matmul = tf32_off("train_more")
    b7, union = [], []
    for shape in MORE_GNN:
        row, timed = train_nequip_shape(dev, seed, shape, check,
                                        path_launches)
        emit({"phase": "train_more", **row, "matmul": matmul, "card": card})
        assert not row["failed"], f"{row['model']}: {row['failed']}"
        b7.extend(timed)
        gc.collect()
        torch.cuda.empty_cache()
    row = train_bert4rec(dev, seed, path_launches)
    emit({"phase": "train_more", **row, "matmul": matmul, "card": card})
    assert not row["failed"], f"{row['model']}: {row['failed']}"
    gc.collect()
    torch.cuda.empty_cache()
    row, timed = train_glm4(dev, seed, check, path_launches)
    emit({"phase": "train_more", **row, "matmul": matmul, "card": card})
    assert not row["failed"], f"{row['model']}: {row['failed']}"
    union.extend(timed)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_more", **train_more_launchers(dev, seed),
          "card": card})
    return b7, union


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|, in float64 (0 where both are
    0)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    return diff / scale if scale else diff


def grads_gap(got: dict, want: dict) -> float:
    """The largest difference of any gradient element over the largest
    float64 gradient element of the model (``grad_gap``'s measure)."""
    scale = max(float(w.detach().abs().max()) for w in want.values())
    return max(float((got[k].detach().double().cpu()
                      - w.detach().double().cpu()).abs().max())
               for k, w in want.items()) / scale


def close_ratio(got, want, tol: dict = GNN_F64) -> float:
    """max |got - want| / (atol + rtol |want|) in float64 over every
    element: at most 1 where ``np.allclose(got, want, **tol)`` holds."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    if not want.numel():
        return 0.0
    return float(((got - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


def nequip_step_flops(cfg, n: int, e: int, forces: bool) -> int:
    """Operations of a NequIP training step: the forward's radial MLP,
    tensor products, channel mixes, self-interactions and gates, the
    embedding and the readout (F), and the least backward: 2F for a
    node-class loss, and for energy + forces the forces' backward (2F)
    and then the backward of both (2 × 3F): 3F or 9F."""
    c, paths = cfg.channels, cfg.paths
    per_layer = 2 * e * (cfg.n_rbf * cfg.radial_hidden
                         + cfg.radial_hidden * len(paths) * c)
    for li, lf, lo in paths:
        per_layer += 2 * e * c * (2 * li + 1) * (2 * lo + 1) \
            + 2 * e * (2 * li + 1) * (2 * lf + 1) * (2 * lo + 1)
    for l in cfg.ls:
        k = sum(1 for p in paths if p[2] == l)
        per_layer += 2 * e * (2 * l + 1) * k * c * c \
            + 2 * n * (2 * l + 1) * c * c + (2 * n * c * c if l else 0)
    fwd = cfg.n_layers * per_layer + 2 * n * (cfg.d_feat * c + c * c
                                              + c * cfg.n_out)
    return (9 if forces else 3) * fwd


def nequip_train_batch(shape: str, seed: int) -> dict:
    """Phase 9's graph of ``shape`` as a training batch (numpy): for
    ``molecule`` with drawn force targets (normal, 0.1, from ``seed``)
    beside the data plane's energies."""
    import numpy as np

    host = dict(gnn_batch(shape))
    if shape == "molecule":
        host["forces"] = np.random.default_rng(seed).normal(
            0.0, 0.1, host["positions"].shape).astype(np.float32)
    return host


def nequip_batch_on(host: dict, device, dtype) -> dict:
    """``host`` as tensors on ``device``: floats in ``dtype``, ids as
    they are, ``n_graphs`` as a number."""
    import numpy as np
    import torch

    out = {}
    for k, v in host.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = t.to(device, dtype) if t.is_floating_point() \
                else t.to(device)
        elif v is not None:
            out[k] = v
    return out


def train_nequip_shape(dev, seed: int, shape: str, check,
                       path_launches: dict) -> tuple:
    """NequIP at published width trained on phase 9's graph of ``shape``
    (``molecule``: energies + 100 × forces, the forces differentiated
    through; ``minibatch_lg``: node classes), the configuration's AdamW.
    The first step is held (a) in deterministic mode byte for byte
    against the same step with B7 swapped for its plain version (the
    loss, every gradient, the forces) and (b) against the float64 CPU
    recompute of the same weights within ``NEQUIP_TRAIN_F64``, with
    planted faults (the forces' sign; one edge's destination shifted)
    outside; B7's launches are counted in the loss's forward and in the
    weights' backward (the backward of the forces' backward), whose
    every B7 call is checked against the plain version and whose
    largest sum is timed.  Then 1 + ``MORE_STEPS["nequip"]`` steps under
    ``Supervisor`` with the counters reset, one profiled step."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import carry
    from repro_torch.configs import nequip as nequip_cfg
    from repro_torch.configs import train as train_cfgs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.segment import kernel as segk
    from repro_torch.kernels.segment import ref as segref
    from repro_torch.models import nequip as nq
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_state import value_and_grad

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    info, cfg = GNN_SHAPES[shape], nequip_cfg.for_shape(shape)
    forces = cfg.readout == "energy"
    host = nequip_train_batch(shape, seed)
    batch = nequip_batch_on(host, dev, torch.float32)
    setup = train_cfgs.train("nequip", cfg, device=dev, seed=seed)
    model, state, step = setup["model"], setup["state"], setup["step"]
    params = state["params"]
    loss_fn = train_cfgs.loss_for("nequip", model)
    p0 = {k: p.detach().clone() for k, p in params.items()}
    opt_leaves = list(ckpt.flatten_tree(state["opt"]).values())

    def reset_state():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(p0[k])
            for t in opt_leaves:
                t.zero_()

    def outputs_of(m, b):
        """{"out": the model's outputs} and, for energies, the forces."""
        args = (b["node_feat"], b["positions"], b["edge_index"], None,
                b.get("graph_ids"), b.get("n_graphs", 1))
        if forces:
            e, f = nq.nequip_energy_forces(m, *args)
            return {"out": e, "forces": f}
        with torch.no_grad():
            return {"out": m(*args)}

    failed = []
    # (a) B7 against its plain version, and the launches by stage.
    with deterministic():
        n0 = LAUNCHES["segment_sum"]
        with torch.enable_grad():
            for p in params.values():
                p.requires_grad_(True)
            loss_k = nq.nequip_loss(model, batch)
            n1 = LAUNCHES["segment_sum"]
            with recording(segk, "segment_sum", results=True) as second:
                g_k = dict(zip(params, torch.autograd.grad(
                    loss_k, list(params.values()), allow_unused=True)))
        n2 = LAUNCHES["segment_sum"]
        stages = {"loss": n1 - n0, "weights_backward": n2 - n1}
        with swapped(segk, "segment_sum", segref.segment_sum):
            loss_r, _, g_r = value_and_grad(loss_fn, params, batch)
            o_r = outputs_of(model, batch)
        o_k = outputs_of(model, batch)
    same = {"loss": same_bytes(loss_k, loss_r),
            "grads": all(g_k[k] is None and not bool(g_r[k].any())
                         or g_k[k] is not None and same_bytes(g_k[k], g_r[k])
                         for k in g_r),
            **{k: same_bytes(o_k[k], o_r[k]) for k in o_k}}
    del g_r
    with torch.no_grad():
        for i, (a, kw, out) in enumerate(second):
            check("segment_sum", out, segref.segment_sum(*a, **kw),
                  f"train {shape} weights' backward call {i}")
    # (b) the float64 CPU recompute of the same weights and batch.
    t0 = time.perf_counter()
    host_model = nq.NequIP(dataclasses.replace(cfg, dtype=torch.float64),
                           device="cpu")
    host_model.load_state_dict({k: v.detach().double().cpu() for k, v in
                                model.state_dict().items()})
    hb = nequip_batch_on(host, "cpu", torch.float64)
    hparams = carry.model_params(host_model)
    loss64, _, g64 = value_and_grad(train_cfgs.loss_for("nequip",
                                                        host_model),
                                    hparams, hb)
    o64 = outputs_of(host_model, hb)
    host_s = time.perf_counter() - t0
    g_k = {k: torch.zeros_like(params[k]) if g is None else g
           for k, g in g_k.items()}

    def gaps_of(loss, grads, outs):
        return {"loss": close_ratio(loss, loss64),
                "grad": grads_gap(grads, g64),
                **{k: close_ratio(outs[k], o64[k]) for k in o64}}

    gaps = gaps_of(loss_k, g_k, o_k)
    del g_k
    # Planted faults: the forces' sign flipped in the loss; one real
    # edge's destination moved to the next node (a labelled node's edge
    # for node classes).
    faults = {}
    real_forces = nq.nequip_energy_forces

    def flipped(*a, **kw):
        e, f = real_forces(*a, **kw)
        return e, -f

    # The edge: of the real ones whose old and new destinations both lie
    # within half the cutoff of its source, the shortest (the largest
    # radial basis), so that its message moves.
    ei, pos = host["edge_index"], host["positions"]
    nxt = (ei[1] + 1) % info["n_nodes"]
    near = (ei[0] >= 0) & (ei[1] >= 0)
    for dst in (ei[1], nxt):
        gap = pos[np.maximum(ei[0], 0)] - pos[np.maximum(dst, 0)]
        near &= np.linalg.norm(gap, axis=-1) < cfg.cutoff / 2
    if not forces:
        near &= host["label_mask"][np.maximum(ei[1], 0)] > 0
    length = np.linalg.norm(pos[np.maximum(ei[0], 0)]
                            - pos[np.maximum(ei[1], 0)], axis=-1)
    edge = int(np.flatnonzero(near)[np.argmin(length[near])])
    shifted = ei.copy()
    shifted[1, edge] = nxt[edge]
    bad_edge = {**batch, "edge_index": torch.from_numpy(shifted).to(dev)}
    plants = [("one edge's destination shifted", None, bad_edge)]
    if forces:
        plants.append(("forces' sign flipped", flipped, batch))
    for what, fn, b in plants:
        ctx = swapped(nq, "nequip_energy_forces", fn) if fn else \
            contextlib.nullcontext()
        with ctx:
            loss_f, _, g_f = value_and_grad(loss_fn, params, b)
            o_f = outputs_of(model, b)
        faults[what] = gaps_of(loss_f, g_f, o_f)
        del g_f
    failed += [f"plain {k}: not byte-equal" for k, ok in same.items()
               if not ok]
    failed += [f"f64 {k}: {v} > {NEQUIP_TRAIN_F64[k]}"
               for k, v in gaps.items() if not v <= NEQUIP_TRAIN_F64[k]]
    failed += [f"fault {what}: within the bounds"
               for what, g in faults.items()
               if all(v <= NEQUIP_TRAIN_F64[k] for k, v in g.items())]
    if forces and not stages["weights_backward"]:
        failed.append("no B7 launch in the double backward")
    # B7 at the largest sum of the weights' backward.
    (m2, plan2, s2), _, _ = max(second, key=lambda c: c[0][0].numel())
    timed = [segment_timing(dev, m2, plan2.ids, s2,
                            f"train {shape}: the weights' backward")]
    del second, host_model, hparams, g64, hb

    # The main path: 1 + steps under the supervisor, counters reset.
    steps = MORE_STEPS["nequip"]
    reset_state()
    del p0
    # Plans a step: the destination ids, the source ids (the gathers)
    # and, for energies, the graph ids.
    per_step = {"segment_sum": stages["loss"] + stages["weights_backward"],
                "segment_plan": 2 + forces}
    state, run, _ = supervised_run(
        step, state, lambda i: batch, 1 + steps, f"train_nequip_{shape}",
        path_launches, {k: n * (1 + steps) for k, n in per_step.items()},
        failed)
    p50 = run["step_ms_p50"]
    flops = nequip_step_flops(cfg, info["n_nodes"], info["n_edges"], forces)
    n_bytes = 9 * sum(p.numel() * p.element_size() for p in params.values())
    profiled = profile_step(lambda: step(state, batch))
    row = {"model": f"nequip {shape}", "seed": seed,
           "nodes": info["n_nodes"], "edges": info["n_edges"],
           "readout": cfg.readout, "forces": forces,
           "params": sum(p.numel() for p in params.values()), **run,
           "samples": "graphs" if forces else "seed nodes",
           "samples_per_s": (info.get("n_graphs") or MINIBATCH_SEEDS)
           / (p50 / 1e3),
           "edges_per_s": info["n_edges"] / (p50 / 1e3),
           **model_bound(flops, n_bytes), "profiled_step": profiled,
           "b7_launches_per_step": stages,
           "first_step": {"plain_byte_equal": same, "f64_gaps": gaps,
                          "bounds": NEQUIP_TRAIN_F64, "faults": faults,
                          "host_f64_s": host_s},
           "phase_peak_bytes": torch.cuda.max_memory_allocated()
           - held_before, "failed": failed,
           "seconds": time.perf_counter() - start}
    return row, timed


def bert4rec_train_batches(cfg, n: int, rows: int, seed: int) -> list:
    """``n`` cloze batches of ``rows`` histories of ``cfg.max_seq`` items
    (numpy): items uniform over the catalogue, each position masked with
    probability ``BERT_MASK_RATE`` (its input the mask token, V - 2, its
    label the item), the mask as weights."""
    import numpy as np

    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 1000 + i)
        items = rng.integers(0, cfg.vocab - 2, (rows, cfg.max_seq)).astype(
            np.int32)
        mask = rng.random((rows, cfg.max_seq)) < BERT_MASK_RATE
        out.append({"items": np.where(mask, cfg.vocab - 2, items).astype(
                        np.int32),
                    "labels": items, "mask": mask.astype(np.float32)})
    return out


def ce_f64(h, table, labels, weights, chunk: int):
    """The chunked tied cross-entropy recomputed in float64 and
    differentiated by autograd, each chunk's step under
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``
    inside its scan): (loss, dh, dtable), all float64."""
    import torch
    from torch.utils.checkpoint import checkpoint

    d = h.shape[-1]
    h64 = h.detach().double().reshape(-1, d).requires_grad_(True)
    t64 = table.detach().double().requires_grad_(True)
    lab = labels.reshape(-1).long()
    w = weights.reshape(-1).double()
    v = t64.shape[0]

    def chunk_step(m, s, gold, tb, start):
        logits = h64 @ tb.T
        col = torch.arange(start, start + tb.shape[0], device=h.device)
        m2 = torch.maximum(m, logits.max(dim=-1).values)
        s2 = s * torch.exp(m - m2) + torch.exp(logits - m2[:, None]).sum(-1)
        hit = col[None, :] == lab[:, None]
        return m2, s2, gold + torch.where(hit, logits, 0.0).sum(-1)

    rows = h64.shape[0]
    m = torch.full((rows,), -torch.inf, dtype=torch.float64, device=h.device)
    s = torch.zeros((rows,), dtype=torch.float64, device=h.device)
    gold = torch.zeros_like(s)
    with torch.enable_grad():
        for start in range(0, v, chunk):
            m, s, gold = checkpoint(chunk_step, m, s, gold,
                                    t64[start:start + chunk], start,
                                    use_reentrant=False)
        nll = m + torch.log(s) - gold
        loss = torch.sum(nll * w) / torch.clamp(w.sum(), min=1.0)
        dh, dt = torch.autograd.grad(loss, (h64, t64))
    return loss.detach(), dh.reshape(h.shape), dt


def train_bert4rec(dev, seed: int, path_launches: dict) -> dict:
    """BERT4Rec at published width (vocab 2²⁰ × 64, 2 layers, 200 learned
    positions) trained with its AdamW on ``BERT_TRAIN_ROWS`` rows a step:
    the first step's chunked cross-entropy (its inputs recorded from the
    step) held within ``CE_F64`` of ``ce_f64`` on the card (the loss,
    ``dh``, ``dtable`` and its label rows), labels shifted by one item
    outside; its backward's peak memory beside one (rows · 48, 2²⁰)
    float32 logits tensor; then 1 + ``MORE_STEPS["bert4rec"]`` steps
    under ``Supervisor``, one profiled step."""
    import torch

    from repro_torch.configs import bert4rec as bert_cfg
    from repro_torch.configs import train as train_cfgs
    from repro_torch.dataplane.pipeline import device_put
    from repro_torch.models import layers
    from repro_torch.models import recsys as rs
    from repro_torch.train.train_state import value_and_grad

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    cfg, rows = bert_cfg._cfg(), BERT_TRAIN_ROWS
    steps = MORE_STEPS["bert4rec"]
    setup = train_cfgs.train("bert4rec", cfg, device=dev, seed=seed)
    state, step = setup["state"], setup["step"]
    params = state["params"]
    host = bert4rec_train_batches(cfg, 1 + steps, rows, seed)
    batches = [device_put(b, dev) for b in host]
    loss_fn = train_cfgs.loss_for("bert4rec", params, cfg)
    failed = []
    # The first step's cross-entropy, its inputs recorded from the loss.
    with recording(rs, "cross_entropy_tied_chunked") as ce_calls:
        loss0, _, g0 = value_and_grad(loss_fn, params, batches[0])
    del g0
    (h_m, table, lab, w), kw = ce_calls[0]
    chunk = kw["chunk"]
    h = h_m.detach().requires_grad_(True)
    t = table.detach().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ce = layers.cross_entropy_tied_chunked(h, t, lab, w, chunk=chunk)
    fwd_peak = torch.cuda.max_memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dh, dt = torch.autograd.grad(ce, (h, t))
    bwd_peak = torch.cuda.max_memory_allocated() - held
    t0 = time.perf_counter()
    loss64, dh64, dt64 = ce_f64(h, t, lab, w, chunk)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    label_rows = torch.unique(lab[w > 0]).long()

    def gaps_of(loss, dh_, dt_):
        return {"loss": abs(float(loss.detach()) - float(loss64))
                / abs(float(loss64)), "dh": rel_gap(dh_, dh64),
                "dtable": rel_gap(dt_, dt64),
                "dtable_label_rows": rel_gap(dt_[label_rows],
                                             dt64[label_rows])}

    gaps = gaps_of(ce, dh, dt)
    same_loss = same_bytes(ce, loss0)
    del dh, dt
    # Planted fault: the labels shifted by one item.
    lab_f = (lab + 1) % (cfg.vocab - 2)
    ce_f = layers.cross_entropy_tied_chunked(h, t, lab_f, w, chunk=chunk)
    faults = {"labels shifted by one item": gaps_of(
        ce_f, *torch.autograd.grad(ce_f, (h, t)))}
    del ce_f, dh64, dt64, h, t
    if not same_loss:
        failed.append("the recorded CE's loss != the step's")
    failed += [f"f64 {k}: {v} > {CE_F64[k]}" for k, v in gaps.items()
               if not v <= CE_F64[k]]
    failed += [f"fault {what}: within the bounds"
               for what, g in faults.items()
               if all(v <= CE_F64[k] for k, v in g.items())]
    logits_bytes = h_m.shape[0] * h_m.shape[1] * cfg.vocab * 4
    del ce_calls, h_m, table, lab, w

    # B1 twice a step (the items' and the positions' embeddings).
    state, run, _ = supervised_run(
        step, state, lambda i: batches[i], 1 + steps, "train_bert4rec",
        path_launches, {"gather_rows": 2 * (1 + steps)}, failed)
    masked = min(rs.MAX_MASKED, cfg.max_seq)
    ce_flops = 4 * 2 * rows * masked * cfg.d_model * cfg.vocab
    flops = 3 * decoder_flops(cfg, rows, cfg.max_seq) + ce_flops
    n_bytes = 9 * sum(p.numel() * p.element_size() for p in params.values())
    profiled = profile_step(lambda: step(state, batches[-1]))
    return {"model": cfg.name, "seed": seed, "batch": rows,
            "cut": "train_batch 65,536 -> " + str(rows),
            "params": sum(p.numel() for p in params.values()), **run,
            "samples_per_s": rows / (run["step_ms_p50"] / 1e3),
            **model_bound(flops, n_bytes), "ce_flops": ce_flops,
            "profiled_step": profiled,
            "first_step": {"f64_gaps": gaps, "bounds": CE_F64,
                           "faults": faults, "f64_s": f64_s,
                           "ce_rows": rows * masked, "chunk": chunk,
                           "ce_forward_peak_bytes": fwd_peak,
                           "ce_backward_peak_bytes": bwd_peak,
                           "one_logits_tensor_bytes": logits_bytes},
            "phase_peak_bytes": torch.cuda.max_memory_allocated()
            - held_before, "failed": failed,
           "seconds": time.perf_counter() - start}


def train_glm4(dev, seed: int, check, path_launches: dict) -> tuple:
    """GLM-4 9B at published width cut to ``LM_TRAIN["layers"]`` layers,
    bf16, AdamW, ``LM_TRAIN["rows"]`` rows of ``LM_TRAIN["seq"]`` tokens a
    step in ``LM_ACCUM`` microbatches, read from a ``TokenCube``
    on the card.  The first microbatch's loss and gradient norm are held
    within ``LM_F32`` of the same microbatch in float32 on the card, with
    labels left unshifted outside; then 1 + ``MORE_STEPS["glm4-9b"]``
    steps under ``Supervisor``: every step's tokens byte-equal to the
    corpus's windows, one ``gather_union_slices`` launch a step and no
    ``gather_rows``, each union read byte-equal to its plain version;
    one profiled step.  Returns (the row, the union read's timing at the
    step's batch)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import carry
    from repro_torch.configs import glm4_9b
    from repro_torch.configs import train as train_cfgs
    from repro_torch.configs.common import LM_ACCUM
    from repro_torch.dataplane.tokens import TokenCube
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import _sdpa
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as optim
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step,
                                               value_and_grad)

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    lt = LM_TRAIN
    cfg = dataclasses.replace(glm4_9b._cfg(), n_layers=lt["layers"])
    rows, seq, accum = lt["rows"], lt["seq"], LM_ACCUM
    steps = MORE_STEPS["glm4-9b"]
    t0 = time.perf_counter()
    tc = TokenCube(vocab=cfg.vocab, n_docs=lt["n_docs"],
                   doc_len=lt["doc_len"], seed=seed, device=dev)
    tc.payload()
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = carry.decoder_params(tf.init_params(cfg, device=dev, seed=seed),
                                  cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    loss_fn = train_cfgs.loss_for("lm", params, cfg)
    failed = []

    # The first microbatch in bf16 and in float32, and with the labels
    # left unshifted (the planted fault).
    first = tc.batch(0, rows, seq)
    mb = {k: v[:1].contiguous() for k, v in first.items()}
    loss_bf, _, g = value_and_grad(loss_fn, params, mb)
    norm_bf = optim.global_norm(g)
    del g
    loss_nf, _, g = value_and_grad(loss_fn, params, {
        "tokens": mb["tokens"], "labels": mb["tokens"]})
    norm_nf = optim.global_norm(g)
    del g
    t0 = time.perf_counter()
    params32 = {k: v.detach().float() for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    loss32, _, g = value_and_grad(train_cfgs.loss_for("lm", params32, cfg32),
                                  params32, mb)
    norm32 = optim.global_norm(g)
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    del g, params32

    def gaps_of(loss, norm):
        return {"loss": abs(float(loss) - float(loss32)) / float(loss32),
                "grad_norm": abs(float(norm) - float(norm32))
                / float(norm32)}

    gaps = gaps_of(loss_bf, norm_bf)
    faults = {"labels not shifted": gaps_of(loss_nf, norm_nf)}
    failed += [f"f32 {k}: {v} > {LM_F32[k]}" for k, v in gaps.items()
               if not v <= LM_F32[k]]
    failed += [f"fault {what}: within the bounds"
               for what, g_ in faults.items()
               if all(v <= LM_F32[k] for k, v in g_.items())]
    torch.cuda.empty_cache()

    # The main path: the train state, then 1 + steps under the supervisor
    # with each batch read from the corpus on the card.
    opt = glm4_9b._opt()
    state = init_train_state(params, opt)
    step = make_train_step(loss_fn, opt, accum_steps=accum)
    read = []

    def source(i):
        bt = tc.batch(i, rows, seq)
        read.append((i, bt))
        return bt

    state, run, calls = supervised_run(
        step, state, source, 1 + steps, "train_glm4", path_launches,
        {"gather_union_slices": 1 + steps,
         "gather_rows": accum * (1 + steps)}, failed,
        record=lambda: recording(gk, "gather_union_slices", results=True))
    state_bytes = sum(t.numel() * t.element_size() for t in
                      ckpt.flatten_tree(state).values())
    # Every step's tokens against the corpus's windows.
    flat = tc.materialize()
    windows_equal = True
    for i, bt in read:
        docs, starts = tc.windows(i, rows, seq)
        toks = np.stack([flat[d * lt["doc_len"] + s0:
                              d * lt["doc_len"] + s0 + seq + 1]
                         for d, s0 in zip(docs, starts)])
        windows_equal &= bt["tokens"].cpu().numpy().tobytes() == \
            toks[:, :-1].tobytes()
        windows_equal &= bt["labels"].cpu().numpy().tobytes() == \
            toks[:, 1:].tobytes()
    if not windows_equal:
        failed.append("a step's tokens differ from the corpus's windows")
    with torch.no_grad():
        for j, (a, kw, out) in enumerate(calls):
            check("gather_union_slices", out,
                  gref.gather_union_slices(*a, **kw),
                  f"train glm4 batch {j}")
    n_params = sum(p.numel() for p in params.values())
    tokens = rows * seq
    # The least time of a step: the matrix products (6 × the parameters
    # × the tokens, the tied head included) and the causal attention's
    # scores and V products (forward and backward, 3 × 4 · S²/2 · H · Dh
    # a row a layer), all on bf16 operands, at the bf16 peak; against
    # the AdamW sweep's bytes (bf16 p and g, float32 m and v).
    bf16_flops = 6 * n_params * tokens
    attn_flops = 3 * 4 * seq * seq // 2 * cfg.n_heads * cfg.d_head \
        * cfg.n_layers * rows
    attn_bound_ms = attn_flops / BF16_FLOPS * 1e3
    t_ops = (bf16_flops + attn_flops) / BF16_FLOPS * 1e3
    n_bytes = n_params * (2 + 2 + 2 + 4 * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    profiled = profile_step(lambda: step(state, read[-1][1]))
    timer = Timer(dev)
    # The reading against the attention's bound: _sdpa as the trunk runs
    # it (float32 scores over the whole S² grid, in q chunks), forward
    # and backward of one layer's row, CUDA events, times the layers and
    # rows of a step (the recomputation's second forward left out).
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = [torch.randn((1, seq, h, cfg.d_head), generator=gen, device=dev,
                       dtype=cfg.dtype, requires_grad=True)
           for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    pos = torch.arange(seq, device=dev)[None]
    d_out = torch.randn_like(qkv[0])
    sdpa_ms = timer(lambda: torch.autograd.grad(
        _sdpa(*qkv, pos, pos, True, cfg.q_chunk), qkv, d_out),
        iters=5, warmup=1) * cfg.n_layers * rows
    del qkv, d_out
    a, kw, _ = calls[-1]
    n_union, n_pos = a[1].numel(), a[2].numel()
    u_bytes = n_union * (4 + 4) + n_pos * (4 + 4)
    offsets = a[1].long()[a[2].long()]
    timed = [{"what": "train glm4: one step's batch", "ms": timer(
        lambda: gk.gather_union_slices(*a, **kw)),
        "plain_ms": timer(lambda: gref.gather_union_slices(*a, **kw)),
        "bound_ms": u_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": timer(lambda: torch.index_select(a[0], 0, offsets)),
        "launches": run["launches"]["gather_union_slices"],
        "shape": {"U": n_union, "P": n_pos, "dtype": "int32"}}]
    del calls
    row = {"model": f"{cfg.name} ({cfg.n_layers} layers)", "seed": seed,
           "batch": rows, "seq": seq, "accum_steps": accum,
           "cut": f"layers 40 -> {cfg.n_layers}, rows 256 -> {rows}",
           "params": n_params, "corpus_s": corpus_s, "init_s": init_s,
           **run, "tokens_per_s": tokens / (run["step_ms_p50"] / 1e3),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bf16_flops": bf16_flops, "attention_flops": attn_flops,
           "attention_bound_ms": attn_bound_ms,
           "sdpa_f32_ms_per_step": sdpa_ms,
           "bytes": n_bytes, "profiled_step": profiled,
           "first_microbatch": {"f32_gaps": gaps, "bounds": LM_F32,
                                "faults": faults, "f32_s": f32_s,
                                "loss_bf16": float(loss_bf),
                                "loss_f32": float(loss32),
                                "grad_norm_bf16": float(norm_bf),
                                "grad_norm_f32": float(norm32)},
           "windows_byte_equal": windows_equal, "state_bytes": state_bytes,
           "phase_peak_bytes": torch.cuda.max_memory_allocated()
           - held_before, "failed": failed,
           "seconds": time.perf_counter() - start}
    return row, timed


def train_more_launchers(dev, seed: int) -> dict:
    """The launcher at smoke width on the card: ``python -m
    repro_torch.launch.train --arch <id> --steps 20`` for
    ``MORE_LAUNCHED`` (each must exit 0, its checkpoints in a temporary
    directory under ``build/``), the other LMs' smoke training through
    the launcher's parts in-process (``MORE_IN_PROCESS``: the set-up, the
    data source and the supervisor, 20 steps, no restart), and a
    DeepSeek-V3 checkpoint written by such a run restored into a fresh
    state byte for byte."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs import train as train_cfgs
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import FaultConfig, Supervisor

    out = {"launched": {}, "in_process": {}}
    for arch in MORE_LAUNCHED:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            argv = [sys.executable, "-m", "repro_torch.launch.train",
                    "--arch", arch, "--steps", "20", "--ckpt-dir", d]
            t0 = time.perf_counter()
            res = subprocess.run(argv, capture_output=True, text=True,
                                 timeout=600, cwd=ROOT,
                                 env={**os.environ, "PYTHONPATH": str(
                                     ROOT / "src")})
            seconds = time.perf_counter() - t0
            ckpts = sorted(p.name for p in Path(d).glob("step_*"))
        assert res.returncode == 0, f"launcher {arch}: exit " \
            f"{res.returncode}\n{res.stderr[-2000:]}"
        assert "restart" not in res.stderr, f"launcher {arch}: restarted"
        out["launched"][arch] = {"exit": res.returncode, "seconds": seconds,
                                 "checkpoints": ckpts,
                                 "said": res.stdout.splitlines()[-3:]}
    for arch in MORE_IN_PROCESS:
        smoke = train_cfgs.smoke(arch, device=dev, seed=seed)
        source = launch_train.data_source_for(smoke, dev)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            sup = Supervisor(FaultConfig(ckpt_dir=d, ckpt_every=20),
                             smoke["step"], source)
            losses = []
            t0 = time.perf_counter()
            state = sup.run(smoke["state"], 20, on_metrics=lambda i, m:
                            losses.append(float(m["loss"])))
            seconds = time.perf_counter() - t0
            assert not sup.restarts, f"{arch}: {sup.restarts} restarts"
            assert all(np.isfinite(losses)), f"{arch}: losses {losses}"
            row = {"seconds": seconds, "losses": losses[::5]}
            if arch == "deepseek-v3-671b":
                last = ckpt.latest_step(d)
                fresh = train_cfgs.smoke(arch, device=dev,
                                         seed=seed + 1)["state"]
                ckpt.restore_checkpoint(d, last, fresh)
                got = ckpt.flatten_tree(fresh)
                row["checkpoint"] = {
                    "step": last, "leaves": len(got),
                    "byte_equal": all(same_bytes(got[k], v) for k, v in
                                      ckpt.flatten_tree(state).items())}
                assert row["checkpoint"]["byte_equal"], \
                    f"{arch}: restored checkpoint differs"
            out["in_process"][arch] = row
        del smoke, state
        torch.cuda.empty_cache()
    return out

def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@functools.lru_cache(maxsize=None)
def gnn_batch(shape: str) -> dict:
    """The input of ``shape`` from the port's data plane: 128 padded
    molecules, the Cora-sized full graph, or one sampled Reddit-sized
    minibatch (average degree cut from 492 to 50: see PERF.md §4).  Built
    once and shared by the phases that read it: callers copy, never
    write into it."""
    from repro_torch.dataplane import graph

    if shape == "molecule":
        return graph.molecule_batch(128, 30, 64, pad_nodes=4096,
                                    pad_edges=8192)
    if shape == "full_graph_sm":
        return graph.full_graph_batch(graph.synthetic_graph(2708, 4, 1433, 7),
                                      3072, 10752)
    g = graph.synthetic_graph(232_965, 50, 602, 41)
    return graph.minibatch(g, 1024, [15, 10], 169_984, 168_960)


def nequip_tree(cfg, seed: int) -> dict:
    """Random NequIP weights as numpy arrays, with the layout and scales
    of the JAX package's ``nequip_init`` (normal · 1/√fan-in, zero
    biases), drawn from ``seed``."""
    import math

    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(
            np.float32)

    def mlp(dims):
        return {"layers": [{"w": normal((a, b), a),
                            "b": np.zeros((b,), np.float32)}
                           for a, b in zip(dims[:-1], dims[1:])]}

    c, paths = cfg.channels, cfg.paths
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"radial": mlp([cfg.n_rbf, cfg.radial_hidden,
                                len(paths) * c]),
                 "mix": {}, "self": {}, "gate": {}}
        for l in cfg.ls:
            k = sum(1 for p in paths if p[2] == l)
            layer["mix"][str(l)] = normal((k * c, c), k * c)
            layer["self"][str(l)] = normal((c, c), c)
            if l > 0:
                layer["gate"][str(l)] = normal((c, c), c)
        layers.append(layer)
    return {"embed": mlp([cfg.d_feat, c]), "layers": layers,
            "readout": mlp([c, c, cfg.n_out])}


def gnn(dev, seed: int, card: str, check, path_launches: dict) -> dict:
    """Phase 9: NequIP at its published width on three graph shapes,
    every message sum through B7; returns B7's timing at
    ``minibatch_lg``'s l = 2 sum (a kernels-line entry without its
    counts), with the other timed shapes under ``variants``."""
    import torch

    matmul = tf32_off("gnn")
    timed = {}
    for shape in GNN_RUNS:
        row, calls = serve_gnn_shape(dev, seed, shape, check, path_launches)
        emit({"phase": "gnn", **row, "matmul": matmul, "card": card})
        if shape == "molecule":
            # The energy readout: the one sum of (N, 1) messages.
            (m, plan, n_seg), _, _ = [c for c in calls
                                      if c[0][0].shape[1] == 1][-1]
            timed["readout"] = segment_timing(dev, m, plan.ids, n_seg,
                                              "molecule energy readout")
        elif shape == "minibatch_lg":
            # The last layer's three sums (l = 0, 1, 2), then the same
            # l = 2 messages with the JAX package's ids (padding edges
            # clamped onto node 0: an 80,417-edge hub, same sums).
            (m0, p0, s0), _, _ = calls[-3]
            (m1, p1, s1), _, _ = calls[-2]
            (m2, p2, s2), _, out2 = calls[-1]
            timed["l2"] = segment_timing(dev, m2, p2.ids, s2, "minibatch_lg "
                                         "l = 2")
            timed["l0"] = segment_timing(dev, m0, p0.ids, s0, "minibatch_lg "
                                         "l = 0")
            timed["l1"] = segment_timing(dev, m1, p1.ids, s1, "minibatch_lg "
                                         "l = 1")
            timed["hub"] = hub_check_and_timing(dev, m2, p2.ids, s2, out2,
                                                check)
        del calls
        torch.cuda.empty_cache()
    return {**timed["l2"], "variants": [timed["l0"], timed["l1"],
                                        timed["readout"], timed["hub"]]}


def serve_gnn_shape(dev, seed: int, shape: str, check, path_launches: dict):
    """One shape of phase 9: one untimed and ``GNN_FORWARDS`` timed
    forwards (energy and forces for ``molecule``), then the checks.
    Returns (the phase row, the B7 calls of the path with their
    results)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.carry import nequip_from_params
    from repro_torch.configs import nequip as nequip_cfg
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.segment import kernel as segk
    from repro_torch.kernels.segment import ref as segref
    from repro_torch.models.nequip import nequip_energy_forces

    start = time.perf_counter()
    info, cfg = GNN_SHAPES[shape], nequip_cfg.for_shape(shape)
    batch = gnn_batch(shape)
    build_s = time.perf_counter() - start
    ei = batch["edge_index"]
    assert batch["node_feat"].shape == (info["n_nodes"], info["d_feat"])
    assert ei.shape == (2, info["n_edges"])
    energy = cfg.readout == "energy"
    tree = nequip_tree(cfg, seed)

    def inputs(model, device, dtype):
        args = [torch.from_numpy(batch["node_feat"]).to(device, dtype),
                torch.from_numpy(batch["positions"]).to(device, dtype),
                torch.from_numpy(ei).to(device)]
        kw = {}
        if energy:
            kw = dict(graph_ids=torch.from_numpy(batch["graph_ids"]).to(
                device), n_graphs=batch["n_graphs"])

        def forward():
            if energy:
                return nequip_energy_forces(model, *args, **kw)
            with torch.no_grad():
                return (model(*args, **kw),)
        return forward

    model = nequip_from_params(cfg, tree, device=dev)
    forward = inputs(model, dev, torch.float32)
    reset_launches()
    outs, secs = [], []
    with recording(segk, "segment_sum", results=True) as calls:
        for _ in range(1 + GNN_FORWARDS):
            t0 = time.perf_counter()
            outs.append(forward())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    launches = path_launches[f"gnn_{shape}"] = dict(LAUNCHES)
    # The forces' backward: the source gathers of every layer after the
    # first (whose rows do not depend on the positions) sum through B7.
    per_forward = cfg.n_layers * len(cfg.ls) + energy + \
        energy * (cfg.n_layers - 1) * len(cfg.ls)
    assert launches["segment_sum"] == (1 + GNN_FORWARDS) * per_forward, \
        f"{shape}: B7 launched {launches['segment_sum']} times"
    assert len(calls) == launches["segment_sum"]
    # Two segment plans a forward (the destination and the source ids),
    # one more for the energy readout (the graph ids), where the CSR was
    # built per call.
    plans_per_forward = launches["segment_plan"] / (1 + GNN_FORWARDS)
    assert plans_per_forward == 2 + energy, \
        f"{shape}: {launches['segment_plan']} segment plans built"
    # Every B7 call of the path against the plain version.
    with torch.no_grad():
        for a, kw, out in calls:
            check("segment_sum", out, segref.segment_sum(*a, **kw),
                  f"{shape} path")
    # The same forward with the plain version in B7's place.
    with swapped(segk, "segment_sum", segref.segment_sum):
        want = forward()
    for got in outs:
        assert bytes_equal(got[0], want[0]), \
            f"{shape}: output with B7 != with its plain version"
    if energy:
        # Forces come from PyTorch's backward, whose gathers' gradients
        # are summed in an order that may vary from run to run; in
        # deterministic mode they must not move by a bit either.
        spread = max(max_abs_err(got[1], outs[1][1]) for got in outs)
        with deterministic():
            forces = forward()[1]
            with swapped(segk, "segment_sum", segref.segment_sum):
                assert bytes_equal(forces, forward()[1]), \
                    f"{shape}: forces with B7 != with its plain version"
    for g in outs[1]:
        assert bool(torch.isfinite(g).all()), f"{shape}: non-finite"
    expect = (info["n_graphs"],) if energy else (info["n_nodes"],
                                                 info["n_out"])
    assert tuple(outs[1][0].shape) == expect
    # The first timed forward against the float64 CPU forward of the
    # same weights.
    t0 = time.perf_counter()
    host = nequip_from_params(dataclasses.replace(cfg, dtype=torch.float64),
                              tree, device="cpu")
    host_out = inputs(host, "cpu", torch.float64)()
    host_s = time.perf_counter() - t0
    errs = {}
    for name, g, h in zip(("energy", "forces") if energy else ("out",),
                          outs[1], host_out):
        g64, h = g.double().cpu().numpy(), h.numpy()
        errs[name] = float(np.abs(g64 - h).max())
        assert np.allclose(g64, h, **GNN_F64), \
            f"{shape} {name}: card != float64 CPU forward ({errs[name]})"
    profiled = device_profile(forward)
    fwd_ms = [t * 1e3 for t in secs[1:]]
    p50 = float(np.median(fwd_ms))
    n_real = int(((ei[0] >= 0) & (ei[1] >= 0)).sum())
    dst = ei[1][ei[1] >= 0]
    row = {"shape": shape, "nodes": info["n_nodes"],
           "edges": info["n_edges"], "real_edges": n_real,
           "max_in_degree": int(np.bincount(dst).max()) if dst.size else 0,
           "d_feat": info["d_feat"], "readout": cfg.readout,
           "forces": energy, "build_s": build_s,
           "warmup_forward_ms": secs[0] * 1e3, "forward_ms": fwd_ms,
           "forward_ms_p50": p50, "forward_ms_max": max(fwd_ms),
           "edges_per_s": info["n_edges"] / (p50 / 1e3),
           "real_edges_per_s": n_real / (p50 / 1e3),
           "host_f64_s": host_s, "host_f64_max_abs_err": errs,
           "host_f64_tol": GNN_F64, "b7_calls_checked": len(calls),
           "segment_plans_per_forward": plans_per_forward,
           "forces_run_spread": spread if energy else None,
           "profiled_forward": profiled,
           "launches": launches}
    row["seconds"] = time.perf_counter() - start
    return row, calls


def device_profile(fn, top: int = 8,
                   named: tuple = ("b7_kernel_ms", "segment_sum_kernel")
                   ) -> dict:
    """One more call of ``fn`` under ``torch.profiler``: its wall time
    (host clock, ending in a synchronize, profiler overhead included),
    the summed time of the CUDA kernels it ran and of those whose name
    holds ``named[1]`` among them (under the key ``named[0]``; B7's by
    default), the device's idle share of the wall time, and the kernels
    that took the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            slot = by_name.setdefault(ev.name, [0.0, 0])
            slot[0] += ev.time_range.elapsed_us() / 1e3
            slot[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms,
            named[0]: sum(ms for name, (ms, _) in by_name.items()
                          if named[1] in name),
            # None where the profiler saw no kernel at all.
            "idle_share": 1.0 - busy_ms / wall_ms if by_name else None,
            "kernels": sum(n for _, n in by_name.values()),
            "top": [{"name": name[:80], "ms": ms, "count": n}
                    for name, (ms, n) in ranked]}


def kernel_breakdown(fn, iters: int = 20) -> dict:
    """The device time of each kernel and memset that one call of ``fn``
    runs, by name: ``iters`` calls under ``torch.profiler`` after one
    warm-up call, the L2 left warm (the inputs are small).  Each name's
    ``ms`` is the mean over the launches the profiler kept (it may drop
    the window's last), ``per_call`` those launches over ``iters``, and
    ``device_ms`` the sum of ``ms`` times the launches a call makes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            slot = by_name.setdefault(ev.name, [0.0, 0])
            slot[0] += ev.time_range.elapsed_us() / 1e3
            slot[1] += 1
    kernels = [{"name": name[:80], "ms": ms / n, "per_call": n / iters}
               for name, (ms, n) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][0])]
    return {"device_ms": sum(k["ms"] * round(k["per_call"])
                             for k in kernels), "kernels": kernels}


def segment_timing(dev, messages, ids, num_segments: int, what: str) -> dict:
    """B7's walk over a segment plan built once (``ms``), the plan's build
    (``plan_ms``: the ids' check with its host read, the sort and the
    offsets), a call on the ids that does both as before the plan
    (``ids_ms``), the plain version and ``index_add_`` on the same sums;
    the bound counts each id, each row of an edge with a segment and
    each output element once."""
    import torch

    from repro_torch.kernels.segment import kernel as segk
    from repro_torch.kernels.segment import ops as segops
    from repro_torch.kernels.segment import ref as segref

    e, d = messages.shape
    size = messages.element_size()
    valid = ids >= 0
    n_valid = int(valid.sum())
    n_bytes = e * 4 + n_valid * d * size + num_segments * d * size
    # index_add_ takes no -1 ids: it is given the valid edges, picked out
    # before the timing.
    lib_ids, lib_msg = ids[valid], messages[valid]
    counts = torch.bincount(ids[valid].long(), minlength=num_segments)
    timer = Timer(dev)
    # The plain version takes one step per rank of the largest segment:
    # on a hub, one timed call is seconds.
    plain_iters = 20 if int(counts.max()) < 1000 else 1
    plan = segops.segment_plan(ids, num_segments)
    return {
        "ms": timer(lambda: segk.segment_sum(messages, plan, num_segments)),
        "plan_ms": timer(lambda: segops.segment_plan(ids, num_segments)),
        "ids_ms": timer(lambda: segops.segment_sum(messages, ids,
                                                   num_segments)),
        "plain_ms": timer(lambda: segref.segment_sum(messages, plan,
                                                     num_segments),
                          iters=plain_iters,
                          warmup=3 if plain_iters > 1 else 0),
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": timer(lambda: torch.zeros(
            (num_segments, d), dtype=messages.dtype,
            device=dev).index_add_(0, lib_ids, lib_msg)),
        "shape": {"what": what, "E": e, "D": d, "S": num_segments,
                  "valid_edges": n_valid,
                  "max_segment": int(counts.max()), "bytes": n_bytes,
                  "dtype": str(messages.dtype).removeprefix("torch."),
                  "plain_iters": plain_iters}}


def hub_check_and_timing(dev, messages, ids, num_segments: int, out,
                         check) -> dict:
    """B7 on ``ids`` with the padding edges clamped onto node 0, as the
    JAX package passes them: the same sums (the padding messages are
    zero), byte for byte, through one 80,417-edge segment; checked once
    against the plain version, then timed."""
    from repro_torch.kernels.segment import kernel as segk
    from repro_torch.kernels.segment import ref as segref

    hub = ids.clamp(min=0)
    got = segk.segment_sum(messages, hub, num_segments)
    assert bytes_equal(got, out), "B7: clamped padding ids change the sum"
    check("segment_sum", got, segref.segment_sum(messages, hub,
                                                 num_segments),
          "minibatch_lg l = 2, clamped padding ids")
    return segment_timing(dev, messages, hub, num_segments,
                          "minibatch_lg l = 2, padding clamped onto node 0")

def b8_gap(got, want) -> dict:
    """B8's output against its plain version's: the max |difference|,
    that over the largest |want|, and whether both bf16 bounds hold."""
    import torch

    err = max_abs_err(got, want)
    top = float(want.float().abs().max()) if want.numel() else 0.0
    ok = bool(torch.allclose(got.float(), want.float(), **B8_BF16)) and \
        err <= B8_REL * top
    return {"max_abs_err": err, "rel_err": err / top if top else err,
            "ok": ok}


def b8_check_call(out, args, tally: dict) -> None:
    """Hold one B8 call's ``out`` against B8's plain version on the same
    ``args`` (q, k_pages, v_pages, block_table, seq_lens) at once, on the
    card (the pool changes after every call), and add it to ``tally``:
    ``calls``, the largest ``max_abs_err`` and ``rel_err``, and the
    seconds the check took (``check_s``)."""
    import torch

    from repro_torch.kernels.paged_attn import ref as paref

    torch.cuda.synchronize()
    t = time.perf_counter()
    gap = b8_gap(out, paref.paged_decode_attention(*args))
    assert bool(torch.isfinite(out).all()), "B8: non-finite output"
    assert gap["ok"], \
        f"B8 != its plain version (call {tally['calls']}, {gap})"
    tally["max_abs_err"] = max(tally["max_abs_err"], gap["max_abs_err"])
    tally["rel_err"] = max(tally["rel_err"], gap["rel_err"])
    tally["calls"] += 1
    tally["check_s"] += time.perf_counter() - t


def b8_faults(table, lens, ps: int, n_split: int, n_pages: int) -> dict:
    """Planted faults of B8 (its tensor-core kernel), each as the plan
    that makes the correct kernel compute what a faulty one would: the
    newest token left out (seq_lens - 1, the off-by-one of C5), the last
    non-empty split left out of the merge (splits of at least
    ``TC_MIN_SPLIT_PAGES`` pages, as the kernel cuts them), and every
    live page read from the next page of the pool (an error in the page
    address)."""
    import torch

    from repro_torch.kernels.paged_attn import kernel as pak

    lens64 = lens.long()
    pages = (lens64 + ps - 1) // ps
    per = ((pages + n_split - 1) // n_split).clamp(
        min=pak.TC_MIN_SPLIT_PAGES)
    used = (pages + per - 1) // per
    cut = torch.minimum((used - 1).clamp(min=0) * per * ps, lens64)
    return {"newest token dropped": (table, (lens64 - 1).clamp(min=0).int()),
            "last split dropped": (table, cut.int()),
            "next page of the pool": (
                torch.where(table >= 0, (table + 1) % n_pages, table), lens)}


def replayed_round_ms(params, cfg, engine, host_plan, dev, n: int
                      ) -> list[float]:
    """Host-clock milliseconds of ``n`` replays of one decode round as
    the engine runs it: the host plan (block table, lengths, tokens as
    numpy) copied to the card at once, the step, the argmax read back.
    Each replay writes its cache rows into pages that are free by now."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tf

    table_np, lens_np, tokens_np = host_plan
    nb, pmax = table_np.shape
    out = []
    torch.cuda.synchronize()
    for _ in range(n):
        t = time.perf_counter()
        flat = torch.from_numpy(np.concatenate(
            [table_np.reshape(-1), lens_np, tokens_np])).to(dev)
        seq_lens = flat[nb * pmax:nb * pmax + nb]
        with torch.no_grad():
            logits = tf.decode_paged(
                params, cfg, engine.k_pool, engine.v_pool,
                flat[nb * pmax + nb:], seq_lens - 1,
                flat[:nb * pmax].view(nb, pmax), seq_lens,
                token_span=(int(tokens_np.min()), int(tokens_np.max())))
        torch.argmax(logits, dim=-1).tolist()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def logits_gap(got, want, max_bound: float = LM_LOGITS_MAX,
               mean_bound: float = LM_LOGITS_MEAN) -> dict:
    """Max and mean |got - want| of two arrays (logits by default), and
    whether they are within the stated bf16 bounds."""
    d = (got.float() - want.float()).abs()
    gap = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean())}
    gap["ok"] = gap["max_abs_err"] <= max_bound and \
        gap["mean_abs_err"] <= mean_bound
    return gap


def b1_held(tally: dict):
    """A stand-in for B1's kernel on a serving path: each call made and
    held byte for byte against B1's plain version on the same inputs
    when it is made.  ``tally`` counts the calls and the mismatches and
    adds up the seconds the checks took, which the path's timings leave
    out."""
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref

    fn = gk.gather_rows

    def held(table, ids, *a, **kw):
        out = fn(table, ids, *a, **kw)
        t = time.perf_counter()
        tally["calls"] += 1
        tally["bad"] += not bytes_equal(out, gref.gather_rows(table, ids))
        tally["check_s"] += time.perf_counter() - t
        return out
    return held


def lm_serve(dev, seed: int, card: str, path_launches: dict) -> dict:
    """Phase 10: GLM-4 9B at its published width in bf16 behind
    ``ServeEngine``, 24 requests through 16 slots; every decode round is
    one B8 launch per layer.  Checks every B8 call, the first round's
    logits with B8's plain version swapped in (and that two planted B8
    faults fall outside the bounds) and two requests against a
    teacher-forced forward; times the first round replayed without
    checks; then the launcher's lm mode; then B8's timings (a
    kernels-line entry without its counts)."""
    import numpy as np
    import torch

    from repro_torch.configs import glm4_9b
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.paged_attn import kernel as pak
    from repro_torch.kernels.paged_attn import ref as paref
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    matmul = tf32_off("lm_serve")
    start = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    cfg = glm4_9b._cfg()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tf.count_params(params)
    assert n_params == 8_779_010_048, n_params
    ecfg = EngineConfig(**LM_ENGINE)
    engine = ServeEngine(params, cfg, ecfg, device=dev)

    rng = np.random.default_rng(seed)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    news = rng.integers(LM_NEW[0], LM_NEW[1] + 1, LM_REQUESTS)
    requests = [Request(prompt=rng.integers(0, cfg.vocab, int(n)).astype(
        np.int32), max_new_tokens=int(m), rid=i)
        for i, (n, m) in enumerate(zip(lens, news))]
    # Any 16 sequences at their full length fit the pool: C4 cannot fire.
    full = sorted(-(-int(n + m) // ecfg.page_size) for n, m in zip(lens, news))
    assert sum(full[-ecfg.max_batch:]) <= ecfg.n_pages
    # The first request, and the last, admitted mid-stream.
    watch = (0, LM_REQUESTS - 1)

    kernel_fn, decode_fn = pak.paged_decode_attention, tf.decode_paged
    prefill_fn, round_fn = tf.prefill_paged, engine._decode_round
    b8 = {"calls": 0, "max_abs_err": 0.0, "rel_err": 0.0, "check_s": 0.0,
          "first": None, "last": None}
    rounds, prefill_s, first_round = [], [], {}
    prefill_logits, decode_logits = {}, {rid: [] for rid in watch}
    live_rids: list = []

    def plain_b8(q, kp, vp, table, lens_, **_):
        return paref.paged_decode_attention(q, kp, vp, table, lens_)

    def faulty_b8(name: str):
        def b8_fault(q, kp, vp, table, lens_, **kw):
            n_split = pak.split_for_tc(q.shape[0], kp.shape[1],
                                       table.shape[1], q.device)
            t_, l_ = b8_faults(table, lens_, kp.shape[2], n_split,
                               kp.shape[0])[name]
            return kernel_fn(q, kp, vp, t_, l_, **kw)
        return b8_fault

    def b8_checked(q, kp, vp, table, lens_, **kw):
        out = kernel_fn(q, kp, vp, table, lens_, **kw)
        b8_check_call(out, (q, kp, vp, table, lens_), b8)
        b8["last"] = (q, kp, vp, table, lens_)
        if b8["first"] is None:
            b8["first"] = b8["last"]
        return out

    def decode_rec(params_, cfg_, k_pool, v_pool, *plan, **kw):
        first = not rounds and not first_round
        if first:
            t = time.perf_counter()
            snap = (k_pool.clone(), v_pool.clone())
            torch.cuda.synchronize()
            b8["check_s"] += time.perf_counter() - t
        logits = decode_fn(params_, cfg_, k_pool, v_pool, *plan, **kw)
        if first:
            # The same round on the pool as it was, B8's plain version
            # in B8's place.  The snapshot and these logits are kept for
            # the planted faults after the path: each decode writes its
            # own new K/V rows before it reads them.
            t = time.perf_counter()
            with swapped(pak, "paged_decode_attention", plain_b8), \
                    uncounted():
                plain = decode_fn(params_, cfg_, *snap, *plan, **kw)
            first_round.update(batch=int(logits.shape[0]), plan=plan,
                               host_plan=[plan[i].cpu().numpy()
                                          for i in (2, 3, 0)],
                               snap=snap, plain=plain,
                               **logits_gap(logits, plain))
            torch.cuda.synchronize()
            b8["check_s"] += time.perf_counter() - t
        for i, rid in enumerate(live_rids):
            if rid in decode_logits:
                decode_logits[rid].append(logits[i].clone())
        return logits

    def prefill_rec(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = b1["check_s"]
        out = prefill_fn(*a, **kw)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t - (b1["check_s"] - before))
        rid = len(prefill_s) - 1             # admission is first come
        if rid in decode_logits:
            prefill_logits[rid] = out[0].clone()
        return out

    def round_rec():
        live_rids[:] = list(engine.live)
        if not live_rids:
            return round_fn()
        checks = b8["check_s"] + b1["check_s"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        round_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check = b8["check_s"] + b1["check_s"] - checks
        rounds.append({"ms": (wall - check) * 1e3, "check_ms": check * 1e3,
                       "batch": len(live_rids),
                       "util": engine.pager.utilization})

    engine._decode_round = round_rec
    b1 = {"calls": 0, "bad": 0, "check_s": 0.0}
    reset_launches()
    with swapped(pak, "paged_decode_attention", b8_checked), \
            swapped(gk, "gather_rows", b1_held(b1)), \
            swapped(tf, "decode_paged", decode_rec), \
            swapped(tf, "prefill_paged", prefill_rec):
        for req in requests:
            engine.submit(req)
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    launches = path_launches["lm_serve"] = dict(LAUNCHES)
    n_rounds = len(rounds)
    assert launches["paged_decode_attention"] == cfg.n_layers * n_rounds, \
        f"B8 launched {launches['paged_decode_attention']} times in " \
        f"{n_rounds} decode rounds"
    assert b8["calls"] == launches["paged_decode_attention"]
    # Every B8 call of the path went to the tensor-core kernel.
    assert launches["paged_decode_attention_simt"] == 0, \
        "lm_serve: B8 took the CUDA-core kernel"
    # B1 embeds each prefill's and each decode round's tokens, once; the
    # first round run again with B8's plain version is not counted.
    assert launches["gather_rows"] == LM_REQUESTS + n_rounds, launches
    assert b1["calls"] == launches["gather_rows"] + 1 and not b1["bad"], \
        f"lm_serve: B1 calls against the plain version: {b1}"
    others = {k: n for k, n in launches.items()
              if n and k not in ("paged_decode_attention", "gather_rows")}
    assert not others, f"lm_serve launched other kernels: {others}"
    assert sorted(r.rid for r in done) == list(range(LM_REQUESTS))
    for r in done:
        assert len(r.out_tokens) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)
    assert engine.pager.utilization == 0.0
    assert max(r["batch"] for r in rounds) == ecfg.max_batch
    # The first round with two planted B8 faults in B8's place (their
    # launches are not the path's), which the logits bounds must tell
    # from the plain version's.
    snap, plain = first_round.pop("snap"), first_round.pop("plain")
    first_round["faults"] = {}
    for name in ("newest token dropped", "last split dropped"):
        with swapped(pak, "paged_decode_attention", faulty_b8(name)), \
                torch.no_grad():
            bad = decode_fn(params, cfg, *snap, *first_round["plan"])
        first_round["faults"][name] = logits_gap(bad, plain)
    del snap, plain, bad
    # The logits bounds are checked after the phase's line is printed.
    failed = [] if first_round["ok"] else ["first round, plain B8"]
    failed += [f"first round, {name}: not caught"
               for name, gap in first_round["faults"].items() if gap["ok"]]

    # Teacher forcing: the forward over prompt + generated tokens must
    # give, at each generated position, the engine's logits there.
    forced = []
    for rid in watch:
        req = requests[rid]
        p, n = len(req.prompt), len(req.out_tokens)
        seq = np.concatenate([req.prompt, req.out_tokens[:-1]])
        with torch.no_grad():
            full_logits, _ = tf.forward(params, cfg, torch.from_numpy(
                seq[None].astype(np.int64)).to(dev))
        want = full_logits[0, p - 1:p + n - 1]
        assert len(decode_logits[rid]) == n - 1
        got = torch.stack([prefill_logits[rid], *decode_logits[rid]])
        gap = logits_gap(got, want)
        agree = float((want.argmax(-1).cpu() == torch.tensor(
            req.out_tokens)).float().mean())
        forced.append({"rid": rid, "prompt": p, "generated": n,
                       "argmax_agrees": agree, **gap})
        if not gap["ok"]:
            failed.append(f"request {rid}: teacher-forced logits")
        del full_logits, want, got
    peak = torch.cuda.max_memory_allocated()
    # The first round's decode step replayed as the engine runs it (the
    # plan copied to the card, the step, the argmax read back) with no
    # check and no profiler, then once more profiled.  Both write their
    # K/V rows into pages that are free by now.
    plan = first_round.pop("plan")
    host_plan = first_round.pop("host_plan")
    nb = host_plan[0].shape[0]
    replay_ms = replayed_round_ms(params, cfg, engine, host_plan, dev,
                                  LM_REPLAYS)
    span = (int(host_plan[2].min()), int(host_plan[2].max()))
    with torch.no_grad():
        profiled = device_profile(
            lambda: tf.decode_paged(params, cfg, engine.k_pool,
                                    engine.v_pool, *plan, token_span=span),
            named=("b8_kernel_ms", "paged_attn_tc_kernel"))
    del plan
    replay_p50 = float(np.median(replay_ms))
    replayed = {"batch": nb, "rounds_ms": replay_ms,
                "round_ms_p50": replay_p50,
                "decode_tokens_per_s": nb / (replay_p50 / 1e3),
                "checked_round_ms": rounds[0]["ms"],
                # The profiled step's kernel time over this wall time.
                "idle_share": 1.0 - profiled["kernel_ms"] / replay_p50}

    # The launcher's lm mode, in-process on the card (smoke config).
    reset_launches()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        run = launcher.run_lm(launcher.parse_args(["--mode", "lm"]))
    torch.cuda.synchronize()
    path_launches["lm_launcher"] = dict(LAUNCHES)
    assert run.engine.k_pool.is_cuda and len(run.done) == 8
    # The smoke configuration is float32: B8's CUDA-core kernel.
    assert LAUNCHES["paged_decode_attention"] == 0
    assert LAUNCHES["paged_decode_attention_simt"] > 0
    assert LAUNCHES["paged_decode_attention_simt"] % \
        run.engine.cfg.n_layers == 0

    ms = [r["ms"] for r in rounds]
    decoded = sum(r["batch"] for r in rounds)
    row = {"model": cfg.name, "params": n_params,
           "weight_bytes": n_params * 2, "init_s": init_s,
           "engine": LM_ENGINE, "requests": LM_REQUESTS,
           "prompt_tokens": int(lens.sum()),
           "tokens_served": sum(len(r.out_tokens) for r in done),
           "decode_rounds": n_rounds,
           "round_ms_p50": float(np.median(ms)), "round_ms_max": max(ms),
           "round_batch_max": max(r["batch"] for r in rounds),
           "decode_tokens_per_s": decoded / (sum(ms) / 1e3),
           "prefill_s": sum(prefill_s),
           "prefill_tokens_per_s": int(lens.sum()) / sum(prefill_s),
           "serve_s": serve_s, "check_s": b8["check_s"],
           "pool_util_max": max(r["util"] for r in rounds),
           "b8_calls_checked": b8["calls"],
           "b8_max_abs_err": b8["max_abs_err"], "b8_rel_err": b8["rel_err"],
           "b8_tol": {**B8_BF16, "rel": B8_REL},
           "b1_calls_byte_equal": b1["calls"],
           "first_round_plain_b8": first_round,
           "teacher_forced": forced, "replayed_first_round": replayed,
           "profiled_first_round": profiled,
           "logits_bounds": {"max": LM_LOGITS_MAX, "mean": LM_LOGITS_MEAN},
           "peak_gb": peak / 1e9, "held_before_gb": held_before / 1e9,
           "launches": launches, "launcher_launches":
               path_launches["lm_launcher"],
           "launcher_said": said.getvalue().splitlines(),
           "matmul": matmul, "card": card}
    row["seconds"] = time.perf_counter() - start
    emit({"phase": "lm_serve", **row})
    assert not failed, f"lm_serve: logits out of bounds: {failed}"

    # B8's timings: the last round's shape and the first (full) round's.
    last, first = b8["last"], b8["first"]
    timed = b8_timing(dev, *last, "last decode round, layer 40")
    variants = [b8_timing(dev, *first, "first decode round, layer 1",
                          drill=True)]
    path_err = b8["max_abs_err"]
    # Free the model and the pools before decode_32k's 4.29 GB pool.
    del engine._decode_round, engine, params, run, last, first
    b8.clear()
    decode_logits.clear()
    prefill_logits.clear()
    gc.collect()
    torch.cuda.empty_cache()
    variants += b8_decode_32k(dev, seed)
    torch.cuda.empty_cache()
    return {**timed, "max_abs_err": max(path_err, timed["max_abs_err"]),
            "variants": variants}


def b8_timing(dev, q, kp, vp, table, lens, what: str,
              drill: bool = False) -> dict:
    """B8 on the tensor-core kernel at its automatic split (``ms``) and
    at each of ``B8_SPLITS`` (``split_ms``, the data of the split rule),
    the CUDA-core kernel on the same bf16 inputs at its automatic
    split and at one split (``simt_ms``, ``simt_one_split_ms``), the
    plain version and ``F.scaled_dot_product_attention``; both kernels
    held to the bf16 bounds.  With ``drill``, also whether the bounds
    catch each planted fault of ``b8_faults`` (the last two must be
    caught).  The bound counts the live K and V rows, q, the output, the
    live table entries and the lengths once, and 4 flops per (head, live
    token, dim) at the bf16 tensor-core (or float32) peak.  The library
    call gets K/V already gathered into the dense (B, KVH, PMAX·PS, Dh)
    rectangle, dead slots masked: it reads that rectangle, and the port
    never calls it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.paged_attn import kernel as pak
    from repro_torch.kernels.paged_attn import ref as paref

    b, h, dh = q.shape
    _, kvh, ps, _ = kp.shape
    pmax = table.shape[1]
    es = q.element_size()
    live = int(lens.sum())
    live_pages = int(((lens.long() + ps - 1) // ps).sum())
    n_bytes = 2 * live * kvh * dh * es + 2 * q.numel() * es \
        + live_pages * 4 + b * 4
    flops = 4 * h * dh * live
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / peak * 1e3
    n_split = pak.split_for_tc(b, kvh, pmax, dev)
    before = LAUNCHES["paged_decode_attention"]
    got = pak.paged_decode_attention(q, kp, vp, table, lens)
    assert LAUNCHES["paged_decode_attention"] == before + 1, \
        f"B8 ({what}) did not take the tensor-core kernel"
    want = paref.paged_decode_attention(q, kp, vp, table, lens)
    gap = b8_gap(got, want)
    assert gap["ok"], f"B8 ({what}) != its plain version ({gap})"
    simt_gap = b8_gap(pak.paged_decode_attention_simt(q, kp, vp, table,
                                                      lens), want)
    assert simt_gap["ok"], \
        f"B8's CUDA-core kernel ({what}) != its plain version ({simt_gap})"
    faults = {}
    if drill:
        for name, (t_, l_) in b8_faults(table, lens, ps, n_split,
                                        kp.shape[0]).items():
            bad = b8_gap(pak.paged_decode_attention(q, kp, vp, t_, l_),
                         want)
            faults[name] = {**bad, "caught": not bad["ok"]}
        missed = [name for name in ("last split dropped",
                                    "next page of the pool")
                  if not faults[name]["caught"]]
        assert not missed, f"B8 ({what}): planted faults not caught: {missed}"
    rows = table.clamp(min=0).long()
    kd = kp[rows].movedim(2, 1).reshape(b, kvh, pmax * ps, dh)
    vd = vp[rows].movedim(2, 1).reshape(b, kvh, pmax * ps, dh)
    mask = None
    if live < b * pmax * ps:
        mask = (torch.arange(pmax * ps, device=dev)[None, :]
                < lens.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = max_abs_err(library()[:, :, 0], want)
    assert torch.allclose(library()[:, :, 0].float(), want.float(),
                          **B8_BF16), f"SDPA ({what}) != B8's function"
    # B8's wrapper does more host work than a flush of 256 MB lasts.
    timer = Timer(dev, flush_bytes=B8_FLUSH_BYTES)
    split_ms = {}
    for n in sorted({*B8_SPLITS, n_split}):
        if n <= pmax:
            split_ms[n] = timer(lambda: pak.paged_decode_attention(
                q, kp, vp, table, lens, n_split=n))
    out = {
        "ms": timer(lambda: pak.paged_decode_attention(q, kp, vp, table,
                                                       lens)),
        "split_ms": split_ms,
        "simt_ms": timer(lambda: pak.paged_decode_attention_simt(
            q, kp, vp, table, lens)),
        "simt_one_split_ms": timer(lambda: pak.paged_decode_attention_simt(
            q, kp, vp, table, lens, n_split=1)),
        "plain_ms": timer(lambda: paref.paged_decode_attention(
            q, kp, vp, table, lens), iters=5),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": timer(library),
        "max_abs_err": gap["max_abs_err"], "rel_err": gap["rel_err"],
        "simt_max_abs_err": simt_gap["max_abs_err"],
        "simt_rel_err": simt_gap["rel_err"],
        **({"faults": faults} if drill else {}),
        "shape": {"what": what, "B": b, "H": h, "KVH": kvh, "Dh": dh,
                  "PS": ps, "PMAX": pmax, "live_tokens": live,
                  "max_len": int(lens.max()),
                  "n_split": n_split,
                  "dtype": str(q.dtype).removeprefix("torch."),
                  "bytes": n_bytes, "flops": flops,
                  "library_reads_bytes": 2 * kd.numel() * es,
                  "library_max_abs_err": lib_err}}
    del kd, vd
    return out


def b8_decode_32k(dev, seed: int) -> list:
    """B8 at ``LM_SHAPES["decode_32k"]``'s per-layer shape for GLM-4 9B:
    128 sequences of 32,768 tokens, 32 heads over 2 KV heads, Dh 128,
    bf16, one layer's pool of 262,144 pages of 16 (4.29 GB of K and V),
    every page live, page ids shuffled; checked against the plain version
    once, then timed (``b8_timing``)."""
    import torch

    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.configs import glm4_9b

    cfg = glm4_9b._cfg()
    b, s = LM_SHAPES["decode_32k"]["batch"], LM_SHAPES["decode_32k"]["seq"]
    ps = LM_ENGINE["page_size"]
    pages = s // ps
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(dtype=cfg.dtype, device=dev)
    shape = (b * pages, cfg.n_kv_heads, ps, cfg.d_head)
    kp = torch.empty(shape, **kw).normal_(generator=gen)
    vp = torch.empty(shape, **kw).normal_(generator=gen)
    q = torch.empty((b, cfg.n_heads, cfg.d_head), **kw).normal_(
        generator=gen)
    table = torch.randperm(b * pages, device=dev, generator=gen).int().view(
        b, pages)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = [b8_timing(dev, q, kp, vp, table, lens, "decode_32k, one layer",
                     drill=True)]
    del kp, vp
    return out


def moe_plain_layer(params, cfg, x):
    """The decode path's MoE layer of ``params`` on x (B, S, D), written
    per token: the dispatch's dropless routing of the same groups, then,
    for each token and each of its choices, that expert's SwiGLU of the
    token alone (a matrix-vector product per weight).  Returns (y (T, k,
    D), gates (T, k), keep (T, k), shared (T, D) or None) for
    ``moe_plain_sum``."""
    import torch

    from repro_torch.models import moe

    b, s, d = x.shape
    t = b * s
    g = min(cfg.n_groups, t)
    if t % g:
        g = 1
    xg = x.reshape(g, t // g, d)
    r = moe.route(moe.router_logits(params, xg), cfg, dropless=True)
    ids = r.expert_ids.reshape(t, cfg.top_k).tolist()
    keep = r.keep.reshape(t, cfg.top_k)
    xt = x.reshape(t, d)
    y = torch.zeros((t, cfg.top_k, d), dtype=x.dtype, device=x.device)
    for i in range(t):
        for j, e in enumerate(ids[i]):
            y[i, j] = moe.swiglu(params["w_gate"][e], params["w_up"][e],
                                 params["w_down"][e], xt[i:i + 1])[0]
    shared = None
    if cfg.n_shared:
        sh = params["shared"]
        shared = moe.swiglu(sh["w_gate"], sh["w_up"], sh["w_down"], x
                            ).reshape(t, d)
    return y, r.gates.reshape(t, cfg.top_k), keep, shared


def moe_plain_sum(y, gates, keep, shared, shape):
    """Σ over choices in order of gate · y at the kept slots, in float32,
    rounded to y's dtype once, plus the shared expert: ``_moe_group``'s
    combine written per token."""
    import torch

    acc = torch.zeros(y.shape[0], y.shape[2], dtype=torch.float32,
                      device=y.device)
    for j in range(y.shape[1]):
        w = y[:, j] * gates[:, j, None].to(y.dtype)
        acc = acc + torch.where(keep[:, j, None], w, 0).float()
    out = acc.to(y.dtype)
    if shared is not None:
        out = out + shared
    return out.reshape(shape)


def moe_prompts(rng, vocab: int) -> list:
    """``MOE_REQUESTS`` requests: half the prompts a multiple of 32 tokens
    (32 routing groups at prefill), half not (one group), shuffled; each
    asks for ``MOE_NEW`` new tokens."""
    import numpy as np

    from repro_torch.serve.engine import Request

    half = MOE_REQUESTS // 2
    lens = rng.integers(MOE_PROMPT[0], MOE_PROMPT[1] + 1, MOE_REQUESTS)
    lens[:half] = lens[:half] // 32 * 32
    lens[half:] = np.minimum(lens[half:], MOE_PROMPT[1] - 1)
    lens[half:] += lens[half:] % 32 == 0
    lens = rng.permutation(lens)
    news = rng.integers(MOE_NEW[0], MOE_NEW[1] + 1, MOE_REQUESTS)
    return [Request(prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=int(m), rid=i)
            for i, (n, m) in enumerate(zip(lens, news))]


def lm_moe(dev, seed: int, card: str, path_launches: dict) -> list:
    """Phase 11: DeepSeek-V3 and Arctic at published width, cut depth,
    in bf16 behind ``ServeEngine``, one model at a time, each freed
    before the next (``serve_moe_model``).  Returns B8's timings at the
    GQA model's path shape (variants of B8's kernels-line entry)."""
    import dataclasses

    import torch

    from repro_torch import configs

    matmul = tf32_off("lm_moe")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()    # the earlier phases' inputs
    b8_variants = []
    for arch, n_layers, n_params in MOE_MODELS:
        cfg = dataclasses.replace(configs.get_config(arch),
                                  n_layers=n_layers)
        row = serve_moe_model(dev, seed, cfg, n_params, path_launches)
        emit({"phase": "lm_moe", **row, "held_before_gb": held / 1e9,
              "matmul": matmul, "card": card})
        assert not row["failed"], f"lm_moe {arch}: {row['failed']}"
        if row["b8_timing"] is not None:
            # the path's largest gap beside the timed call's own
            b8_variants.append({**row["b8_timing"],
                                "path_max_abs_err": row["b8"]["max_abs_err"],
                                "path_launches": row["b8"]["calls"]})
        gc.collect()
        torch.cuda.empty_cache()
    return b8_variants


def serve_moe_model(dev, seed: int, cfg, n_params: int | None,
                    path_launches: dict) -> dict:
    """One model of phase 11: seeded random weights drawn on the card,
    ``MOE_REQUESTS`` requests through ``ServeEngine`` (``MOE_ENGINE``),
    then the checks: launches (GQA's decode is one B8 launch a layer,
    each on the tensor-core kernel and held against its plain version
    inside the call; MLA's launches no kernel of the port but B1's
    token embeddings), routing on
    the card byte-equal to the CPU's on the same logits, the first
    decode round's MoE layers against ``moe_plain_layer`` (and two
    planted faults outside the bound), and two requests served dropless
    against a teacher-forced ``forward``; then the first round replayed
    and profiled.  Returns the row, with the failed checks under
    ``failed``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.paged_attn import kernel as pak
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    counted = tf.count_params(params)
    assert n_params is None or counted == n_params, (cfg.name, counted)
    read_bytes = sum(t.numel() * t.element_size() for t in tf.tree_leaves(
        {k: v for k, v in params.items() if k != "mtp"}))
    ecfg = EngineConfig(**MOE_ENGINE)
    engine = ServeEngine(params, cfg, ecfg, device=dev)
    requests = moe_prompts(np.random.default_rng(seed), cfg.vocab)
    full = sorted(-(-(len(r.prompt) + r.max_new_tokens) // ecfg.page_size)
                  for r in requests)
    assert sum(full[-ecfg.max_batch:]) <= ecfg.n_pages   # C4 cannot fire

    gqa = cfg.attn_type != "mla"
    kernel_fn, route_fn, moe_fn = (pak.paged_decode_attention, moe.route,
                                   tf.moe_ffn)
    decode_fn, prefill_fn = tf.decode_paged, tf.prefill_paged
    round_fn = engine._decode_round
    b8 = {"calls": 0, "max_abs_err": 0.0, "rel_err": 0.0, "check_s": 0.0,
          "groups": set()}
    stage = {"name": None}
    rounds, prefill_s, checks = [], [], [0.0]
    routings, layers, drops, first_plan = [], [], [], {}
    want_prefill = {}                    # group branch → its first prefill

    def b8_checked(q, kp, vp, table, lens_, **kw):
        out = kernel_fn(q, kp, vp, table, lens_, **kw)
        before = b8["check_s"]
        b8_check_call(out, (q, kp, vp, table, lens_), b8)
        assert pak.takes_tensor_cores(q, kp, vp), "B8 off the tensor cores"
        b8["groups"].add(q.shape[1] // kp.shape[1])
        b8.setdefault("first", (q, kp, vp, table, lens_))
        checks[0] += b8["check_s"] - before
        return out

    def route_rec(logits, cfg_, dropless):
        r = route_fn(logits, cfg_, dropless)
        if not dropless:
            drops.append(((~r.keep).sum(), r.keep.numel()))
        if stage["name"] is not None:
            t = time.perf_counter()
            routings.append({"stage": stage["name"], "dropless": dropless,
                             "logits": logits.cpu(), "capacity": r.capacity,
                             "card": [a.cpu() for a in r[:5]]})
            checks[0] += time.perf_counter() - t
        return r

    def moe_rec(params_, cfg_, x, dropless=False):
        out = moe_fn(params_, cfg_, x, dropless=dropless)
        if stage["name"] == "first decode round":
            layers.append((params_, x.clone(), out[0].clone()))
        return out

    def prefill_rec(params_, cfg_, tokens, *a, **kw):
        s = tokens.shape[1]
        branch = "32 groups" if s % 32 == 0 else "1 group"
        first = branch not in want_prefill
        if first:
            want_prefill[branch] = s
        stage["name"] = f"first prefill, {branch}" if first else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = checks[0] + b1["check_s"]
        out = prefill_fn(params_, cfg_, tokens, *a, **kw)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t
                         - (checks[0] + b1["check_s"] - before))
        stage["name"] = None
        return out

    def decode_rec(params_, cfg_, k_pool, v_pool, *plan, **kw):
        if not first_plan:
            first_plan.update(plan=plan, host=[plan[i].cpu().numpy()
                                               for i in (2, 3, 0)])
        return decode_fn(params_, cfg_, k_pool, v_pool, *plan, **kw)

    def round_rec():
        if not engine.live:
            return round_fn()
        stage["name"] = "first decode round" if not rounds else None
        batch = len(engine.live)
        before = checks[0] + b1["check_s"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        round_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check = checks[0] + b1["check_s"] - before
        rounds.append({"ms": (wall - check) * 1e3, "check_ms": check * 1e3,
                       "batch": batch})
        stage["name"] = None

    engine._decode_round = round_rec
    b1 = {"calls": 0, "bad": 0, "check_s": 0.0}
    reset_launches()
    with swapped(pak, "paged_decode_attention", b8_checked), \
            swapped(gk, "gather_rows", b1_held(b1)), \
            swapped(moe, "route", route_rec), \
            swapped(tf, "moe_ffn", moe_rec), \
            swapped(tf, "prefill_paged", prefill_rec), \
            swapped(tf, "decode_paged", decode_rec):
        for req in requests:
            engine.submit(req)
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    del engine._decode_round
    launches = path_launches[f"lm_moe {cfg.name}"] = dict(LAUNCHES)
    n_rounds = len(rounds)
    if gqa:
        assert launches["paged_decode_attention"] == \
            cfg.n_layers * n_rounds == b8["calls"], (launches, n_rounds)
        assert b8["groups"] == {cfg.n_heads // cfg.n_kv_heads}
    # B1 embeds each prefill's and each decode round's tokens, once.
    assert launches["gather_rows"] == MOE_REQUESTS + n_rounds, launches
    assert b1["calls"] == launches["gather_rows"] and not b1["bad"], \
        f"lm_moe {cfg.name}: B1 calls against the plain version: {b1}"
    others = {k: n for k, n in launches.items()
              if n and k != "gather_rows"
              and not (gqa and k == "paged_decode_attention")}
    assert not others, f"lm_moe {cfg.name} launched {others}"
    assert sorted(r.rid for r in done) == list(range(MOE_REQUESTS))
    for r in done:
        assert len(r.out_tokens) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)
    assert engine.pager.utilization == 0.0
    assert max(r["batch"] for r in rounds) == ecfg.max_batch
    assert set(want_prefill) == {"32 groups", "1 group"}
    failed = []

    # Routing: the card's decisions against the CPU's on the same logits.
    n_moe = sum(cfg.layer_uses_moe())
    assert len(routings) == 3 * n_moe, len(routings)
    for rec in routings:
        host = route_fn(rec["logits"], cfg.moe, rec["dropless"])
        rec["byte_equal"] = host.capacity == rec["capacity"] and all(
            bytes_equal(a, b) for a, b in zip(host[:5], rec["card"]))
        if not rec["byte_equal"]:
            failed.append(f"routing at the {rec['stage']}")
    dropped = sum(int(n) for n, _ in drops)
    slots = sum(n for _, n in drops)

    # The first decode round's MoE layers against the plain per-token
    # formulation, and two planted faults of the combine.
    assert len(layers) == n_moe
    moe_gaps = []
    for lp, x, out in layers:
        y, gates, keep, shared = moe_plain_layer(lp, cfg.moe, x)
        plain = moe_plain_sum(y, gates, keep, shared, out.shape)
        no_second = keep.clone()
        no_second[:, 1] = False
        swapped_gates = gates[:, [1, 0, *range(2, gates.shape[1])]]
        gap = {**logits_gap(out, plain, MOE_LAYER_MAX, MOE_LAYER_MEAN),
               "batch": int(x.shape[0]), "faults": {
                   "second choice dropped": logits_gap(
                       out, moe_plain_sum(y, gates, no_second, shared,
                                          out.shape),
                       MOE_LAYER_MAX, MOE_LAYER_MEAN),
                   "gates of choices 1 and 2 swapped": logits_gap(
                       out, moe_plain_sum(y, swapped_gates, keep, shared,
                                          out.shape),
                       MOE_LAYER_MAX, MOE_LAYER_MEAN)}}
        moe_gaps.append(gap)
        if not gap["ok"]:
            failed.append("MoE layer against its plain version")
        failed += [f"MoE layer, {name}: not caught"
                   for name, f in gap["faults"].items() if f["ok"]]
    del layers, y

    # Teacher forcing: two requests served dropless (capacity_factor =
    # E / k: capacity t, nothing dropped at prefill either) through the
    # same paged entry points; their prefill and decode logits against a
    # forward over prompt + generated tokens, of the same function.  A
    # near tie between a token's k-th and (k+1)-th expert can flip under
    # bf16 noise between the two computations and move that position's
    # logits by far more than the noise: such positions are counted, each
    # flip must be a near tie (router logit margin under MOE_FLIP_MARGIN
    # in the forward), and the bounds hold the other positions.
    cfg_tf = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    watch = [requests[0], requests[-1]]
    tf_engine = ServeEngine(params, cfg_tf, EngineConfig(
        max_batch=2, max_seq=ecfg.max_seq, page_size=ecfg.page_size,
        n_pages=2 * ecfg.max_seq // ecfg.page_size), device=dev)
    got_logits = {i: [] for i in range(len(watch))}
    served_routes = {i: {} for i in range(len(watch))}   # rid → pos → ids
    route_log = []

    def route_logged(logits, cfg_, dropless):
        r = route_fn(logits, cfg_, dropless)
        route_log.append((r.expert_ids.reshape(-1, cfg_.top_k).cpu(),
                          logits.reshape(-1, cfg_.n_experts).cpu()))
        return r

    def tf_prefill(params_, cfg_, tokens, *a, **kw):
        rid = sum(1 for v in got_logits.values() if v)   # first come
        route_log.clear()
        out = prefill_fn(params_, cfg_, tokens, *a, **kw)
        got_logits[rid].append(out[0].float())
        last = tokens.shape[1] - 1
        served_routes[rid][last] = [ids[last] for ids, _ in route_log]
        return out

    def tf_decode(*a, **kw):
        route_log.clear()
        out = decode_fn(*a, **kw)
        for i, (rid, pos) in enumerate(zip(tf_engine.live, a[5].tolist())):
            got_logits[rid].append(out[i].float())
            served_routes[rid][pos] = [ids[i] for ids, _ in route_log]
        return out

    with swapped(tf, "prefill_paged", tf_prefill), \
            swapped(tf, "decode_paged", tf_decode), \
            swapped(moe, "route", route_logged):
        for i, r in enumerate(watch):
            tf_engine.submit(Request(prompt=r.prompt, rid=i,
                                     max_new_tokens=r.max_new_tokens))
        tf_done = tf_engine.run()
    forced = []
    for req in tf_done:
        p, n = len(req.prompt), len(req.out_tokens)
        seq = np.concatenate([req.prompt, req.out_tokens[:-1]])
        route_log.clear()
        with torch.no_grad(), swapped(moe, "route", route_logged):
            full_logits, _ = tf.forward(params, cfg_tf, torch.from_numpy(
                seq[None].astype(np.int64)).to(dev))
        want = full_logits[0, p - 1:p + n - 1]
        got = torch.stack(got_logits[req.rid])
        assert got.shape == want.shape, (got.shape, want.shape)
        k = cfg.moe.top_k
        flips, margins = [], []
        for j, pos in enumerate(range(p - 1, p + n - 1)):
            served = served_routes[req.rid][pos]
            assert len(served) == len(route_log) == n_moe
            for mine, (ids, logits) in zip(served, route_log):
                if set(mine.tolist()) != set(ids[pos].tolist()):
                    top = torch.sort(logits[pos], descending=True).values
                    margins.append(float(top[k - 1] - top[k]))
                    flips.append(j)
        held = torch.ones(n, dtype=torch.bool)
        held[sorted(set(flips))] = False
        gap = logits_gap(got[held.to(dev)], want[held.to(dev)],
                         MOE_LOGITS_MAX, MOE_LOGITS_MEAN)
        agree = float((want.argmax(-1).cpu() == torch.tensor(
            req.out_tokens)).float().mean())
        # A planted fault: the forward with the configuration's own
        # capacity, which drops slots at every position.
        with torch.no_grad():
            dropping, _ = tf.forward(params, cfg, torch.from_numpy(
                seq[None].astype(np.int64)).to(dev))
        fault = logits_gap(got[held.to(dev)],
                           dropping[0, p - 1:p + n - 1][held.to(dev)],
                           MOE_LOGITS_MAX, MOE_LOGITS_MEAN)
        forced.append({"prompt": p, "generated": n,
                       "argmax_agrees": agree, **gap,
                       "routing_flips": len(set(flips)),
                       "flip_margins": margins,
                       "with_flips": logits_gap(got, want, MOE_LOGITS_MAX,
                                                MOE_LOGITS_MEAN),
                       "fault_capacity_not_lifted": fault})
        if not gap["ok"]:
            failed.append(f"teacher-forced logits (prompt {p})")
        if fault["ok"]:
            failed.append(f"teacher-forced, capacity not lifted: not "
                          f"caught (prompt {p})")
        del dropping
        if any(m >= MOE_FLIP_MARGIN for m in margins):
            failed.append(f"teacher-forced routing flip off a near tie "
                          f"(prompt {p}, margins {margins})")
        del full_logits, want, got
    del tf_engine, got_logits, route_log
    peak = torch.cuda.max_memory_allocated()

    # The first round replayed as the engine runs it (the plan copied to
    # the card, the step, the argmax read back), unchecked, then profiled.
    nb = first_plan["host"][0].shape[0]
    replay_ms = replayed_round_ms(params, cfg, engine, first_plan["host"],
                                  dev, MOE_REPLAYS)
    plan, host_tokens = first_plan["plan"], first_plan["host"][2]
    span = (int(host_tokens.min()), int(host_tokens.max()))
    with torch.no_grad():
        profiled = device_profile(
            lambda: tf.decode_paged(params, cfg, engine.k_pool,
                                    engine.v_pool, *plan, token_span=span),
            named=("b8_kernel_ms", "paged_attn_tc_kernel"))
    replay_p50 = float(np.median(replay_ms))
    bound_ms = read_bytes / HBM_BYTES_PER_S * 1e3
    # B8 at this path's shape: the first decode round's first layer.
    first_b8 = b8.pop("first", None)
    b8_timed = None if first_b8 is None else b8_timing(
        dev, *first_b8, f"{cfg.name} first decode round, layer 1 "
        f"(G = {cfg.n_heads // cfg.n_kv_heads})")

    ms = [r["ms"] for r in rounds]
    prompt_tokens = sum(len(r.prompt) for r in requests)
    row = {"model": cfg.name, "n_layers": cfg.n_layers,
           "layer_moe": cfg.layer_uses_moe(), "params": counted,
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in tf.tree_leaves(params)),
           "init_s": init_s, "engine": MOE_ENGINE, "requests": MOE_REQUESTS,
           "prompt_lens": [len(r.prompt) for r in requests],
           "first_prefill_lens": want_prefill,
           "prompt_tokens": prompt_tokens,
           "tokens_served": sum(len(r.out_tokens) for r in done),
           "decode_rounds": n_rounds, "round_ms_p50": float(np.median(ms)),
           "round_ms_max": max(ms),
           "decode_tokens_per_s": sum(r["batch"] for r in rounds)
           / (sum(ms) / 1e3),
           "prefill_s": sum(prefill_s),
           "prefill_tokens_per_s": prompt_tokens / sum(prefill_s),
           "serve_s": serve_s, "check_s": checks[0],
           "prefill_dropped_share": dropped / slots,
           "replayed_first_round": {
               "batch": nb, "rounds_ms": replay_ms,
               "round_ms_p50": replay_p50,
               "decode_tokens_per_s": nb / (replay_p50 / 1e3),
               "idle_share": 1.0 - profiled["kernel_ms"] / replay_p50},
           "profiled_first_round": profiled,
           "round_bound_ms": bound_ms, "round_read_bytes": read_bytes,
           "b8": {**b8, "groups": sorted(b8["groups"])},
           "routing_checked": [
               {k: v for k, v in r.items() if k not in ("logits", "card")}
               for r in routings],
           "moe_layer": moe_gaps,
           "moe_layer_bounds": {"max": MOE_LAYER_MAX, "mean": MOE_LAYER_MEAN},
           "teacher_forced": forced,
           "logits_bounds": {"max": MOE_LOGITS_MAX, "mean": MOE_LOGITS_MEAN},
           "peak_gb": peak / 1e9, "launches": launches, "failed": failed,
           "b1_calls_byte_equal": b1["calls"],
           "b8_timing": b8_timed}
    del engine, params, plan, first_plan, first_b8
    row["seconds"] = time.perf_counter() - start
    return row


# -- 11b. distributed ---------------------------------------------------------
DIST_PSUM_ELEMENTS = 1 << 24       # quantized_psum's seeded tensor (64 MB)
DIST_STEP_TOL = 1e-5               # the JAX distributed test's bound
DIST_STATE_ARCH = "dlrm-rm2"       # its published train state, AdamW
C14_ELEMENTS = 1 << 31             # one B2 run over a uint8 payload
C14_TIMED = 5


def quantized_psum_plain(x, scale_factor: float = 1.0):
    """``quantized_psum``'s arithmetic over a group of one rank, in plain
    torch on the CPU: the scale max|x| / 127 (``scale_factor`` times it:
    a planted fault), the int8 values, their int32 sum (the one rank's),
    dequantised."""
    import torch

    x32 = x.detach().float().cpu()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    scale = scale * scale_factor
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q.to(torch.int32).float() * scale


def dist_linear_step(dev, mesh, seed: int) -> dict:
    """The JAX test's linear AdamW step (w (16, 8), x (32, 16), y (32,
    8), lr 0.05, no decay or warm-up) on DTensors placed as that test
    places them, inside the mesh's context, against the same step on
    plain tensors on the card."""
    import numpy as np
    import torch

    from repro_torch.dataplane.pipeline import device_put_sharded
    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.sharding import P, named
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    cfg = OptimizerConfig(kind="adamw", lr=0.05, weight_decay=0.0,
                          warmup_steps=0, total_steps=10_000)
    rng = np.random.default_rng(seed)
    host = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(dev) for k, s in (("w", (16, 8)), ("x", (32, 16)),
                                  ("y", (32, 8)))}
    step = make_train_step(loss_fn, cfg)
    batch = {"x": host["x"], "y": host["y"]}
    ref, _ = step(init_train_state({"w": host["w"].clone()}, cfg), batch)
    sspec = {"params": {"w": P(None, "model")},
             "opt": {"m": {"w": P("data", "model")},
                     "v": {"w": P("data", "model")}, "step": P()}}
    state = device_put_sharded(init_train_state({"w": host["w"].clone()},
                                                cfg), named(mesh, sspec))
    placed = device_put_sharded(batch, named(mesh, {"x": P("data", None),
                                                    "y": P("data", None)}))
    with mesh_context(mesh):
        out, _ = step(state, placed)
    w = out["params"]["w"].detach()
    err = float(torch.max(torch.abs(w.full_tensor()
                                    - ref["params"]["w"].detach())))
    assert w.to_local().device.type == dev.type
    assert err <= DIST_STEP_TOL, f"DTensor step off by {err}"
    return {"max_abs_err": err, "tol": DIST_STEP_TOL,
            "placements": [str(p) for p in w.placements]}


def dist_state_round_trip(dev, seed: int, mesh, d: Path, cfg=None) -> dict:
    """DLRM-RM2's train state (published unless ``cfg``) with drawn
    moments, placed on ``mesh`` by its sanitized specs (the recsys rules
    and ZeRO-1 moments: its lowering's, which the published state
    checks), saved
    as a sharded checkpoint into ``d`` and restored onto the mesh with
    ``shardings``; every local tensor must be byte-equal to the
    source's."""
    import torch

    from repro_torch.configs import get_arch, get_config
    from repro_torch.configs import train as train_cfgs
    from repro_torch.configs.common import _opt_specs
    from repro_torch.dataplane.pipeline import device_put_sharded
    from repro_torch.distributed.sharding import (named, param_specs,
                                                  recsys_rules,
                                                  sanitize_specs)
    from repro_torch.train import checkpoint as ckpt

    out = {"arch": DIST_STATE_ARCH}
    t0 = time.perf_counter()
    run = train_cfgs.train(DIST_STATE_ARCH,
                           cfg or get_config(DIST_STATE_ARCH), device=dev,
                           seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for m in run["state"]["opt"]["m"].values():
            m.normal_(generator=gen)
        for v in run["state"]["opt"]["v"].values():
            v.uniform_(generator=gen)
        run["state"]["opt"]["step"].fill_(3)
    state = {"params": {k: p.detach() for k, p in
                        run["state"]["params"].items()},
             "opt": run["state"]["opt"]}
    pspecs = param_specs(state["params"], recsys_rules)
    specs = {"params": pspecs,
             "opt": _opt_specs(run["opt"].kind, state["params"], pspecs)}
    if cfg is None:     # the published state: its lowering's own specs
        low = get_arch(DIST_STATE_ARCH).lowering("train_batch", mesh)
        assert specs == low.in_specs[0]
        del low
    shardings = named(mesh, sanitize_specs(specs, state, mesh))
    placed = device_put_sharded(state, shardings)
    # What the restore is handed: the state's shapes and dtypes only.
    target = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), state)
    del run, state
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out["build_and_place_s"] = time.perf_counter() - t0
    leaves = ckpt.flatten_tree(placed)
    out["bytes"] = sum(t.to_local().numel() * t.element_size()
                       for t in leaves.values())
    out["leaves"] = len(leaves)
    t0 = time.perf_counter()
    ckpt.save_checkpoint(d, 1, placed)
    out["save_s"] = time.perf_counter() - t0
    out["file_bytes"] = sum(f.stat().st_size for f in d.rglob("*")
                            if f.is_file())
    t0 = time.perf_counter()
    restored = ckpt.restore_checkpoint(d, 1, target, shardings)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    got = ckpt.flatten_tree(restored)
    assert sorted(got) == sorted(leaves)
    bad = [k for k, v in leaves.items()
           if tuple(got[k].placements) != tuple(v.placements)
           or got[k].to_local().device.type != dev.type
           or not same_bytes(got[k].to_local(), v.to_local())]
    assert not bad, f"restored state differs at {bad[:5]}"
    out["byte_equal"] = True
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del placed, restored, got, leaves
    torch.cuda.empty_cache()
    return out


def c14_read(dev, seed: int, timer, path_launches: dict) -> dict:
    """Fault C14: one run (0, 2³¹) of a 2³¹-element uint8 payload through
    ``gather_plan_runs``, the counts set to 0 just before and read just
    after (``path_launches["distributed"]``: one B2 launch), byte-equal
    to the payload; then its time beside the bytes bound (each byte read
    once and written once, each run's start, length and offset) and that
    of the one PyTorch call that computes the same, a copy of the
    payload."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ops as gops

    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randint(0, 256, (C14_ELEMENTS,), dtype=torch.uint8,
                         device=dev, generator=gen)
    starts, lengths = np.array([0]), np.array([C14_ELEMENTS])
    reset_launches()
    out = gops.gather_plan_runs(flat, starts, lengths)
    torch.cuda.synchronize()
    path_launches["distributed"] = dict(LAUNCHES)
    assert {k: n for k, n in LAUNCHES.items() if n} == \
        {"gather_plan_runs": 1}, f"the 2^31-element read: {dict(LAUNCHES)}"
    assert out.shape == flat.shape and torch.equal(out, flat), \
        "C14: the 2^31-element read differs from the payload"
    del out
    runs = gops.plan_run_inputs(flat, starts, lengths)
    n_runs = runs[0].numel()
    n_bytes = 2 * C14_ELEMENTS + n_runs * 16
    ms = timer(lambda: gk.gather_plan_runs(flat, *runs), iters=C14_TIMED,
               warmup=1)
    # One run from 0 is a copy of the payload's first 2^31 elements.
    library_ms = timer(lambda: flat.narrow(0, 0, C14_ELEMENTS).clone(),
                       iters=C14_TIMED, warmup=1)
    del flat, runs
    torch.cuda.empty_cache()
    return {"what": "C14: one run of 2^31 uint8 elements",
            "byte_equal": True, "ms": ms, "library_ms": library_ms,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": n_bytes, "shape": {"N": C14_ELEMENTS, "R": 1,
                                        "runs_handed_to_b2": n_runs}}


# The dry run's trace of all 80 records runs beside the card's phases, in
# a process of its own started after the build (it needs no card), each
# decoder cut to DRYRUN_LAYERS layers a layer group (a full-depth trace
# of a decoder's train step takes minutes of host time), DRYRUN_JOBS
# cells at once.
DRYRUN_LAYERS = 1
DRYRUN_JOBS = 3
DRYRUN_LIMIT_S = 900


def start_dryrun() -> tuple:
    """``python -m repro_torch.launch.dryrun --all --both-meshes --cost``
    started (no card: ``CUDA_VISIBLE_DEVICES`` empty), its records to
    ``build/dryrun_cost.json`` and its output to a log beside them:
    (the process, the records' path, the log's path, its start)."""
    out = ROOT / "build" / "dryrun_cost.json"
    log = out.with_suffix(".log")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--both-meshes", "--cost", "--layers", str(DRYRUN_LAYERS),
             "--jobs", str(DRYRUN_JOBS), "--out", str(out)],
            env=env, cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT,
            process_group=0)
    # However this script ends, the dry run and its workers end with it.
    atexit.register(stop_group, proc)
    return proc, out, log, time.perf_counter()


def stop_group(proc) -> None:
    """Kill ``proc``'s process group (it and the workers it started)."""
    import signal

    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def dryrun_all(started: tuple) -> dict:
    """The dry run's 80 traced records (``start_dryrun``), waited for:
    all ``ok``, each with the JAX dry run's cost, collective and memory
    keys (FLOPs and bytes accessed above 0, ``code_bytes`` None); the
    largest per-device ``argument_bytes`` of each family and DeepSeek-V3's
    and Arctic's ``train_4k``, each with its traced FLOPs, temporary
    bytes and collective bytes."""
    from repro_torch.configs import get_arch

    proc, out, log, t0 = started
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_LIMIT_S -
                                   (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_group(proc)
        raise AssertionError(f"the dry run passed {DRYRUN_LIMIT_S} s: "
                             f"{log.read_text()[-2000:]}")
    assert rc == 0, f"the dry run failed: {log.read_text()[-3000:]}"
    done = [ln for ln in log.read_text().splitlines()
            if ln.startswith("done:")][-1]
    recs = list(json.loads(out.read_text()).values())
    assert len(recs) == 80 and all(r["ok"] for r in recs)
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    for r in recs:
        assert r["cost"]["flops_per_device"] > 0, r["arch"]
        assert r["cost"]["bytes_accessed_per_device"] > 0, r["arch"]
        assert r["memory"]["code_bytes"] is None
        assert set(r["collectives"]) == set(kinds) | {"total_bytes"}

    def traced(r):
        return {"argument_bytes": r["memory"]["argument_bytes"],
                "flops_per_device": r["cost"]["flops_per_device"],
                "temp_bytes": r["memory"]["temp_bytes"],
                "collective_bytes": r["collectives"]["total_bytes"]}

    largest: dict = {}
    for r in recs:
        fam = get_arch(r["arch"]).family
        b = r["memory"]["argument_bytes"]
        if b > largest.get(fam, {}).get("argument_bytes", -1):
            largest[fam] = {**traced(r), "arch": r["arch"],
                            "shape": r["shape"], "mesh": r["mesh"]}
    return {"records": len(recs), "traced": True,
            "layers": DRYRUN_LAYERS, "jobs": DRYRUN_JOBS,
            "seconds": float(done.rsplit(",", 1)[1].split()[0]),
            "read_at_s": time.perf_counter() - t0,
            "trace_s_sum": sum(r["compile_s"] for r in recs),
            "largest_by_family": largest,
            "train_4k": {f"{r['arch']}|{r['mesh']}": traced(r)
                         for r in recs if r["shape"] == "train_4k"
                         and r["arch"] in ("deepseek-v3-671b",
                                           "arctic-480b")}}


def distributed(dev, seed: int, card: str, path_launches: dict,
                dryrun_started: tuple) -> dict:
    """Phase 11b; returns B2's C14 variant for the kernels line.  The dry
    run (``start_dryrun``) is read after the NCCL group is gone."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.compression import quantized_psum
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    row = {"phase": "distributed", "card": card}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(str(Path(d) / "store"), 1), rank=0,
            world_size=1)
        try:
            mesh = make_host_mesh(1, 1)
            assert mesh.device_mesh.device_type == dev.type
            row["group_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn(DIST_PSUM_ELEMENTS, generator=gen, device=dev)
            got = quantized_psum(x).cpu()
            want = quantized_psum_plain(x)
            fault = quantized_psum_plain(x, scale_factor=0.5)
            assert bytes_equal(got, want), "quantized_psum != plain"
            assert not bytes_equal(got, fault), \
                "a halved scale went unseen"
            timer = Timer(dev)
            row["quantized_psum"] = {
                "elements": DIST_PSUM_ELEMENTS, "byte_equal": True,
                "planted_fault_outside": True,
                "ms": timer(lambda: quantized_psum(x), iters=10),
                "seconds": time.perf_counter() - t0}
            del x

            t0 = time.perf_counter()
            row["dtensor_step"] = {**dist_linear_step(dev, mesh, seed),
                                   "seconds": time.perf_counter() - t0}

            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            row["state"] = {**dist_state_round_trip(
                dev, seed, mesh, Path(d) / "ckpt"),
                "seconds": time.perf_counter() - t0}

            t0 = time.perf_counter()
            c14 = c14_read(dev, seed, timer, path_launches)
            row["c14"] = {**c14, "seconds": time.perf_counter() - t0}
        finally:
            dist.destroy_process_group()
    row["dryrun"] = dryrun_all(dryrun_started)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return c14


# The sharded_models phase: cells' Lowering.fn on DTensors over a (1, 1)
# mesh of an NCCL group of one, against the plain-tensor path from the
# same seed.  A one-rank mesh reduces nothing, so every result must be
# the plain path's to the bit (both in deterministic mode: B6's and B1's
# backward is index_add_).
SHARDED_STEPS = 3                 # DLRM-RM2 and NequIP: 1 + 2 steps each
SHARDED_TT_P99 = 512              # two-tower serve_p99 users and items


def sharded_models(dev, seed: int, card: str, check,
                   path_launches: dict) -> None:
    """Phase 11b2: DLRM-RM2 ``train_batch`` (published width, 65,536
    rows), two-tower ``serve_p99`` and ``retrieval_cand`` and NequIP
    ``minibatch_lg`` training, each through its cell's ``Lowering.fn``
    with the state (or parameters) and the batch as DTensors under the
    cell's specs on a (1, 1) ("data", "model") mesh, against the
    plain-tensor path from the same seed, which runs first and is freed
    (its results kept on the host).  Results byte-equal, the same
    launches of B6, B1 and B7 (and ``segment_plan``), and every kernel
    call of the mesh runs' first step or forward held against its plain
    version at the time of the call (so the mesh's first step is slower
    by those checks).  Each run's seconds cover building its state
    (the plain path builds its model, the mesh run places one built
    before); ``step_s`` times each step to a synchronize.  The counters
    of the mesh runs alone are the path's."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    row = {"phase": "sharded_models", "card": card}
    mesh_launches = {k: 0 for k in LAUNCHES}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(d) / "store"), 1), rank=0,
            world_size=1)
        try:
            mesh = make_host_mesh(1, 1)
            assert mesh.device_mesh.device_type == "cuda"
            for name, fn in (("dlrm_train", sharded_dlrm),
                             ("two_tower_serve", sharded_two_tower),
                             ("nequip_train", sharded_nequip)):
                row[name] = fn(dev, seed, mesh, check)
                for k, v in row[name]["mesh"]["launches"].items():
                    mesh_launches[k] += v
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    path_launches["sharded_models"] = mesh_launches
    for kname in ("gather_rows", "gather_rows_bag", "segment_sum"):
        assert mesh_launches[kname] > 0, f"{kname}: not on the mesh path"
    row["launches"] = {k: v for k, v in mesh_launches.items() if v}
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)


def counted_run(fn) -> dict:
    """``fn()`` with the counters reset before it: its result, seconds
    (to a synchronize), launches and peak memory above what was held."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, peak = peak_of(fn)
    torch.cuda.synchronize()
    return {"out": out, "seconds": time.perf_counter() - t0,
            "launches": {k: v for k, v in LAUNCHES.items() if v},
            "peak_bytes": peak}


def host_copy(tree: dict) -> dict:
    """Each tensor of ``tree`` (plain, or a DTensor's local shard: the
    whole tensor on a one-rank mesh) copied to the host."""
    from repro_torch.distributed.sharding import is_dtensor

    return {k: (v.to_local() if is_dtensor(v) else v).detach().cpu()
            for k, v in tree.items()}


def compare_runs(plain: dict, mesh: dict, what: str) -> dict:
    """The two runs' host results byte-equal and their launches equal;
    the row of both (the results dropped)."""
    assert plain["launches"] == mesh["launches"], \
        f"{what}: launches {plain['launches']} plain, {mesh['launches']} " \
        f"on the mesh"
    bad = [k for k in plain["out"] if not same_bytes(plain["out"][k],
                                                     mesh["out"][k])]
    assert not bad, f"{what}: the mesh run differs from the plain one " \
        f"at {bad[:5]}"
    return {run: {k: v for k, v in r.items() if k != "out"}
            for run, r in (("plain", plain), ("mesh", mesh))}


@contextlib.contextmanager
def checked_calls(module, name: str, plain, check, what: str):
    """Each call of ``module.<name>`` while the block runs held against
    ``plain`` on the same inputs at the time of the call (before a step's
    optimizer writes the parameters it read); yields the list of checked
    calls' shapes."""
    fn = getattr(module, name)
    shapes = []

    def checking(*a, **kw):
        out = fn(*a, **kw)
        check(name, out, plain(*a, **kw), what)
        shapes.append(list(out.shape))
        return out

    with swapped(module, name, checking):
        yield shapes


def sharded_dlrm(dev, seed: int, mesh, check) -> dict:
    """DLRM-RM2 at published width: ``SHARDED_STEPS`` steps of the plain
    path (``configs.train.train``'s step on the model's parameters) and
    of the ``train_batch`` cell's ``fn`` on the state as DTensors, from
    the same seed and batches."""
    import torch

    from repro_torch import carry
    from repro_torch.configs import dlrm_rm2, get_arch
    from repro_torch.configs import train as train_cfgs
    from repro_torch.dataplane.pipeline import device_put
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels.gather import kernel as gk, ref as gref
    from repro_torch.models.recsys import DLRM
    from repro_torch.train.train_state import init_train_state

    cfg = dlrm_rm2._cfg()
    host = train_batches("dlrm", cfg, SHARDED_STEPS, seed)
    low = get_arch("dlrm-rm2").lowering("train_batch", mesh)

    def plain_steps():
        setup = train_cfgs.train("dlrm-rm2", cfg, device=dev, seed=seed)
        state, times = setup["state"], []
        for b in host:
            t0 = time.perf_counter()
            state, _ = setup["step"](state, device_put(b, dev))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return host_copy(state["params"]), times

    with deterministic():
        plain = counted_run(plain_steps)
        plain["out"], plain["step_s"] = plain["out"]
        gc.collect()
        torch.cuda.empty_cache()
        model = DLRM(cfg, device=dev, seed=seed)
        state = carry.distribute_state(init_train_state(
            carry.model_params(model), dlrm_rm2._opt()), mesh,
            low.in_specs[0])
        del model
        gc.collect()
        torch.cuda.empty_cache()
        batches = [carry.distribute_state(b, mesh, low.in_specs[1])
                   for b in host]

        def mesh_steps():
            st, times, first = state, [], []
            with mesh_context(mesh):
                for i, b in enumerate(batches):
                    t0 = time.perf_counter()
                    with (checked_calls(gk, "gather_rows_bag",
                                        gref.gather_rows_bag, check,
                                        "sharded_models dlrm")
                          if i == 0 else contextlib.nullcontext()) as c:
                        st, _ = low.fn(st, b)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    first = c or first
            return host_copy(st["params"]), times, first

        on_mesh = counted_run(mesh_steps)
        peak = traced_peak(low, mesh, state, batches[0])
    on_mesh["out"], on_mesh["step_s"], first = on_mesh["out"]
    out = compare_runs(plain, on_mesh, "dlrm-rm2 train_batch")
    out["b6_calls_checked"] = len(first)
    out["rows"] = int(host[0]["bags"].shape[0])
    out["steps"] = SHARDED_STEPS
    out["traced_peak"] = peak
    return out


def traced_peak(low, mesh, state, batch) -> dict:
    """One more step of a cell's ``fn`` on ``mesh``: first traced by the
    dry run's counting (``launch.cost.trace``) on fake copies of the
    state's and batch's shards, then run for real (unchecked, its
    launches uncounted) with the card's peak reset before it.  The
    trace's peak of live bytes (arguments, temporaries and the outputs
    not written in place) beside ``torch.cuda.max_memory_allocated`` over
    the real step, less what was held before it but the step's own
    arguments; their ratio (no bound)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch import cost

    fake_mode = FakeTensorMode()

    def fake(x):
        return DTensor.from_local(fake_mode.from_tensor(x.to_local()),
                                  x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    t0 = time.perf_counter()
    args = (tree_map(fake, state), tree_map(fake, batch))
    with mesh_context(mesh), fake_mode:
        rec = cost.trace(low.fn, args, low.donate)
    mem = rec["memory"]
    traced = mem["argument_bytes"] + mem["temp_bytes"] + \
        mem["output_bytes"] - mem["alias_bytes"]
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with uncounted(), mesh_context(mesh):
        low.fn(state, batch)
    torch.cuda.synchronize()
    max_allocated = torch.cuda.max_memory_allocated()
    measured = max_allocated - held + mem["argument_bytes"]
    return {"traced_peak_bytes": traced, "memory": mem,
            "max_memory_allocated": max_allocated, "held_before": held,
            "measured_peak_bytes": measured,
            "traced_over_measured": traced / measured,
            "trace_s": trace_s}


def sharded_two_tower(dev, seed: int, mesh, check) -> dict:
    """Two-tower at published width: ``serve_p99`` (512 users against
    their 512 items) and ``retrieval_cand`` (one user, 2²⁰ candidates)
    forwards, through the plain model and through each cell's ``fn`` on
    the parameters and ids as DTensors, the mesh's B1 calls checked;
    then both once more, unchecked, timed alike (``warm_s``), and once
    more under the profiler (``profiled``: wall, kernel time, idle
    share)."""
    import numpy as np
    import torch

    from repro_torch import carry
    from repro_torch.configs import get_arch, two_tower_retrieval
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels.gather import kernel as gk, ref as gref
    from repro_torch.models.recsys import TwoTower

    cfg = two_tower_retrieval._cfg()
    rng = np.random.default_rng(seed)
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_cand"]
    p99 = {"user_ids": rng.integers(0, cfg.n_users, SHARDED_TT_P99),
           "item_ids": rng.integers(0, cfg.n_items, SHARDED_TT_P99),
           "item_logq": np.zeros(SHARDED_TT_P99)}
    p99 = {k: v.astype(np.float32 if k == "item_logq" else np.int32)
           for k, v in p99.items()}
    user = rng.integers(0, cfg.n_users, 1).astype(np.int32)
    cands = rng.integers(0, cfg.n_items, n_cand).astype(np.int32)
    model = TwoTower(cfg, device=dev, seed=seed)

    def plain_forwards():
        with torch.no_grad():
            t = {k: torch.from_numpy(v).to(dev) for k, v in p99.items()}
            a = model.score_candidates(t["user_ids"], t["item_ids"])
            b = model.score_candidates(torch.from_numpy(user).to(dev),
                                       torch.from_numpy(cands).to(dev))
        return {"serve_p99": a.cpu(), "retrieval_cand": b.cpu()}

    with deterministic():
        plain = counted_run(plain_forwards)
        params = {k: v.detach() for k, v in
                  carry.model_params(model).items()}
        lows = {s: get_arch("two-tower-retrieval").lowering(s, mesh)
                for s in ("serve_p99", "retrieval_cand")}
        placed = carry.distribute_state(params, mesh,
                                        lows["serve_p99"].in_specs[0])
        args = {"serve_p99": (carry.distribute_state(
                    p99, mesh, lows["serve_p99"].in_specs[1]),),
                "retrieval_cand": tuple(
                    carry.distribute_state(a, mesh, s) for a, s in zip(
                        (user, cands), lows["retrieval_cand"].in_specs[1:]))}

        def mesh_forwards():
            with mesh_context(mesh), checked_calls(
                    gk, "gather_rows", gref.gather_rows, check,
                    "sharded_models two-tower") as calls:
                got = {s: lows[s].fn(placed, *args[s]).full_tensor().cpu()
                       for s in lows}
            return got, calls

        on_mesh = counted_run(mesh_forwards)

        def mesh_unchecked():
            with mesh_context(mesh):
                return {s: lows[s].fn(placed, *args[s]).full_tensor().cpu()
                        for s in lows}

        # Both paths again, warm and unchecked, for their times; then once
        # more each under the profiler: the device's share of the wall.
        warm = {"plain": counted_run(plain_forwards),
                "mesh": counted_run(mesh_unchecked)}
        profiled = {run: device_profile(fn, top=4,
                                        named=("b1_ms", "gather_rows"))
                    for run, fn in (("plain", plain_forwards),
                                    ("mesh", mesh_unchecked))}
    on_mesh["out"], calls = on_mesh["out"]
    for run, r in warm.items():
        assert all(same_bytes(plain["out"][k], r["out"][k])
                   for k in plain["out"]), f"two-tower {run} again differs"
    out = compare_runs(plain, on_mesh, "two-tower serving")
    out["b1_calls_checked"] = len(calls)
    out["warm_s"] = {run: r["seconds"] for run, r in warm.items()}
    out["profiled"] = profiled
    out["shapes"] = {"serve_p99": SHARDED_TT_P99, "retrieval_cand": n_cand}
    return out


def sharded_nequip(dev, seed: int, mesh, check) -> dict:
    """NequIP at published width on phase 9's ``minibatch_lg`` graph:
    ``SHARDED_STEPS`` steps of the plain path and of the cell's ``fn``
    on the state and the graph as DTensors (nodes and edges sharded over
    both mesh axes), from the same seed, their parameters compared; then
    one more step of each under the profiler (``profiled``: wall, kernel
    time, idle share), its launches counted with the rest."""
    import torch

    from repro_torch import carry
    from repro_torch.configs import get_arch
    from repro_torch.configs import nequip as nequip_cfg
    from repro_torch.configs import train as train_cfgs
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels.segment import kernel as segk
    from repro_torch.kernels.segment import ref as segref
    from repro_torch.models.nequip import NequIP
    from repro_torch.train.train_state import init_train_state

    shape = "minibatch_lg"
    cfg = nequip_cfg.for_shape(shape)
    low = get_arch("nequip").lowering(shape, mesh)
    host = {k: v for k, v in nequip_train_batch(shape, seed).items()
            if k in low.args[1]}
    assert set(host) == set(low.args[1]), sorted(host)

    def plain_steps():
        setup = train_cfgs.train("nequip", cfg, device=dev, seed=seed)
        state = setup["state"]
        batch = nequip_batch_on(host, dev, torch.float32)
        times = []
        for _ in range(SHARDED_STEPS):
            t0 = time.perf_counter()
            state, _ = setup["step"](state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        params = host_copy(state["params"])
        return params, times, device_profile(
            lambda: setup["step"](state, batch), top=4)

    with deterministic():
        plain = counted_run(plain_steps)
        plain["out"], plain["step_s"], plain["profiled"] = plain["out"]
        gc.collect()
        torch.cuda.empty_cache()
        model = NequIP(cfg, device=dev, seed=seed)
        state = carry.distribute_state(init_train_state(
            carry.model_params(model), nequip_cfg._opt()), mesh,
            low.in_specs[0])
        del model
        batch = carry.distribute_state(nequip_batch_on(host, dev,
                                                       torch.float32),
                                       mesh, low.in_specs[1])

        def mesh_steps():
            st, times, first = state, [], []
            with mesh_context(mesh):
                for i in range(SHARDED_STEPS):
                    t0 = time.perf_counter()
                    with (checked_calls(segk, "segment_sum",
                                        segref.segment_sum, check,
                                        "sharded_models nequip")
                          if i == 0 else contextlib.nullcontext()) as c:
                        st, _ = low.fn(st, batch)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    first = c or first
                params = host_copy(st["params"])
                return params, times, first, device_profile(
                    lambda: low.fn(st, batch), top=4)

        on_mesh = counted_run(mesh_steps)
    on_mesh["out"], on_mesh["step_s"], first, on_mesh["profiled"] = \
        on_mesh["out"]
    out = compare_runs(plain, on_mesh, f"nequip {shape}")
    out["b7_calls_checked"] = len(first)
    out["graph"] = {"nodes": int(host["node_feat"].shape[0]),
                    "edges": int(host["edge_index"].shape[1]),
                    "d_feat": int(host["node_feat"].shape[1])}
    out["steps"] = SHARDED_STEPS
    return out


# The sharded_lm phase: the LM family's and BERT4Rec's cells' Lowering.fn
# on DTensors over a (1, 1) mesh of an NCCL group of one, against the
# same fn on plain tensors from the same seed (both in deterministic
# mode), at published width and the cuts below (PERF.md §4).
SHARDED_LM_DECODE_ROWS = 8        # decode_32k: 128 rows cut to 8
SHARDED_LM_PREFILL_ROWS = 1       # prefill_32k: 32 rows cut to 1
# prefill_32k's q chunk for DeepSeek-V3 and Arctic: their published
# 1024-row tiles of float32 scores (17.2 GB for DeepSeek's 128 heads)
# do not fit beside 53-55 GB of weights, nor did 256-row ones beside
# what the earlier phases hold (2.9 GB); a chunk changes no value.
SHARDED_MOE_Q_CHUNK = 128
SHARDED_BERT_BULK = 4096          # serve_bulk: 262,144 rows cut to 4,096
# DeepSeek-V3 and Arctic train_4k at smoke width (published width does
# not fit one card): 8 microbatches of 2 rows of 64 tokens.
SHARDED_SMOKE_TRAIN = dict(rows=16, seq=64)


def draw_decoder(cfg, dev, seed: int) -> dict:
    """A decoder's flat train-state parameters (``carry.decoder_params``'
    keys, each group's layers stacked) drawn on the card from ``seed``,
    each leaf in place where it lives: norms ones, embeddings normal ·
    0.02, every weight normal · 1/√d_in (d_in its second-to-last dim),
    in the configuration's dtypes (the router float32): ``init_params``'
    scheme without the nested tree, whose stacking would hold the
    weights twice."""
    import math

    import torch

    from repro_torch import carry
    from repro_torch.models import transformer as tf

    meta = carry.decoder_params(tf.init_params(cfg, device="meta"), cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for key, m in meta.items():
        t = torch.empty(m.shape, dtype=m.dtype, device=dev)
        parts = key.split("/")
        if parts[-1] == "scale":
            t.fill_(1.0)
        elif parts[0] in ("embed", "pos_embed"):
            t.normal_(0.0, 0.02, generator=gen)
        else:
            t.normal_(0.0, 1.0 / math.sqrt(m.shape[-2]), generator=gen)
        out[key] = t
    return out


def draw_caches(cfg, rows: int, seq: int, dev, seed: int) -> list:
    """A dense decode cache (``init_cache``'s layout) of normal values
    drawn on the card from ``seed``: the same bytes at every call."""
    import torch

    from repro_torch.models import transformer as tf

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return [{k: torch.empty(v.shape, dtype=v.dtype, device=dev).normal_(
                generator=gen) for k, v in group.items()}
            for group in tf.init_cache(cfg, rows, seq, device="meta")]


def on_one_rank(tree, mesh, specs):
    """The tensors of ``tree`` as DTensors on a one-rank ``mesh`` under
    ``specs`` (made legal for it): each wraps its tensor, never a copy,
    since every shard of one rank is the whole tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd

    assert mesh.size == 1, mesh
    specs = shd.sanitize_specs(specs, tree, mesh)

    def wrap(t, spec):
        return DTensor.from_local(
            t, mesh.device_mesh, shd.placements(mesh.axis_names, spec),
            run_check=False, shape=t.shape, stride=t.stride())

    return shd.tree_map(wrap, tree, specs, is_leaf=shd.is_spec_leaf)


def local_tree(tree) -> dict:
    """{path: tensor} of a result tree, each DTensor as its local tensor
    (the whole tensor on a one-rank mesh), detached, where it lies."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.train.checkpoint import flatten_tree

    return {k: (v.to_local() if is_dtensor(v) else v).detach()
            for k, v in flatten_tree(tree).items()}


def lm_pair(mesh, check, low, plain_args, mesh_args, keep, what: str
            ) -> dict:
    """``low.fn`` on ``plain_args()`` and then, within the mesh's context,
    on ``mesh_args()`` (DTensors), both in deterministic mode, each
    building its arguments inside its run: the two ``keep(result)``
    trees byte-equal, the same launches, every B1 call of the mesh run
    held against B1's plain version when it is made; each run's
    seconds, launches and peak memory."""
    import torch

    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels.gather import kernel as gk, ref as gref

    def run_plain():
        return keep(low.fn(*plain_args()))

    def run_mesh():
        args = mesh_args()
        with mesh_context(mesh), checked_calls(
                gk, "gather_rows", gref.gather_rows, check,
                f"sharded_lm {what}") as calls:
            return keep(low.fn(*args)), calls

    with deterministic():
        plain = counted_run(run_plain)
        gc.collect()
        torch.cuda.empty_cache()
        on_mesh = counted_run(run_mesh)
    on_mesh["out"], calls = on_mesh["out"]
    row = compare_runs(plain, on_mesh, what)
    assert calls, f"{what}: no B1 call on the mesh"
    for run in ("plain", "mesh"):
        row[run]["peak_gb"] = row[run].pop("peak_bytes") / 1e9
    row["b1_calls_checked"] = len(calls)
    del plain, on_mesh
    gc.collect()
    torch.cuda.empty_cache()
    return row


def lm_serving_runs(dev, seed: int, mesh, check, arch_id: str, cfg,
                    params: dict, prefill_cfg, prefill_params: dict
                    ) -> dict:
    """A decoder's ``long_500k`` (at full size) and ``decode_32k`` (rows
    cut to ``SHARDED_LM_DECODE_ROWS``) at ``cfg`` on ``params``, and
    ``prefill_32k`` (cut to ``SHARDED_LM_PREFILL_ROWS``) at
    ``prefill_cfg`` on ``prefill_params``, through their cells' ``fn``;
    the mesh runs read the same tensors wrapped as DTensors, and each
    run's cache is drawn again from the seed."""
    import numpy as np
    import torch

    from repro_torch.configs import common, train as train_cfgs

    mod = train_cfgs.module_of(arch_id)
    fsdp = arch_id not in ("glm4-9b", "granite-3-8b")
    arch = common.lm_arch(arch_id, cfg, cfg, mod._opt(), fsdp=fsdp)
    rows = {}
    for shape, n in (("long_500k", 1),
                     ("decode_32k", SHARDED_LM_DECODE_ROWS)):
        low = arch.lowering(shape, mesh)
        seq = common.LM_SHAPES[shape]["seq"]
        rng = np.random.default_rng(seed)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, n).astype(
            np.int32)).to(dev)
        # The last position reads every cache row of a sequence.
        pos = torch.from_numpy(np.concatenate([[seq - 1], rng.integers(
            0, seq, n - 1)]).astype(np.int32)).to(dev)
        placed = on_one_rank(params, mesh, low.in_specs[0])
        rows[shape] = lm_pair(
            mesh, check, low,
            lambda n=n, seq=seq, tok=tok, pos=pos: (
                params, draw_caches(cfg, n, seq, dev, seed), tok, pos),
            lambda n=n, seq=seq, tok=tok, pos=pos, low=low, placed=placed: (
                placed, *(on_one_rank(a, mesh, s) for a, s in zip(
                    (draw_caches(cfg, n, seq, dev, seed), tok, pos),
                    low.in_specs[1:]))),
            local_tree, f"{arch_id} {shape}")
        rows[shape].update(rows=n, seq=seq)
    parch = common.lm_arch(arch_id, prefill_cfg, prefill_cfg, mod._opt(),
                           fsdp=fsdp)
    low = parch.lowering("prefill_32k", mesh)
    seq = common.LM_SHAPES["prefill_32k"]["seq"]
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SHARDED_LM_PREFILL_ROWS, seq)).astype(np.int32)).to(
        dev)
    placed = on_one_rank(prefill_params, mesh, low.in_specs[0])
    rows["prefill_32k"] = lm_pair(
        mesh, check, low, lambda: (prefill_params, toks),
        lambda: (placed, on_one_rank(toks, mesh, low.in_specs[1])),
        local_tree, f"{arch_id} prefill_32k")
    rows["prefill_32k"].update(rows=SHARDED_LM_PREFILL_ROWS, seq=seq,
                               q_chunk=prefill_cfg.q_chunk,
                               layers=prefill_cfg.n_layers)
    return rows


def lm_train_run(dev, seed: int, mesh, check, arch_id: str, cfg,
                 rows: int, seq: int) -> dict:
    """One ``train_4k`` step of a decoder at ``cfg`` through the cell's
    ``fn`` (8 microbatches): the plain state drawn from the seed, then
    the same state drawn again and wrapped as DTensors; the parameters
    after the step byte-equal."""
    import numpy as np
    import torch

    from repro_torch.configs import common, train as train_cfgs
    from repro_torch.train.train_state import init_train_state

    mod = train_cfgs.module_of(arch_id)
    opt = mod._opt()
    arch = common.lm_arch(arch_id, cfg, cfg, opt,
                          fsdp=arch_id not in ("glm4-9b", "granite-3-8b"))
    low = arch.lowering("train_4k", mesh)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (rows, seq + 1)).astype(np.int32)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in (("tokens", toks[:, :-1]), ("labels", toks[:, 1:]))}

    def params_of(out):
        return local_tree(out[0]["params"])

    row = lm_pair(
        mesh, check, low,
        lambda: (init_train_state(draw_decoder(cfg, dev, seed), opt), batch),
        lambda: tuple(on_one_rank(a, mesh, s) for a, s in zip(
            (init_train_state(draw_decoder(cfg, dev, seed), opt), batch),
            low.in_specs)),
        params_of, f"{arch_id} train_4k")
    row.update(rows=rows, seq=seq, layers=cfg.n_layers,
               d_model=cfg.d_model, optimizer=opt.kind)
    return row


def sharded_glm4(dev, seed: int, mesh, check) -> dict:
    """GLM-4 9B at published width in bf16 (18.8 GB of weights): its
    serving cells, ``prefill_32k`` on its first ``LM_TRAIN["layers"]``
    layers (views of the same weights: 40 layers of 32,768 positions in
    float32 attention take 39 s a run), then ``train_4k`` at the
    ``train_more`` phase's cut (``LM_TRAIN``: 8 layers, 8 rows of 4,096
    tokens)."""
    import dataclasses

    import torch

    from repro_torch.configs import glm4_9b

    cfg = glm4_9b._cfg()
    params = draw_decoder(cfg, dev, seed)
    n = LM_TRAIN["layers"]
    runs = lm_serving_runs(
        dev, seed, mesh, check, "glm4-9b", cfg, params,
        dataclasses.replace(cfg, n_layers=n),
        {k: v[:n] if k.startswith("groups/") else v
         for k, v in params.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    runs["train_4k"] = lm_train_run(
        dev, seed, mesh, check, "glm4-9b",
        dataclasses.replace(cfg, n_layers=LM_TRAIN["layers"]),
        LM_TRAIN["rows"], LM_TRAIN["seq"])
    return runs


def sharded_moe_lm(dev, seed: int, mesh, check, arch_id: str,
                   n_layers: int) -> dict:
    """DeepSeek-V3 or Arctic at published width, the serving depth of
    ``MOE_MODELS`` (5 and 2 layers, 52.8 and 54.9 GB of bf16 weights):
    its serving cells (prefill's q chunk ``SHARDED_MOE_Q_CHUNK``), then
    ``train_4k`` at smoke width (``SHARDED_SMOKE_TRAIN``)."""
    import dataclasses

    import torch

    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(arch_id),
                              n_layers=n_layers)
    params = draw_decoder(cfg, dev, seed)
    runs = lm_serving_runs(
        dev, seed, mesh, check, arch_id, cfg, params,
        dataclasses.replace(cfg, q_chunk=SHARDED_MOE_Q_CHUNK), params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    runs["train_4k"] = lm_train_run(
        dev, seed, mesh, check, arch_id,
        configs.get_config(arch_id, smoke=True),
        SHARDED_SMOKE_TRAIN["rows"], SHARDED_SMOKE_TRAIN["seq"])
    return runs


def sharded_bert4rec(dev, seed: int, mesh, check) -> dict:
    """BERT4Rec at published width (2²⁰ items × 64): ``serve_p99`` (512
    rows), ``retrieval_cand``, ``serve_bulk`` (cut to
    ``SHARDED_BERT_BULK`` rows: each row's scores over 2²⁰ items are
    4 MB) and ``train_batch`` (cut to ``BERT_TRAIN_ROWS``, one step)."""
    import numpy as np
    import torch

    from repro_torch.configs import bert4rec, get_arch
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.train.train_state import init_train_state

    cfg = bert4rec._cfg()
    arch = get_arch("bert4rec")
    params = draw_decoder(cfg, dev, seed)
    rng = np.random.default_rng(seed)
    runs = {}
    for shape, n in (("serve_p99", RECSYS_SHAPES["serve_p99"]["batch"]),
                     ("retrieval_cand", 1),
                     ("serve_bulk", SHARDED_BERT_BULK)):
        low = arch.lowering(shape, mesh)
        items = torch.from_numpy(rng.integers(
            0, cfg.vocab - 2, (n, cfg.max_seq)).astype(np.int32)).to(dev)
        arg = items if shape == "retrieval_cand" else {"items": items}
        placed = on_one_rank(params, mesh, low.in_specs[0])
        runs[shape] = lm_pair(
            mesh, check, low, lambda arg=arg: (params, arg),
            lambda arg=arg, low=low, placed=placed: (
                placed, on_one_rank(arg, mesh, low.in_specs[1])),
            lambda out: {"scores": local_tree({"s": out})["s"]},
            f"bert4rec {shape}")
        runs[shape]["rows"] = n
    del params
    gc.collect()
    torch.cuda.empty_cache()
    low = arch.lowering("train_batch", mesh)
    (host,) = bert4rec_train_batches(cfg, 1, BERT_TRAIN_ROWS, seed)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    opt = bert4rec._opt()
    runs["train_batch"] = lm_pair(
        mesh, check, low,
        lambda: (init_train_state(draw_decoder(cfg, dev, seed), opt), batch),
        lambda: tuple(on_one_rank(a, mesh, s) for a, s in zip(
            (init_train_state(draw_decoder(cfg, dev, seed), opt), batch),
            low.in_specs)),
        lambda out: local_tree(out[0]["params"]), "bert4rec train_batch")
    runs["train_batch"]["rows"] = BERT_TRAIN_ROWS
    return runs


def sharded_lm(dev, seed: int, card: str, check,
               path_launches: dict) -> None:
    """Phase 11b3: the LM family's and BERT4Rec's cells through their
    ``Lowering.fn`` on DTensors over a (1, 1) ("data", "model") mesh of
    a new NCCL group of one, each run first on the plain-tensor path
    from the same seed: GLM-4 9B, DeepSeek-V3 and Arctic
    (``sharded_glm4``, ``sharded_moe_lm``) and BERT4Rec
    (``sharded_bert4rec``), one model at a time, each freed before the
    next.  Outputs, caches or parameters byte-equal, the same B1
    launches, every B1 call of the mesh runs held against its plain
    version when it is made; each run's seconds and peak memory.  The
    counters of the mesh runs alone are the path's."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    matmul = tf32_off("sharded_lm")
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": "sharded_lm", "card": card, "matmul": matmul,
           "held_before_gb": torch.cuda.memory_allocated() / 1e9}
    mesh_launches = {k: 0 for k in LAUNCHES}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(d) / "store"), 1), rank=0,
            world_size=1)
        try:
            mesh = make_host_mesh(1, 1)
            assert mesh.device_mesh.device_type == "cuda"
            models = [("glm4-9b", lambda: sharded_glm4(dev, seed, mesh,
                                                       check))]
            models += [(arch, functools.partial(
                sharded_moe_lm, dev, seed, mesh, check, arch, n))
                for arch, n, _ in MOE_MODELS]
            models.append(("bert4rec", lambda: sharded_bert4rec(
                dev, seed, mesh, check)))
            for name, fn in models:
                t0 = time.perf_counter()
                row[name] = fn()
                row[name]["seconds"] = time.perf_counter() - t0
                for run in row[name].values():
                    if isinstance(run, dict):
                        for k, v in run["mesh"]["launches"].items():
                            mesh_launches[k] += v
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    path_launches["sharded_lm"] = mesh_launches
    assert mesh_launches["gather_rows"] > 0, "gather_rows: not on the path"
    row["launches"] = {k: v for k, v in mesh_launches.items() if v}
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)


def analysis(dev, card, check, path_launches: dict) -> None:
    """Phase 11c: the port's CLI gate (``--all --device cuda``) in
    process from a temporary working directory, with B3's calls of the
    self-check held against its plain version."""
    from repro_torch.analysis import __main__ as cli
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.plan import kernel as pk, ref as pref

    t0 = time.perf_counter()
    said = io.StringIO()
    reset_launches()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d, \
            contextlib.chdir(d), contextlib.redirect_stdout(said), \
            recording(pk, "plan_runs_2d") as calls:
        rc = cli.main(["--all", "--device", dev.type])
    path_launches["analysis"] = dict(LAUNCHES)
    assert rc == 0, f"the analysis gate exited {rc}"
    # The box and the triangle plan on B3; span_all on the host.
    assert LAUNCHES["plan_runs_2d"] == len(calls) == 2, LAUNCHES
    for a, kw in calls:
        for g, w in zip(pk.plan_runs_2d(*a, **kw),
                        pref.plan_runs_2d(*a, **kw)):
            check("plan_runs_2d", g, w, "analysis self-check")
    emit({"phase": "analysis", "argv": ["--all", "--device", dev.type],
          "exit": rc, "said": said.getvalue().splitlines(),
          "b3_calls_checked": len(calls),
          "launches": path_launches["analysis"], "card": card,
          "seconds": time.perf_counter() - t0})


def load_example(name: str):
    """The module ``examples/<name>.py``, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_values_equal(cube, flat_np, requests: dict, values: dict) -> int:
    """Each request's values byte-equal to ``flat_np[plan.offsets]`` of
    the host ``Slicer``'s plan; returns the points compared."""
    import numpy as np

    from repro_torch.core import Slicer

    host = Slicer(cube)
    n = 0
    for name, req in requests.items():
        plan, _ = host.extract_plan(req)
        want = flat_np[plan.offsets]
        got = values[name]
        assert got.dtype == want.dtype and np.array_equal(
            got.view(np.uint8), want.view(np.uint8)), \
            f"{name}: values != flat[plan.offsets] of the host plan"
        n += plan.n_points
    return n


def examples(dev, card, check, path_launches: dict) -> None:
    """Phase 11d: every ``examples/torch_*.py``'s ``main(argv)`` on the
    card, its printout kept, its kernels counted and checked."""
    import torch

    from repro_torch.analysis import check_bench_file
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gather import kernel as gk, ref as gref
    from repro_torch.kernels.paged_attn import kernel as pak
    from repro_torch.kernels.paged_attn import ref as paref

    t_phase = time.perf_counter()
    row = {"phase": "examples", "card": card}
    by_example = {}

    @contextlib.contextmanager
    def run(name: str):
        """Counters reset before, read after; stdout kept in the row."""
        said = io.StringIO()
        t0 = time.perf_counter()
        reset_launches()
        with contextlib.redirect_stdout(said):
            yield
        torch.cuda.synchronize()
        by_example[name] = {k: v for k, v in LAUNCHES.items() if v}
        row[name] = {"seconds": time.perf_counter() - t0,
                     "said": said.getvalue().splitlines()[-6:]}

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d, \
            recording(gk, "gather_plan_runs") as b2_calls, \
            recording(gk, "gather_union_slices") as union_calls:
        qs = load_example("torch_quickstart")
        with run("quickstart"):
            out = qs.main(["--device", dev.type])
        wc, flat_np = qs.cube_and_data()
        row["quickstart"].update(points_checked=host_values_equal(
            wc.cube, flat_np, out["requests"], out["values"]),
            rows=out["rows"])
        assert by_example["quickstart"]["gather_plan_runs"] == 5
        assert "gather_rows" not in by_example["quickstart"]

        ew = load_example("torch_extract_weather")
        bench = Path(d) / "BENCH_torch_extraction.json"
        with run("extract_weather"):
            out = ew.main(["--device", dev.type, "--out", str(bench)])
        cubes = ew.cubes_and_data()
        irr = out["irregular"]
        row["extract_weather"].update(
            points_checked=host_values_equal(
                cubes["regular"][0].cube, cubes["regular"][1],
                out["requests"], out["values"])
            + host_values_equal(cubes["irregular"][0].cube,
                                cubes["irregular"][1], irr["requests"],
                                irr["values"]),
            rows=irr["rows"],
            seam_shift_cache_hit=irr["seam_shift_cache_hit"])
        assert irr["seam_shift_cache_hit"]
        assert [str(x) for x in check_bench_file(bench)] == []
        launched = by_example["extract_weather"]
        assert launched["gather_plan_runs"] == 4, launched
        assert launched["gather_union_slices"] == 3, launched
        assert "gather_rows" not in launched
        del cubes, flat_np, wc

        # serve_lm: every B8 call held against its plain version inside
        # the call (the pool changes after every call).
        tally = {"calls": 0, "max_abs_err": 0.0}
        b8 = pak.paged_decode_attention

        def checked_b8(*a, **kw):
            out = b8(*a, **kw)
            want = paref.paged_decode_attention(*a)
            torch.testing.assert_close(out, want, **B8_F32)
            tally["calls"] += 1
            tally["max_abs_err"] = max(tally["max_abs_err"],
                                       max_abs_err(out, want))
            return out

        sl = load_example("torch_serve_lm")
        with swapped(pak, "paged_decode_attention", checked_b8), \
                run("serve_lm"):
            out = sl.main(["--device", dev.type])
        assert out["requests"] == 10 and all(
            len(toks) == 12 for _, toks in out["outputs"]), out
        assert out["utilization"] == 0
        launched = by_example["serve_lm"]
        assert "paged_decode_attention" not in launched
        n_layers = sl.demo_config().n_layers
        assert launched["paged_decode_attention_simt"] == tally["calls"] \
            and tally["calls"] % n_layers == 0, (launched, tally)
        row["serve_lm"].update(new_tokens=out["new_tokens"],
                               utilization=out["utilization"],
                               b8_calls_checked=tally["calls"],
                               b8_max_abs_err=tally["max_abs_err"],
                               b8_tol=B8_F32)

        tl = load_example("torch_train_lm")
        n_unions = len(union_calls)
        with run("train_lm"):
            out = tl.main(["--device", dev.type, "--preset", "100m",
                           "--steps", str(EXAMPLE_STEPS), "--preempt-at",
                           str(EXAMPLE_PREEMPT), "--ckpt-dir",
                           str(Path(d) / "lm")])
        # steps 0 to the preemption, then again from the checkpoint
        # after step 49 (the batch of each is one union read)
        replayed = EXAMPLE_STEPS - 50
        assert out["restarts"] == 1, out["restarts"]
        assert len(out["losses"]) == EXAMPLE_PREEMPT + replayed
        assert out["final_loss"] < out["first_loss"], out
        assert by_example["train_lm"]["gather_union_slices"] \
            == len(union_calls) - n_unions == EXAMPLE_PREEMPT + replayed
        row["train_lm"].update({k: out[k] for k in (
            "n_params", "first_loss", "final_loss", "restarts", "steps")})

        trs = load_example("torch_train_recsys")
        with recording(gk, "gather_rows_bag") as b6_calls, \
                run("train_recsys"):
            out = trs.main(["--device", dev.type, "--steps",
                            str(EXAMPLE_STEPS), "--ckpt-dir",
                            str(Path(d) / "dlrm")])
        assert out["restarts"] == 0
        assert out["final_loss"] < out["first_loss"], out
        # D = 16 float32, 64-byte rows: B6's tiled kernel, once a step
        assert by_example["train_recsys"]["gather_rows_bag_tiled"] \
            == len(b6_calls) == EXAMPLE_STEPS, by_example["train_recsys"]
        row["train_recsys"].update({k: out[k] for k in (
            "first_loss", "final_loss", "restarts", "steps")})

    # The calls against their plain versions: B2's and the union reads'
    # inputs do not change; B6's table moved with every step, so its last
    # calls are checked on their inputs as they are now.
    for a, kw in b2_calls:
        check("gather_plan_runs", gk.gather_plan_runs(*a, **kw),
              gref.gather_plan_runs(*a, **kw), "examples")
    for a, kw in union_calls:
        check("gather_union_slices", gk.gather_union_slices(*a, **kw),
              gref.gather_union_slices(*a, **kw), "examples")
    with torch.no_grad():
        for a, kw in b6_calls[-3:]:
            check("gather_rows_bag", gk.gather_rows_bag(*a, **kw),
                  gref.gather_rows_bag(*a, **kw), "train_recsys example")
    path_launches["examples"] = {
        k: sum(e.get(k, 0) for e in by_example.values()) for k in LAUNCHES}
    row.update({"checked": {"gather_plan_runs": len(b2_calls),
                            "gather_union_slices": len(union_calls),
                            "gather_rows_bag": min(3, len(b6_calls))},
                "launches_by_example": by_example,
                "launches": path_launches["examples"],
                "seconds": time.perf_counter() - t_phase})
    emit(row)


def weather_setup():
    """The extraction phases' cube and requests: the F320-like irregular
    weather cube (2 dates of 4 times, 37 levels, 640 latitude rows),
    every country, a box across the seam, and Germany over all datetimes
    and levels (3552 B3 jobs).  Returns (the cube's generator, the
    requests by name)."""
    from repro_torch.core import Request, Span
    from repro_torch.dataplane.weather import COUNTRIES, IrregularWeatherCube

    iwc = IrregularWeatherCube(n_dates=2, times_per_day=4, n_levels=37,
                               n_lat=640, n_lon=1280)
    requests = {c: iwc.country_request(c) for c in COUNTRIES}
    requests["seam_box"] = iwc.seam_box_request(35.0, 62.0, -20.0, 20.0)
    requests["germany_all_levels"] = Request([
        Span("datetime", 0.0, float(iwc.datetime_values[-1])),
        Span("level", 0.0, float(iwc.n_levels - 1)),
        iwc.country_request("germany").shapes[2]])
    return iwc, requests


def serve_windows(iwc, requests, seed: int) -> list:
    """Phase 3's 4 windows of 16 requests, Zipf-drawn (s = 1.1) from
    ``seed`` over ``weather_setup``'s requests and each country drifted
    to the next datetime and to the next level."""
    import numpy as np

    from repro_torch.dataplane.weather import COUNTRIES

    population = list(requests.values())
    for name in COUNTRIES:
        population.append(iwc.country_request(name, datetime=21600.0))
        population.append(iwc.country_request(name, level=1.0))
    draws = zipf_draw(np.random.default_rng(seed), len(population), 64)
    return [[population[i] for i in draws[16 * b:16 * (b + 1)]]
            for b in range(4)]


def bfs_layer(iwc, requests) -> tuple:
    """Phase 5's BFS layer: every (triangle, latitude row) pair of the
    countries' and the seam box's (lat, lon) polygons, the rows those the
    host Slicer would visit (``OrderedAxis.indices_in_range``, lookup
    tolerance 1e-9).  Returns (the (polytope, row) pairs, the polygons,
    the rows as float32 planes)."""
    import numpy as np

    from repro_torch.dataplane.weather import COUNTRIES

    lat_sorted = np.sort(iwc.latitudes)
    eps = 1e-9 * max(abs(lat_sorted[0]), abs(lat_sorted[-1]), 1.0)
    polygons = [p for name in (*COUNTRIES, "seam_box")
                for p in requests[name].polytopes()
                if p.axes == ("lat", "lon")]
    layer = []
    for poly in polygons:
        lo, hi = poly.extents("lat")
        i0 = np.searchsorted(lat_sorted, lo - eps, side="left")
        i1 = np.searchsorted(lat_sorted, hi + eps, side="right")
        layer += [(poly, lat) for lat in lat_sorted[i0:i1]]
    return layer, polygons, np.asarray([lat for _, lat in layer],
                                       np.float32)


def batched_crops(iwc, requests, flat_np, seed: int, n_crops: int = 256
                  ) -> dict:
    """Phase 6's inputs: ``n_crops`` country triangles at shifts drawn
    from ``seed + 6`` on one F320 field (datetime 0, level 0, rows in
    ascending latitude, float32), with the rows and columns the widest
    crop spans (so the lattice never truncates).  The axes stay numpy
    arrays, as a caller hands them; ``field`` is numpy too."""
    import numpy as np

    from repro_torch.core.geometry import Polytope
    from repro_torch.dataplane.weather import COUNTRIES

    lat_sorted = np.sort(iwc.latitudes)
    n0, n1 = len(lat_sorted), len(iwc.lon_values)
    axis0 = lat_sorted.astype(np.float32)
    axis1 = iwc.lon_values.astype(np.float32)
    order = np.argsort(iwc.latitudes)
    field = np.ascontiguousarray(
        flat_np[:n0 * n1].reshape(n0, n1)[order].astype(np.float32)
    ).reshape(-1)
    tris = [p.points for name in COUNTRIES
            for p in requests[name].polytopes() if p.axes == ("lat", "lon")]
    rng = np.random.default_rng(seed + 6)
    pick = rng.integers(0, len(tris), n_crops)
    shift = np.stack([rng.uniform(-30.0, 15.0, n_crops),
                      rng.uniform(10.0, 300.0, n_crops)], axis=1)
    crops = [Polytope(("lat", "lon"), tris[i] + shift[j])
             for j, i in enumerate(pick)]
    ext = np.array([[*c.extents("lat"), *c.extents("lon")] for c in crops])
    max_rows = 1 + int(max(
        np.searchsorted(axis0, e[1] + 1e-6, side="right")
        - np.searchsorted(axis0, e[0] - 1e-6) for e in ext))
    max_cols = 1 + int(max(
        np.searchsorted(axis1, e[3] + 1e-6, side="right")
        - np.searchsorted(axis1, e[2] - 1e-6) for e in ext))
    return {"crops": crops, "axis0": axis0, "axis1": axis1, "n0": n0,
            "n1": n1, "field": field, "max_rows": max_rows,
            "max_cols": max_cols}


def b4_cuts(verts, valid, axis0, max_rows: int) -> tuple:
    """B4's inputs on a batch of crops, built directly as the batched
    planner cuts them: each crop's x and y, its mask, its ``max_rows``
    rows from the first at or above its lowest valid x - 1e-6 (clamped to
    the last), and its tolerance 1e-6 · max(1, |x|max), float32."""
    import torch

    from repro_torch.kernels.slice import ref as sref

    x = verts[:, :, 0].contiguous()
    lo0 = torch.where(valid, x, torch.inf).amin(1)
    start = torch.searchsorted(axis0, lo0 - 1e-6)
    rows = start[:, None] + torch.arange(max_rows, device=x.device)
    planes = axis0[rows.clamp(max=axis0.numel() - 1)].contiguous()
    tol = sref.PLANE_TOL * torch.clamp(x.abs().amax(1), min=1.0)
    return x, verts[:, :, 1].contiguous(), valid, planes, tol


def recording_planner(cube, **kw):
    """A ``DevicePlanner`` that records the pipeline inputs of every
    plan() call in ``.calls``, so the kernel checks and timings see the
    tensors the main path hands the planning kernel."""
    from repro_torch.core import DevicePlanner

    class RecordingPlanner(DevicePlanner):
        def __init__(self, *a, **kw_):
            super().__init__(*a, **kw_)
            self.calls = []

        def _invoke(self, verts, valid, bases, scalars, g, max_rows):
            self.calls.append((verts, valid, bases, scalars, g, max_rows))
            return super()._invoke(verts, valid, bases, scalars, g,
                                   max_rows)

    return RecordingPlanner(cube, **kw)


def b3_timing(timer, planner, call) -> dict:
    """B3 at one recorded plan() call of ``planner``: its jobs and rows,
    the call's time by ``timer`` and the device time of each kernel and
    memset it runs."""
    from repro_torch.kernels.plan import kernel as pk

    verts, valid, bases, scalars, g, max_rows = call
    tens = planner.pipeline_inputs(verts, valid, bases, scalars, g)
    kw = dict(n0=g["n0"], n1=g["n1"], max_rows=max_rows, cyclic=g["cyclic"])
    return {"J": int(verts.shape[0]), "max_rows": int(max_rows),
            "ms": timer(lambda: pk.plan_runs_2d(*tens, **kw)),
            **kernel_breakdown(lambda: pk.plan_runs_2d(*tens, **kw))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch.analysis.plan_check import verify_plan
    from repro_torch.carry import payload_to_tensor
    from repro_torch.core import PolytopeExtractor, Slicer
    from repro_torch.dataplane.weather import COUNTRIES
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.gather import kernel as gk, ops as gops
    from repro_torch.kernels.gather import ref as gref
    from repro_torch.kernels.plan import kernel as pk, ops as pops
    from repro_torch.kernels.plan import ref as pref
    from repro_torch.kernels.slice import kernel as sk, ops as sops
    from repro_torch.kernels.slice import ref as sref
    from repro_torch.serve import ExtractionService

    dev = torch.device("cuda")
    card = card_line()

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library("gather")
    build_s = time.perf_counter() - t0
    with ThreadPoolExecutor(len(PTXAS_SOURCES)) as pool:
        ptxas = dict(zip(PTXAS_SOURCES, pool.map(ptxas_usage,
                                                 PTXAS_SOURCES)))
    # B1's instantiations (a pack width and rows a group each) must not
    # spill.
    b1_ptxas = {k: v for k, v in ptxas["gather"].items()
                if k.startswith("gather_rows_kernel")}
    assert len(b1_ptxas) == 20, sorted(b1_ptxas)
    spilled = [k for k, v in b1_ptxas.items()
               if v.get("spill_stores") or v.get("spill_loads")]
    assert not spilled, f"B1 spills: {spilled}"
    emit({"phase": "build", "seconds": build_s,
          "nvcc_seconds": _build.last_build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "b8_tensor_core_ptxas": ptxas["paged_attn_tc"],
          "b1_ptxas": b1_ptxas, "b3_ptxas": ptxas["plan_runs_2d"],
          "b6_ptxas": {k: v for k, v in ptxas["gather"].items()
                       if k.startswith("gather_rows_bag")},
          "batched_plan_ptxas": ptxas["batched_plan"],
          "b5_ptxas": ptxas["slice_batch"]})

    # The dry run's trace, on the host beside the phases below (11b).
    dryrun_started = start_dryrun()

    # -- the cube, the payload and the requests -------------------------
    iwc, requests = weather_setup()
    cube = iwc.cube
    t0 = time.perf_counter()
    flat_np = iwc.field_data(seed=args.seed)
    flat = payload_to_tensor(flat_np, dev)
    torch.cuda.synchronize()
    emit({"phase": "payload", "elements": cube.n_elements,
          "bytes": int(flat.numel() * flat.element_size()),
          "seconds": time.perf_counter() - t0})

    # -- 2. the main path: device planning + burst gather ---------------
    reset_launches()
    pe = PolytopeExtractor(cube, device_planner=True, burst_gather=True)
    host = Slicer(cube)
    rows = []
    # What each request's burst read hands B2: its runs on the card.
    burst_inputs, plans = {}, {}
    for name, req in requests.items():
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        with recording(gk, "gather_plan_runs") as b2_calls:
            res = pe.extract(req, flat)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        assert LAUNCHES["plan_runs_2d"] == before["plan_runs_2d"] + 1, \
            f"{name}: the device planner fell back to the host"
        assert LAUNCHES["gather_plan_runs"] == \
            before["gather_plan_runs"] + 1 and len(b2_calls) == 1, \
            f"{name}: the read was not one gather_plan_runs launch"
        assert LAUNCHES["gather_rows"] == before["gather_rows"], \
            f"{name}: the read launched gather_rows"
        t0 = time.perf_counter()
        hplan, hstats = host.extract_plan(req)
        host_s = time.perf_counter() - t0
        plan, stats = res.plan, res.stats
        assert np.array_equal(plan.offsets, hplan.offsets), name
        assert np.array_equal(plan.run_starts, hplan.run_starts), name
        assert np.array_equal(plan.run_lengths, hplan.run_lengths), name
        assert stats.n_slices_by_dim == hstats.n_slices_by_dim, name
        verify_plan(plan, datacube=cube, stats=stats)
        want = torch.from_numpy(flat_np[hplan.offsets])
        assert res.values.is_cuda and bytes_equal(res.values.cpu(), want), \
            f"{name}: values != flat[plan.offsets]"
        burst_inputs[name] = b2_calls[0][0]
        plans[name] = plan
        rows.append({"request": name, "points": int(plan.n_points),
                     "runs": int(len(plan.run_starts)),
                     "extract_s": dev_s, "host_plan_s": host_s})
    emit({"phase": "extract", "requests": rows})

    # -- 3. serving: Zipf-drawn batches over the card-resident payload --
    svc = ExtractionService(cube)
    host_plans = {}
    # What each window's read hands gather_union_slices (the union's
    # offsets and every distinct plan's positions in it, on the card),
    # and the windows with a non-empty plan.
    window_offsets, nonempty_windows = [], 0
    with recording(gk, "gather_union_slices") as union_reads:
        for batch in serve_windows(iwc, requests, args.seed):
            results = svc.submit_batch(batch, flat)
            torch.cuda.synchronize()
            plans3 = {r.key: r.plan for r in results if r.plan.n_points}
            if plans3:
                nonempty_windows += 1
                window_offsets.append(np.concatenate(
                    [p.offsets for p in plans3.values()]))
            for res in results:
                if res.key not in host_plans:
                    host_plans[res.key] = host.extract_plan(res.request)[0]
                hplan = host_plans[res.key]
                assert np.array_equal(res.plan.offsets, hplan.offsets)
                want = torch.from_numpy(flat_np[hplan.offsets])
                assert res.values.is_cuda and bytes_equal(res.values.cpu(),
                                                          want)
    st = svc.stats
    emit({"phase": "serve", "requests": 64, "batches": 4, "hits": st.hits,
          "misses": st.misses, "delta_hits": st.delta_hits,
          "batch_dedup": st.batch_dedup,
          "bytes_requested": st.bytes_requested,
          "bytes_read": st.bytes_read})
    # Launch counts of each path, read just after it ran.
    path_launches = {"extract_serve": dict(LAUNCHES)}
    assert LAUNCHES["gather_plan_runs"] == len(requests), LAUNCHES
    assert LAUNCHES["gather_union_slices"] == nonempty_windows \
        == len(union_reads) > 0, (LAUNCHES, nonempty_windows)
    assert LAUNCHES["plan_runs_2d"] > 0, "the planning kernel never ran"
    assert LAUNCHES["gather_rows"] == 0, "the main path launched gather_rows"

    # A plain extract (burst_gather=False) of Germany over all levels: its
    # read is one B1 launch over the plan's 174,640 offsets.
    reset_launches()
    pe_plain = PolytopeExtractor(cube, device_planner=True)
    with recording(gk, "gather_rows") as b1_calls:
        res = pe_plain.extract(requests["germany_all_levels"], flat)
        torch.cuda.synchronize()
    path_launches["plain_extract"] = dict(LAUNCHES)
    assert LAUNCHES["gather_rows"] == 1 == len(b1_calls), LAUNCHES
    assert LAUNCHES["gather_plan_runs"] == 0, LAUNCHES
    assert bytes_equal(res.values.cpu(), torch.from_numpy(
        flat_np[plans["germany_all_levels"].offsets])), \
        "plain extract values"

    # -- 4. kernels against their plain versions, on main-path inputs ---
    errs = {"gather_plan_runs": 0.0, "gather_union_slices": 0.0,
            "plan_runs_2d": 0.0}
    n_checked = {k: 0 for k in errs}

    def check(kname, got, want, what):
        assert bytes_equal(got, want), f"{kname} != plain version ({what})"
        errs[kname] = max(errs.get(kname, 0.0), max_abs_err(got, want))
        n_checked[kname] = n_checked.get(kname, 0) + 1

    for name, b2_args in burst_inputs.items():
        check("gather_plan_runs", gk.gather_plan_runs(*b2_args),
              gref.gather_plan_runs(*b2_args), name)
    # Runs ending at the payload's last element, of length 1, longer than
    # 128, at odd offsets (float64: source and output not congruent mod
    # 16), on the payload and on its view one element in.
    n = flat.numel()
    edge_starts = np.array([n - 1, 5, n - 300, 1001, 70_001, 3, n - 2])
    edge_lengths = np.array([1, 1, 300, 517, 4099, 0, 1])
    for shift in (0, 1):
        view = flat[shift:]
        edge = gops.plan_run_inputs(view, edge_starts - shift, edge_lengths)
        got = gk.gather_plan_runs(view, *edge)
        check("gather_plan_runs", got, gref.gather_plan_runs(view, *edge),
              f"edge runs, shift {shift}")
        want = torch.from_numpy(np.concatenate(
            [flat_np[s0:s0 + ln] for s0, ln in zip(edge_starts,
                                                   edge_lengths)]))
        assert bytes_equal(got.cpu(), want), "edge runs != the payload's"
    for b, (a, kw) in enumerate(union_reads):
        check("gather_union_slices", gk.gather_union_slices(*a, **kw),
              gref.gather_union_slices(*a, **kw), f"window {b}")
    for a, kw in b1_calls:
        check("gather_rows", gk.gather_rows(*a, **kw),
              gref.gather_rows(*a, **kw), "plain extract")

    recs = {}
    for dtype in (np.float64, np.float32):
        rec = recs[dtype] = recording_planner(cube, dtype=dtype)
        for name in ("germany", "uk", "seam_box", "germany_all_levels"):
            assert rec.plan(requests[name]) is not None, name
        for verts, valid, bases, scalars, g, max_rows in rec.calls:
            tens = rec.pipeline_inputs(verts, valid, bases, scalars, g)
            kw = dict(n0=g["n0"], n1=g["n1"], max_rows=max_rows,
                      cyclic=g["cyclic"])
            got = pk.plan_runs_2d(*tens, **kw)
            want = pref.plan_runs_2d(*tens, **kw)
            for a, b in zip(got, want):
                check("plan_runs_2d", a, b, np.dtype(dtype).name)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "byte_equal": True, "checked": n_checked,
          "max_abs_err": errs})

    # -- 5. bfs_layer: one BFS layer of Algorithm 1 as a batch (B5) -----
    from repro_torch.core.geometry import slice_vertices
    from repro_torch.core.hull import convex_hull_prune

    layer, polygons, planes_np = bfs_layer(iwc, requests)
    reset_launches()
    t0 = time.perf_counter()
    verts5, valid5 = sops.pack_polytopes([p for p, _ in layer], device=dev)
    planes5 = torch.from_numpy(planes_np).to(dev)
    out5, mask5 = sops.slice_batch(verts5, valid5, planes5, k=0)
    subs = sops.unpack_sliced(out5, mask5, ("lat", "lon"), k=0)
    layer_s = time.perf_counter() - t0
    path_launches["bfs_layer"] = dict(LAUNCHES)
    assert LAUNCHES["slice_batch"] > 0, "slice_batch was never launched"

    got = sk.slice_batch(verts5, valid5, planes5, 0)
    want = sref.slice_batch(verts5, valid5, planes5, 0)
    check("slice_batch", got[0], want[0], "bfs layer candidates")
    check("slice_batch", got[1], want[1], "bfs layer mask")
    check("slice_batch", out5, want[0], "bfs layer, path output")
    check("slice_batch", mask5, want[1], "bfs layer, path mask")
    hits = 0
    for (poly, _), sub, c in zip(layer, subs, planes_np):
        host = slice_vertices(poly.points, 0, float(c), tol=1e-6)
        if host is None:
            assert sub is None, f"plane {c} misses on the host only"
            continue
        hits += 1
        assert sub is not None, f"plane {c} misses on the card only"
        a = sorted(map(tuple, np.round(convex_hull_prune(host), 3)))
        b = sorted(map(tuple, np.round(sub.points, 3)))
        assert len(a) == len(b) and np.allclose(a, b, atol=2e-3), \
            f"plane {c}: {a} != {b}"
    emit({"phase": "bfs_layer", "P": int(verts5.shape[0]),
          "V": int(verts5.shape[1]), "D": int(verts5.shape[2]),
          "polygons": len(polygons), "pairs_hit": hits,
          "seconds": layer_s, "launches": path_launches["bfs_layer"]})

    # -- 6. batched: 256 crops per call on one F320 field ---------------
    # batched_plan_2d and batched_extract_2d are one launch each of the
    # batched crop planner (B4's cut inside it); the runs are B3.
    from repro_torch.core import batched

    bc = batched_crops(iwc, requests, flat_np, args.seed)
    n_crops, axis0, axis1 = len(bc["crops"]), bc["axis0"], bc["axis1"]
    n0, n1, max_rows, max_cols = bc["n0"], bc["n1"], bc["max_rows"], \
        bc["max_cols"]
    field_np = bc["field"]
    field = torch.from_numpy(field_np).to(dev)
    verts6, valid6 = sops.pack_polytopes(bc["crops"], device=dev)
    reset_launches()
    entry_launches = {}

    def entry(name, fn):
        before = dict(LAUNCHES)
        out = fn()
        entry_launches[name] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                                if LAUNCHES[k] != before[k]}
        return out

    with recording(sk, "batched_plan_2d") as fused_calls, \
            recording(pops, "plan_runs_2d") as b3_calls:
        t0 = time.perf_counter()
        lattice6 = entry("batched_plan_2d", lambda: batched.batched_plan_2d(
            verts6, valid6, axis0, axis1, n0, n1, max_rows, max_cols,
            device=dev))
        runs6 = entry("batched_plan_runs_2d",
                      lambda: batched.batched_plan_runs_2d(
                          verts6, valid6, axis0, axis1, max_rows,
                          device=dev))
        ext6 = entry("batched_extract_2d", lambda: batched.batched_extract_2d(
            field, verts6, valid6, axis0, axis1, max_rows, max_cols,
            device=dev))
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
    path_launches["batched"] = dict(LAUNCHES)
    for name in ("batched_plan_2d", "batched_extract_2d"):
        assert entry_launches[name] == {"batched_plan_2d": 1}, \
            f"{name}: not one launch of the batched planner " \
            f"({entry_launches[name]})"
    assert entry_launches["batched_plan_runs_2d"] == {"plan_runs_2d": 1}, \
        entry_launches

    # The plain versions: the same calls on CPU tensors.
    cpu_args = (verts6.cpu(), valid6.cpu(), axis0, axis1)
    plain = {
        "lattice": batched.batched_plan_2d(*cpu_args, n0, n1, max_rows,
                                           max_cols, device="cpu"),
        "runs": batched.batched_plan_runs_2d(*cpu_args, max_rows,
                                             device="cpu"),
        "extract": batched.batched_extract_2d(field.cpu(), *cpu_args,
                                              max_rows, max_cols,
                                              device="cpu"),
    }
    for what, ours in (("lattice", lattice6), ("runs", runs6),
                       ("extract", ext6)):
        for a, b in zip(ours, plain[what]):
            assert bytes_equal(a.cpu(), b), f"batched {what} != plain"
    vals6, offsets6, npts6 = (t.cpu() for t in ext6)
    flat_off = offsets6.reshape(n_crops, -1).long()
    want_vals = np.where(flat_off >= 0,
                         field_np[flat_off.clamp(min=0).numpy()], 0)
    assert np.array_equal(vals6.numpy(), want_vals.astype(np.float32)), \
        "batched values != field[offsets]"
    starts, lengths, meta = (t.cpu().numpy() for t in runs6)
    assert int(meta[2]) == int(npts6.sum()), "runs and lattice disagree"
    run_offsets = np.concatenate([
        np.arange(s0, s0 + ln) for s0, ln in
        zip(starts[:meta[0]], lengths[:meta[0]])])
    lattice_offsets = flat_off[flat_off >= 0].numpy()
    assert np.array_equal(np.sort(run_offsets), np.sort(lattice_offsets))
    # Each launch of the path against the plain version on the card.
    assert len(fused_calls) == 2, len(fused_calls)
    for (a, kw), what in zip(fused_calls, ("lattice", "extract")):
        got, want = sk.batched_plan_2d(*a, **kw), sref.batched_plan_2d(*a,
                                                                      **kw)
        for g, w in zip(got, want):
            if w is not None:
                check("batched_plan_2d", g, w, f"batched {what}")
    # B4 on its own, on the path's cuts built directly: its core runs
    # inside the batched planner's launch (and B3's).
    axis0_dev = torch.from_numpy(axis0).to(dev)
    b4_args = b4_cuts(verts6, valid6, axis0_dev, max_rows)
    for g, w in zip(sk.slice_minor_extents(*b4_args),
                    sref.slice_minor_extents_rows(*b4_args)):
        check("slice_minor_extents", g, w, "batched rows, built directly")
    for a, kw in b3_calls:
        for g, w in zip(pk.plan_runs_2d(*a, **kw), pref.plan_runs_2d(*a,
                                                                    **kw)):
            check("plan_runs_2d", g, w, "batched float32")
    emit({"phase": "batched", "P": n_crops, "V": int(verts6.shape[1]),
          "max_rows": max_rows, "max_cols": max_cols, "n0": n0, "n1": n1,
          "n_points": int(npts6.sum()), "n_runs": int(meta[0]),
          "seconds": batched_s, "launches": path_launches["batched"],
          "entry_launches": entry_launches})

    # -- 7. sharded_serve: the launcher at O1280 -------------------------
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import sharded

    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        bench_out = Path(tmp) / "BENCH_torch_serve.json"
        serve_argv = ["--mode", "extract", "--grid-n", "1280",
                      "--threads", "8", "--shards", "4",
                      "--requests", str(SERVE_REQUESTS),
                      "--window-ms", "2.0", "--bench-out", str(bench_out)]
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said), \
                recording(sharded, "shared_union_gather") as windows, \
                recording(gk, "gather_union_slices") as slice_calls:
            run = launcher.run_extract(launcher.parse_args(serve_argv))
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        bench = json.loads(bench_out.read_text())
    path_launches["sharded_serve"] = dict(LAUNCHES)
    assert run.payload.is_cuda and len(run.served) == SERVE_REQUESTS
    # One launch per window that read anything (a window's batch_plans is
    # the third argument of its shared_union_gather call), none of B1.
    sharded_windows = sum(any(p.n_points for p in a[2].values())
                          for a, _ in windows)
    assert LAUNCHES["gather_union_slices"] == sharded_windows \
        == len(slice_calls) > 0, (LAUNCHES, sharded_windows)
    assert LAUNCHES["gather_rows"] == 0, "the launcher launched gather_rows"
    # Each window's read against its plain version.
    for a, kw in slice_calls:
        check("gather_union_slices", gk.gather_union_slices(*a, **kw),
              gref.gather_union_slices(*a, **kw), "sharded window")
    slice_calls.clear()
    # The values against the payload on the host, and against a fresh
    # single-threaded extractor.
    payload_np = run.payload.cpu().numpy()
    fresh = PolytopeExtractor(run.weather.cube)
    reference = {}
    for rank, res in run.served:
        if rank not in reference:
            reference[rank] = fresh.extract(run.population[rank],
                                            run.payload).values
        assert res.values.is_cuda and bytes_equal(res.values,
                                                   reference[rank]), \
            f"served values of request {rank} != a fresh extractor's"
        assert bytes_equal(res.values.cpu(), torch.from_numpy(
            payload_np[res.plan.offsets])), \
            f"served values of request {rank} != payload[plan.offsets]"
    del payload_np
    st = run.service.stats
    emit({"phase": "sharded_serve", "argv": serve_argv,
          "elements": run.weather.cube.n_elements,
          "payload_bytes": int(run.payload.numel()
                               * run.payload.element_size()),
          "distinct_requests": len(reference), "seconds": serve_s,
          "windows": len(windows), "windows_read": sharded_windows,
          "gather_union_slices_checked": n_checked["gather_union_slices"],
          **{k: bench["rows"][0][k] for k in (
              "requests", "req_per_s", "p50_ms", "p99_ms", "hit_rate",
              "coalescing_factor")},
          "hits": st.hits, "misses": st.misses, "delta_hits": st.delta_hits,
          "batch_dedup": st.batch_dedup, "card": card,
          "launches": path_launches["sharded_serve"],
          "launcher_said": said.getvalue().splitlines()})
    del run, fresh, reference

    # -- 8. recsys_serve: DLRM-RM2 and DeepFM at full width (B6) --------
    b6_timing = recsys_serve(dev, args.seed, card, check, path_launches)

    # -- 8b. recsys_retrieval: two-tower and BERT4Rec at full width (B1)
    b1_variants = recsys_retrieval(dev, args.seed, card, check,
                                   path_launches)

    # -- 8c. recsys_train: DLRM-RM2, DeepFM and two-tower trained (B6, B1)
    b6_train, b1_train = recsys_train(dev, args.seed, card, check,
                                      path_launches)
    b6_timing["variants"] += b6_train
    b1_variants += b1_train

    # -- 8d. train_more: NequIP, BERT4Rec and GLM-4 trained (B7, the
    # union read), and the launcher for the LM, GNN and BERT4Rec families
    b7_train, union_train = train_more(dev, args.seed, card, check,
                                       path_launches)

    # -- 9. gnn: NequIP at full width on three graph shapes (B7) --------
    b7_timing = gnn(dev, args.seed, card, check, path_launches)
    b7_timing["variants"] += b7_train

    # -- 10. lm_serve: GLM-4 9B at full width behind the engine (B8) ---
    b8_timing_entry = lm_serve(dev, args.seed, card, path_launches)

    # -- 11. lm_moe: DeepSeek-V3 and Arctic at full width, cut depth -----
    b8_timing_entry["variants"] += lm_moe(dev, args.seed, card,
                                          path_launches)

    # -- 11b. distributed: torch.distributed on a group of one, C14 ------
    c14_variant = distributed(dev, args.seed, card, path_launches,
                              dryrun_started)

    # -- 11b2. sharded_models: DLRM-RM2, two-tower and NequIP through
    # their cells' Lowering.fn on DTensors (B6, B1, B7 on the mesh) ------
    sharded_models(dev, args.seed, card, check, path_launches)

    # -- 11b3. sharded_lm: GLM-4, DeepSeek-V3, Arctic and BERT4Rec through
    # their cells' Lowering.fn on DTensors (B1 on the mesh) ---------------
    sharded_lm(dev, args.seed, card, check, path_launches)

    # -- 11c. analysis: the port's CLI gate, B3 planning its self-check -
    analysis(dev, card, check, path_launches)

    # -- 11d. examples: the five examples on the card -------------------
    examples(dev, card, check, path_launches)

    # -- 12. timing at the shapes each path gave its kernels ------------
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in LAUNCHES}
    for name, n in launches.items():
        # B4 on its own is on no path: its core runs inside the batched
        # planner's launch and B3's.
        assert n > 0 or name == "slice_minor_extents", \
            f"{name} was launched on no path"
    timer = Timer(dev)
    entries = []

    # B1: the plain extract's read of Germany over all levels (D = 1,
    # float64), with two-tower's candidate and p99 item lookups (D = 256,
    # float32; timed in phase 8b) under "variants"; its launches by path.
    table1, idx1 = b1_calls[0][0]
    entries.append({
        "name": "gather_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/gather.cu",
        "replaces": "src/repro/kernels/gather/kernel.py:71",
        "launches": launches["gather_rows"],
        "launches_by_path": {k: p["gather_rows"]
                             for k, p in path_launches.items()
                             if p["gather_rows"]},
        "max_abs_err": errs["gather_rows"],
        **b1_timing(timer, table1, idx1, "plain extract, Germany, all "
                                         "levels"),
        "variants": b1_variants + b1_sweep(dev, args.seed)})

    # B2: the all-levels request's runs: each point read and written once
    # plus each run's start, length and output offset.
    b2_args = burst_inputs["germany_all_levels"]
    n_runs, n_points = b2_args[1].numel(), b2_args[4]
    b2_bytes = n_points * 2 * flat.element_size() + n_runs * 16
    offsets2 = torch.from_numpy(plans["germany_all_levels"].offsets).to(dev)
    entries.append({
        "name": "gather_plan_runs", "route": "cuda",
        "source": "src/repro_torch/csrc/gather.cu",
        "replaces": "src/repro/kernels/gather/kernel.py:181",
        "launches": launches["gather_plan_runs"],
        "max_abs_err": errs["gather_plan_runs"],
        "ms": timer(lambda: gk.gather_plan_runs(*b2_args)),
        "plain_ms": timer(lambda: gref.gather_plan_runs(*b2_args)),
        "bound_ms": b2_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": timer(lambda: torch.index_select(flat, 0, offsets2)),
        "shape": {"N": n_points, "R": n_runs}, "variants": [c14_variant]})

    # The union read and its slices: phase 3's last window, each union
    # offset and position read once with its element, each output
    # written once.
    u_args = union_reads[-1][0]
    n_union, n_pos = u_args[1].numel(), u_args[2].numel()
    w = flat.element_size()
    u_bytes = n_union * (4 + w) + n_pos * (4 + w)
    offsets3 = torch.from_numpy(window_offsets[-1]).to(dev)
    entries.append({
        "name": "gather_union_slices", "route": "cuda",
        "source": "src/repro_torch/csrc/gather.cu",
        "replaces": "src/repro/kernels/gather/kernel.py:71",
        "launches": launches["gather_union_slices"],
        "max_abs_err": errs["gather_union_slices"],
        "ms": timer(lambda: gk.gather_union_slices(*u_args)),
        "plain_ms": timer(lambda: gref.gather_union_slices(*u_args)),
        "bound_ms": u_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": timer(lambda: torch.index_select(flat, 0, offsets3)),
        "shape": {"U": n_union, "P": n_pos}, "variants": union_train})

    # B3: the all-levels request's jobs, float64; the device time of each
    # kernel and memset of a call there and at Germany's call (the first
    # recorded), and Germany's time.
    rec = recs[np.float64]
    b3_breakdown = {
        "germany_all_levels": b3_timing(timer, rec, rec.calls[-1]),
        "germany": b3_timing(timer, rec, rec.calls[0])}
    verts, valid, bases, scalars, g, max_rows = rec.calls[-1]
    tens = rec.pipeline_inputs(verts, valid, bases, scalars, g)
    kw = dict(n0=g["n0"], n1=g["n1"], max_rows=max_rows, cyclic=g["cyclic"])
    n_slots = verts.shape[0] * max_rows * 2
    b3_bytes = sum(t.numel() * t.element_size() for t in tens) \
        + 2 * n_slots * 4 + 3 * 4
    b3_flops = plan_flops(verts, valid, g["sv0"], g["eps0"], scalars[2],
                          g["n1"])
    t_bytes = b3_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = b3_flops / FP64_FLOPS * 1e3
    entries.append({
        "name": "plan_runs_2d", "route": "cuda",
        "source": "src/repro_torch/csrc/plan_runs_2d.cu",
        "replaces": "src/repro/kernels/plan/kernel.py:86",
        "launches": launches["plan_runs_2d"],
        "max_abs_err": errs["plan_runs_2d"],
        "ms": timer(lambda: pk.plan_runs_2d(*tens, **kw)),
        "plain_ms": timer(lambda: pref.plan_runs_2d(*tens, **kw)),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": None, "breakdown": b3_breakdown,
        "shape": {"J": int(verts.shape[0]), "V": int(verts.shape[1]),
                  "max_rows": int(max_rows), "n0": g["n0"], "n1": g["n1"],
                  "flops": b3_flops, "bytes": b3_bytes}})

    # The batched crop planner: phase 6's extract (the plan and the
    # read in one launch), with its lattice-only call as a variant.
    (fused_plan, _), (fused_extract, _) = fused_calls
    fb = batched_plan_cost(*fused_extract)
    t_bytes = fb["bytes"] / HBM_BYTES_PER_S * 1e3
    t_flops = fb["flops"] / FP32_FLOPS * 1e3
    plan_only = batched_plan_cost(*fused_plan)
    entries.append({
        "name": "batched_plan_2d", "route": "cuda",
        "source": "src/repro_torch/csrc/batched_plan.cu",
        "replaces": "src/repro/kernels/slice/ref.py:31",
        "launches": launches["batched_plan_2d"],
        "max_abs_err": errs["batched_plan_2d"],
        "ms": timer(lambda: sk.batched_plan_2d(*fused_extract)),
        "plain_ms": timer(lambda: sref.batched_plan_2d(*fused_extract)),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": None,
        **kernel_breakdown(lambda: sk.batched_plan_2d(*fused_extract)),
        "shape": {"P": n_crops, "V": int(verts6.shape[1]),
                  **dict(zip(("n0", "n1", "R", "C"), fused_extract[4:8])),
                  **fb},
        "variants": [{
            "what": "lattice only (batched_plan_2d)",
            "ms": timer(lambda: sk.batched_plan_2d(*fused_plan)),
            "plain_ms": timer(lambda: sref.batched_plan_2d(*fused_plan)),
            "bound_ms": max(plan_only["bytes"] / HBM_BYTES_PER_S,
                            plan_only["flops"] / FP32_FLOPS) * 1e3,
            **kernel_breakdown(lambda: sk.batched_plan_2d(*fused_plan)),
            "shape": plan_only}]})

    # B4 on its own, on phase 6's (polytope, row) cuts built directly,
    # float32: on no path (its core runs inside batched_plan_2d and B3).
    b4_bytes, b4_flops = extents_cost(b4_args[0], b4_args[2], b4_args[3],
                                      b4_args[4])
    t_bytes = b4_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = b4_flops / FP32_FLOPS * 1e3
    x4, y4, valid4, planes4, tol4 = b4_args
    entries.append({
        "name": "slice_minor_extents", "route": "cuda",
        "source": "src/repro_torch/csrc/slice_extents.cu",
        "replaces": "src/repro/kernels/slice/ref.py:31",
        "launches": launches["slice_minor_extents"],
        "on_path": "none: inlined in batched_plan_2d and plan_runs_2d",
        "max_abs_err": errs["slice_minor_extents"],
        "ms": timer(lambda: sk.slice_minor_extents(*b4_args)),
        "plain_ms": timer(lambda: sref.slice_minor_extents_rows(*b4_args)),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": None,
        **kernel_breakdown(lambda: sk.slice_minor_extents(*b4_args)),
        "shape": {"B": int(x4.shape[0]), "V": int(x4.shape[1]),
                  "R": int(planes4.shape[1]), "dtype": "float32",
                  "flops": b4_flops, "bytes": b4_bytes}})

    # B5: the BFS layer of phase 5.
    b5_bytes, b5_flops = slice_batch_cost(verts5, mask5)
    t_bytes = b5_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = b5_flops / FP32_FLOPS * 1e3
    entries.append({
        "name": "slice_batch", "route": "cuda",
        "source": "src/repro_torch/csrc/slice_batch.cu",
        "replaces": "src/repro/kernels/slice/kernel.py:73",
        "launches": launches["slice_batch"],
        "max_abs_err": errs["slice_batch"],
        "ms": timer(lambda: sk.slice_batch(verts5, valid5, planes5, 0)),
        "plain_ms": timer(lambda: sref.slice_batch(verts5, valid5, planes5,
                                                   0)),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": None,
        **kernel_breakdown(lambda: sk.slice_batch(verts5, valid5, planes5,
                                                  0)),
        "shape": {"P": int(verts5.shape[0]), "V": int(verts5.shape[1]),
                  "D": int(verts5.shape[2]), "flops": b5_flops,
                  "bytes": b5_bytes}})

    # B6: the DLRM serve_bulk batch (timed in phase 8), with DeepFM's
    # bulk calls and the padded bags under "variants"; its launches are
    # those of both its kernels (wide rows, and narrow rows tiled).
    entries.append({
        "name": "gather_rows_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/gather.cu",
        "replaces": "src/repro/kernels/gather/kernel.py:123",
        "launches": launches["gather_rows_bag"]
        + launches["gather_rows_bag_tiled"],
        "launches_by_kernel": {
            k: launches[k] for k in ("gather_rows_bag",
                                     "gather_rows_bag_tiled")},
        "launches_by_path": {
            k: p["gather_rows_bag"] + p["gather_rows_bag_tiled"]
            for k, p in path_launches.items()
            if p["gather_rows_bag"] + p["gather_rows_bag_tiled"]},
        "max_abs_err": errs["gather_rows_bag"], **b6_timing})

    # B7: minibatch_lg's l = 2 message sum (timed in phase 9), with the
    # l = 0 and l = 1 sums, the energy readout and the hub under
    # "variants"; "segment_plans" counts the plans its launches read.
    entries.append({
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment/kernel.py:70",
        "launches": launches["segment_sum"],
        "segment_plans": launches["segment_plan"],
        "max_abs_err": errs["segment_sum"], **b7_timing})

    # B8: the last decode round of lm_serve (timed in phase 10) on the
    # tensor-core kernel, with the first round's, the decode_32k
    # per-layer shape and Arctic's first round (phase 11, G = 7) under
    # "variants"; max_abs_err over every call of lm_serve's path.  Its CUDA-core kernel (float32 and other shapes; the
    # launcher's float32 smoke model) is timed beside it at each shape.
    entries.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attn_tc.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:123",
        "launches": launches["paged_decode_attention"],
        "simt": {"source": "src/repro_torch/csrc/paged_attn.cu",
                 "launches": launches["paged_decode_attention_simt"]},
        **b8_timing_entry})
    emit({"phase": "timing", "card": card})

    # -- 13. the kernels line, the card, the result ----------------------
    emit({"kernels": entries, "launches": launches,
          "path_launches": path_launches})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
