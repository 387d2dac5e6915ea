#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ompi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi) and properties;
  2. build   — nvcc builds every kernel under ompi_tpu_torch/csrc/; the
               ptxas report of every kernel is read (registers, spills and
               serialised wgmma: either fails) and the bf16 forward and
               backward tiles (rows, threads, shared memory) are printed;
  3. kernels — each kernel against its plain PyTorch version on the card:
               K1 over K1_CASES and the merge contract, K2 and K3 over
               BWD_CASES row by row (each case also shows that the check
               rejects a planted fault on the kernel's own last tile), and
               flash_mha's gradients through autograd against autograd
               through the dense attention_reference;
  4. flash_attention — K4 against its plain version over K4_CASES and
               K4_VIEWS (strided (b, s, h, d) views; each case also shows
               that the check rejects a planted fault on its last BQ rows);
               SDPA's top-left causal alignment for s_q != s_k checked;
               flash_attention at full flagship width, (4, 2048, 16, 128)
               bf16 causal and not, and q (4, 1024, 16, 128) against that
               k/v: each call checked against the plain version and SDPA,
               exactly one K4 and no K1-K3 launch per call, and one
               profiled call holding exactly one device kernel (K4, no
               copy); CUDA-event medians of K4 on folded inputs, the entry
               point on (b, s, h, d), the plain version and SDPA, and a
               torch.profiler breakdown;
  5. forward path — the flagship forward at full flagship_config() width,
               batch 4 x 2048, weights from torch.Generator().manual_seed(0):
               logits checked, K1 launches counted (exactly n_layers per
               forward, no K4 launch), 4 requests answered greedily by
               full-context recompute, and the flash logits held against
               attn="dense";
  6. forward numbers — CUDA-event medians of K1, its plain version, the
               SDPA yardstick and one forward, as JSON lines, and a
               torch.profiler breakdown of one forward's device time;
  7. train path — make_train_step at full width, batch 4 x (2048 + 1),
               remat "dots", AdamW: K1/K2/K3/K4 launches per step counted
               exactly (12/6/6/0), a finite loss that falls over six steps on one
               batch, and attn="dense" from the same weights (losses and
               first-step gradients held to stated bounds, no K1/K2/K3
               launch);
  8. train numbers — CUDA-event medians of K2, K3, their plain versions,
               flash_mha's backward beside SDPA's backward; the train
               step's ms, tokens/s, MFU and peak memory for remat
               none/dots/full and attn="dense"; a torch.profiler breakdown
               of one step, whose K1/K2/K3/K4 launches must be 12/6/6/0.
  9. device collectives — DeviceComm in a one-process NCCL world, R = 8
               rank rows on the card (the single-device regime of
               bench.py's sweep): every method of the device plane on
               CUDA tensors against its MPI result in numpy (bitwise
               where data only moves, rtol 1e-6 for f32 sums, 1e-2 for
               bf16), each comparison shown to reject one planted wrong
               row (coll_check lines); bench.py's seven collectives at
               its sizes, 8 B to 64 MB a rank, by CUDA events, beside its
               staged arm and the HBM bound (coll_numbers lines); the
               allreduce at the flagship's gradient size in bf16.
 10. mesh    — in phase 9's world: (a) the flagship's causal attention,
               (4, 2048, 16, 128) bf16, cut into 4 sequence shards, every
               (my, src) hop through ring_block(block_impl="pallas"): 16
               K1 launches with the hops' global offsets, each hop held to
               K1's plain version, the merged result to flash_attention
               (K4) on the whole sequence, and a planted 10% fault on one
               hop rejected by both checks (ring_hops line); (b) the mesh
               train step at dp·sp·tp = 1·1·1 and full width, attn "ring"
               and "flash", remat "dots", from phase 7's weights and batch:
               the first step's gathered gradients held to the mesh-free
               step's (MESH_GRAD_RMS), a planted fault (ring: the last
               hop dropped) rejected, four steps' losses held to the
               mesh-free step's (MESH_LOSS_REL), falling, K1/K2/K3/K4
               launches per step exactly 0/0/0/0 (ring) and 12/6/6/0
               (flash); step ms, tokens/s and MFU beside the mesh-free
               step's.
 11. mpi     — the MPI surface under the port's launcher (a subprocess,
               the rank program written to a temporary file): (a) tpurun
               -np 1 runs runtime.init(), init_device_plane(ctx) (NCCL),
               make_mesh and attach_mesh, checks that coll/nccl serves
               every ported entry, holds comm.coll's allreduce (f32, bf16),
               bcast, allgather, reduce_scatter_block (f32, bf16),
               alltoall, allgatherv and alltoallv on R = 8 rows to numpy
               (phase 9's tolerances, each rejecting one planted wrong
               row) with exactly one native arm count a call and no
               staging, the forced staged arm (same result, R·b bytes
               staged out), a numpy buffer on the host path and a forced
               quant refused naming P8; then times comm.coll.allreduce
               beside DeviceComm.allreduce, the staged arm and the HBM
               bound at bench.py's sizes (mpi_numbers lines); (b) tpurun
               -np 4 runs the ring program of examples/ring.py on the
               host plane (tcp): "done: 10 laps", then the µs a hop.
               The forced quant arm (12c) runs: one quant arm count,
               exact with R = 8 rows in one process (folded in f32).
 12. grad sync — in phase 9's world: (a) the quant codec on all
               469,788,672 gradient elements (f32) on the card, a 2^24
               slice bitwise against the CPU, the whole against the
               reference's error model (a block planted 10% off
               rejected), timed beside its bytes bound (codec line); (b)
               every grad_sync arm (native, perleaf, bucketed 4 and 64
               MiB, quant, unsynced) on a {"dp": 1} mesh at full width:
               the loss and gradients of native's, no collective issued,
               step ms beside native's (grad_sync_dp1 lines).
 13. serve   — in phase 9's world, after phase 12, weights from
               torch.Generator().manual_seed(0) on a {"tp": 1} mesh, the
               train shards through convert_params: (a) f32, four
               requests of 7-64 tokens answered 16 tokens each together by
               the ServingEngine (max_seqs 8, pages of 16): the streams
               equal tfm.greedy's (attn="flash", K1 launches counted) and
               every step's logits are within 1e-4 relative of forward's;
               one decode step issues 27 audited decode collectives
               (serve_f32 line); (b) bf16, teacher-forced along (a)'s
               streams: each step's logits within phase 5's bound of
               forward's (serve_bf16 line); against both checks three
               planted faults (a page write one offset late, a block table
               pointing at another live slot's page, decode attention
               without the last page) must fail; (c) the scheduler on
               poisson_stream(32, 50 qps, prompts 64-512, 16-64 new):
               continuous and static give the same streams, continuous
               fewer decode steps and higher occupancy, the cache drains
               (serve_scheduler line); (d) prefill ms at 128/512/2048
               tokens, decode_step ms at max_seqs 8 and 32 with every slot
               at 512 and 2048 context beside its bytes bound, tokens/s,
               the scheduler's tokens/s, one profiled decode step
               (serve_numbers and profile lines).
 14. decode  — in phase 9's world, after phase 13, the same weights on a
               {"tp": 1} mesh: (a) f32, the scheduler on 13a's four
               prompts at spec_k 0, 2 and 4 gives the streams of plain
               decoding (a departure is excused only where that step's
               top-two logits are within 1e-5 of the larger, and printed),
               the speculative ledger, every page released, some draft
               accepted, the longest request's pages filling its block
               table; a draft accepted one past its match, seq_lens not
               rolled back after a rejection and no draft accepted must
               each fail that check (decode_check line); (b) bf16,
               decode_window ms at (max_seqs, context) = (8, 512) and
               (32, 512) for k = 2 and 4 beside decode_step
               ms on the same engine, each with one profiled call (idle
               share, launches), and the scheduler's tokens/s, decode
               steps and acceptance rate on 13c's stream at spec_k 0, 2
               and 4 (decode_numbers lines).
 15. fleet   — in phase 9's world, after phase 14: (a) a ServingFleet of
               one colocated replica at tp 1 against the bare scheduler on
               an engine of the same geometry, 13c's stream in bf16 at full
               width: under one step clock (a fixed step a reading) the
               same streams and decode steps, no K1-K4 launch in the
               fleet, every page released; then each once on the host
               clock, tokens/s and ITL, streams equal (fleet_check
               "fleet_of_one" line).
 17. moe     — in phase 9's world, after phase 15 (P12a): (a) f32, TF32
               off, at a narrow width (MOE_NARROW): the MoE forward and
               loss (attn "dense", the einsum block) on the card against
               the same code on the CPU, routing flips counted and the
               logits held to 1e-5 of their largest on the tokens before
               the first flip, aux and loss to 1e-5 (gates left
               unnormalised must fail it); moe_block_ep with 8 rows of 64
               tokens in one process at cf 8 against moe_block on the same
               tokens within 2e-5, its info and spc wire (the combine's
               inverse map rolled one token must fail it); the engine at
               tp 1 with mlp="moe", cf 4, 13a's four requests answered
               together: tokens equal tfm.greedy's, logits within 1e-4
               of forward's (its experts in reverse order must fail it)
               (moe_check lines); (b) bf16, flagship_config() with
               mlp="moe" (8 experts, top 2, cf 1.25; 2.58 G parameters),
               batch 4 x 2048: the forward's ms and each layer's routed
               and dropped tokens (moe_forward), the einsum block's parts
               (moe_numbers), and the train step under remat "dots",
               "none" and "full": step ms, tokens/s, MFU by the
               reference's count and by the FLOPs the step issues, peak
               bytes, K1/K2/K3/K4 launches of one step exactly 12/6/6/0,
               6/6/6/0 and 12/6/6/0, a falling loss, one profiled "dots"
               step (moe_train_numbers, profile lines).
 18. audit  — in phase 9's world, after phase 12 (P16a-1): (a) the
               flagship step at full width on {"dp": 1}, grad_sync
               "bucketed" in 4 MiB buckets, five steps timed with the
               trace, perf and traffic planes off and then on: step ms,
               the events a step by category, the ring's dropped events,
               K1/K2/K3/K4 launches still 12/6/6/0 a step, one
               decide:grad_sync event a bucket and one grad_sync:run span
               a step, the traffic plane's grad_sync charge 2(n-1)/n x the
               gradient bytes, and the goodput row the step records
               (wall, tokens/s, MFU at perf_peak_tflops 989) beside phase
               8's MFU (audit_train, audit_check lines); DeviceComm's
               allreduce at 1 and 64 MB a row, R = 8, with perf on: the
               host's dispatch ms (no synchronize, as perf.timed_coll
               samples) beside its CUDA-event ms, and the cost model's
               cells, none with one process (audit_numbers lines).
The last lines are the collectives, mesh, mpi, grad_sync, serve, decode,
fleet, moe, audit and kernels JSON objects (the kernels line carries each
kernel's launches in one MoE step, moe_step_launches),
the nvidia-smi line and {"ok": true, "device": {...}}.  Without CUDA it
exits 1 and prints no result.

    python3 chip_smoke.py --multi-card

runs on four cards of one host (else it exits 1): phase 9 across them
(one NCCL process a card, R = 8 rows over them), then phase 10c: the
flagship's mesh train step, attn="ring", at full width at (dp, sp, tp) =
(1, 2, 2) and (2, 2, 1), its gathered gradients and losses held to the
one-card step from the same weights and tokens as in 10b (planted faults:
the gradient sum over dp × sp skipped, the last hop dropped), and its
step ms, tokens/s and MFU beside that step's; then phase 11 across the
cards: tpurun -np 4 --gpus-per-rank 1, one rank bound to each card with
one row (R = 4), the 11a checks, comm.coll's allreduce, bcast, allgather
and alltoall beside DeviceComm's, and coll/tuned's host allreduce of the
same bytes up to 4 MB.  Phase 12 across the cards: (d) the flagship step,
attn "flash", on a {"dp": 4} mesh with every grad_sync arm, each arm's
gradients held to native's (perleaf and bucketed to SYNC_GRAD_RMS, quant
to the codec's error model, unsynced to this rank's own), a skipped
bucket and a zeroed scale block rejected, three losses held to one
card's, K1-K3 launches counted, each arm timed under remat "dots" and
"none" with bench.py's overlap efficiency and busbw (grad_sync_check and
grad_sync_numbers lines); (e) tp_overlap="fused" at (1, 1, 4), attn
"dense", against the unfused tp step, as decided and with the rings
forced bidirectional, a dropped partial rejected, timed (fused_step
lines); (f) in phase 11, comm.coll.allreduce forced onto the quant arm
at 1 and 64 MB a rank, within the error model, wire bytes <= 0.3 x
native's, timed beside native (mpi_numbers lines).  Phase 13e on a
{"tp": 4} mesh: convert_params on the flagship's train shards bitwise
against the decode layout cut from the whole tree, and back; the three
all_to_all plans timed; the f32 engine's streams equal one card's greedy
and its logits within 1e-4, 27 audited dispatches a step, the decode
collectives forced onto quant within 0.05 (>= 75% of the tokens), one
decode_ag returning only this rank's shard rejected; the bf16 decode step
on four cards beside one card's (serve_multi_card, serve_numbers lines).
Phase 14c on the same mesh: decode_overlap="fused" at full width, f32
tokens equal to the eager engine's and logits within 1e-4, an allgather
ring short its last hop and a reduce-scatter ring without this rank's
partial each rejected, 2 eager dispatches and 25 decode_collmm a step
whose wire (909,312 B at 8 rows in bf16) equals ring_schedule's and the
spc's, spec_k 2 on the fused engine with plain decoding's streams and
some draft accepted; bf16 teacher-forced within phase 13b's 4e-2 of the
eager engine; the fused
step beside the eager one at (8, 512) and (32, 512), each profiled
(decode_check, decode_numbers lines, then the decode line).
Phase 15 across the cards, seed-0 weights at full width: (b) a 1 + 1
fleet at tp 2, bf16: a 512-token prompt prefilled on the prefill row and
its KV pages migrated, the decode ranks' pages bitwise equal to the prefill
ranks' (sent again by a plain send), seq_lens carried over, wire bytes =
the plan's = the spc's = fleet_migrated_bytes, peak <= bound, a dropped
piece and the last page of prompt rows of one layer zeroed each failing the
bitwise check, then the ms and GB/s of a migration (fleet_check
"migration" line); (c)
13a's four requests in f32 through colocated 1 x tp 4 and 2 x tp 2 and
disaggregated 1 + 1 at tp 2 and 1 + 3 at tp 1: every request's tokens
equal colocated 1 x tp 4's, the migrations equal the requests that outlive
their first token (fleet_check "fleet_tokens_f32" line); (d) 13c's stream
in bf16 through colocated 1 x tp 4 and disaggregated 2 x tp 2 (one prefill
replica, one decode replica): tokens/s and ITL p50/p99 on the host's
clock (tokens over the command's wall time; the gaps between a request's
tokens on its serving replica) and on the fleet's virtual clock, decode
steps, migrations, the share of the command spent migrating, every card's
idle share from one more, profiled run (fleet_numbers lines).  The
fleets of one layout share its mesh and pair groups (made once).
Phase 16 across the cards, after phase 15, seed-0 weights at full width,
the axes named in HIER_SIM_AXES on the simulated slow plane (each
layout's mesh made once for the world, world_mesh), in phase 15's world
(which tears down its groups in an order every rank shares, leave_world):
(a) a DeviceComm over
("outer", "inner") on {"outer": 2, "inner": 2}: phase 9's checks of every
flat method (coll_check lines); hierarchical_allreduce exact at counts 7
and 1,000,003 (f32, bf16) and hierarchical_psum_quant within the codec's
model, a skipped outer stage rejected by both (hier_check lines); the
hierarchical allreduce at 1, 16 and 64 MB a rank beside the flat NCCL
allreduce with hier_wire_bytes' split, the shim off (hier_numbers); (c)
the flagship step on {"dpo": 2, "dp": 2}, attn "flash", bucketed, its
bucket arms forced native, decided, forced hier and hier+quant: against
native's gradients (hier SYNC_GRAD_RMS, hier+quant the codec's model), a
skipped hier bucket and a zeroed scale block rejected, three losses
against one card's, K1-K3 12/6/6 a step, each arm timed under "dots" and
"none" beside 12d's native (hier_sync_check, hier_sync_numbers); (d)
ulysses_attention at (4, 2048, 16, 128) bf16 causal on {"sp": 4}, with
flash_mha and the dense default, against one card's flash_mha on the
whole tensors, the sequence's chunks out of order rejected, timed beside
ring_attention (ulysses_check, ulysses_numbers); (e) the mesh step with
attn "flash" and "dense" at (1, 2, 2) and (2, 2, 1) against the one-card
step within 10c's bounds, the dp × sp sum and the heads->seq exchange
each skipped and rejected, K1-K3 counted, timed beside "ring"
(mesh_step, ulysses_mesh_numbers); (f) pipeline() of the six layers in
two stages on {"dp": 2, "pp": 2}, four microbatches of one sequence,
against the layers in order, a dropped shift rejected, K1-K3 30/15/15,
timed, the bubble 0.2 (pipeline_check).  The world's ranks end through
leave_world after the hier line: teardown lines, and a process group
whose teardown does not return within 60 s fails the run.  After
phase 11, (b) tpurun -np 4 --gpus-per-rank 1 runs the hier rank program:
comm_world attached to ("dpo", "dp"), comm.coll.allreduce decided (native)
and forced hier and hier+quant, the arm counts and spc wire =
hier_wire_bytes' total, a MAX allreduce refused the hier arm with the
reference's reason, the simulated-DCN charges (hier: the outer bytes;
native: the ring's dcn share of its wire), each arm timed at 1, 16 and 64
MB a rank with the shim off and at HIER_US_PER_MIB (hier_mpi_check,
hier_mpi_numbers lines, then the hier_mpi line).  Phase 17c across the
cards, in a second world of its own (spawned once the first has torn
down): moe_block_ep on {"ep": 4} with two rows a card against moe_block
(17a's check and fault); at the flagship's width, 2048 tokens a card,
moe_block_ep native in bf16 (ms, routed and dropped tokens, wire bytes,
the exchange's plan) and, with "epo" simulated as the slow plane, native,
hier and hier+quant on {"epo": 2, "epi": 2} in f32: hier within 1e-4 of
native, hier+quant within 0.05, inner + outer = wire in each leg, the
spc's wire the legs' sum, hier+quant's dispatch the hier one and only its
outer combine smaller (the outer dispatch lane dropped must fail it);
moe_eval_loss over the four cards against one card's loss_fn within 5e-4
(gates left unnormalised must fail it); the engine at tp 4 with
mlp="moe" as in 17a; the MoE decode step at the flagship's width, bf16,
(8, 512), its ms and each layer's routed tokens (moe_check,
moe_ep_numbers, moe_numbers lines).  Phase 17d in the same world: the MoE
mesh train step (moe_block_mesh) on {"dp": 1, "ep": 2, "tp": 2} and
{"dp": 2, "ep": 2, "tp": 1}.  At the flagship's width cut to two layers,
f32, TF32 off, batch 4 x 2049: the tokens dropped per layer by the global
routing and by each dp shard's own (the capacity factor cut by 0.8 until
they differ; moe_mesh_drops line); the mesh step's loss and each rank's
gradient shards against the one-card step's, cut to the rank's slices
(MOE_MESH_LOSS_REL, MOE_MESH_GRAD_RMS), routing flips counted, and three
planted faults each failing the gradient check: (a) the capacity and
positions over the rank's own tokens (where dp > 1), (b) the dispatch
input's sum over ep skipped in the backward, (c) the combine gather's
backward a reduce-scatter (moe_mesh_step lines); then the full
flagship_config() with mlp="moe" (6 layers, bf16, remat "dots") timed on
each layout: step ms, tokens/s, MFU a card by the reference's count, peak
bytes, host_issue_ms and K1/K2/K3/K4 launches of one step a rank, exactly
12/6/6/0 (train_numbers lines; then the moe line and its teardown).
Each world's ranks end through leave_world: its process groups destroyed
one at a time in the order the world's teardown takes them, each with its
members, what made it (a world_mesh layout's axis or product group, or the
group's own description) and its seconds (teardown_group lines), then the
world's teardown line with the count of groups it held.  Last, phase
18 across the cards: (b) tpurun -np 4 --gpus-per-rank 1 runs the audit
rank program, comm_world attached to {"x": 4} with the three planes on:
the twelve comm.coll entries of the JAX package's audit test leave one
decision event each on every rank, with the same arm, reason and chain on
every rank; traffic_attributed_bytes equals the spc's coll_wire_bytes,
nothing unattributed, the edges (all 12, all ICI) summing to the wire;
mpisync's offsets and best RTT; trace.gather to rank 0, timed, and the
merged Chrome trace monotonic with no overlap in any lane; planted
faults (a) one edge's charge dropped, (b) a second decision event for one
bcast and (c) rank 2 sleeping 5 ms before each of 20 allreduces each fail
their check (entry_skew flags exactly rank 2, and nobody without the
sleep); the cost model's cells for comm.coll.allreduce at 1 and 64 MB a
rank (dispatch-time samples) beside their CUDA-event ms (audit_check,
audit_numbers lines); (c) the flagship step on {"dp": 4} as in 18a, the
planes off and on (then the audit line).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

# Tolerances of the kernel-vs-plain checks, on o/l over rows that see a key
# (elementwise, rtol = atol): f32 takes the same FMA arithmetic in another
# order; bf16 rounds p to bf16 at tile-dependent running maxima (the kernel
# tiles 128 kv columns, 64 at d 256; the plain version 128).  m must agree
# to M_TOL * max|s|.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
M_TOL = 1e-5
# Flash vs dense logits at full width, bf16: relative RMS difference.  Each
# bf16 path rounds scores or probabilities in other places (dense rounds the
# scores themselves to bf16), and each sits ~1.5e-2 from the f32 forward
# at six layers; 4e-2 leaves room for two such independent errors.
FLASH_VS_DENSE_RMS = 4e-2

# (name, dtype, causal, bh, s_q, s_k, d, q_offset, kv_offset)
K1_CASES = [
    ("f32 dense d64", "float32", False, 4, 256, 256, 64, 0, 0),
    ("f32 causal d128", "float32", True, 4, 256, 256, 128, 0, 0),
    ("f32 ragged d64", "float32", True, 3, 77, 77, 64, 0, 0),
    ("f32 d256 sq!=sk", "float32", False, 2, 96, 160, 256, 0, 0),
    ("bf16 dense d64", "bfloat16", False, 4, 256, 256, 64, 0, 0),
    ("bf16 causal d128", "bfloat16", True, 4, 256, 256, 128, 0, 0),
    ("bf16 sq!=sk causal", "bfloat16", True, 4, 128, 320, 128, 192, 0),
    ("bf16 ragged s=200", "bfloat16", True, 4, 200, 200, 128, 0, 0),
    ("bf16 ragged d80", "bfloat16", False, 2, 131, 97, 80, 0, 0),
    ("bf16 d256", "bfloat16", True, 2, 192, 192, 256, 0, 0),
    ("bf16 hop fully visible", "bfloat16", True, 4, 256, 256, 128, 256, 0),
    ("bf16 hop invisible", "bfloat16", True, 4, 256, 256, 128, 0, 256),
    ("bf16 hop partly masked", "bfloat16", True, 4, 256, 256, 128, 0, 32),
    ("f32 hop partly masked", "float32", True, 4, 256, 256, 64, 96, 160),
    # the bf16 tile's edges: BQ = BK = 128 (d <= 128), 64 (d 256)
    ("bf16 s=127 (tile-1)", "bfloat16", True, 4, 127, 127, 128, 0, 0),
    ("bf16 s=129 (tile+1)", "bfloat16", True, 4, 129, 129, 128, 0, 0),
    ("bf16 bh=1 sq=129 sk=127", "bfloat16", False, 1, 129, 127, 128, 0, 0),
    ("bf16 d64 sq=127 sk=129", "bfloat16", True, 2, 127, 129, 64, 0, 0),
    ("bf16 d256 s=65 (tile+1)", "bfloat16", True, 2, 65, 65, 256, 0, 0),
    ("bf16 d256 s=63 (tile-1)", "bfloat16", False, 2, 63, 63, 256, 0, 0),
    ("bf16 hop offsets off the tile", "bfloat16", True, 2, 200, 300, 128,
     77, 13),
    ("bf16 hop off the tile, kv past", "bfloat16", True, 2, 129, 127, 128,
     300, 45),
    ("bf16 flagship shape", "bfloat16", True, 64, 2048, 2048, 128, 0, 0),
]
PATH_CASE = "bf16 flagship shape"

# K2/K3 against their plain versions, row by row (q rows of dq, kv rows of
# dk and dv): |kernel - plain| <= BWD_TOL * max |plain| over the row
# + BWD_ATOL * max |plain| over the tensor.  Per row, because under causal
# masking the rows' gradients shrink down the sequence (the first rows hold
# the tensor's max, the last are ~100x smaller), so a bound on the global
# max would not see a wrong tile near the end.  f32 runs the same FMA
# arithmetic in another order (~1e-6 of a row); bf16 rounds p and ds to
# bf16 from scores summed in another order and rounds the results to bf16
# (one bf16 step is 2^-8 = 3.9e-3 of an element).  BWD_ATOL covers rows
# that are zero up to rounding: dq's first row under causal masking, where
# p = 1 and dp = delta (~1e-7 of the max).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_ATOL = 1e-5
# Every case also plants a fault in the kernel's result, PLANTED_ERR off on
# the last quarter of the live rows and on the kernel's last tile of them
# (K3's q tile for dq, K2's kv tile for dk and dv, from flash_bwd_tile), and
# requires the check to reject both.  Live rows are those a gradient can
# reach: under top-left causal masking kv rows at or past s_q see no query,
# so dk and dv are zero there and a scaled zero is no fault.
PLANTED_ERR = 0.1
# K4 against its plain version: elementwise TOL on the normalised output,
# and a planted fault (PLANTED_ERR on the last BQ rows, the kernel's q
# tile: 128 rows in bf16 at d <= 128, 64 at d 256, F32_TILE_ROWS in f32)
# that the check must reject.  q is drawn at Q_SCALE times unit scale: scores of std ~2, a
# peaked softmax as trained models have, so the outputs are O(1) and a 10%
# fault stands above the elementwise bound, where on the ~0.1 outputs of a
# flat softmax it would not.
Q_SCALE = 2.0
# (name, q dtype, k/v dtype, causal, b, h, s_q, s_k, d)
K4_CASES = [
    ("f32 dense d64", "float32", "float32", False, 2, 2, 256, 256, 64),
    ("f32 causal d128", "float32", "float32", True, 2, 2, 256, 256, 128),
    ("f32 ragged causal s=77", "float32", "float32", True, 1, 3, 77, 77, 64),
    ("f32 causal sq>sk d256", "float32", "float32", True, 2, 1, 320, 128,
     256),
    ("f32 causal sq<sk", "float32", "float32", True, 2, 2, 128, 320, 64),
    ("bf16 dense d64", "bfloat16", "bfloat16", False, 2, 2, 256, 256, 64),
    ("bf16 causal d128", "bfloat16", "bfloat16", True, 2, 2, 256, 256, 128),
    ("bf16 ragged causal s=200", "bfloat16", "bfloat16", True, 2, 2, 200,
     200, 128),
    ("bf16 ragged s=77 d80", "bfloat16", "bfloat16", False, 3, 2, 77, 77,
     80),
    ("bf16 causal d256", "bfloat16", "bfloat16", True, 1, 2, 192, 192, 256),
    ("bf16 causal sq>sk", "bfloat16", "bfloat16", True, 2, 2, 320, 128, 128),
    ("bf16 causal sq<sk", "bfloat16", "bfloat16", True, 2, 2, 128, 320, 128),
    ("bf16 dense sq<sk ragged", "bfloat16", "bfloat16", False, 2, 2, 131,
     320, 128),
    ("mixed bf16 q, f32 k/v", "bfloat16", "float32", True, 2, 2, 256, 256,
     128),
    ("bf16 causal s=129 (tile+1) b=h=1", "bfloat16", "bfloat16", True, 1, 1,
     129, 129, 128),
    ("bf16 dense s=127 (tile-1)", "bfloat16", "bfloat16", False, 2, 3, 127,
     127, 128),
    ("bf16 causal sq=129 sk=127", "bfloat16", "bfloat16", True, 2, 2, 129,
     127, 128),
    ("bf16 causal d256 s=65 (tile+1)", "bfloat16", "bfloat16", True, 1, 2,
     65, 65, 256),
]
# K4 on (b, s, h, d) views as a model passes them, read in place: (name,
# layout, dtype, causal, b, h, s, d).  "packed qkv": q, k and v sliced from
# one (b, s, 3, h, d) tensor; "transposed": (b, h, s, d) tensors seen as
# (b, s, h, d).
K4_VIEWS = [
    ("bf16 packed qkv causal", "packed qkv", "bfloat16", True, 2, 4, 300,
     128),
    ("bf16 packed qkv d80", "packed qkv", "bfloat16", False, 2, 2, 129, 80),
    ("bf16 transposed causal", "transposed", "bfloat16", True, 2, 4, 257,
     128),
    ("f32 packed qkv causal", "packed qkv", "float32", True, 2, 2, 200, 64),
]
F32_TILE_ROWS = 32       # the float32 loops' tile: K1/K4's q tile
                         # (csrc/flash_fwd.cuh), K2's kv and K3's q tile
# flash_attention at full flagship width: (name, causal, s_q) against k/v
# of the flagship's sequence, batch BATCH, its heads and head_dim, bf16.
K4_PATH = [("causal", True, 2048), ("not causal", False, 2048),
           ("cross s_q 1024", False, 1024)]
# (name, dtype, causal, bh, s_q, s_k, d)
BWD_CASES = [
    ("f32 dense d64", "float32", False, 4, 256, 256, 64),
    ("f32 causal d128", "float32", True, 4, 256, 256, 128),
    ("f32 ragged causal d64", "float32", True, 3, 77, 77, 64),
    ("f32 d256 sq!=sk", "float32", False, 2, 96, 160, 256),
    ("bf16 dense d64", "bfloat16", False, 4, 256, 256, 64),
    ("bf16 causal d128", "bfloat16", True, 4, 256, 256, 128),
    ("bf16 sq!=sk d128", "bfloat16", False, 4, 128, 320, 128),
    ("bf16 ragged s=200", "bfloat16", True, 4, 200, 200, 128),
    ("bf16 ragged d80", "bfloat16", False, 2, 131, 97, 80),
    ("bf16 d256 causal", "bfloat16", True, 2, 192, 192, 256),
    # the Hopper kernels' edges (K2: 128 kv rows a block, 64 q rows a step;
    # K3: 128 q rows a block, 64 kv rows a step), d padded to D = 64 or 128
    ("bf16 causal s=127 (tile-1)", "bfloat16", True, 4, 127, 127, 128),
    ("bf16 causal s=129 (tile+1)", "bfloat16", True, 4, 129, 129, 128),
    ("bf16 causal s=255", "bfloat16", True, 4, 255, 255, 128),
    ("bf16 causal d64 s=255", "bfloat16", True, 4, 255, 255, 64),
    ("bf16 causal d80 s=200", "bfloat16", True, 4, 200, 200, 80),
    ("bf16 causal sq<sk", "bfloat16", True, 4, 128, 320, 128),
    ("bf16 causal sq>sk", "bfloat16", True, 4, 320, 128, 128),
    ("bf16 causal sq<sk ragged d64", "bfloat16", True, 2, 129, 257, 64),
    ("bf16 causal sq>sk ragged d80", "bfloat16", True, 2, 257, 129, 80),
    # b 4100 x h 16: bh past 65535, on the Hopper kernels' grid x
    ("bf16 bh 65600", "bfloat16", True, 65600, 128, 128, 64),
    ("bf16 flagship shape", "bfloat16", True, 64, 2048, 2048, 128),
]
# flash_mha's gradients against autograd through the dense reference: f32
# elementwise to 2e-4 (rtol = atol, the figure of tests/test_ops.py); bf16
# at the path's shape against the dense f32 gradients of the same inputs,
# as a relative RMS: the flash path rounds o, p and ds to bf16 (2^-8 each)
# and 1e-2 leaves room for a few such roundings.
GRAD_TOL_F32 = 2e-4
GRAD_RMS_BF16 = 1e-2
# (dtype, (b, s, h, d), causal cases): a moderate f32 size, and the path's
GRAD_CASES = [("float32", (2, 512, 4, 64), (False, True)),
              ("bfloat16", (4, 2048, 16, 128), (True,))]
# The train path, flash against attn="dense" from the same weights and
# batch, bf16: the first three losses to 1e-2 relative, and the first
# step's gradients, all leaves together, to a relative RMS of 0.1.  The
# dense path rounds the scores and the softmax itself to bf16, so its
# forward's logits sit ~1.9e-2 (RMS) from f32 (phase 4 measures it);
# a gradient through six such layers takes a few times that.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_RMS = 0.1
TRAIN_STEPS = 6          # on one repeated batch: the loss must fall
TIMED_STEPS, WARMUP_STEPS = 10, 2
BATCH = 4

# How the profile groups kernels by name (first match wins).
KERNEL_CLASSES = [
    ("NCCL", ("nccl",)),
    ("K4 attention_sm90", ("attention_sm90", "attention_f32")),
    ("K1 partials_sm90", ("partials_sm90", "partials_f32")),
    ("K2 dkdv", ("dkdv_sm90", "dkdv_kernel")),
    ("K3 dq", ("dq_sm90", "dq_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("copies and casts", ("copy_kernel", "bfloat16_copy")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
]

# A kernel's time is the median of 20 samples of KERNEL_REPS launches in
# a row: a sub-millisecond kernel timed one launch at a time would also
# count the host's gap before the launch.
KERNEL_REPS = 10

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n: int = 20, warmup: int = 3, reps: int = 1) -> float:
    """The median over n samples of the ms per call of ``reps`` calls in a
    row between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check_k1(torch, attention, case):
    """One K1-vs-plain comparison; returns the max abs error of o/l."""
    name, dtype, causal, bh, s_q, s_k, d, q_off, kv_off = case
    gen = torch.Generator(device="cuda").manual_seed(s_q * 1000 + d)
    mk = lambda s: torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=getattr(torch, dtype))
    q, k, v = mk(s_q), mk(s_k), mk(s_k)
    got = attention.flash_attention_partials(
        q, k, v, causal=causal, q_offset=q_off, kv_offset=kv_off)
    want = attention.flash_attention_partials_reference(
        q, k, v, causal=causal, q_offset=q_off, kv_offset=kv_off)
    torch.cuda.synchronize()
    return partials_agree(torch, f"K1 {name}", dtype, got, want, q, k,
                          causal, q_off, kv_off)


def partials_agree(torch, name, dtype, got, want, q, k, causal, q_off,
                   kv_off, m_step: float = 0.0) -> float:
    """(o, m, l) of K1 against its plain version's, or raise: o/l over the
    rows that see a key elementwise to TOL, l to TOL relative, m to
    M_TOL * max|s| plus ``m_step`` of |m| (a rounding step, where both
    sides rounded m), m <= -1e29 on rows that see none.  Returns the max
    abs error of o/l."""
    bh, s_q, d = q.shape
    rows = q_off + torch.arange(s_q, device=q.device)
    seen = (rows >= kv_off) if causal else torch.ones_like(rows, dtype=bool)
    seen = seen.expand(bh, s_q)
    (o1, m1, l1), (o2, m2, l2) = ([x.float() for x in t]
                                  for t in (got, want))
    tol = TOL[dtype]
    err = 0.0
    if seen.any():
        n1 = o1[seen] / l1[seen][:, None]
        n2 = o2[seen] / l2[seen][:, None]
        err = float((n1 - n2).abs().max())
        ok_o = bool(((n1 - n2).abs() <= tol + tol * n2.abs()).all())
        scale = 1.0 / math.sqrt(d)
        s_max = float((q.float() @ k.float().transpose(1, 2)).abs().amax()
                      * scale)
        m_diff = (m1[seen] - m2[seen]).abs()
        m_err = float(m_diff.max())
        ok_m = bool((m_diff <= M_TOL * s_max
                     + m_step * m2[seen].abs()).all())
        l_err = float(((l1[seen] - l2[seen]).abs()
                       / l2[seen].abs()).max())
        if not (ok_o and ok_m and l_err <= tol):
            raise AssertionError(
                f"{name}: o/l max err {err:.3g} (tol {tol}), m err "
                f"{m_err:.3g} (tol {M_TOL * s_max:.3g} + {m_step} |m|), "
                f"l rel err {l_err:.3g} (tol {tol})")
    if not bool((m1[~seen] <= -1e29).all() and (m2[~seen] <= -1e29).all()):
        raise AssertionError(f"{name}: a row that sees no key has m > "
                             f"-1e29")
    if not all(bool(torch.isfinite(x[seen]).all()) for x in got):
        raise AssertionError(f"{name}: non-finite output on a seen row")
    return err


def check_merge(torch, attention, ring, dtype):
    """Two kv halves through K1, merged with ring._merge, equal the plain
    version over the whole kv (causal, the second half at kv_offset)."""
    bh, s, d = 8, 512, 128
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                           dtype=getattr(torch, dtype)) for _ in range(3))
    for causal in (False, True):
        h = s // 2
        p1 = attention.flash_attention_partials(q, k[:, :h], v[:, :h],
                                                causal=causal)
        p2 = attention.flash_attention_partials(q, k[:, h:], v[:, h:],
                                                causal=causal, kv_offset=h)
        o, m, l = ring._merge(*p1, *p2)
        wo, wm, wl = attention.flash_attention_partials_reference(
            q, k, v, causal=causal)
        a, b = o / l[..., None], wo / wl[..., None]
        err = float((a - b).abs().max())
        tol = TOL[dtype]
        if not bool(((a - b).abs() <= tol + tol * b.abs()).all()):
            raise AssertionError(f"merge {dtype} causal={causal}: max err "
                                 f"{err:.3g} (tol {tol})")
        log({"phase": "merge", "dtype": dtype, "causal": causal,
             "max_abs_err": err, "tol": tol, "ok": True})


def bwd_args(torch, attention, dtype, causal, bh, s_q, s_k, d):
    """(q, k, v, dO, lse, delta) for K2/K3: random q, k, v, dO, with lse
    and delta from one K1 forward of the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(s_q * 1000 + d + 1)
    mk = lambda s: torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=getattr(torch, dtype))
    q, k, v, do = mk(s_q), mk(s_k), mk(s_k), mk(s_q)
    o, m, l = attention.flash_attention_partials(q, k, v, causal=causal)
    l = l.clamp_min(1e-20)
    of = (o / l[..., None]).to(q.dtype)
    return (q, k, v, do, m + torch.log(l),
            (do.float() * of.float()).sum(dim=-1))


def bound_use(got, want, tol: float) -> float:
    """The largest |got - want| over its row's bound (see BWD_TOL); the
    check passes at <= 1."""
    top = want.abs()
    lim = (tol * top.amax(dim=-1, keepdim=True)
           + BWD_ATOL * top.amax(dim=(-2, -1), keepdim=True))
    return float(((got - want).abs() / lim).max())


def bwd_tile_rows(bwd_lib, dtype: str, d: int):
    """The rows of K2's kv tile (dk, dv) and K3's q tile (dq) at this dtype
    and head dim: the rows a planted fault covers."""
    if dtype == "float32":
        return dict.fromkeys(("dk", "dv", "dq"), F32_TILE_ROWS)
    import ctypes
    out = (ctypes.c_int * 7)()
    bwd_lib.flash_bwd_tile(d, out)
    return {"dk": out[1], "dv": out[1], "dq": out[2]}


def check_bwd(torch, attention, case, tiles):
    """One K2/K3-vs-plain comparison; returns, for each of dq, dk and dv,
    the max abs error, the bound used (bound_use) and what the two planted
    faults read.  ``tiles`` gives each gradient's tile rows
    (bwd_tile_rows)."""
    name, dtype, causal, bh, s_q, s_k, d = case
    args = bwd_args(torch, attention, dtype, causal, bh, s_q, s_k, d)
    dk, dv = attention.flash_mha_bwd_dkdv(*args, causal=causal)
    dq = attention.flash_mha_bwd_dq(*args, causal=causal)
    want_dk, want_dv = attention.flash_mha_bwd_dkdv_reference(*args,
                                                              causal=causal)
    want_dq = attention.flash_mha_bwd_dq_reference(*args, causal=causal)
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype]
    errs, used, planted = {}, {}, {}
    for what, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        got, want = got.float(), want.float()
        errs[what] = float((got - want).abs().max())
        used[what] = bound_use(got, want, tol)
        if not (bool(torch.isfinite(got).all()) and used[what] <= 1):
            raise AssertionError(
                f"K2/K3 {name}: {what} max err {errs[what]:.3g}, "
                f"{used[what]:.3g} of its row's bound, finite="
                f"{bool(torch.isfinite(got).all())}")
        live = got.shape[1]
        if causal and what != "dq":
            live = min(live, s_q)
        rows = tiles[what]
        planted[what] = {"tile_rows": rows}
        for fault, sl in (("last_quarter", slice(live - live // 4, live)),
                          ("last_tile", slice(max(live - rows, 0), live))):
            bad = got.clone()
            bad[:, sl] *= 1 + PLANTED_ERR
            planted[what][fault] = bound_use(bad, want, tol)
            if not planted[what][fault] > 1:
                raise AssertionError(
                    f"K2/K3 {name}: {what} with the {fault} rows "
                    f"{PLANTED_ERR:.0%} off reads {planted[what][fault]:.3g}"
                    f" of the bound; the check would pass it")
    return errs, used, planted


def mha_grads(torch, fn, q, k, v, g):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    return torch.autograd.grad(fn(q, k, v), (q, k, v), g)


def check_grad(torch, attention, ring) -> None:
    """flash_mha through autograd (K1, then delta, K2, K3) against autograd
    through the dense attention_reference."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for dtype, shape, causals in GRAD_CASES:
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda",
                                  dtype=getattr(torch, dtype))
                      for _ in range(4))
        for causal in causals:
            got = mha_grads(torch, lambda q, k, v: attention.flash_mha(
                q, k, v, causal), q, k, v, g)
            # the dense reference runs in f32 on the same (bf16) values
            want = mha_grads(torch, lambda q, k, v: ring.attention_reference(
                q, k, v, causal=causal), *(x.float() for x in (q, k, v, g)))
            torch.cuda.synchronize()
            for what, a, b in zip(("dq", "dk", "dv"), got, want):
                if dtype == "float32":
                    err = float((a - b).abs().max())
                    ok = bool(((a - b).abs() <= GRAD_TOL_F32
                               + GRAD_TOL_F32 * b.abs()).all())
                    tol = GRAD_TOL_F32
                else:
                    err = rel_rms(a.float(), b)
                    ok, tol = err < GRAD_RMS_BF16, GRAD_RMS_BF16
                log({"phase": "grad_check", "dtype": dtype, "causal": causal,
                     "shape": list(shape), "grad": what,
                     "max_abs_err" if dtype == "float32" else "rel_rms": err,
                     "tol": tol, "ok": ok})
                if not ok:
                    raise AssertionError(f"flash_mha {dtype} causal={causal}"
                                         f" {what}: {err:.3g} (tol {tol})")
            del got, want


def fold(x):
    """(b, s, h, d) -> (b*h, s, d), as the plain version takes them."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def k4_inputs(torch, gen, b, h, s_q, s_k, d, q_dtype, kv_dtype):
    """q (b, s_q, h, d) at Q_SCALE, k and v (b, s_k, h, d) at unit scale."""
    mk = lambda s, dtype, scale=1.0: (torch.randn(
        (b, s, h, d), generator=gen, device="cuda") * scale).to(
        getattr(torch, dtype))
    return mk(s_q, q_dtype, Q_SCALE), mk(s_k, kv_dtype), mk(s_k, kv_dtype)


def elementwise_use(got, want, tol: float) -> float:
    """The largest |got - want| over its bound tol + tol * |want|; the check
    passes at <= 1."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def tile_rows(attention_lib, dtype: str, d: int) -> int:
    """The q tile of K1/K4 at this dtype and head dim: the rows a planted
    fault covers."""
    if dtype == "float32":
        return F32_TILE_ROWS
    import ctypes
    out = (ctypes.c_int * 4)()
    attention_lib.flash_attention_tile(d, out)
    return out[0]


def check_k4(torch, attention, lib, name, dtype, causal, q, k, v):
    """One K4-vs-plain comparison through flash_attention on (b, s, h, d)
    inputs as they lie; returns the max abs error, the share of the bound
    used and what the planted fault on the last BQ rows reads."""
    b, s_q, h, d = q.shape
    out = attention.flash_attention(q, k, v, causal=causal)
    want = attention.flash_attention_reference(fold(q), fold(k), fold(v),
                                               causal=causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    if out.shape != (b, s_q, h, d) or out.dtype != q.dtype or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"K4 {name}: output {tuple(out.shape)} "
                             f"{out.dtype}, finite="
                             f"{bool(torch.isfinite(out).all())}")
    got = fold(out).float()
    err = float((got - want.float()).abs().max())
    used = elementwise_use(got, want, tol)
    if not used <= 1:
        raise AssertionError(f"K4 {name}: max err {err:.3g}, {used:.3g} of "
                             f"the bound (tol {tol})")
    rows = tile_rows(lib, dtype, d)
    bad = got.clone()
    bad[:, max(s_q - rows, 0):] *= 1 + PLANTED_ERR
    planted = elementwise_use(bad, want, tol)
    if not planted > 1:
        raise AssertionError(f"K4 {name}: the last {rows} rows "
                             f"{PLANTED_ERR:.0%} off read {planted:.3g} of "
                             f"the bound; the check would pass it")
    return err, used, planted, rows


def k4_view_inputs(torch, gen, layout, dtype, b, h, s, d):
    """q (at Q_SCALE), k and v as (b, s, h, d) views of the given layout."""
    dt = getattr(torch, dtype)
    if layout == "packed qkv":
        x = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
        x[:, :, 0] *= Q_SCALE
        x = x.to(dt)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
               * scale for scale in (Q_SCALE, 1.0, 1.0))
    return tuple(x.to(dt).transpose(1, 2) for x in (q, k, v))


def sdpa(torch, q, k, v, causal):
    """SDPA's forward on the (b, h, s, d) views of (b, s, h, d) inputs."""
    t = lambda x: x.transpose(1, 2)
    return torch.nn.functional.scaled_dot_product_attention(
        t(q), t(k), t(v), is_causal=causal)


def check_sdpa_alignment(torch, attention) -> None:
    """SDPA's is_causal with s_q != s_k against the plain version, whose
    causal mask is aligned at the top left (row i sees the keys j <= i).
    Logged, not required: the yardstick's timed shapes do not depend on
    it (causal at s_q == s_k, cross not causal)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, d = 2, 2, 128
    for s_q, s_k in ((320, 128), (128, 320)):
        q, k, v = k4_inputs(torch, gen, b, h, s_q, s_k, d, "bfloat16",
                            "bfloat16")
        want = attention.flash_attention_reference(fold(q), fold(k),
                                                   fold(v), causal=True)
        got = sdpa(torch, q, k, v, True).reshape(b * h, s_q, d)
        use = elementwise_use(got, want, TOL["bfloat16"])
        log({"phase": "sdpa_alignment", "s_q": s_q, "s_k": s_k,
             "bound_use": use, "top_left": use <= 1})


def visible_pairs(s_q: int, s_k: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves visible, top-left causal."""
    if not causal:
        return s_q * s_k
    return sum(min(i + 1, s_k) for i in range(s_q))


def k4_path(torch, attention, cfg, card):
    """flash_attention at full flagship width over K4_PATH: each call
    checked against the plain version and SDPA, its launches counted, and
    timed.  Returns one row of numbers per shape."""
    b, h, d, s_k = BATCH, cfg.n_heads, cfg.head_dim, cfg.seq
    tol = TOL["bfloat16"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, causal, s_q in K4_PATH:
        q, k, v = k4_inputs(torch, gen, b, h, s_q, s_k, d, "bfloat16",
                            "bfloat16")
        zero_counts(attention)
        out = attention.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        counts = launch_counts(attention)
        if counts != (0, 0, 0, 1):
            raise AssertionError(f"flash_attention {name}: K1/K2/K3/K4 "
                                 f"launches {counts}, want (0, 0, 0, 1)")
        # the device sees exactly one kernel, K4: no fold, copy or cast
        seen = device_kernels(torch, lambda: attention.flash_attention(
            q, k, v, causal=causal))
        log({"phase": "k4_one_kernel", "case": name, "kernels": seen})
        if len(seen) != 1 or seen[0]["count"] != 1 or \
                "attention_sm90" not in seen[0]["name"]:
            raise AssertionError(f"flash_attention {name}: one profiled "
                                 f"call ran {seen}, want K4 alone")
        qf, kf, vf = fold(q), fold(k), fold(v)
        want = attention.flash_attention_reference(qf, kf, vf, causal=causal)
        got = fold(out)
        use = elementwise_use(got, want, tol)
        sdpa_use = elementwise_use(
            sdpa(torch, q, k, v, causal).reshape(b * h, s_q, d), want, tol)
        if out.shape != q.shape or out.dtype != q.dtype or \
                not bool(torch.isfinite(out).all()) or not use <= 1:
            raise AssertionError(
                f"flash_attention {name}: output {tuple(out.shape)} "
                f"{out.dtype}, finite={bool(torch.isfinite(out).all())}, "
                f"{use:.3g} of the bound against the plain version")
        if not sdpa_use <= 1:
            raise AssertionError(f"SDPA {name}: {sdpa_use:.3g} of the bound "
                                 f"against the plain version; it is no "
                                 f"yardstick for this function")
        # K4 on the folded inputs, read as (b·h, s, 1, d)
        one = lambda t: t[:, :, None]
        k4_ms = median_ms(lambda: attention.flash_attention(
            one(qf), one(kf), one(vf), causal=causal), reps=KERNEL_REPS)
        entry_ms = median_ms(lambda: attention.flash_attention(
            q, k, v, causal=causal), reps=KERNEL_REPS)
        plain_ms = median_ms(lambda: attention.flash_attention_reference(
            qf, kf, vf, causal=causal), n=5, warmup=1)
        sdpa_ms = median_ms(lambda: sdpa(torch, q, k, v, causal),
                            reps=KERNEL_REPS)
        # K1 on the same folded inputs: the same tile loop, K1's epilogue
        k1_ms = median_ms(lambda: attention.flash_attention_partials(
            qf, kf, vf, causal=causal), reps=KERNEL_REPS)
        # QK^T and PV over the visible pairs; q, k, v read and o written
        flops = 4 * d * b * h * visible_pairs(s_q, s_k, causal)
        n_bytes = 2 * b * h * d * (2 * s_q + 2 * s_k)
        bound_ms, bound_by = bound(flops, n_bytes)
        row = {"phase": "k4_path", "case": name, "causal": causal,
               "q_shape": list(q.shape), "kv_shape": list(k.shape),
               "launches": counts[3], "max_abs_err": float(
                   (got.float() - want.float()).abs().max()),
               "bound_use": use, "sdpa_bound_use": sdpa_use, "tol": tol,
               "k4_ms": k4_ms, "flash_attention_ms": entry_ms,
               "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
               "k1_same_inputs_ms": k1_ms, "flop": flops,
               "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": bound_by,
               "k4_tflops": flops / k4_ms / 1e9,
               "flash_attention_tflops": flops / entry_ms / 1e9,
               "roofline_share": bound_ms / k4_ms, "card": card}
        log(row)
        rows.append(row)
        if causal:
            profile_run(torch, lambda: attention.flash_attention(
                q, k, v, causal=True), entry_ms, card, "flash_attention")
        del q, k, v, out, want, got, qf, kf, vf
    return rows


def device_kernels(torch, fn, tries: int = 3):
    """The device kernels of one warm call of ``fn``, by torch.profiler:
    [{"name", "count"}].  The profiler now and then returns a trace with
    no device record at all (seen on H100 machines whose other traces
    were whole); such a trace says nothing of what ran, so it is taken
    again, up to ``tries`` times.  A trace with any kernel is returned
    as it is."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    kernels = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = [{"name": e.key[:120], "count": e.count}
                for e in prof.key_averages() if e.device_type == kernels]
        if seen:
            break
    return seen


KERNEL_NAMES = ("partials_sm90", "attention_sm90", "partials_f32",
                "attention_f32", "dkdv_sm90", "dq_sm90", "dkdv_kernel",
                "dq_kernel")


def ptxas_table(report: str):
    """Registers and spills of every kernel in an nvcc -Xptxas=-v report:
    [{"kernel", "registers", "spill_stores", "spill_loads"}], and the
    count of ptxas's notes that it serialised wgmma instructions."""
    rows, current = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            base = next((k for k in KERNEL_NAMES if k in mangled), mangled)
            ints = re.findall(r"Li(\d+)E", mangled)
            dtype = "bf16" if ("sm90" in base or "bfloat16" in mangled) \
                else "f32"
            current = {"kernel": f"{base}<{dtype}{''.join(',' + i for i in ints)}>"}
            rows.append(current)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return rows, sum("C7512" in line for line in report.splitlines())


def check_ptxas(_build, lib, bwd_lib) -> None:
    """Every kernel's registers and spills from its nvcc report, and the
    bf16 forward tiles (BQ, BK, threads, dynamic shared memory) and backward
    tiles; a spill or a serialised wgmma anywhere fails."""
    import ctypes
    spills, serialised = [], {}
    for src in _build.sources():
        rows, notes = ptxas_table(_build.report(src.stem))
        log({"phase": "ptxas", "source": src.name, "kernels": rows,
             "wgmma_serialised_notes": notes})
        spills += [r["kernel"] for r in rows
                   if r.get("spill_stores", 0) or r.get("spill_loads", 0)]
        if notes:
            serialised[src.name] = notes
    tiles = {}
    for d in (64, 128, 256):
        out = (ctypes.c_int * 4)()
        lib.flash_attention_tile(d, out)
        tiles[d] = dict(zip(("bq", "bk", "threads", "smem_bytes"), out))
    log({"phase": "fwd_tiles", "by_padded_head_dim": tiles})
    # d 64 and 128: the Hopper kernels; d 256: the wmma loop
    tiles = {}
    for d in (64, 128, 256):
        out = (ctypes.c_int * 7)()
        bwd_lib.flash_bwd_tile(d, out)
        tiles[d] = dict(zip(("k2_bq", "k2_bk", "k3_bq", "k3_bk", "threads",
                             "k2_smem_bytes", "k3_smem_bytes"), out))
    log({"phase": "bwd_tiles", "by_padded_head_dim": tiles})
    if spills:
        raise AssertionError(f"ptxas spilled registers in {spills}")
    if serialised:
        raise AssertionError(f"ptxas serialised wgmma in {serialised}")


def profile_run(torch, fn, ref_ms: float, card: str, what: str,
                want_launches=None, log_fn=log) -> None:
    """Where one warm run of ``fn`` spends device time: kernel time by name
    from torch.profiler, and the device's idle share of the unprofiled time
    ``ref_ms`` (the profiler's own overhead lengthens the profiled wall
    time, so that is reported but not used).  ``want_launches`` maps
    kernel classes to the launches the run must show."""
    prof, spans, wall_ms = traced(torch, fn, warm=True, cpu=True)
    kernels = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if e.device_type == kernels
              and not e.key.startswith(ANNOTATIONS)]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    shares = idle_shares(spans, ref_ms)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    # the host's time inside operators (dispatch and launch, inflated by
    # the profiler's own cost); the rest of the host's time is Python
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and not e.key.startswith("ProfilerStep")]
    host_top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]
    by_class = {}
    for e in events:
        cls = next((c for c, marks in KERNEL_CLASSES
                    if any(m in e.key for m in marks)), "other")
        ms, count = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + e.self_device_time_total / 1e3,
                         count + e.count)
    out = {"phase": "profile", "what": what, "profiled_wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "unprofiled_ms": ref_ms,
           "host_ops_ms": sum(e.self_cpu_time_total for e in ops) / 1e3,
           "host_top": [{"name": e.key[:60], "count": e.count,
                         "host_ms": e.self_cpu_time_total / 1e3}
                        for e in host_top],
           **shares, "card": card,
           "by_class": {c: {"device_ms": ms, "launches": n}
                        for c, (ms, n) in sorted(by_class.items())},
           "top": [{"name": e.key[:90], "count": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in top]}
    log_fn(out)
    for cls, n in (want_launches or {}).items():
        seen = by_class.get(cls, (0.0, 0))[1]
        if seen != n:
            raise AssertionError(f"profile of {what}: {seen} launches of "
                                 f"{cls}, want {n}")
    return out


# kernels only: an operator's device time repeats its kernels', the
# ProfilerStep annotation spans the whole step, and c10d's "nccl:<op>"
# annotation on the device timeline repeats its NCCL kernel
ANNOTATIONS = ("ProfilerStep", "nccl:")


def traced(torch, fn, warm: bool, cpu: bool):
    """A torch.profiler trace of one call of ``fn`` (after an unrecorded
    warm-up call when ``warm``; host operators too when ``cpu``): the
    profile, its kernels' (start, end, is NCCL) spans and the recorded
    call's wall ms.  A trace with no kernel at all is taken again, up to
    3 times (on one card the profiler has returned such empty traces)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    kernels = torch.autograd.DeviceType.CUDA
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for _ in range(3):
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=int(warm), active=1,
                                       repeat=1)) as prof:
            for _ in range(1 + int(warm)):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        spans = [(e.time_range.start, e.time_range.end, "nccl" in e.name)
                 for e in prof.events() if e.device_type == kernels
                 and not e.name.startswith(ANNOTATIONS)]
        if spans:
            break
    return prof, spans, wall_ms


def idle_shares(spans, ref_ms: float) -> dict:
    """The device busy as the union of the kernels' intervals (NCCL's
    stream overlaps the compute stream's, and an NCCL kernel spans its
    wait for late peers, so the kernels' sum can pass the wall time), and
    its idle share of the unprofiled ``ref_ms``; also without NCCL's
    kernels (``compute_idle_share``).  No kernel seen means the profiler
    could not trace the card: the shares are then not measured (None),
    not 100% idle."""
    union_ms = interval_union(spans) / 1e3
    compute_ms = interval_union([sp for sp in spans if not sp[2]]) / 1e3
    return {"device_union_ms": union_ms, "compute_union_ms": compute_ms,
            "kernels": len(spans),
            "nccl_kernels": sum(1 for sp in spans if sp[2]),
            "idle_share": 1 - union_ms / ref_ms if spans else None,
            "compute_idle_share": 1 - compute_ms / ref_ms if spans
            else None}


def interval_union(spans) -> float:
    """The length of the union of (start, end, ...) intervals."""
    total, end = 0.0, None
    for start, stop, *_ in sorted(spans):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def rel_rms(a, b) -> float:
    return float(((a - b).square().mean() / b.square().mean()).sqrt())


def bound(flops: float, n_bytes: float):
    """The least time the card could take: (bound ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def launch_counts(attention):
    """K1, K2, K3 and K4 launches since the counts were last set to 0."""
    return (attention.launches, attention.dkdv_launches,
            attention.dq_launches, attention.attention_launches)


def zero_counts(attention) -> None:
    attention.launches = attention.dkdv_launches = 0
    attention.dq_launches = attention.attention_launches = 0


def clone_tree(optim, tree):
    return optim.tree_map(lambda t: t.clone(), tree)


def grads_rel_rms(got, want) -> float:
    """Relative RMS over all leaves together."""
    num = sum(float((a.float() - b.float()).square().sum())
              for a, b in zip(got, want))
    return math.sqrt(num / sum(float(b.float().square().sum())
                               for b in want))


def run_steps(tfm, cfg, params, tokens, n: int):
    init_opt, step = tfm.make_train_step(cfg, learning_rate=1e-3)
    state, losses = init_opt(params), []
    for _ in range(n):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    return losses


def train_path(torch, tfm, optim, attention, cfg, pristine, tokens):
    """The slice's main path: make_train_step at full width.  Returns the
    K1/K2/K3/K4 launches of its first step."""
    n = cfg.n_layers
    init_opt, step = tfm.make_train_step(cfg, learning_rate=1e-3)
    params = clone_tree(optim, pristine)
    state = init_opt(params)
    zero_counts(attention)
    params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    per_step = launch_counts(attention)
    # K1 runs in the forward and again in the remat recompute; K2 and K3
    # once per layer in the backward; K4 is off the path
    want = (2 * n if cfg.remat != "none" else n, n, n, 0)
    if per_step != want:
        raise AssertionError(f"K1/K2/K3/K4 launches in one train step: "
                             f"{per_step}, want {want}")
    losses = [float(loss)]
    for _ in range(TRAIN_STEPS - 1):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    log({"phase": "train_path", "config": dataclasses.asdict(cfg)
         | {"dtype": str(cfg.dtype)}, "batch": BATCH,
         "tokens_shape": list(tokens.shape), "learning_rate": 1e-3,
         "k1_k2_k3_k4_launches_per_step": list(per_step), "losses": losses})
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train losses on one repeated batch: {losses}")
    del params, state

    # attn="dense" from the same weights and batch: no K1/K2/K3 launch
    dense = dataclasses.replace(cfg, attn="dense")
    before = launch_counts(attention)
    dense_losses = run_steps(tfm, dense, clone_tree(optim, pristine), tokens,
                             3)
    # the train step's own value-and-grad, from the pristine weights
    grads = lambda c: tfm.value_and_grad(clone_tree(optim, pristine),
                                         tokens, c)[1]
    g_dense = grads(dense)
    torch.cuda.synchronize()
    if launch_counts(attention) != before:
        raise AssertionError("the dense train path launched a kernel")
    g_flash = grads(cfg)
    rel = grads_rel_rms(g_flash, g_dense)
    g_truth = grads(dataclasses.replace(dense, dtype=torch.float32))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, dense_losses))
    log({"phase": "train_flash_vs_dense", "flash_losses": losses[:3],
         "dense_losses": dense_losses, "loss_max_rel_diff": loss_rel,
         "loss_bound": TRAIN_LOSS_REL, "grad_rel_rms": rel,
         "grad_bound": TRAIN_GRAD_RMS,
         "flash_vs_f32_grad_rel_rms": grads_rel_rms(g_flash, g_truth),
         "dense_vs_f32_grad_rel_rms": grads_rel_rms(g_dense, g_truth)})
    if not (loss_rel < TRAIN_LOSS_REL and rel < TRAIN_GRAD_RMS):
        raise AssertionError(f"flash vs dense train: loss rel diff "
                             f"{loss_rel:.3g} (bound {TRAIN_LOSS_REL}), grad "
                             f"rel RMS {rel:.3g} (bound {TRAIN_GRAD_RMS})")
    return per_step


def timed_steps(torch, step, params, state, tokens, n: int = TIMED_STEPS):
    """``n`` chained train steps, each between two CUDA events: the params
    and state after them, each step's ms, the host's ms to issue each
    (nothing in a step waits for the card: near the step's ms, it is
    host-bound) and each step's loss."""
    times, host, losses = [], [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    return params, state, times, host, losses


def time_train(torch, tfm, optim, cfg, pristine, tokens, card,
               profile=False, mesh=None, log_fn=log, attention=None) -> dict:
    """Log and return the median ms of TIMED_STEPS chained train steps
    after WARMUP_STEPS, by CUDA events, with the peak memory of the run;
    on a ``mesh``, the step of this rank's shards (MFU over its cards).
    With ``attention``, the K1-K4 launches of the first step too."""
    init_opt, step = tfm.make_train_step(cfg, mesh, learning_rate=1e-3)
    params = (clone_tree(optim, pristine) if mesh is None
              else tfm.shard_params(pristine, mesh, cfg))
    cards = 1 if mesh is None else mesh.mesh.numel()
    state = init_opt(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = None
    for i in range(WARMUP_STEPS):
        if i == 0 and attention is not None:
            zero_counts(attention)
        params, state, _ = step(params, state, tokens)
        if i == 0 and attention is not None:
            torch.cuda.synchronize()
            launches = list(launch_counts(attention))
    params, state, times, host, losses = timed_steps(torch, step, params,
                                                     state, tokens)
    ms = statistics.median(times)
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    tokens_per_s = n_tokens / ms * 1e3
    row = {"phase": "train_numbers", "attn": cfg.attn, "remat": cfg.remat,
           "mesh": None if mesh is None else dict(zip(
               mesh.mesh_dim_names, mesh.mesh.shape)), "cards": cards,
           "step_ms": ms, "step_ms_all": times,
           "host_issue_ms": statistics.median(host),
           "tokens_per_step": n_tokens,
           "tokens_per_s": tokens_per_s,
           "mfu": tokens_per_s * tfm.train_flops_per_token(cfg)
           / (PEAK_BF16_FLOPS * cards),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "bytes_before_run": base, "final_loss": losses[-1],
           "card": card}
    if launches is not None:
        row["k1_k2_k3_k4_launches_per_step"] = launches
    log_fn(row)
    if profile:
        def one_step():
            nonlocal params, state
            params, state, _ = step(params, state, tokens)
        n = cfg.n_layers if cfg.attn == "flash" else 0
        what = "train_step" if mesh is None else f"mesh_step {row['mesh']}"
        profile_run(torch, one_step, ms, card, what, {
            "K1 partials_sm90": 2 * n if cfg.remat != "none" else n,
            "K2 dkdv": n, "K3 dq": n, "K4 attention_sm90": 0},
            log_fn=log_fn)
    del params, state
    return row


# -- 9. device collectives (DeviceComm on NCCL) -------------------------------

# bench.py's sweep: float32 counts a rank (8 B to 64 MB) and its seven
# collectives, R = 8 rank rows (its single-device regime keeps all eight
# on one device; with n processes each holds 8/n).
COLL_ROWS = 8
COLL_SIZES = [2, 256, 16 * 1024, 262_144, 4 * 1024 * 1024,
              16 * 1024 * 1024]
COLLS = ["allreduce", "bcast", "allgather", "reduce_scatter", "alltoall",
         "allgatherv", "alltoallv"]
# the nccl-tests bus-bandwidth factors bench.py uses, at R ranks
BUS_FACTOR = {
    "allreduce": lambda R: 2 * (R - 1) / R, "bcast": lambda R: 1.0,
    "reduce_scatter": lambda R: (R - 1) / R, "allgather": lambda R: R - 1.0,
    "allgatherv": lambda R: R - 1.0, "alltoall": lambda R: (R - 1) / R,
    "alltoallv": lambda R: (R - 1) / R,
    "alltoallv_rows": lambda R: (R - 1) / R}
# f32 reductions held to the CPU tests' rtol (the inputs are small
# integers, so the sums are exact in any order); bf16 to 1e-2; data that
# only moves, bitwise
COLL_RTOL = {"float32": 1e-6, "bfloat16": 1e-2}
# elements of each row the gradient allreduce's check holds at a time
# (8 rows of float32: 2 GiB a chunk)
GRAD_CHUNK = 1 << 26


def coll_global(torch, dc, t):
    """The global result as numpy (bf16 as float32), every process's rows
    gathered (to_ranks)."""
    full = torch.stack(dc.to_ranks(t))
    return (full.float() if full.dtype == torch.bfloat16 else full).numpy()


def coll_agree(np, got, want, rtol) -> bool:
    if got.shape != want.shape:
        return False
    if rtol is None:
        return bool(np.array_equal(got, want))
    return bool(np.allclose(got, want, rtol=rtol, atol=0))


def coll_cases(torch, np, dc, R: int):
    """(method, run, want, rtol): run() gives the method's global result on
    the card, want its MPI result computed in numpy from the same inputs,
    as tests/test_device_coll.py states each; rtol None = bitwise."""
    from ompi_tpu_torch import op as ops
    from ompi_tpu_torch import topo as topos
    rng = np.random.default_rng(0)
    n = dc.n
    ints = lambda *s, lo=-8, hi=9: rng.integers(lo, hi, s).astype(np.float32)
    dev = lambda a: dc.from_ranks(list(a))
    glob = lambda t: coll_global(torch, dc, t)
    rep = lambda row: np.broadcast_to(row, (R,) + row.shape).copy()
    cases = []
    add = lambda name, run, want, rtol=None: cases.append(
        (name, run, want, rtol))

    x = ints(R, 64)
    add("allreduce sum", lambda: glob(dc.allreduce(dev(x))), rep(x.sum(0)),
        1e-6)
    add("allreduce max", lambda: glob(dc.allreduce(dev(x), ops.MAX)),
        rep(x.max(0)))
    add("allreduce min", lambda: glob(dc.allreduce(dev(x), ops.MIN)),
        rep(x.min(0)))
    xp = ints(R, 64, lo=-2, hi=3)
    add("allreduce prod", lambda: glob(dc.allreduce(dev(xp), ops.PROD)),
        rep(xp.prod(0)), 1e-6)
    xi = rng.integers(0, 1 << 20, (R, 64)).astype(np.int32)
    add("allreduce band (all-gather and fold)",
        lambda: glob(dc.allreduce(dev(xi), ops.BAND)),
        rep(np.bitwise_and.reduce(xi, 0)))
    user = ops.Op.create(lambda a, b: a + b + 1, name="sum_plus_one")
    add("allreduce user op", lambda: glob(dc.allreduce(dev(x), user)),
        rep(x.sum(0) + R - 1), 1e-6)
    add("allreduce bf16",
        lambda: glob(dc.allreduce(dev(x).to(torch.bfloat16))),
        rep(x.sum(0)), COLL_RTOL["bfloat16"])
    add("reduce", lambda: glob(dc.reduce(dev(x), root=2)), rep(x.sum(0)),
        1e-6)
    root = min(5, R - 1)
    add("bcast", lambda: glob(dc.bcast(dev(x), root)), rep(x[root]))
    x3 = ints(R, 4, 2)
    add("allgather", lambda: glob(dc.allgather(dev(x3))),
        rep(x3.reshape(R * 4, 2)))
    add("gather", lambda: glob(dc.gather(dev(x3), root=1)),
        rep(x3.reshape(R * 4, 2)))
    add("allgather_dedup", lambda: glob(dc.allgather_dedup(dev(x3))),
        np.broadcast_to(x3.reshape(R * 4, 2), (n, R * 4, 2)).copy())
    add("dedup_to_ranks", lambda: torch.stack(dc.dedup_to_ranks(
        dc.allgather_dedup(dev(x3)), R)).numpy(), rep(x3.reshape(R * 4, 2)))
    xs = ints(R, R * 6)
    add("reduce_scatter sum", lambda: glob(dc.reduce_scatter(dev(xs))),
        xs.sum(0).reshape(R, 6), 1e-6)
    add("reduce_scatter max",
        lambda: glob(dc.reduce_scatter(dev(xs), ops.MAX)),
        xs.max(0).reshape(R, 6))
    xa = ints(R, R, 3)
    add("alltoall", lambda: glob(dc.alltoall(dev(xa))), np.swapaxes(xa, 0, 1))
    add("ring_shift 3", lambda: glob(dc.ring_shift(dev(x), 3)),
        np.roll(x, 3, 0))
    add("ring_shift 4 in 2 steps",
        lambda: glob(dc.ring_shift(dev(x), 4, steps=2)), np.roll(x, 4, 0))
    pushed = x.copy()
    pushed[1 % R] = x[(R - 2) % R]
    add("push_row", lambda: glob(dc.push_row(dev(x), R - 2, 1 % R)), pushed)
    inc = np.cumsum(x, 0)
    add("scan sum", lambda: glob(dc.scan(dev(x))), inc, 1e-6)
    add("scan sum exclusive", lambda: glob(dc.scan(dev(x), exclusive=True)),
        np.concatenate([np.zeros_like(x[:1]), inc[:-1]]), 1e-6)
    add("scan max", lambda: glob(dc.scan(dev(x), ops.MAX)),
        np.maximum.accumulate(x, 0))
    add("from_ranks/to_ranks", lambda: glob(dev(x3)), x3)
    add("from_local/to_local", lambda: dc.to_local(dc.from_local(
        x3[dc.pos * (R // n):(dc.pos + 1) * (R // n)])).numpy(),
        x3[dc.pos * (R // n):(dc.pos + 1) * (R // n)])
    full = ints(3, 4 * n)
    add("canonicalize", lambda: glob(dc.canonicalize(torch.from_numpy(
        np.split(full, n, 1)[dc.pos].copy()).to(dc.device), 1)),
        np.stack(np.split(full, n, 1)))

    # ragged and rooted
    counts = [int(c) for c in rng.integers(1, 6, R)]
    rows = [ints(c) for c in counts]
    cat = np.concatenate(rows)
    add("pad_ragged/unpad_ragged",
        lambda: np.concatenate([t.numpy() for t in dc.unpad_ragged(
            *dc.pad_ragged(rows))]), cat)
    add("allgatherv", lambda: glob(dc.allgatherv(*dc.pad_ragged(rows))),
        rep(cat))
    add("gatherv", lambda: glob(dc.gatherv(*dc.pad_ragged(rows), root=0)),
        rep(cat))
    xsc = ints(R, R, 2)
    add("scatter", lambda: glob(dc.scatter(dev(xsc), root=root)), xsc[root])
    add("scatterv",
        lambda: glob(dc.scatterv(dev(xsc), [2] * R, root=root)), xsc[root])
    C = rng.integers(0, 4, (R, R))
    cap = max(1, int(C.max()))
    blocks = ints(R, R, cap)
    out_cap = dc._bucket(max(1, int(C.sum(0).max())))
    add("alltoallv", lambda: glob(dc.alltoallv(dev(blocks), C)[0]),
        dc.compact_ragged_blocks(blocks, C, out_cap))
    dense = ints(R, max(1, int(C.sum(1).max())), 2)
    add("alltoallv_from_rows slice_cap 2",
        lambda: glob(dc.alltoallv_from_rows(dev(dense), C, 2)[0]),
        dc.compact_from_rows(dense, C, out_cap))
    add("alltoallv_from_rows", lambda: glob(dc.alltoallv_from_rows(
        dev(dense), C)[0]), dc.compact_from_rows(dense, C, out_cap))
    idx = rng.integers(-1, 6, (R, 9))
    src = ints(R, 6, 2)
    want = np.where((idx >= 0)[..., None],
                    np.take_along_axis(src, np.maximum(idx, 0)[..., None],
                                       1), 0).astype(np.float32)
    add("row_gather", lambda: glob(dc.row_gather(dev(src), idx)), want)
    vc = [1, 2, 3, 2, 1, 2, 3, 2][:R]
    xv = ints(R, sum(vc))
    vcap = dc._bucket(max(vc))
    displ = np.concatenate([[0], np.cumsum(vc)[:-1]])
    for name, red, op in (("sum", xv.sum(0), ops.SUM),
                          ("max", xv.max(0), ops.MAX)):
        want = np.zeros((R, vcap), np.float32)
        for i, (d, c) in enumerate(zip(displ, vc)):
            want[i, :c] = red[d:d + c]
        add(f"reduce_scatter_v {name}", lambda op=op: glob(
            dc.reduce_scatter_v(dev(xv), vc, op)), want, 1e-6)

    # neighbourhood collectives: one rank a process
    dims = [2, n // 2] if n % 2 == 0 and n > 2 else [n]
    cart = topos.CartTopo(dims, [True] * len(dims))
    xn = ints(n, 3)
    k = 2 * len(dims)
    add("neighbor_allgather_cart", lambda: glob(
        dc.neighbor_allgather_cart(dev(xn), cart)),
        np.stack([xn[cart.neighbors(i)] for i in range(n)]))
    xk = ints(n, k, 3)
    add("neighbor_alltoall_cart", lambda: glob(
        dc.neighbor_alltoall_cart(dev(xk), cart)),
        np.stack([np.stack([xk[nb, j ^ 1] for j, nb in
                            enumerate(cart.neighbors(i))])
                  for i in range(n)]))
    # a graph of every degree the methods handle: a self-loop (one card),
    # a pair, and the reference's 4-rank graphs (0-1, 0-2, 1-3 for the
    # allgather; 0-1, 0-3, 1-2 for the alltoall)
    graphs = {1: [([1], [0])] * 2, 2: [([1, 2], [1, 0])] * 2,
              4: [([2, 4, 5, 6], [1, 2, 0, 3, 0, 1]),
                  ([2, 4, 5, 6], [1, 3, 0, 2, 1, 0])]}[n]
    graph = topos.GraphTopo(*graphs[0])
    deg = max(len(graph.neighbors(i)) for i in range(n))
    want = np.zeros((n, deg, 3), np.float32)
    for i in range(n):
        for j, nb in enumerate(graph.neighbors(i)):
            want[i, j] = xn[nb]
    add("neighbor_allgather_graph", lambda: glob(
        dc.neighbor_allgather_graph(dev(xn), graph)), want)
    graph2 = topos.GraphTopo(*graphs[1])
    deg = max(len(graph2.neighbors(i)) for i in range(n))
    xg = ints(n, deg, 3)
    want = np.zeros((n, deg, 3), np.float32)
    for j in range(n):
        for slot, s in enumerate(graph2.in_neighbors(j)):
            want[j, slot] = xg[s, graph2.out_neighbors(s).index(j)]
    add("neighbor_alltoall_graph", lambda: glob(
        dc.neighbor_alltoall_graph(dev(xg), graph2)), want)
    return cases


def coll_check(torch, np, dc, R: int, log_fn, skip=()) -> int:
    """Every DeviceComm method on the card against its numpy result (but
    the cases named in ``skip``); each comparison must also reject the
    result with one row planted wrong."""
    checked = 0
    for name, run, want, rtol in coll_cases(torch, np, dc, R):
        if name in skip:
            continue
        got = run()
        ok = coll_agree(np, got, want, rtol)
        bad = got.copy()
        last = bad.reshape(bad.shape[0], -1)[-1]
        last[:] = last * 1.1 + 1                   # one row 10% and 1 off
        planted = coll_agree(np, bad, want, rtol)
        err = (float(np.abs(got.astype(np.float64) - want).max())
               if got.shape == want.shape and got.size else 0.0)
        log_fn({"phase": "coll_check", "method": name,
                "shape": list(want.shape), "rtol": rtol, "max_abs_err": err,
                "planted_row_passes": planted, "ok": ok and not planted})
        if not ok:
            raise AssertionError(f"DeviceComm {name}: result differs from "
                                 f"its MPI semantics (max err {err})")
        if planted:
            raise AssertionError(f"DeviceComm {name}: a wrong row passes "
                                 f"the comparison")
        checked += 1
    dc.barrier()
    log_fn({"phase": "coll_check", "method": "barrier", "ok": True})
    return checked + 1


def coll_bytes(coll: str, R: int, n: int, b: int, total: int,
               out_cap: int) -> int:
    """Bytes one card must move for the collective (each input byte it
    holds read once, each output byte written once): b bytes a rank row,
    total valid ragged elements, out_cap the padded receive row."""
    r = R // n
    return {"allreduce": 2 * r * b, "bcast": b + r * b,
            "reduce_scatter": r * b + r * b // R,
            "allgather": r * b + R * b, "alltoall": 2 * r * b,
            "allgatherv": 4 * total // n + r * 4 * total,
            "alltoallv": r * b + r * 4 * out_cap,
            "alltoallv_rows": r * b + r * 4 * out_cap}[coll]


def coll_sweep(torch, np, dc, R: int, card: str, log_fn,
               staged: bool = True) -> list:
    """bench.py's sweep on the card: the device arm of every collective at
    every size by CUDA events, beside the staged arm bench.py times (device
    to host, numpy, host to device) and the HBM bound."""
    n = dc.n
    rng = np.random.default_rng(0)
    rows_out = []
    to_dev = lambda a: torch.from_numpy(np.require(a, requirements="CW")).to(
        dc.device)
    for count in COLL_SIZES:
        nbytes = count * 4
        host = rng.standard_normal((R, count), dtype=np.float32)
        x = dc.from_ranks(list(host))
        per = count // R
        vbase = [(per - per // 2) if j % 2 == 0 else (per + per // 2)
                 for j in range(R)]
        vbase[-1] += count - sum(vbase)
        vC = np.stack([np.roll(vbase, -i) for i in range(R)])
        for coll in COLLS:
            if coll in ("alltoall", "reduce_scatter") and count % R:
                continue
            if coll in ("allgatherv", "alltoallv") and per < 1:
                continue
            row_nbytes, total, out_cap = nbytes, count, 0
            if coll == "allreduce":
                dev = lambda: dc.allreduce(x)

                def host_arm():
                    h = x.cpu().numpy()
                    to_dev(np.broadcast_to(h.sum(0, dtype=np.float32),
                                           h.shape))
            elif coll == "bcast":
                dev = lambda: dc.bcast(x, 0)

                def host_arm():
                    h = x.cpu().numpy()
                    to_dev(np.broadcast_to(h[0], h.shape))
            elif coll == "reduce_scatter":
                dev = lambda: dc.reduce_scatter(x)

                def host_arm():
                    h = x.cpu().numpy()
                    to_dev(h.sum(0, dtype=np.float32).reshape(R, count // R))
            elif coll == "allgather":
                xg = x.reshape(x.shape[0], 1, count)
                dev = lambda: dc.allgather_dedup(xg)

                def host_arm():
                    h = x.cpu().numpy()
                    to_dev(np.broadcast_to(h.reshape(1, -1), (n, R * count)))
            elif coll == "alltoall":
                xt = x.reshape(x.shape[0], R, count // R)
                dev = lambda: dc.alltoall(xt)

                def host_arm():
                    h = xt.cpu().numpy()
                    to_dev(np.swapaxes(h, 0, 1).reshape(R, count))
            elif coll == "allgatherv":
                vx, vcounts = dc.pad_ragged(
                    [host[i, :c] for i, c in enumerate(vbase)])
                row_nbytes = dc._bucket(max(vbase)) * 4
                dev = lambda: dc.allgatherv(vx, vcounts)

                def host_arm():
                    h = vx.cpu().numpy()
                    cat = np.concatenate([h[i, :c]
                                          for i, c in enumerate(vbase)])
                    to_dev(np.broadcast_to(cat, (R, len(cat))))
            else:
                vcap = dc._bucket(int(vC.max()))
                out_cap = dc._bucket(int(vC.sum(axis=0).max()))
                if R * R * vcap * 4 > 1 << 27:
                    # bench.py's switch: past 128 MiB of padded blocks the
                    # dense-rows exchange, with no padding anywhere
                    coll = "alltoallv_rows"
                    dev = lambda: dc.alltoallv_from_rows(x, vC)

                    def host_arm():
                        to_dev(dc.compact_from_rows(x.cpu().numpy(), vC,
                                                    out_cap))
                else:
                    blocks = dc.pack_ragged_blocks(host, vC, vcap)
                    bx = dc.from_ranks(list(blocks))
                    row_nbytes = R * vcap * 4
                    dev = lambda: dc.alltoallv(bx, vC)

                    def host_arm():
                        to_dev(dc.compact_ragged_blocks(bx.cpu().numpy(), vC,
                                                        out_cap))
            big = nbytes >= 1 << 24
            # KERNEL_REPS calls in a row, so that the host's launch time
            # of one call hides behind the device work of the one before
            dev_ms = median_ms(dev, n=10 if big else 20, warmup=10,
                               reps=KERNEL_REPS)
            # the staged arm is 100x slower from 16 MB up: one call there
            staged_ms = (median_ms(host_arm, n=1 if big else 3,
                                   warmup=0 if big else 1)
                         if staged else None)
            bound_b = coll_bytes(coll, R, n, nbytes, total, out_cap)
            bound_ms = bound_b / PEAK_BYTES * 1e3
            row = {"phase": "coll_numbers", "collective": coll,
                   "bytes_per_rank": row_nbytes, "ranks": R, "cards": n,
                   "device_ms": dev_ms,
                   "device_GBps": row_nbytes / dev_ms / 1e6,
                   "busbw_GBps": BUS_FACTOR[coll](R) * row_nbytes / dev_ms
                   / 1e6,
                   "staged_ms": staged_ms,
                   "speedup_vs_staged": (staged_ms / dev_ms if staged
                                         else None),
                   "bound_bytes": bound_b, "bound_ms": bound_ms,
                   "bound_share": bound_ms / dev_ms, "card": card}
            log_fn(row)
            rows_out.append(row)
        del x
        torch.cuda.empty_cache()
    return rows_out


def grad_err(torch, got, want) -> float:
    """The largest error of the r result rows ``got`` against the float32
    sum ``want``, over the largest value of ``want``."""
    return float((got.float() - want).abs().max() / want.abs().max())


def grad_allreduce(torch, dc, R: int, numel: int, card: str, log_fn) -> dict:
    """The allreduce at the flagship's gradient size: numel bf16 elements a
    rank row, R rows (r on this card).  Every element of every row is held
    against a float32 sum, GRAD_CHUNK elements at a time, and a block
    planted wrong in the middle of the last row must fail that check;
    timed by CUDA events."""
    r = R // dc.n
    gen = torch.Generator(device=dc.device).manual_seed(dc.pos)
    x = torch.empty((r, numel), dtype=torch.bfloat16, device=dc.device)
    x.normal_(generator=gen)
    out = dc.allreduce(x)
    mid = numel // 2
    errs, planted = [], None
    for lo in range(0, numel, GRAD_CHUNK):
        part = slice(lo, min(lo + GRAD_CHUNK, numel))
        want = x[:, part].float().sum(0)
        torch.distributed.all_reduce(want, group=dc.group)
        # bf16 rounds the fold once and NCCL's sum once a hop: the error
        # over the part's largest value, 1e-2 as the CPU tests' bf16 rtol
        errs.append(grad_err(torch, out[:, part], want))
        if lo <= mid < part.stop:
            bad = out[:, part].clone()
            blk = bad[-1, mid - lo:mid - lo + 4096]
            blk.mul_(1.1).add_(1)                  # 10% and 1 off
            planted = grad_err(torch, bad, want)
            del bad
        del want
    err = max(errs)
    if not err <= COLL_RTOL["bfloat16"]:
        raise AssertionError(f"gradient allreduce: error {err} of the "
                             f"largest value")
    if planted <= COLL_RTOL["bfloat16"]:
        raise AssertionError("gradient allreduce: a block planted wrong in "
                             "the middle of a row passes the check")
    del out
    ms = median_ms(lambda: dc.allreduce(x), n=10, warmup=2)
    # the call's three parts, timed alone: the local fold of the r rows,
    # the NCCL all-reduce of the folded row, the copies into the r rows
    from ompi_tpu_torch.op import SUM
    from ompi_tpu_torch.parallel.collectives import _repeat_rows
    red = dc._fold_local(x, SUM)
    parts = {"fold": median_ms(lambda: dc._fold_local(x, SUM), n=5),
             "nccl": median_ms(lambda: torch.distributed.all_reduce(
                 red, group=dc.group), n=5),
             "rows": median_ms(lambda: _repeat_rows(red, r), n=5)}
    del red
    b = numel * 2
    bound_b = coll_bytes("allreduce", R, dc.n, b, numel, 0)
    bound_ms = bound_b / PEAK_BYTES * 1e3
    row = {"phase": "coll_numbers", "collective": "flagship_grad_allreduce",
           "dtype": "bfloat16", "elements_per_rank": numel,
           "bytes_per_rank": b, "ranks": R, "cards": dc.n, "device_ms": ms,
           "device_GBps": b / ms / 1e6,
           "busbw_GBps": BUS_FACTOR["allreduce"](R) * b / ms / 1e6,
           "bound_bytes": bound_b, "bound_ms": bound_ms,
           "bound_share": bound_ms / ms, "err_of_max": err,
           "planted_block_err": planted, "chunks_checked": len(errs),
           "parts_ms": parts, "card": card}
    log_fn(row)
    del x
    torch.cuda.empty_cache()
    return row


def device_coll(torch, np, dc, card: str, grad_numel: int, log_fn,
                staged: bool = True) -> list:
    """Phase 9 on a comm: the checks, bench.py's sweep and the flagship's
    gradient allreduce.  Returns the rows of the collectives line."""
    n = dc.n
    if COLL_ROWS % n:
        raise ValueError(f"{COLL_ROWS} rows do not divide over {n} cards")
    t0 = time.perf_counter()
    coll_check(torch, np, dc, COLL_ROWS, log_fn)
    t1 = time.perf_counter()
    rows = coll_sweep(torch, np, dc, COLL_ROWS, card, log_fn, staged)
    t2 = time.perf_counter()
    rows.append(grad_allreduce(torch, dc, COLL_ROWS, grad_numel, card,
                               log_fn))
    log_fn({"phase": "device_coll_seconds", "check": t1 - t0,
            "sweep": t2 - t1, "grad_allreduce": time.perf_counter() - t2})
    return [{k: v for k, v in row.items() if k not in ("phase", "card")}
            for row in rows]


# -- 10. the flagship on a mesh -----------------------------------------------

# 10a: the flagship's causal q, k, v cut into RING_SP sequence shards and
# every (my, src) hop run through ring.ring_block(block_impl="pallas"): K1
# with the hop's global offsets, its f32 o, m and l rounded to bf16 as the
# reference rounds them.  Each hop is held to its plain version rounded
# the same way (partials_agree at TOL; m also gets BF16_STEP of |m|: both
# sides round their f32 m to bf16, and f32 values a few bits apart can
# round to neighbouring bf16 values, 2^-7 apart at most).  The hops merged
# in ring order by ring._merge in bf16 and normalised, as ring_attention
# does, are held to flash_attention (K4) on the whole sequence at RING_TOL
# of its largest value: each hop's rounding to bf16 (2^-8) and the bf16
# merge over four hops stay well inside it.
RING_SP = 4
RING_TOL = 2e-2
BF16_STEP = 2.0 ** -7
# 10b, 10c: the mesh step's losses over MESH_STEPS steps against the
# mesh-free step from the same weights and tokens.  "flash" at dp·sp·tp =
# 1·1·1 runs the same kernels and products as the mesh-free step, only the
# loss summed in another order: 1e-4 relative.  "ring" runs the
# reference's jnp block where the mesh-free step runs attention_reference:
# each rounds scores and probabilities to bf16 in other places, as flash
# and dense do (TRAIN_LOSS_REL, phase 7).
MESH_STEPS = 4
MESH_LOSS_REL = {"flash": 1e-4, "ring": TRAIN_LOSS_REL}
# ... and the first step's gradients, gathered from every rank's shards
# into the full tree, against the mesh-free step's, by relative RMS over
# all leaves: 1e-4 for "flash" at 1·1·1 (the same products), phase 7's
# TRAIN_GRAD_RMS for "ring" (bf16 rounding in other places, as flash
# against dense).  Each fault planted in mesh_faults must fail it.
MESH_GRAD_RMS = {"flash": 1e-4, "ring": TRAIN_GRAD_RMS}
# the multi-card entry's cards and its (dp, sp, tp) layouts on them
MULTI_CARDS = 4
MULTI_LAYOUTS = [(1, 2, 2), (2, 2, 1)]


def ring_hops(torch, attention, ring, cfg, card) -> dict:
    """Phase 10a: K1 on every hop of a RING_SP-member ring at the
    flagship's attention width.  Returns the K1 entry's ring figures."""
    b, s, h, d, n = BATCH, cfg.seq, cfg.n_heads, cfg.head_dim, RING_SP
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    q = q * Q_SCALE
    sl = s // n
    qs, ks, vs = ([fold(x)[:, i * sl:(i + 1) * sl].contiguous()
                   for i in range(n)] for x in (q, k, v))
    hops = [(my, (my - i) % n) for my in range(n) for i in range(n)]

    def run(fn):
        return {(my, src): fn(qs[my], ks[src], vs[src], my, src)
                for my, src in hops}

    zero_counts(attention)
    got = run(lambda q_, k_, v_, my, src: ring.ring_block(
        q_, k_, v_, my, src, causal=True, block_impl="pallas"))
    torch.cuda.synchronize()
    launches = launch_counts(attention)
    if launches != (n * n, 0, 0, 0):
        raise AssertionError(f"K1/K2/K3/K4 launches over the {n * n} ring "
                             f"hops: {launches}")
    plain = run(lambda q_, k_, v_, my, src: tuple(
        x.to(torch.bfloat16) for x in
        attention.flash_attention_partials_reference(
            q_, k_, v_, causal=True, q_offset=my * sl, kv_offset=src * sl)))

    def agree(parts, my, src):
        return partials_agree(torch, f"ring hop {my}<-{src}", "bfloat16",
                              parts[my, src], plain[my, src], qs[my],
                              ks[src], True, my * sl, src * sl, BF16_STEP)

    hop_err = max(agree(got, my, src) for my, src in hops)

    def merged(parts):
        outs = []
        for my in range(n):
            o = torch.zeros_like(qs[my])
            m = torch.full(o.shape[:2], -1e30, dtype=o.dtype, device="cuda")
            l = torch.zeros_like(m)
            for i in range(n):
                o, m, l = ring._merge(o, m, l, *parts[my, (my - i) % n])
            outs.append(o / torch.clamp_min(l, 1e-20)[..., None])
        return torch.cat(outs, dim=1).float()

    k4 = fold(attention.flash_attention(q, k, v, causal=True)).float()
    big = float(k4.abs().max())
    err = float((merged(got) - k4).abs().max())
    # a 10% fault on every row of one hop: the first shard's diagonal,
    # the only hop those rows see
    o, m, l = got[0, 0]
    bad = dict(got)
    bad[0, 0] = (o * 1.1, m, l)
    planted = float((merged(bad) - k4).abs().max())
    try:
        agree(bad, 0, 0)
        hop_rejects = False
    except AssertionError:
        hop_rejects = True
    row = {"phase": "ring_hops", "sp": n, "hops": len(hops),
           "k1_k2_k3_k4_launches": list(launches),
           "hop_max_abs_err": hop_err, "hop_tol": TOL["bfloat16"],
           "merged_vs_k4_err": err, "merged_bound": RING_TOL * big,
           "planted_merged_err": planted,
           "planted_hop_rejected": hop_rejects}
    log(row)
    if not (err <= RING_TOL * big and planted > RING_TOL * big
            and hop_rejects):
        raise AssertionError(f"ring hops: {row}")

    # one hop's time: the 16 launches in a row, per launch
    k1 = lambda q_, k_, v_, my, src: attention.flash_attention_partials(
        q_, k_, v_, causal=True, q_offset=my * sl, kv_offset=src * sl)
    ref = lambda q_, k_, v_, my, src: \
        attention.flash_attention_partials_reference(
            q_, k_, v_, causal=True, q_offset=my * sl, kv_offset=src * sl)
    hop_ms = median_ms(lambda: run(k1)) / len(hops)
    plain_ms = median_ms(lambda: run(ref), n=5, warmup=1) / len(hops)
    # the work the 16 hops need: the causal pairs of the whole sequence;
    # every hop writes o (f32), m and l, and only a hop that sees a key
    # (src <= my) reads its q, k and v: a hop wholly after its queries
    # writes the empty block's o = 0, m = -1e30, l = 0 from no input
    bh = b * h
    pairs = bh * s * (s + 1) // 2
    writes = bh * sl * d * 4 + 2 * bh * sl * 4
    reads = 3 * bh * sl * d * 2
    live = sum(src <= my for my, src in hops)
    hop_bound, hop_by = bound(4 * d * pairs,
                              len(hops) * writes + live * reads)
    out = {"ring_hop_launches": launches[0], "ring_hop_max_abs_err": hop_err,
           "ring_merged_vs_k4_err": err, "ring_hop_ms": hop_ms,
           "ring_hop_plain_ms": plain_ms,
           "ring_hop_bound_ms": hop_bound / len(hops),
           "ring_hop_bound_by": hop_by}
    log({"phase": "numbers", "metric": "ring_hop", **out, "card": card})
    return out


@contextlib.contextmanager
def planted(obj, name: str, value):
    """``obj.<name>`` replaced by ``value`` while the block runs."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def mesh_faults(torch, tfm, cfg, mesh) -> dict:
    """The faults the mesh gradient check must reject, by name, each a
    context that plants it: the gradient sum over dp × sp skipped (where
    that group has more than one member), with attn "ring" every rank's
    last hop dropped (its partials those of a block that sees no key), and
    with attn "flash" or "dense" on sp > 1 the Ulysses heads->seq exchange
    skipped."""
    from ompi_tpu_torch.parallel import ring
    dims = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    faults = {}
    if dims["dp"] * dims["sp"] > 1:
        faults["grad_sum_skipped"] = lambda: planted(
            tfm._Plan, "sync", lambda self, grads: None)
    if cfg.attn == "ring":
        real, sp = ring.ring_block, dims["sp"]

        def last_hop_dropped(q, k, v, my, src, *args):
            o, m, l = real(q, k, v, my, src, *args)
            if src != (my + 1) % sp:
                return o, m, l
            # zeros that keep the hop in the graph (its grads 0)
            return o * 0, torch.full_like(m, -1e30), l * 0

        faults["last_hop_dropped"] = lambda: planted(
            ring, "ring_block", last_hop_dropped)
    if cfg.attn != "ring" and dims.get("sp", 1) > 1:
        faults["heads_to_seq_skipped"] = heads_to_seq_skipped
    return faults


def mesh_grads(tfm, optim, cfg, mesh, pristine, tokens) -> list:
    """The mesh's gradients at ``pristine`` and ``tokens``, gathered from
    every rank's shards into the full tree's leaves."""
    return mesh_value_grads(tfm, optim, cfg, mesh, pristine, tokens)[1]


def mesh_losses(torch, tfm, optim, attention, cfg, mesh, pristine, tokens,
                ref_losses, want_launches, log_fn=log, bounds=None) -> dict:
    """The mesh step from ``pristine`` against the mesh-free step: the
    first step's gradients within MESH_GRAD_RMS, each planted fault
    outside it; then MESH_STEPS steps, the first step's K1-K4 launches
    ``want_launches``, the losses falling and within MESH_LOSS_REL of
    ``ref_losses`` (the mesh-free step's).  ``bounds`` = (loss, gradient)
    bounds in place of those two."""
    loss_bound, grad_bound = bounds or (MESH_LOSS_REL[cfg.attn],
                                        MESH_GRAD_RMS[cfg.attn])
    want = tfm.value_and_grad(clone_tree(optim, pristine), tokens, cfg)[1]
    grad_rel = grads_rel_rms(
        mesh_grads(tfm, optim, cfg, mesh, pristine, tokens), want)
    planted_rel = {}
    for name, fault in mesh_faults(torch, tfm, cfg, mesh).items():
        with fault():
            planted_rel[name] = grads_rel_rms(
                mesh_grads(tfm, optim, cfg, mesh, pristine, tokens), want)
    del want
    torch.cuda.empty_cache()
    init_opt, step = tfm.make_train_step(cfg, mesh, learning_rate=1e-3)
    params = tfm.shard_params(pristine, mesh, cfg)
    state = init_opt(params)
    losses = []
    for i in range(MESH_STEPS):
        if i == 0:
            zero_counts(attention)
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
        if i == 0:
            launches = launch_counts(attention)
    del params, state
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    row = {"phase": "mesh_step", "attn": cfg.attn, "mesh": dict(zip(
        mesh.mesh_dim_names, mesh.mesh.shape)), "losses": losses,
        "mesh_free_losses": ref_losses, "loss_max_rel_diff": rel,
        "loss_bound": loss_bound, "grad_rel_rms": grad_rel,
        "grad_bound": grad_bound,
        "planted_grad_rel_rms": planted_rel,
        "k1_k2_k3_k4_launches_per_step": list(launches)}
    log_fn(row)
    if launches != want_launches:
        raise AssertionError(f"mesh step {cfg.attn}: K1/K2/K3/K4 launches "
                             f"{launches}, want {want_launches}")
    bound_ = grad_bound
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] and rel < loss_bound
            and grad_rel < bound_
            and all(x > bound_ for x in planted_rel.values())):
        raise AssertionError(f"mesh step: {row}")
    return row


def mesh_world_of_one(torch, tfm, optim, attention, cfg, pristine, tokens,
                      card) -> list:
    """Phase 10b: the mesh step at dp·sp·tp = 1·1·1 in this process's
    world, attn "ring" and "flash", against the mesh-free step, and both
    timed."""
    from ompi_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    n = cfg.n_layers
    rows = []
    for attn, want in (("ring", (0, 0, 0, 0)), ("flash", (2 * n, n, n, 0))):
        c = dataclasses.replace(cfg, attn=attn)
        ref = run_steps(tfm, c, clone_tree(optim, pristine), tokens,
                        MESH_STEPS)
        row = mesh_losses(torch, tfm, optim, attention, c, mesh, pristine,
                          tokens, ref, want)
        torch.cuda.empty_cache()
        on_mesh = time_train(torch, tfm, optim, c, pristine, tokens, card,
                             mesh=mesh)
        torch.cuda.empty_cache()
        free = time_train(torch, tfm, optim, c, pristine, tokens, card)
        torch.cuda.empty_cache()
        rows.append({"attn": attn, "mesh": row["mesh"],
                     "loss_max_rel_diff": row["loss_max_rel_diff"],
                     "grad_rel_rms": row["grad_rel_rms"],
                     **{k: on_mesh[k] for k in
                        ("step_ms", "host_issue_ms", "tokens_per_s",
                         "mfu")},
                     **{f"mesh_free_{k}": free[k] for k in
                        ("step_ms", "host_issue_ms", "tokens_per_s",
                         "mfu")}})
    return rows


def mesh_multi_card(torch, np, tfm, optim, world: int, card: str,
                    log_fn) -> list:
    """Phase 10c: the flagship's mesh step, attn="ring", across four
    cards, each layout of MULTI_LAYOUTS against the one-card step from the
    same weights and tokens, and timed."""
    from ompi_tpu_torch.ops import attention
    cfg = dataclasses.replace(tfm.flagship_config(), attn="ring")
    pristine = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, cfg.seq + 1))).cuda()
    # every rank takes the one-card step itself: the same weights and
    # tokens give the same losses, and no rank waits on another
    ref = run_steps(tfm, cfg, clone_tree(optim, pristine), tokens,
                    MESH_STEPS)
    torch.cuda.empty_cache()
    one = time_train(torch, tfm, optim, cfg, pristine, tokens, card,
                     profile=True, log_fn=log_fn)
    # remat "none" beside "dots": what selective checkpointing costs the
    # host
    no_remat = dataclasses.replace(cfg, remat="none")
    one_none = time_train(torch, tfm, optim, no_remat, pristine, tokens,
                          card, log_fn=log_fn)
    torch.cuda.empty_cache()
    rows = []
    for dp, sp, tp in MULTI_LAYOUTS:
        mesh = world_mesh({"dp": dp, "sp": sp, "tp": tp})
        row = mesh_losses(torch, tfm, optim, attention, cfg, mesh, pristine,
                          tokens, ref, (0, 0, 0, 0), log_fn)
        torch.cuda.empty_cache()
        t = time_train(torch, tfm, optim, cfg, pristine, tokens, card,
                       profile=True, mesh=mesh, log_fn=log_fn)
        torch.cuda.empty_cache()
        t_none = time_train(torch, tfm, optim, no_remat, pristine, tokens,
                            card, mesh=mesh, log_fn=log_fn)
        torch.cuda.empty_cache()
        rows.append({"attn": "ring", "mesh": row["mesh"], "cards": world,
                     "loss_max_rel_diff": row["loss_max_rel_diff"],
                     "grad_rel_rms": row["grad_rel_rms"],
                     **{k: t[k] for k in ("step_ms", "host_issue_ms",
                                          "tokens_per_s", "mfu",
                                          "peak_bytes")},
                     **{f"one_card_{k}": one[k] for k in
                        ("step_ms", "host_issue_ms", "tokens_per_s",
                         "mfu")},
                     "remat_none": {"step_ms": t_none["step_ms"],
                                    "host_issue_ms": t_none["host_issue_ms"],
                                    "one_card_step_ms": one_none["step_ms"],
                                    "one_card_host_issue_ms":
                                        one_none["host_issue_ms"]}})
    return rows


# -- 12. the gradient-sync arms and comm/compute overlap (P8, P9) -----------

# 12a: the codec on the flagship's gradient elements (f32): a CODEC_SLICE
# slice held bitwise to the same function on CPU tensors, the whole tensor
# to the reference's error model (|x - deq(q(x))| <= amax/250 + 1e-7 a
# block, tests/test_quant_coll.py::test_quantize_roundtrip_error_model),
# which a block planted 10% off must fail.
QUANT_BLOCK = 256
CODEC_SLICE = 1 << 24
# 12b, 12d: the grad_sync arms, (mode, bucket bytes); native first
SYNC_ARMS = [("native", None), ("perleaf", None), ("bucketed", 4 << 20),
             ("bucketed", 64 << 20), ("quant", None), ("unsynced", None)]
SYNC_STEPS = 3
# 12d: perleaf and bucketed against native's gradients, relative RMS over
# all leaves: the same f32 sums of four contributions, in another order
# (NCCL's ring adds them in an order set by an element's place in the
# buffer, and a bucket moves it)
SYNC_GRAD_RMS = 1e-5
# the collectives a step may issue, counted by name while it runs
DIST_CALLS = ("all_reduce", "all_to_all_single", "all_gather_into_tensor",
              "reduce_scatter_tensor", "batch_isend_irecv", "broadcast")


@contextlib.contextmanager
def counting_collectives(torch):
    """The torch.distributed collective calls made while the block runs,
    by name (the port calls them through the module)."""
    dist = torch.distributed
    counts = dict.fromkeys(DIST_CALLS, 0)
    saved = {name: getattr(dist, name) for name in DIST_CALLS}

    def wrap(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in DIST_CALLS:
        setattr(dist, name, wrap(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def codec_check(torch, numel: int, card: str, log_fn=log) -> dict:
    """12a: quantize_blocks -> dequantize_blocks on ``numel`` f32 elements
    on the card: bitwise against the CPU on a slice, the error model on
    the whole, timed beside the bytes bound."""
    from ompi_tpu_torch.coll import quant
    b = QUANT_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(numel, generator=gen, device="cuda")
    q, sc = quant.quantize_blocks(x, b)
    back = quant.dequantize_blocks(q, sc, b)
    cq, cs = quant.quantize_blocks(x[:CODEC_SLICE].cpu(), b)
    cb = quant.dequantize_blocks(cq, cs, b)
    bits = lambda t: t.view(torch.int32)
    same = {"q": torch.equal(q[:CODEC_SLICE].cpu(), cq),
            "scales": torch.equal(bits(sc[:CODEC_SLICE // b].cpu()),
                                  bits(cs)),
            "values": torch.equal(bits(back[:CODEC_SLICE].cpu()), bits(cb))}
    bitwise = all(same.values())
    del cq, cs, cb

    def model_use(y) -> float:
        err = (y - x).abs().view(-1, b).amax(dim=-1)
        allow = x.abs().view(-1, b).amax(dim=-1) / 250.0 + 1e-7
        return float((err / allow).max())

    use = model_use(back)
    mid = (numel // b // 2) * b
    back[mid:mid + b] *= 1.1                     # one block 10% off
    planted = model_use(back)
    del back
    torch.cuda.empty_cache()
    q_ms = median_ms(lambda: quant.quantize_blocks(x, b), n=5, warmup=1)
    d_ms = median_ms(lambda: quant.dequantize_blocks(q, sc, b), n=5,
                     warmup=1)
    rt_ms = median_ms(lambda: quant.dequantize_blocks(
        *quant.quantize_blocks(x, b), b), n=5, warmup=1)
    # quantize reads x and writes q and the scales; dequantize the reverse
    one_way = numel * 4 + numel + numel // b * 4
    bound_ms = 2 * one_way / PEAK_BYTES * 1e3
    row = {"phase": "codec", "elements": numel, "block": b,
           "bitwise_slice_elements": CODEC_SLICE, "bitwise": same,
           "error_model_use": use, "planted_error_model_use": planted,
           "quantize_ms": q_ms, "dequantize_ms": d_ms,
           "round_trip_ms": rt_ms, "bound_bytes": 2 * one_way,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_share": bound_ms / rt_ms, "card": card}
    log_fn(row)
    del x, q, sc
    torch.cuda.empty_cache()
    if not (bitwise and use <= 1.0 and planted > 1.0):
        raise AssertionError(f"codec: {row}")
    return row


def _sync_cfg(cfg, mode, bucket_bytes):
    return dataclasses.replace(cfg, grad_sync=mode,
                               grad_bucket_bytes=bucket_bytes)


def _arm_name(mode, bucket_bytes) -> str:
    return mode if bucket_bytes is None else f"{mode} {bucket_bytes >> 20} MiB"


def grad_sync_one_card(torch, tfm, optim, cfg, pristine, tokens, card,
                       log_fn=log) -> list:
    """12b: each grad_sync arm on a {"dp": 1} mesh at full width: the loss
    and gradients of native's, no collective (the n = 1 short cuts), and
    the step timed beside native's (the host cost of the hooks)."""
    from ompi_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"dp": 1})
    rows, native = [], None
    for mode, nb in SYNC_ARMS:
        c = _sync_cfg(cfg, mode, nb)
        vg = tfm.make_value_and_grad(c, mesh)
        params = clone_tree(optim, pristine)
        with counting_collectives(torch) as calls:
            loss, grads = vg(params, tokens)
            torch.cuda.synchronize()
        del params
        if native is None:
            native = (float(loss), grads)
        rel = grads_rel_rms(grads, native[1])
        del grads
        torch.cuda.empty_cache()
        t = time_train(torch, tfm, optim, c, pristine, tokens, card,
                       mesh=mesh, log_fn=log_fn)
        torch.cuda.empty_cache()
        row = {"phase": "grad_sync_dp1", "arm": _arm_name(mode, nb),
               "loss": float(loss), "native_loss": native[0],
               "loss_equal": float(loss) == native[0],
               "grad_rel_rms_vs_native": rel,
               "collective_calls": sum(calls.values()),
               "step_ms": t["step_ms"], "host_issue_ms": t["host_issue_ms"],
               "native_step_ms": rows[0]["step_ms"] if rows else
               t["step_ms"], "card": card}
        log_fn(row)
        rows.append(row)
        if not (row["loss_equal"] and rel == 0.0
                and row["collective_calls"] == 0):
            raise AssertionError(f"grad_sync at dp 1: {row}")
    return rows


class _DoneWork:
    """A completed collective's handle (the planted skipped bucket)."""

    def wait(self):
        return True


@contextlib.contextmanager
def bucket_skipped(torch, which: int):
    """Planted: the ``which``-th asynchronous allreduce (a bucket's) is not
    issued, on every rank alike (no rank waits on another)."""
    dist = torch.distributed
    real, seen = dist.all_reduce, [0]

    def all_reduce(t, *args, async_op=False, **kwargs):
        if async_op:
            seen[0] += 1
            if seen[0] == which + 1:
                return _DoneWork()
        return real(t, *args, async_op=async_op, **kwargs)

    dist.all_reduce = all_reduce
    try:
        yield
    finally:
        dist.all_reduce = real


@contextlib.contextmanager
def scale_block_zeroed():
    """Planted: every quantization's first scale block set to 0."""
    from ompi_tpu_torch.coll import quant
    real = quant.quantize_blocks

    def zeroed(x, block, scale_dtype=None):
        q, sc = real(x, block, scale_dtype)
        sc = sc.clone()
        sc[..., 0] = 0
        return q, sc

    quant.quantize_blocks = zeroed
    try:
        yield
    finally:
        quant.quantize_blocks = real


def quant_model_use(torch, grads, local, group, n: int, block: int) -> float:
    """The quant arm's gradients against the codec's error model, leaf by
    leaf: every element within half a step of each contribution's block
    (averaged over the n contributions, all-gathered from every rank) and
    half a step of the output's block, from the exact mean.  Returns the
    largest error over its allowance (<= 1 passes).  Collective."""
    from ompi_tpu_torch.coll import quant
    worst = 0.0
    for got, mine in zip(grads, local):
        parts = torch.empty((n,) + tuple(mine.shape), dtype=mine.dtype,
                            device=mine.device)
        torch.distributed.all_gather_into_tensor(parts.view(-1),
                                                 mine.contiguous().view(-1),
                                                 group=group)
        L = mine.numel()
        pad = quant.padded_len(L, n, block) - L
        blocks = lambda t: torch.nn.functional.pad(
            t.reshape(t.shape[0], -1).float(), (0, pad)).view(
                t.shape[0], -1, block)
        contrib = blocks(parts)
        exact = contrib.mean(dim=0)
        out = blocks(got[None])[0]
        allow = (contrib.abs().amax(dim=-1).mean(dim=0) / 254.0
                 + out.abs().amax(dim=-1) / 254.0)
        err = (out - exact).abs().amax(dim=-1)
        worst = max(worst, float((err / (allow * (1 + 1e-4) + 1e-12))
                                 .max()))
        del parts, contrib, exact, out
    return worst


def grad_sync_multi_card(torch, np, tfm, optim, world: int, card: str,
                         log_fn) -> dict:
    """12d: the flagship train step at full width on a {"dp": world} mesh,
    one sequence a card, attn "flash", with every grad_sync arm: each
    arm's gradients held to native's (perleaf and bucketed within
    SYNC_GRAD_RMS, quant within the codec's error model, unsynced equal to
    this rank's own gradient), each planted fault rejected, SYNC_STEPS
    losses held to the one-card step's, then every arm timed under remat
    "dots" and "none" with bench.py's overlap efficiency and busbw."""
    from ompi_tpu_torch.coll import quant
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import make_mesh, overlap
    cfg = tfm.flagship_config()
    pristine = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, cfg.seq + 1))).cuda()
    mesh = make_mesh({"dp": world})
    group = mesh.get_group("dp")
    leaves = optim.tree_leaves(pristine)
    total_bytes = sum(p.numel() * 4 for p in leaves)
    ref = run_steps(tfm, cfg, clone_tree(optim, pristine), tokens,
                    SYNC_STEPS)
    torch.cuda.empty_cache()
    native = tfm.make_value_and_grad(cfg, mesh)(clone_tree(optim, pristine),
                                                tokens)[1]
    local = tfm.value_and_grad(clone_tree(optim, pristine),
                               overlap.dp_batch(tokens, mesh), cfg)[1]
    f32 = torch.float32
    native_wire = sum(quant.wire_bytes("allreduce", p.numel(), world,
                                       f32)["native_bytes"] for p in leaves)

    def wire(mode, nb) -> int:
        if mode == "unsynced":
            return 0
        if mode in ("native", "perleaf"):
            return native_wire
        if mode == "quant":
            return sum(quant.wire_bytes("allreduce", p.numel(), world, f32,
                                        cfg.grad_sync_block)["quant_bytes"]
                       for p in leaves)
        plan = overlap.bucket_plan(leaves, nb)
        arms = overlap._decide_buckets(plan, world, "cuda")
        return sum(quant.wire_bytes("allreduce", b.nbytes // 4, world, f32,
                                    cfg.grad_sync_block)[f"{a}_bytes"]
                   for b, a in zip(plan.buckets, arms))

    checks = []
    for mode, nb in SYNC_ARMS:
        c = _sync_cfg(cfg, mode, nb)
        vg = tfm.make_value_and_grad(c, mesh)
        zero_counts(attention)
        with counting_collectives(torch) as calls:
            loss, grads = vg(clone_tree(optim, pristine), tokens)
            torch.cuda.synchronize()
        launches = launch_counts(attention)
        row = {"phase": "grad_sync_check", "arm": _arm_name(mode, nb),
               "cards": world, "loss": float(loss),
               "collective_calls": {k: v for k, v in calls.items() if v},
               "buckets": (overlap.pvar_value("grad_bucket_count")
                           if mode == "bucketed" else None),
               "k1_k2_k3_k4_launches_per_step": list(launches),
               "wire_bytes": wire(mode, nb), "native_wire_bytes":
               native_wire}
        row["wire_ratio"] = row["wire_bytes"] / native_wire
        if mode in ("native", "perleaf", "bucketed"):
            row["grad_rel_rms_vs_native"] = grads_rel_rms(grads, native)
            ok = row["grad_rel_rms_vs_native"] <= SYNC_GRAD_RMS
            if mode == "bucketed":
                plan = overlap.bucket_plan(leaves, nb)
                with bucket_skipped(torch, plan.n_buckets // 2):
                    bad = vg(clone_tree(optim, pristine), tokens)[1]
                row["planted_bucket_skipped_rel_rms"] = grads_rel_rms(
                    bad, native)
                ok = ok and (row["planted_bucket_skipped_rel_rms"]
                             > SYNC_GRAD_RMS)
                del bad
        elif mode == "quant":
            row["grad_rel_rms_vs_native"] = grads_rel_rms(grads, native)
            row["error_model_use"] = quant_model_use(
                torch, grads, local, group, world, cfg.grad_sync_block)
            with scale_block_zeroed():
                bad = vg(clone_tree(optim, pristine), tokens)[1]
            row["planted_scale_zeroed_use"] = quant_model_use(
                torch, bad, local, group, world, cfg.grad_sync_block)
            ok = (row["error_model_use"] <= 1.0
                  and row["planted_scale_zeroed_use"] > 1.0)
            del bad
        else:
            row["grad_rel_rms_vs_local"] = grads_rel_rms(grads, local)
            ok = row["grad_rel_rms_vs_local"] == 0.0
        del grads
        torch.cuda.empty_cache()
        init_opt, step = tfm.make_train_step(c, mesh, learning_rate=1e-3)
        params = clone_tree(optim, pristine)
        state, losses = init_opt(params), []
        for _ in range(SYNC_STEPS):
            params, state, loss = step(params, state, tokens)
            losses.append(float(loss))
        del params, state
        torch.cuda.empty_cache()
        row["losses"], row["one_card_losses"] = losses, ref
        row["loss_max_rel_diff"] = max(abs(a - b) / abs(b)
                                       for a, b in zip(losses, ref))
        # unsynced trains each replica on its own rows: its losses are
        # shown, not held
        if mode != "unsynced":
            ok = ok and row["loss_max_rel_diff"] < TRAIN_LOSS_REL
        n = cfg.n_layers
        ok = ok and launches == (2 * n, n, n, 0)
        row["ok"] = ok
        log_fn(row)
        checks.append(row)
        if not ok:
            raise AssertionError(f"grad_sync {row['arm']}: {row}")
    del native, local
    torch.cuda.empty_cache()
    numbers = {}
    for remat in ("dots", "none"):
        times = {}
        for mode, nb in SYNC_ARMS:
            c = dataclasses.replace(_sync_cfg(cfg, mode, nb), remat=remat)
            arm = _arm_name(mode, nb)
            profile = remat == "none" and mode in ("native", "perleaf",
                                                   "bucketed") \
                and nb != 64 << 20
            t = time_train(torch, tfm, optim, c, pristine, tokens, card,
                           profile=profile, mesh=mesh, log_fn=log_fn)
            torch.cuda.empty_cache()
            times[arm] = {k: t[k] for k in ("step_ms", "host_issue_ms",
                                            "tokens_per_s", "mfu")}
        floor = times["unsynced"]["step_ms"]
        span = times["perleaf"]["step_ms"] - floor
        for arm, t in times.items():
            sync = t["step_ms"] - floor
            t["overlap_efficiency"] = (1 - sync / span if span > 0
                                       and arm != "unsynced" else None)
            t["busbw_GBps"] = (2 * (world - 1) / world * total_bytes
                               / (sync * 1e-3) / 1e9
                               if sync > 0 and arm != "unsynced" else None)
        numbers[remat] = times
        log_fn({"phase": "grad_sync_numbers", "remat": remat,
                "cards": world, "arms": times, "card": card})
    return {"checks": [{k: v for k, v in r.items() if k != "phase"}
                       for r in checks], "numbers": numbers}


def mesh_value_grads(tfm, optim, cfg, mesh, pristine, tokens):
    """The mesh's loss and gradients at ``pristine`` and ``tokens``, the
    gradients gathered from every rank's shards into the full tree's
    leaves."""
    params = tfm.shard_params(pristine, mesh, cfg)
    loss, grads = tfm.value_and_grad(params, tokens, cfg, mesh=mesh)
    of = dict(zip(map(id, optim.tree_leaves(params)), grads))
    tree = optim.tree_map(lambda p: of[id(p)], params)
    return float(loss), optim.tree_leaves(tfm.gather_params(tree, mesh,
                                                            cfg))


@contextlib.contextmanager
def rs_ring_last_partial_dropped():
    """Planted: matmul_reduce_scatter's ring adds no partial at its last
    hop (one rank's share of every row-parallel product lost)."""
    from ompi_tpu_torch.ops import collective_matmul as cm
    real = cm._rs_ring

    def dropped(x, w, group, bidir):
        import torch.distributed as dist
        mb = x.shape[-2] // dist.get_world_size(group)
        own = x.narrow(-2, dist.get_rank(group) * mb, mb)
        out = real(x, w, group, bidir)
        return out - (own @ w).to(out.dtype)

    cm._rs_ring = dropped
    try:
        yield
    finally:
        cm._rs_ring = real


def fused_multi_card(torch, np, tfm, optim, world: int, card: str,
                     log_fn) -> list:
    """12e: tp_overlap="fused" at (dp, sp, tp) = (1, 1, world), attn
    "dense", full width: the loss and gathered gradients against the
    unfused tp step's (phase 7's bf16 bounds), as decided and with the
    collmm rings forced bidirectional, a planted dropped partial rejected;
    each step timed beside the unfused one."""
    from ompi_tpu_torch.core import var
    from ompi_tpu_torch.parallel import make_mesh
    base = dataclasses.replace(tfm.flagship_config(), attn="dense")
    fused = dataclasses.replace(base, tp_overlap="fused")
    pristine = tfm.init_params(torch.Generator().manual_seed(0), base)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab, (BATCH, base.seq + 1))).cuda()
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": world})
    want_loss, want = mesh_value_grads(tfm, optim, base, mesh, pristine,
                                       tokens)
    unfused_t = time_train(torch, tfm, optim, base, pristine, tokens, card,
                           mesh=mesh, log_fn=log_fn)
    torch.cuda.empty_cache()
    rows = []
    for ring in ("", "bidir"):
        var.registry.set_override("coll_nccl_collmm_mode", ring)
        try:
            loss, got = mesh_value_grads(tfm, optim, fused, mesh, pristine,
                                         tokens)
            rel = grads_rel_rms(got, want)
            del got
            planted = None
            if not ring:
                with rs_ring_last_partial_dropped():
                    planted = grads_rel_rms(mesh_value_grads(
                        tfm, optim, fused, mesh, pristine, tokens)[1], want)
            torch.cuda.empty_cache()
            t = time_train(torch, tfm, optim, fused, pristine, tokens, card,
                           profile=not ring, mesh=mesh, log_fn=log_fn)
        finally:
            var.registry.set_override("coll_nccl_collmm_mode", "")
        torch.cuda.empty_cache()
        row = {"phase": "fused_step", "rings": ring or "decided",
               "mesh": {"dp": 1, "sp": 1, "tp": world}, "loss": loss,
               "unfused_loss": want_loss,
               "loss_rel_diff": abs(loss - want_loss) / abs(want_loss),
               "loss_bound": TRAIN_LOSS_REL, "grad_rel_rms": rel,
               "grad_bound": TRAIN_GRAD_RMS,
               "planted_partial_dropped_rel_rms": planted,
               "step_ms": t["step_ms"], "host_issue_ms": t["host_issue_ms"],
               "tokens_per_s": t["tokens_per_s"], "mfu": t["mfu"],
               "unfused_step_ms": unfused_t["step_ms"],
               "unfused_host_issue_ms": unfused_t["host_issue_ms"],
               "card": card}
        log_fn(row)
        rows.append({k: v for k, v in row.items() if k != "phase"})
        if not (row["loss_rel_diff"] < TRAIN_LOSS_REL
                and rel < TRAIN_GRAD_RMS
                and (planted is None or planted > TRAIN_GRAD_RMS)):
            raise AssertionError(f"fused step: {row}")
    return rows


# -- 13. serving: convert_params, the paged-KV engine, the scheduler --------

SERVE_PROMPT_LENS = (7, 23, 41, 64)      # four requests, 7-64 tokens
SERVE_NEW = 16                           # tokens answered a request
SERVE_PAGE = 16
SERVE_SEQS = 8
# f32: the reference's own bound on the engine against full-context greedy
# (tests/test_serving.py:221-223), max|diff| / max|want| over a request's
# logits
SERVE_REL = 1e-4
# bf16, teacher-forced: each step's logits against forward's last position,
# relative RMS; phase 5's bound (two bf16 paths that round in other places)
SERVE_BF16_RMS = FLASH_VS_DENSE_RMS
# both decode collectives forced onto quant at the reference test's block
# (tests/test_serving.py:316-339): logits within 0.05 relative of the
# native arm's, teacher-forced, and >= 75% of the tokens the same
SERVE_QUANT_REL = 0.05
SERVE_QUANT_MATCH = 0.75
SERVE_QUANT_BLOCK = 32
# 13c: the scheduler's stream
SCHED_N, SCHED_QPS = 32, 50.0
SCHED_PROMPT, SCHED_NEW = (64, 512), (16, 64)
# 13d: prefill lengths; decode steps at (max_seqs, context of every slot)
PREFILL_LENS = (128, 512, 2048)
DECODE_CASES = [(8, 512), (8, 2048), (32, 512), (32, 2048)]


def serve_prompts(np, vocab: int):
    rng = np.random.default_rng(13)
    return [rng.integers(0, vocab, n).tolist() for n in SERVE_PROMPT_LENS]


def serve_pages(n_tokens: int) -> int:
    return -(-n_tokens // SERVE_PAGE)


def serve_engine(tfm, dc, train, cfg, max_seqs: int, pages_per_seq: int):
    """An engine from this rank's train shards, with room for max_seqs
    sequences of pages_per_seq pages each (page 0 is scratch)."""
    from ompi_tpu_torch.serving.engine import ServingEngine
    return ServingEngine(dc, train, cfg, n_pages=max_seqs * pages_per_seq + 1,
                         page_size=SERVE_PAGE, max_seqs=max_seqs,
                         max_pages_per_seq=pages_per_seq)


def serve_requests(torch, np, eng, prompts, n_new: int, teacher=None,
                   corrupt=None):
    """Answer ``prompts`` together on ``eng``: every request admitted and
    prefilled, then n_new - 1 batched greedy decode steps; with
    ``teacher`` the tokens fed back come from it (teacher-forced).
    ``corrupt(eng, slots)`` runs after admission (a planted fault).
    Returns the token streams and each request's logits rows (n_new, V),
    this rank's, on the device."""
    cache = eng.cache
    slots = [cache.admit(len(p), n_new) for p in prompts]
    if corrupt is not None:
        corrupt(eng, slots)
    try:
        streams, rows = [], []
        for s, p in zip(slots, prompts):
            first, lg = eng.prefill(s, np.asarray(p))
            streams.append([first])
            rows.append([lg[0, 0]])
        for t in range(1, n_new):
            tokens = np.zeros(eng.max_seqs, np.int64)
            positions = np.full(eng.max_seqs, -1, np.int64)
            for i, s in enumerate(slots):
                tokens[s] = (streams[i][-1] if teacher is None
                             else teacher[i][t - 1])
                positions[s] = cache.seq_lens[s]
            nxt, lg = eng.decode_step(tokens, positions)
            for i, s in enumerate(slots):
                cache.seq_lens[s] += 1
                streams[i].append(int(nxt[s]))
                rows[i].append(lg[0, s])
    finally:
        for s in slots:
            cache.release(s)
    return streams, [torch.stack(r) for r in rows]


def serve_yardstick(torch, tfm, params, cfg, prompts, streams):
    """forward's last-position logits at every context the streams see
    (prompt + stream[:t]): the full-context recompute greedy does."""
    return [torch.stack([tfm.forward(params, [p + s[:t]], cfg)[0, -1]
                         for t in range(len(s))])
            for p, s in zip(prompts, streams)]


def serve_rel(got, want) -> float:
    """max|got - want| / max|want| of each request's logits, the largest
    over the requests (the reference test's measure)."""
    return max(float((g.float() - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def serve_step_rms(got, want) -> float:
    """The largest relative RMS of one step's logits."""
    return max(rel_rms(g[t].float(), w[t]) for g, w in zip(got, want)
               for t in range(len(w)))


def greedy_check(torch, tfm, attention, params, cfg, prompts) -> tuple:
    """13a's yardstick: ``tfm.greedy`` (attn="flash": full-context
    recompute, K1 a layer a forward) on each prompt, its K1 launches
    counted, and forward's logits at every context it saw."""
    zero_counts(attention)
    streams = [tfm.greedy(params, [p], SERVE_NEW, cfg)[0] for p in prompts]
    torch.cuda.synchronize()
    counts = launch_counts(attention)
    want = cfg.n_layers * SERVE_NEW * len(prompts)
    if counts != (want, 0, 0, 0):
        raise AssertionError(f"greedy's K1-K4 launches {counts}, want "
                             f"({want}, 0, 0, 0)")
    return streams, serve_yardstick(torch, tfm, params, cfg, prompts,
                                    streams), counts[0]


def check_dispatches(np, eng) -> dict:
    """One decode step (one live slot) issues 1 + 4 n_layers + 2 decode
    collectives, one of them decode_rs, and the engine's wire bytes equal
    the spc's coll_wire_bytes."""
    spc = eng.dc.spc
    slot = eng.cache.admit(1, 2)
    before = dict(eng.dispatches)
    wire0, spc0 = eng.wire_bytes, spc.get("coll_wire_bytes")
    tokens = np.zeros(eng.max_seqs, np.int64)
    positions = np.full(eng.max_seqs, -1, np.int64)
    positions[slot] = 0
    eng.decode_step(tokens, positions)
    eng.cache.release(slot)
    per_step = {k: eng.dispatches[k] - before[k] for k in before}
    row = {"dispatches_per_step": sum(per_step.values()),
           "decode_rs_per_step": per_step["decode_rs"],
           "want": 1 + 4 * eng.cfg.n_layers + 2,
           "wire_bytes": eng.wire_bytes - wire0,
           "spc_wire_bytes": spc.get("coll_wire_bytes") - spc0}
    if (row["dispatches_per_step"] != row["want"]
            or row["decode_rs_per_step"] != 1
            or row["wire_bytes"] != row["spc_wire_bytes"]
            or eng.wire_bytes != spc.get("coll_wire_bytes")):
        raise AssertionError(f"decode dispatch audit: {row}")
    return row


def serve_faults(torch, eng_mod):
    """The faults the engine checks must reject, by name: (name, the
    context that plants it, the corruption applied after admission)."""
    late = eng_mod._page_write
    attn = eng_mod._paged_attn

    def write_late(kp, vp, k, v, page_idx, offset):
        late(kp, vp, k, v, page_idx, (offset + 1) % SERVE_PAGE)

    def drop_last_page(q, kp, vp, bt, q_pos):
        bt = bt.clone()
        rows = torch.arange(bt.shape[0], device=bt.device)
        bt[rows, q_pos.clamp(min=0) // SERVE_PAGE] = 0   # the scratch page
        return attn(q, kp, vp, bt, q_pos)

    def shared_page(eng, slots):
        tables = eng.cache.block_tables
        tables[slots[1], 0] = tables[slots[0], 0]

    return [("page write one offset late",
             lambda: planted(eng_mod, "_page_write", write_late), None),
            ("block table points at another live slot's page",
             contextlib.nullcontext, shared_page),
            ("decode attention drops the last page",
             lambda: planted(eng_mod, "_paged_attn", drop_last_page), None)]


def fault_rows(torch, np, eng_mod, eng, prompts, check, teacher=None):
    """Each planted fault run through ``check(streams, rows) -> (ok, err)``:
    each must fail it."""
    out = []
    for name, ctx, corrupt in serve_faults(torch, eng_mod):
        with ctx():
            streams, rows = serve_requests(torch, np, eng, prompts, SERVE_NEW,
                                           teacher, corrupt)
        ok, err = check(streams, rows)
        out.append({"fault": name, "err": err, "rejected": not ok})
        if ok:
            raise AssertionError(f"the check passed the planted fault "
                                 f"{name!r} (err {err})")
    return out


def f32_check(want_streams, want_rows):
    """13a's check: the same tokens and logits within SERVE_REL."""
    def check(streams, rows):
        err = serve_rel(rows, want_rows)
        return streams == want_streams and err < SERVE_REL, err
    return check


def timed_ms(torch, fn, n: int = 10, warmup: int = 2) -> float:
    """Median host-clock ms of ``fn``, which ends in a device sync."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def decode_bound(cfg, n_params: int, max_seqs: int, context: int,
                 itemsize: int):
    """The least time one decode step could take: every weight read once
    and every live KV row read once (2 x heads x head_dim per layer), and
    the products' operations."""
    h = cfg.n_heads * cfg.head_dim
    kv = max_seqs * context * 2 * h * itemsize * cfg.n_layers
    flops = 2 * n_params * max_seqs + 4 * max_seqs * context * h * cfg.n_layers
    ms, by = bound(flops, n_params * itemsize + kv)
    return ms, by, n_params * itemsize, kv


def decode_step_ms(torch, np, tfm, dc, train, cfg, max_seqs: int,
                   context: int, profile=None) -> float:
    """decode_step with every slot at ``context`` (its keys 0..context-1
    live), median host-clock ms; ``profile`` (card, log_fn) also runs one
    profiled step, its row handed to log_fn."""
    eng = serve_engine(tfm, dc, train, cfg, max_seqs,
                       serve_pages(context + 1))
    for _ in range(max_seqs):
        eng.cache.admit(context, 1)
    tokens = np.arange(max_seqs, dtype=np.int64)
    positions = np.full(max_seqs, context - 1, np.int64)
    step = lambda: eng.decode_step(tokens, positions)
    ms = timed_ms(torch, step)
    if profile is not None:
        profile_run(torch, step, ms, profile[0], "decode_step",
                    log_fn=profile[1])
    del eng
    torch.cuda.empty_cache()
    return ms


def serve_one_card(torch, np, tfm, attention, card, log_fn=log) -> dict:
    """Phase 13 on one card, in phase 9's one-process world: 13a-13d."""
    from ompi_tpu_torch import serving, spc as spc_mod
    from ompi_tpu_torch.parallel import DeviceComm, make_mesh
    from ompi_tpu_torch.serving import engine as eng_mod
    from ompi_tpu_torch.serving.scheduler import (
        ContinuousBatchingScheduler, poisson_stream)
    cfg = tfm.flagship_config()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    n_params = sum(p.numel() for p in params["layers"][0].values()) * \
        cfg.n_layers + params["embed"].numel() + cfg.d_model
    mesh = make_mesh({"tp": 1})
    dc = DeviceComm(mesh, "tp")
    dc.spc = spc_mod.Counters()
    train = tfm.shard_params(params, mesh, cfg)
    prompts = serve_prompts(np, cfg.vocab)
    pages = serve_pages(max(SERVE_PROMPT_LENS) + SERVE_NEW)
    row = {"n_params": n_params}

    # 13a: f32, against full-context greedy (K1 launched)
    t0 = time.perf_counter()
    want_streams, want_rows, k1 = greedy_check(torch, tfm, attention, params,
                                               f32, prompts)
    eng = serve_engine(tfm, dc, train, f32, SERVE_SEQS, pages)
    # the serving path itself runs none of K1-K4 (prefill is
    # attention_reference, decode decode_attention, as in the reference)
    zero_counts(attention)
    streams, rows = serve_requests(torch, np, eng, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    engine_launches = launch_counts(attention)
    check = f32_check(want_streams, want_rows)
    ok, err = check(streams, rows)
    a = {"phase": "serve_f32", "requests": len(prompts),
         "prompt_lens": list(SERVE_PROMPT_LENS), "new_tokens": SERVE_NEW,
         "tokens_equal": streams == want_streams, "max_rel_err": err,
         "bound": SERVE_REL, "k1_launches_greedy": k1,
         "k1_k4_launches_engine": list(engine_launches),
         "audit": check_dispatches(np, eng),
         "faults": fault_rows(torch, np, eng_mod, eng, prompts, check),
         "seconds": time.perf_counter() - t0, "card": card}
    log_fn(a)
    if not ok or any(engine_launches):
        raise AssertionError(f"13a: engine against greedy: {a}")
    del eng
    torch.cuda.empty_cache()

    # 13b: bf16, teacher-forced along 13a's streams, against forward
    t0 = time.perf_counter()
    want_bf = serve_yardstick(torch, tfm, params, cfg, prompts, want_streams)
    sched_pages = max(pages, serve_pages(SCHED_PROMPT[1] + SCHED_NEW[1]))
    eng = serve_engine(tfm, dc, train, cfg, SERVE_SEQS, sched_pages)

    def bf16_check(streams, rows):
        e = serve_step_rms(rows, want_bf)
        return e < SERVE_BF16_RMS, e

    streams, rows = serve_requests(torch, np, eng, prompts, SERVE_NEW,
                                   teacher=want_streams)
    ok, err = bf16_check(streams, rows)
    b = {"phase": "serve_bf16", "max_step_rel_rms": err,
         "bound": SERVE_BF16_RMS,
         "tokens_equal_f32_greedy": streams == want_streams,
         "faults": fault_rows(torch, np, eng_mod, eng, prompts, bf16_check,
                              teacher=want_streams),
         "seconds": time.perf_counter() - t0, "card": card}
    log_fn(b)
    if not ok:
        raise AssertionError(f"13b: bf16 engine against forward: {b}")
    del want_bf, want_rows

    # 13c: the scheduler, continuous against static, on the same engine
    sched = {}
    for policy in ("continuous", "static"):
        serving.reset()
        serving.enable()
        reqs = poisson_stream(SCHED_N, SCHED_QPS, cfg.vocab, seed=1,
                              prompt_len=SCHED_PROMPT, max_new=SCHED_NEW)
        t0 = time.perf_counter()
        out = ContinuousBatchingScheduler(eng, reqs, policy=policy).run()
        rep = serving.report()
        serving.disable()
        sched[policy] = {
            "decode_steps": out["decode_steps"], "tokens": out["tokens"],
            "completed": out["completed"], "clock_s": out["clock_s"],
            "tokens_per_s": out["tokens_per_s"],
            "batch_occupancy": rep["batch_occupancy"],
            "decode_tokens_per_s": rep["goodput"]["decode_tokens_per_s"],
            "goodput": rep["goodput"], "itl": rep["itl"],
            "pages_used": eng.cache.pages_used,
            "wall_s": time.perf_counter() - t0,
            "streams": {rid: r["tokens"] for rid, r in out["results"].items()}}
    cont, stat = sched["continuous"], sched["static"]
    c = {"phase": "serve_scheduler", "requests": SCHED_N, "qps": SCHED_QPS,
         "prompt_len": list(SCHED_PROMPT), "max_new": list(SCHED_NEW),
         "streams_equal": cont["streams"] == stat["streams"],
         **{p: {k: v for k, v in s.items() if k != "streams"}
            for p, s in sched.items()}, "card": card}
    log_fn(c)
    if not (c["streams_equal"] and cont["completed"] == SCHED_N
            and cont["decode_steps"] < stat["decode_steps"]
            and cont["batch_occupancy"] > stat["batch_occupancy"]
            and cont["pages_used"] == stat["pages_used"] == 0):
        raise AssertionError(f"13c: scheduler: {c}")
    del eng
    torch.cuda.empty_cache()

    # 13d: numbers, bf16
    numbers = []

    def number(metric, value, **extra):
        r = {"phase": "serve_numbers", "metric": metric, "value": value,
             **extra, "card": card}
        log_fn(r)
        numbers.append({k: v for k, v in r.items() if k != "phase"})

    eng = serve_engine(tfm, dc, train, cfg, 1,
                       serve_pages(max(PREFILL_LENS) + 1))
    slot = eng.cache.admit(max(PREFILL_LENS), 1)
    rng = np.random.default_rng(14)
    for n in PREFILL_LENS:
        prompt = rng.integers(0, cfg.vocab, n)
        number("prefill_ms", timed_ms(torch, lambda: eng.prefill(slot, prompt),
                                      n=5, warmup=1), prompt_tokens=n)
    del eng
    torch.cuda.empty_cache()
    profiled = []

    def keep(obj):
        profiled.append(obj)
        log_fn(obj)

    for max_seqs, context in DECODE_CASES:
        profile = (card, keep) if (max_seqs, context) == DECODE_CASES[0] \
            else None
        ms = decode_step_ms(torch, np, tfm, dc, train, cfg, max_seqs, context,
                            profile)
        b_ms, by, w_bytes, kv_bytes = decode_bound(
            cfg, n_params, max_seqs, context, cfg.dtype.itemsize)
        number("decode_step_ms", ms, max_seqs=max_seqs, context=context,
               bound_ms=b_ms, bound_by=by, weight_bytes=w_bytes,
               kv_bytes=kv_bytes, bound_share=b_ms / ms,
               decode_tokens_per_s=max_seqs / ms * 1e3)
    p = profiled[0]
    number("decode_step_idle_share", p["idle_share"],
           max_seqs=DECODE_CASES[0][0], context=DECODE_CASES[0][1],
           device_busy_ms=p["device_busy_ms"], step_ms=p["unprofiled_ms"],
           launches=sum(c["launches"] for c in p["by_class"].values()))
    for policy in ("continuous", "static"):
        number("scheduler_tokens_per_s", sched[policy]["tokens_per_s"],
               policy=policy)
    del params, train
    torch.cuda.empty_cache()
    row.update({"f32": {k: v for k, v in a.items() if k != "phase"},
                "bf16": {k: v for k, v in b.items() if k != "phase"},
                "scheduler": {k: v for k, v in c.items() if k != "phase"},
                "numbers": numbers})
    return row


def serve_multi_card(torch, np, tfm, attention, world: int, card: str,
                     log_fn) -> dict:
    """13e: the flagship's shards on a {"tp": world} mesh over NCCL:
    convert_params bitwise against the decode layout cut from the whole
    tree, both ways; the three all_to_all plans timed; the f32 engine
    against one card's greedy (tokens equal, logits within SERVE_REL), its
    dispatch audit, the quant arm forced, a skipped decode_ag rejected;
    the bf16 decode step on four cards beside one card's."""
    from ompi_tpu_torch import optim, spc as spc_mod
    from ompi_tpu_torch.core import var
    from ompi_tpu_torch.parallel import DeviceComm, make_mesh
    from ompi_tpu_torch.parallel.mesh import sharded
    from ompi_tpu_torch.parallel.reshard import resharder
    cfg = tfm.flagship_config()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = make_mesh({"tp": world})
    train = tfm.shard_params(params, mesh, cfg)
    row = {}

    # convert_params, bitwise both ways
    dec = tfm.convert_params(train, mesh, cfg, to="decode")
    back = tfm.convert_params(dec, mesh, cfg, to="train")
    specs = tfm.decode_param_specs(cfg)

    def cut(x, spec, name):
        if name == "wqkv":
            x = tfm._qkv_by_heads(x, world)
        return sharded(mesh, *spec).local(x)

    want = {"embed": cut(params["embed"], specs["embed"], "embed"),
            "final_norm": params["final_norm"],
            "layers": [{k: cut(v, s[k], k) for k, v in lw.items()}
                       for lw, s in zip(params["layers"], specs["layers"])]}
    same = lambda t1, t2: all(torch.equal(x, y) for x, y in zip(
        optim.tree_leaves(t1), optim.tree_leaves(t2)))
    row["convert"] = {"decode_bitwise": same(dec, want),
                      "train_round_trip_bitwise": same(back, train)}
    del dec, back, want

    # the three all_to_all plans, timed
    rs = resharder(mesh)
    train_specs = tfm.param_specs(cfg)
    plans = []
    for name, x, src, dst in (
            ("embed", train["embed"], train_specs["embed"], specs["embed"]),
            ("wo", train["layers"][0]["wo"], train_specs["layers"][0]["wo"],
             specs["layers"][0]["wo"]),
            ("w_down", train["layers"][0]["w_down"],
             train_specs["layers"][0]["w_down"],
             specs["layers"][0]["w_down"])):
        shape = [n * (world if a else 1) for n, a in zip(x.shape, src)]
        plan = rs.plan(shape, x.dtype, src, dst)
        ms = median_ms(lambda: rs.run(x, src, dst), n=10)
        plans.append({"leaf": name, "steps": plan.describe(),
                      "shape": shape, "shard_bytes": plan.src_shard_bytes,
                      "wire_bytes": plan.wire_bytes, "ms": ms,
                      "wire_GBps": plan.wire_bytes / ms / 1e6})
    row["plans"] = plans
    if not (all(row["convert"].values())
            and all(p["steps"] == ["all_to_all[tp:0->1]"] for p in plans)):
        raise AssertionError(f"13e: convert_params: {row}")

    # the f32 engine against one card's greedy, on every rank
    prompts = serve_prompts(np, cfg.vocab)
    want_streams, want_rows, k1 = greedy_check(torch, tfm, attention, params,
                                               f32, prompts)
    dc = DeviceComm(mesh, "tp")
    dc.spc = spc_mod.Counters()
    pages = serve_pages(max(SERVE_PROMPT_LENS) + SERVE_NEW)
    eng = serve_engine(tfm, dc, train, f32, SERVE_SEQS, pages)
    streams, rows = serve_requests(torch, np, eng, prompts, SERVE_NEW)
    check = f32_check(want_streams, want_rows)
    ok, err = check(streams, rows)
    e = {"tokens_equal": streams == want_streams, "max_rel_err": err,
         "bound": SERVE_REL, "k1_launches_greedy": k1,
         "audit": check_dispatches(np, eng)}
    # both decode collectives forced onto quant, teacher-forced along the
    # native streams
    force = {"coll_nccl_decode_ag_mode": "quant",
             "coll_nccl_decode_rs_mode": "quant",
             "coll_quant_block": SERVE_QUANT_BLOCK}
    quant0 = dc.spc.get("coll_arm_quant_count")
    for name, value in force.items():
        var.registry.set_override(name, value)
    try:
        q_streams, q_rows = serve_requests(torch, np, eng, prompts, SERVE_NEW,
                                           teacher=streams)
    finally:
        for name in force:
            var.registry.set_override(name, var.registry.lookup(name).default)
    match = float(np.mean([a == b for qs, s in zip(q_streams, streams)
                           for a, b in zip(qs, s)]))
    e["quant"] = {"max_rel_err": serve_rel(q_rows, rows),
                  "bound": SERVE_QUANT_REL, "token_match": match,
                  "match_bound": SERVE_QUANT_MATCH, "block": SERVE_QUANT_BLOCK,
                  "quant_dispatches": dc.spc.get("coll_arm_quant_count")
                  - quant0}
    # planted: one decode_ag a forward returns only this rank's shard
    real = dc.allgather
    calls = [0]

    def own_shard_only(x):
        calls[0] += 1
        if calls[0] % (4 * cfg.n_layers + 2) == 2:   # layer 0's head combine
            return x.repeat(1, world, 1)
        return real(x)

    with planted(dc, "allgather", own_shard_only):
        f_streams, f_rows = serve_requests(torch, np, eng, prompts, SERVE_NEW)
    f_ok, f_err = check(f_streams, f_rows)
    e["fault_skipped_decode_ag"] = {"err": f_err, "rejected": not f_ok}
    row["engine_f32"] = e
    log_fn({"phase": "serve_multi_card", "cards": world, **e, "card": card})
    if not (ok and e["quant"]["max_rel_err"] < SERVE_QUANT_REL
            and match >= SERVE_QUANT_MATCH and e["quant"]["quant_dispatches"]
            and not f_ok):
        raise AssertionError(f"13e: engine on {world} cards: {e}")
    del eng, want_rows, rows, q_rows, f_rows
    torch.cuda.empty_cache()

    # the bf16 decode step on the tp mesh beside one card's (a {"dp":
    # world, "tp": 1} mesh: every rank its own one-card engine)
    max_seqs, context = DECODE_CASES[0]
    four = decode_step_ms(torch, np, tfm, dc, train, cfg, max_seqs, context)
    solo_mesh = make_mesh({"dp": world, "tp": 1})
    solo = DeviceComm(solo_mesh, "tp")
    solo.spc = spc_mod.Counters()
    one = decode_step_ms(torch, np, tfm, solo,
                         tfm.shard_params(params, solo_mesh, cfg), cfg,
                         max_seqs, context)
    row["decode_step"] = {"max_seqs": max_seqs, "context": context,
                          "cards": world, "ms": four, "one_card_ms": one,
                          "ratio": four / one}
    log_fn({"phase": "serve_numbers", "metric": "decode_step_ms_tp",
            **row["decode_step"], "card": card})
    del params, train
    torch.cuda.empty_cache()
    return row


# -- 14. speculative decoding and the fused decode program --------------------

# 14a/14c: the windows beside spec_k 0, on the phase-13 prompts
SPEC_KS = (2, 4)
# a stream may leave spec_k 0's only where that step's top-two logits are
# closer than this share of the larger (the window's products run at
# other shapes than the step's, so their last bits differ)
NEAR_TIE = 1e-5
# 14b: decode_window beside decode_step at (max_seqs, context), k of each
WINDOW_CASES = [(8, 512), (32, 512)]
WINDOW_KS = (2, 4)
# 14c: the fused step beside the eager one at (max_seqs, context)
FUSED_CASES = [(8, 512), (32, 512)]


def spec_requests(np, prompts):
    """The phase-13 prompts as requests, all arrived at 0, SERVE_NEW
    tokens each."""
    from ompi_tpu_torch.serving.scheduler import Request
    return [Request(rid=i, prompt=np.asarray(p, np.int64),
                    max_new=SERVE_NEW) for i, p in enumerate(prompts)]


def run_scheduler(eng, reqs, spec_k: int) -> dict:
    """One scheduler run with the serve plane on: streams in request
    order, decode steps, tokens/s, the speculative ledger, pages left."""
    from ompi_tpu_torch import serving
    from ompi_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
    serving.reset()
    serving.enable()
    try:
        t0 = time.perf_counter()
        out = ContinuousBatchingScheduler(eng, reqs, spec_k=spec_k).run()
        wall = time.perf_counter() - t0
        rep = serving.report()
    finally:
        serving.disable()
    return {"spec_k": spec_k, "decode_steps": out["decode_steps"],
            "tokens": out["tokens"], "tokens_per_s": out["tokens_per_s"],
            "clock_s": out["clock_s"], "wall_s": wall,
            "speculative": rep["speculative"],
            "pages_used": eng.cache.pages_used,
            "streams": [out["results"][r.rid]["tokens"] for r in reqs]}


def departures(streams, want, want_rows) -> list:
    """Where each stream first leaves ``want``: the index, both tokens,
    and the top-two margin of want's logits there over the larger
    (``want_rows``: each request's plain decode logits, row t giving
    token t)."""
    out = []
    for r, (got, ref) in enumerate(zip(streams, want)):
        i = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                 None)
        if i is None:
            if len(got) == len(ref):
                continue
            i = min(len(got), len(ref))
        if i >= len(want_rows[r]):
            gap = None
        else:
            top = want_rows[r][i].float().topk(2).values
            gap = float((top[0] - top[1]) / top[0].abs())
        out.append({"request": r, "index": i,
                    "got": got[i] if i < len(got) else None,
                    "want": ref[i] if i < len(ref) else None, "gap": gap,
                    "near_tie": gap is not None and gap < NEAR_TIE})
    return out


def spec_check(run, want, want_rows) -> dict:
    """One scheduler run against ``want``: a stream may leave it only at a
    near-tie (printed, not hidden), every page is released, and at
    spec_k >= 2 some draft was accepted (a verify loop that accepts
    nothing gives the same streams)."""
    run["departures"] = departures(run.pop("streams"), want, want_rows)
    run["identical"] = all(d["near_tie"] for d in run["departures"])
    run["ok"] = (run["identical"] and run["pages_used"] == 0
                 and (run["spec_k"] == 0
                      or run["speculative"]["accepted"] > 0))
    return run


def spec_identity(eng, reqs, want, want_rows, ks) -> dict:
    """The scheduler at spec_k 0 and each of ``ks`` through
    ``spec_check``."""
    return {k: spec_check(run_scheduler(eng, reqs, k), want, want_rows)
            for k in (0, *ks)}


@contextlib.contextmanager
def accept_one_past():
    """Planted: the verify loop accepts one draft past its last match."""
    from ompi_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
    real = ContinuousBatchingScheduler.__dict__["_accepted"]
    ContinuousBatchingScheduler._accepted = staticmethod(
        lambda d, y: min(real.__func__(d, y) + 1, len(d)))
    try:
        yield
    finally:
        ContinuousBatchingScheduler._accepted = real


@contextlib.contextmanager
def accept_none():
    """Planted: the verify loop accepts no draft (speculation a no-op)."""
    from ompi_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
    real = ContinuousBatchingScheduler.__dict__["_accepted"]
    ContinuousBatchingScheduler._accepted = staticmethod(lambda d, y: 0)
    try:
        yield
    finally:
        ContinuousBatchingScheduler._accepted = real


@contextlib.contextmanager
def no_rollback():
    """Planted: after a window every KV row is kept — seq_lens is never
    rolled back to the accepted prefix."""
    from ompi_tpu_torch.serving.scheduler import ContinuousBatchingScheduler

    def keep_all(self, slot, rows):
        self.engine.cache.seq_lens[slot] += self.spec_k

    with planted(ContinuousBatchingScheduler, "_truncate", keep_all):
        yield


def spec_faults(eng, reqs, want, want_rows, k: int) -> list:
    """Each planted fault of the verify loop must fail ``spec_check``."""
    out = []
    for name, ctx in (("a draft accepted one past its match",
                       accept_one_past),
                      ("seq_lens not rolled back after a rejection",
                       no_rollback),
                      ("no draft accepted", accept_none)):
        with ctx():
            run = spec_check(run_scheduler(eng, reqs, k), want, want_rows)
        ok = run["ok"]
        out.append({"fault": name, "spec_k": k,
                    "departures": len(run["departures"]),
                    "accepted": run["speculative"]["accepted"],
                    "rejected": not ok})
        if ok:
            raise AssertionError(f"the identity check passed the planted "
                                 f"fault {name!r}")
    return out


def case_engine(tfm, dc, train, cfg, max_seqs: int, context: int, k: int):
    """An engine with every slot at ``context`` (keys 0..context-1 live)
    and room for a k-token window past it."""
    eng = serve_engine(tfm, dc, train, cfg, max_seqs,
                       serve_pages(context + k))
    for _ in range(max_seqs):
        eng.cache.admit(context, k)
    return eng


def step_call(np, eng, context: int):
    tokens = np.arange(eng.max_seqs, dtype=np.int64)
    positions = np.full(eng.max_seqs, context - 1, np.int64)
    return lambda: eng.decode_step(tokens, positions)


def window_call(np, eng, context: int, k: int):
    b = eng.max_seqs
    tokens = np.arange(b * k, dtype=np.int64).reshape(b, k)
    positions = context - 1 + np.broadcast_to(np.arange(k), (b, k))
    return lambda: eng.decode_window(tokens, positions)


def interleaved_ms(torch, calls: dict, card: str, what: str, log_fn,
                   n: int = 10, warmup: int = 2) -> dict:
    """Median host-clock ms of each call (each ends in a device sync),
    timed in turns so the host's drift falls on all alike, then one
    profiled run each: idle share, device busy ms, launches, NCCL
    launches and the host's time inside operators."""
    for fn in calls.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in calls}
    for _ in range(n):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for name, fn in calls.items():
        ms = statistics.median(times[name])
        prof = profile_run(torch, fn, ms, card, f"{name} {what}",
                           log_fn=log_fn)
        out[name] = {"ms": ms, "ms_all": times[name],
                     "idle_share": prof["idle_share"],
                     "compute_idle_share": prof["compute_idle_share"],
                     "device_busy_ms": prof["device_busy_ms"],
                     "device_union_ms": prof["device_union_ms"],
                     "compute_union_ms": prof["compute_union_ms"],
                     "host_ops_ms": prof["host_ops_ms"],
                     "launches": sum(c["launches"]
                                     for c in prof["by_class"].values()),
                     "nccl_launches": prof["by_class"].get(
                         "NCCL", {"launches": 0})["launches"]}
    return out


def decode_one_card(torch, np, tfm, card, log_fn=log) -> dict:
    """Phase 14 on one card, in phase 9's one-process world after phase
    13: (a) f32, the scheduler on the phase-13 prompts at spec_k 0, 2 and
    4 with the same streams as plain decoding (near-ties excepted and
    printed), two planted faults of the verify loop rejected; (b) bf16,
    decode_window beside decode_step and the scheduler's tokens/s at each
    spec_k."""
    from ompi_tpu_torch import spc as spc_mod
    from ompi_tpu_torch.parallel import DeviceComm, make_mesh
    from ompi_tpu_torch.serving.scheduler import poisson_stream
    cfg = tfm.flagship_config()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = make_mesh({"tp": 1})
    dc = DeviceComm(mesh, "tp")
    dc.spc = spc_mod.Counters()
    train = tfm.shard_params(params, mesh, cfg)
    del params
    prompts = serve_prompts(np, cfg.vocab)
    reqs = spec_requests(np, prompts)
    # the longest request fills its block table: a window's rows past it
    # go to the scratch page
    pages = serve_pages(max(SERVE_PROMPT_LENS) + SERVE_NEW)
    row = {}

    # 14a: f32 stream identity against plain decoding
    t0 = time.perf_counter()
    eng = serve_engine(tfm, dc, train, f32, SERVE_SEQS, pages)
    want, want_rows = serve_requests(torch, np, eng, prompts, SERVE_NEW)
    runs = spec_identity(eng, reqs, want, want_rows, SPEC_KS)
    a = {"phase": "decode_check", "check": "spec_identity_f32", "tp": 1,
         "path": "eager", "requests": len(prompts), "new_tokens": SERVE_NEW,
         "near_tie": NEAR_TIE,
         "runs": runs,
         "faults": spec_faults(eng, reqs, want, want_rows, max(SPEC_KS)),
         "seconds": time.perf_counter() - t0, "card": card}
    log_fn(a)
    if not all(r["ok"] for r in runs.values()):
        raise AssertionError(f"14a: speculative streams: {a}")
    del eng, want_rows
    torch.cuda.empty_cache()
    row["spec_f32"] = {k: v for k, v in a.items() if k != "phase"}

    # 14b: bf16 numbers
    numbers = []

    def number(metric, value, **extra):
        r = {"phase": "decode_numbers", "metric": metric, "value": value,
             **extra, "card": card}
        log_fn(r)
        numbers.append({k: v for k, v in r.items() if k != "phase"})

    for max_seqs, context in WINDOW_CASES:
        eng = case_engine(tfm, dc, train, cfg, max_seqs, context,
                          max(WINDOW_KS))
        calls = {"decode_step": step_call(np, eng, context)}
        calls.update({f"decode_window k={k}": window_call(np, eng, context, k)
                      for k in WINDOW_KS})
        got = interleaved_ms(torch, calls, card, f"({max_seqs}, {context})",
                             log_fn)
        del eng, calls
        torch.cuda.empty_cache()
        step = got["decode_step"]
        number("decode_step_ms", step["ms"], max_seqs=max_seqs,
               context=context, **{k: v for k, v in step.items()
                                   if k != "ms"})
        for k in WINDOW_KS:
            w = got[f"decode_window k={k}"]
            number("decode_window_ms", w["ms"], max_seqs=max_seqs,
                   context=context, k=k, decode_step_ms=step["ms"],
                   window_over_step=w["ms"] / step["ms"],
                   **{key: v for key, v in w.items() if key != "ms"})
    sched_pages = serve_pages(SCHED_PROMPT[1] + SCHED_NEW[1])
    eng = serve_engine(tfm, dc, train, cfg, SERVE_SEQS, sched_pages)
    stream = poisson_stream(SCHED_N, SCHED_QPS, cfg.vocab, seed=1,
                            prompt_len=SCHED_PROMPT, max_new=SCHED_NEW)
    plain = None
    for k in (0, *SPEC_KS):
        run = run_scheduler(eng, stream, k)
        streams = run.pop("streams")
        plain = streams if plain is None else plain
        number("scheduler_tokens_per_s", run["tokens_per_s"], spec_k=k,
               decode_steps=run["decode_steps"], tokens=run["tokens"],
               clock_s=run["clock_s"], wall_s=run["wall_s"],
               acceptance_rate=run["speculative"]["acceptance_rate"],
               speculative=run["speculative"],
               streams_equal_spec0=streams == plain,
               pages_used=run["pages_used"])
        if run["pages_used"]:
            raise AssertionError(f"14b: spec_k {k} left pages held: {run}")
    del eng, train
    torch.cuda.empty_cache()
    row["numbers"] = numbers
    return row


@contextlib.contextmanager
def ag_ring_short(every: int):
    """Planted: the first allgather ring of every ``every`` (one a decode
    step) stops one hop short — the block its last hop brings is never
    placed."""
    import torch.distributed as dist
    from ompi_tpu_torch.ops import collective_matmul as cm
    real = cm._ag_ring
    calls = [0]

    def short(x, w, group, reverse, bidir):
        out, full = real(x, w, group, reverse, bidir)
        if calls[0] % every == 0:
            n, my = dist.get_world_size(group), dist.get_rank(group)
            m = x.shape[-2]
            last = (my + (-1 if reverse else 1)) % n
            out.narrow(-2, last * m, m).zero_()
        calls[0] += 1
        return out, full

    with planted(cm, "_ag_ring", short):
        yield


@contextlib.contextmanager
def rs_ring_partial_dropped(every: int):
    """Planted: the first reduce-scatter ring of every ``every`` (one a
    decode step) leaves out this rank's own partial."""
    import torch.distributed as dist
    from ompi_tpu_torch.ops import collective_matmul as cm
    real = cm._rs_ring
    calls = [0]

    def dropped(x, w, group, bidir):
        out = real(x, w, group, bidir)
        if calls[0] % every == 0:
            mb = x.shape[-2] // dist.get_world_size(group)
            own = x.narrow(-2, dist.get_rank(group) * mb, mb)
            out = out - (own @ w).to(out.dtype)
        calls[0] += 1
        return out

    with planted(cm, "_rs_ring", dropped):
        yield


def fused_audit(np, eng) -> dict:
    """One fused decode step (one live slot): 2 eager decode_ag, 4 n_layers
    + 1 decode_collmm, the rings' wire equal to ring_schedule's and the
    spc's wire moving by the engine's."""
    from ompi_tpu_torch.coll.quant import wire_bytes
    from ompi_tpu_torch.serving.fused import ring_schedule
    dc, cfg, b = eng.dc, eng.cfg, eng.max_seqs
    spc = dc.spc
    slot = eng.cache.admit(1, 2)
    before = dict(eng.dispatches)
    wire0, spc0 = eng.wire_bytes, spc.get("coll_wire_bytes")
    native0 = spc.get("coll_arm_native_count")
    tokens = np.zeros(b, np.int64)
    positions = np.full(b, -1, np.int64)
    positions[slot] = 0
    eng.decode_step(tokens, positions)
    eng.cache.release(slot)
    # the two eager AGs: the embed's d/tp and the logits' f32 V/tp columns
    eager = sum(wire_bytes("allgather", b * c // dc.n, dc.n, dt)
                ["native_bytes"] for c, dt in ((cfg.d_model, cfg.dtype),
                                               (cfg.vocab, np.float32)))
    sched = ring_schedule(cfg.n_layers, b, cfg.d_model, dc.n,
                          cfg.dtype.itemsize)
    step_wire = eng.wire_bytes - wire0
    row = {"rows": b, "dtype": str(cfg.dtype),
           "dispatches_per_step": {k: eng.dispatches[k] - before[k]
                                   for k in before},
           "want_collmm": 4 * cfg.n_layers + 1,
           "collmm_wire_bytes": step_wire - eager,
           "ring_schedule_wire_bytes": sum(w for _, _, w in sched),
           "spc_wire_bytes": spc.get("coll_wire_bytes") - spc0,
           "step_wire_bytes": step_wire,
           "spc_native_arms": spc.get("coll_arm_native_count") - native0}
    if (row["dispatches_per_step"] != {"decode_ag": 2, "decode_rs": 0,
                                       "decode_collmm": row["want_collmm"]}
            or row["collmm_wire_bytes"] != row["ring_schedule_wire_bytes"]
            or row["spc_wire_bytes"] != step_wire
            or row["spc_native_arms"] != 2 + row["want_collmm"]):
        raise AssertionError(f"fused decode audit: {row}")
    return row


def decode_multi_card(torch, np, tfm, world: int, card: str,
                      log_fn) -> dict:
    """14c: decode_overlap="fused" on a {"tp": world} mesh at full width:
    f32 tokens and logits against the eager engine's, two planted ring
    faults rejected, the audit (2 eager dispatches and 4 n_layers + 1
    decode_collmm a step, the rings' wire), spec_k 2 on the fused engine;
    bf16 teacher-forced against the eager engine; the fused step beside
    the eager one."""
    from ompi_tpu_torch import spc as spc_mod
    from ompi_tpu_torch.parallel import DeviceComm, make_mesh
    cfg = tfm.flagship_config()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = make_mesh({"tp": world})
    dc = DeviceComm(mesh, "tp")
    dc.spc = spc_mod.Counters()
    train = tfm.shard_params(params, mesh, cfg)
    del params
    prompts = serve_prompts(np, cfg.vocab)
    reqs = spec_requests(np, prompts)
    # the longest request fills its block table: a window's rows past it
    # go to the scratch page
    pages = serve_pages(max(SERVE_PROMPT_LENS) + SERVE_NEW)
    fused = lambda c: dataclasses.replace(c, decode_overlap="fused")
    rings = 2 * cfg.n_layers + 1        # AG rings a step (RS: n_layers)
    row = {}

    # f32: the fused engine against the eager one
    t0 = time.perf_counter()
    eng = serve_engine(tfm, dc, train, f32, SERVE_SEQS, pages)
    want, want_rows = serve_requests(torch, np, eng, prompts, SERVE_NEW)
    del eng
    eng = serve_engine(tfm, dc, train, fused(f32), SERVE_SEQS, pages)
    streams, rows = serve_requests(torch, np, eng, prompts, SERVE_NEW)
    check = f32_check(want, want_rows)
    ok, err = check(streams, rows)
    faults = []
    for name, ctx in (("an allgather ring short its last hop",
                       lambda: ag_ring_short(rings)),
                      ("a reduce-scatter ring drops this rank's partial",
                       lambda: rs_ring_partial_dropped(cfg.n_layers))):
        with ctx():
            f_streams, f_rows = serve_requests(torch, np, eng, prompts,
                                               SERVE_NEW)
        f_ok, f_err = check(f_streams, f_rows)
        faults.append({"fault": name, "err": f_err, "rejected": not f_ok})
    spec = spec_identity(eng, reqs, want, want_rows, (2,))
    c = {"phase": "decode_check", "check": "fused_f32", "tp": world,
         "tokens_equal_eager": streams == want, "max_rel_err": err,
         "bound": SERVE_REL, "audit": fused_audit(np, eng),
         "faults": faults,
         "spec": spec,
         "seconds": time.perf_counter() - t0, "card": card}
    log_fn(c)
    if not (ok and all(f["rejected"] for f in faults)
            and all(r["ok"] for r in spec.values())):
        raise AssertionError(f"14c: fused engine on {world} cards: {c}")
    del eng, want_rows, rows
    torch.cuda.empty_cache()
    row["f32"] = {k: v for k, v in c.items() if k != "phase"}

    # bf16, teacher-forced along the eager engine's streams
    t0 = time.perf_counter()
    eng = serve_engine(tfm, dc, train, cfg, SERVE_SEQS, pages)
    e_streams, e_rows = serve_requests(torch, np, eng, prompts, SERVE_NEW)
    del eng
    eng = serve_engine(tfm, dc, train, fused(cfg), SERVE_SEQS, pages)
    _, f_rows = serve_requests(torch, np, eng, prompts, SERVE_NEW,
                               teacher=e_streams)
    rms = serve_step_rms(f_rows, [r.float() for r in e_rows])
    b = {"phase": "decode_check", "check": "fused_bf16", "tp": world,
         "max_step_rel_rms": rms, "bound": SERVE_BF16_RMS,
         "audit": fused_audit(np, eng),
         "seconds": time.perf_counter() - t0, "card": card}
    log_fn(b)
    if not rms < SERVE_BF16_RMS:
        raise AssertionError(f"14c: bf16 fused engine: {b}")
    del eng, e_rows, f_rows
    torch.cuda.empty_cache()
    row["bf16"] = {k: v for k, v in b.items() if k != "phase"}

    # the fused step beside the eager one, bf16
    numbers = []
    for max_seqs, context in FUSED_CASES:
        engs = {path: case_engine(tfm, dc, train, c_, max_seqs, context, 1)
                for path, c_ in (("eager", cfg), ("fused", fused(cfg)))}
        got = interleaved_ms(torch, {p: step_call(np, e, context)
                                     for p, e in engs.items()}, card,
                             f"decode_step ({max_seqs}, {context}) on "
                             f"{world} cards", log_fn)
        del engs
        torch.cuda.empty_cache()
        r = {"phase": "decode_numbers", "metric": "fused_step_ms",
             "value": got["fused"]["ms"], "eager_ms": got["eager"]["ms"],
             "fused_over_eager": got["fused"]["ms"] / got["eager"]["ms"],
             "max_seqs": max_seqs, "context": context, "cards": world,
             "fused": got["fused"], "eager": got["eager"], "card": card}
        log_fn(r)
        numbers.append({k: v for k, v in r.items() if k != "phase"})
    del train
    torch.cuda.empty_cache()
    row["numbers"] = numbers
    return row


# -- 15. the serving fleet ----------------------------------------------------

# 15b: the migrated prompt and the timed migrations after the checked one
FLEET_PROMPT = 512
FLEET_MIGRATIONS = 5
# 15c: the four fleets of the f32 token check (name, replicas, tp,
# prefill replicas); the first is the yardstick
FLEET_TOKEN_TOPOS = [("colocated 1x4", 1, 4, 0), ("colocated 2x2", 2, 2, 0),
                     ("disaggregated 1+1 tp2", 2, 2, 1),
                     ("disaggregated 1+3 tp1", 4, 1, 1)]
# 15d: colocated against disaggregated on the same cards (bench.py:3907-3909
# on four cards)
FLEET_TIMED_TOPOS = [("colocated 1x4", 1, 4, 0),
                     ("disaggregated 2x2", 2, 2, 1)]
# 15a: the virtual clock's step when both runs read a step clock
FLEET_STEP_S = 0.02


class StepClock:
    """A host clock that moves ``step`` seconds a reading: two runs that
    read it take the same virtual time, so their admissions, and with them
    their decode steps, can be held equal."""

    def __init__(self, step: float) -> None:
        self.step, self.now = float(step), 0.0

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now


@contextlib.contextmanager
def step_clock(step: float):
    """The scheduler and the fleet read a fresh ``StepClock``."""
    from ompi_tpu_torch.serving import fleet, scheduler
    clock = StepClock(step)
    with planted(scheduler, "time", clock), planted(fleet, "time", clock):
        yield


def fleet_of(params, cfg, replicas: int, tp: int, prefill: int,
             pages_per_seq: int):
    """A fleet at phase 13's page size and batch, room for SERVE_SEQS
    sequences of pages_per_seq pages, its own spc table."""
    from ompi_tpu_torch import spc as spc_mod
    from ompi_tpu_torch.serving.fleet import ServingFleet
    return ServingFleet(params, cfg, replicas=replicas, tp=tp,
                        prefill_replicas=prefill,
                        n_pages=SERVE_SEQS * pages_per_seq + 1,
                        page_size=SERVE_PAGE, max_seqs=SERVE_SEQS,
                        spc=spc_mod.Counters())


def sched_stream(cfg):
    from ompi_tpu_torch.serving.scheduler import poisson_stream
    return poisson_stream(SCHED_N, SCHED_QPS, cfg.vocab, seed=1,
                          prompt_len=SCHED_PROMPT, max_new=SCHED_NEW)


def fleet_one_card(torch, np, tfm, attention, card, log_fn=log) -> dict:
    """15a, in phase 9's one-process world: a fleet of one colocated
    replica at tp 1 against the bare scheduler on an engine of the same
    geometry, 13c's stream in bf16 at full width.  Under one step clock
    both give the same streams and decode steps (and the fleet launches
    none of K1-K4); then each once on the host clock, timed."""
    from ompi_tpu_torch import serving
    from ompi_tpu_torch.parallel import DeviceComm, make_mesh
    from ompi_tpu_torch.serving.engine import ServingEngine
    from ompi_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
    cfg = tfm.flagship_config()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    pages = serve_pages(SCHED_PROMPT[1] + SCHED_NEW[1])
    t0 = time.perf_counter()
    fl = fleet_of(params, cfg, 1, 1, 0, pages)
    mesh = make_mesh({"tp": 1})
    dc = DeviceComm(mesh, "tp")
    eng = ServingEngine(dc, tfm.shard_params(params, mesh, cfg), cfg,
                        n_pages=SERVE_SEQS * pages + 1, page_size=SERVE_PAGE,
                        max_seqs=SERVE_SEQS)
    del params
    runs = {}
    for clock in ("step", "host"):
        for name, run in (
                ("scheduler", lambda: ContinuousBatchingScheduler(
                    eng, sched_stream(cfg)).run()),
                ("fleet", lambda: fl.run(sched_stream(cfg)))):
            serving.reset()
            serving.enable()
            zero_counts(attention)
            w0 = time.perf_counter()
            with (step_clock(FLEET_STEP_S) if clock == "step"
                  else contextlib.nullcontext()):
                out = run()
            torch.cuda.synchronize()
            rep = serving.report()
            serving.disable()
            runs[(clock, name)] = {
                "streams": {rid: r["tokens"]
                            for rid, r in out["results"].items()},
                "decode_steps": out["decode_steps"],
                "completed": out["completed"], "tokens": out["tokens"],
                "tokens_per_s": out["tokens_per_s"],
                "clock_s": out["clock_s"], "itl": rep["itl"],
                "wall_s": time.perf_counter() - w0,
                "k1_k4_launches": list(launch_counts(attention))}
    step = {n: runs[("step", n)] for n in ("scheduler", "fleet")}
    host = {n: runs[("host", n)] for n in ("scheduler", "fleet")}
    a = {"phase": "fleet_check", "check": "fleet_of_one", "tp": 1,
         "replicas": 1, "requests": SCHED_N, "qps": SCHED_QPS,
         "prompt_len": list(SCHED_PROMPT), "max_new": list(SCHED_NEW),
         "step_clock_s": FLEET_STEP_S,
         "streams_equal": step["fleet"]["streams"]
         == step["scheduler"]["streams"],
         "decode_steps": {n: r["decode_steps"] for n, r in step.items()},
         "host_clock_streams_equal": host["fleet"]["streams"]
         == host["scheduler"]["streams"],
         "host_clock": {n: {k: v for k, v in r.items() if k != "streams"}
                        for n, r in host.items()},
         "k1_k4_launches_fleet": step["fleet"]["k1_k4_launches"],
         "pages_used": fl.engine.cache.pages_used,
         "seconds": time.perf_counter() - t0, "card": card}
    log_fn(a)
    if not (a["streams_equal"] and a["host_clock_streams_equal"]
            and step["fleet"]["completed"] == SCHED_N
            and a["decode_steps"]["fleet"] == a["decode_steps"]["scheduler"]
            and not any(a["k1_k4_launches_fleet"]) and not a["pages_used"]):
        raise AssertionError(f"15a: a fleet of one against the scheduler: "
                             f"{a}")
    del fl, eng
    torch.cuda.empty_cache()
    return {k: v for k, v in a.items() if k != "phase"}


def gathered(torch, obj) -> list:
    """Every rank's ``obj``, in rank order."""
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, obj)
    return out


def slot_pages(torch, cache, slot: int):
    """The slot's pages of every pool, k then v, layer-major: the block a
    migration moves."""
    idx = torch.as_tensor(cache._slot_pages[slot], device=cache.k[0].device)
    return torch.cat([p.index_select(1, idx) for p in cache.k + cache.v],
                     dim=1)


def migration_bitwise(torch, fl, pslot, dslot) -> bool:
    """Decode rank j's pages of ``dslot`` against prefill rank j's of
    ``pslot``, bitwise: the prefill rank sends its block again, by one
    send of its own outside the migration's path (on the world group's
    communicator, as the migration's).  Every rank returns the fleet's
    verdict."""
    dist = torch.distributed
    pre, dec = fl.replicas[0], fl.replicas[1]
    pos = fl.engine.dc.pos
    ok = True
    if fl.me == 0:
        op = dist.P2POp(dist.isend, slot_pages(
            torch, fl.engine.cache, pslot).contiguous(), dec.ranks[pos])
    else:
        mine = slot_pages(torch, fl.engine.cache, dslot)
        theirs = torch.empty_like(mine)
        op = dist.P2POp(dist.irecv, theirs, pre.ranks[pos])
    for req in dist.batch_isend_irecv([op]):
        req.wait()
    if fl.me != 0:
        ok = bool(torch.equal(mine, theirs))
    return all(gathered(torch, ok))


@contextlib.contextmanager
def piece_dropped():
    """Planted: the migration's plan loses its first cross-rank piece
    (prefill rank 0 → decode rank 0), on every rank."""
    from ompi_tpu_torch.parallel import reshard
    real = reshard._cross_plan

    def drop(*args):
        plan = real(*args)
        first = next(i for i, p in enumerate(plan.pieces)
                     if p.src_pos != p.dst_pos)
        return dataclasses.replace(plan, pieces=plan.pieces[:first]
                                   + plan.pieces[first + 1:])

    with planted(reshard, "_cross_plan", drop):
        yield


@contextlib.contextmanager
def last_page_zeroed(n_layers: int, npg: int):
    """Planted: on the decode ranks the migrated block's last page that
    holds prompt rows, of the last layer's k pool, is zeroed before it is
    written."""
    from ompi_tpu_torch.parallel import reshard
    real = reshard.cross_reshard
    page = (n_layers - 1) * npg + (FLEET_PROMPT - 1) // SERVE_PAGE

    def zeroed(*args, **kw):
        out = real(*args, **kw)
        if out is not None:
            out[0, :, page].zero_()
        return out

    with planted(reshard, "cross_reshard", zeroed):
        yield


def fleet_migration(torch, np, tfm, world: int, card: str, log_fn) -> dict:
    """15b: a 1 + 1 fleet at tp world/2, bf16, full width: a FLEET_PROMPT
    prompt prefilled and its pages migrated, the decode pools bitwise equal
    to the prefill pools and seq_lens carried over; wire = plan = spc =
    fleet_migrated_bytes, peak <= bound; two planted faults (a dropped
    piece, the last page of prompt rows of one layer zeroed) each fail the
    bitwise check;
    then FLEET_MIGRATIONS timed migrations."""
    from ompi_tpu_torch import serving
    from ompi_tpu_torch.parallel import reshard
    dist = torch.distributed
    cfg = tfm.flagship_config()
    tp = world // 2
    t_build = time.perf_counter()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    npg = serve_pages(FLEET_PROMPT + SERVE_NEW)
    fl = fleet_of(params, cfg, 2, tp, 1, npg)
    del params
    pre, dec = fl.replicas
    cache = fl.engine.cache
    rng = np.random.default_rng(15)

    def prefill(seed):
        if fl.me != 0:
            return None
        prompt = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                      FLEET_PROMPT)
        slot = cache.admit(FLEET_PROMPT, SERVE_NEW)
        fl.engine.prefill(slot, prompt)
        return slot

    def migrate(pslot, rid):
        return fl.migrate(pre, dec, pslot, FLEET_PROMPT, SERVE_NEW, rid=rid)

    def release(pslot, dslot):
        cache.release(pslot if fl.me == 0 else dslot)

    # the checked migration
    serving.reset()
    serving.enable()
    pslot = prefill(int(rng.integers(1 << 30)))
    spc = fl.spc
    arms0, wire0 = spc.get("coll_arm_native_count"), spc.get(
        "coll_wire_bytes")
    dslot = migrate(pslot, 0)
    torch.cuda.synchronize()
    last = reshard.report()["last"]
    rep = serving.fleet_report()
    serving.disable()
    rows = 2 * cfg.n_layers * npg
    plan = reshard.compile_cross_plan(
        (2, tp, rows, SERVE_PAGE, cfg.n_heads // tp, cfg.head_dim),
        cfg.dtype, ("fleet", "tp"), (None, "tp"), *fl._bridge(pre, dec))
    seq = int(cache.seq_lens[pslot if fl.me == 0 else dslot])
    b = {"phase": "fleet_check", "check": "migration", "tp": tp,
         "prompt_tokens": FLEET_PROMPT, "pages": npg,
         "bitwise": migration_bitwise(torch, fl, pslot, dslot),
         "seq_lens": gathered(torch, seq),
         "wire_bytes": last["wire_bytes"], "plan_wire_bytes":
         plan.wire_bytes, "spc_wire_bytes": spc.get("coll_wire_bytes")
         - wire0, "spc_native_arms": spc.get("coll_arm_native_count")
         - arms0, "fleet_migrated_bytes": rep["migrated_bytes"],
         "peak_bytes": last["peak_bytes"], "bound_bytes":
         last["bound_bytes"], "pieces": len(plan.pieces)}
    release(pslot, dslot)
    faults = []
    for i, (name, ctx) in enumerate((
            ("a dropped piece", piece_dropped),
            ("the last prompt page of one layer zeroed",
             lambda: last_page_zeroed(cfg.n_layers, npg)))):
        pslot = prefill(int(rng.integers(1 << 30)))
        with ctx():
            dslot = migrate(pslot, f"fault{i}")
        torch.cuda.synchronize()
        ok = migration_bitwise(torch, fl, pslot, dslot)
        faults.append({"fault": name, "rejected": not ok})
        release(pslot, dslot)
    b["faults"] = faults
    # timed: one migration after the checked one, FLEET_MIGRATIONS times
    pslot = prefill(int(rng.integers(1 << 30)))
    times = []
    for i in range(FLEET_MIGRATIONS + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dslot = migrate(pslot, f"timed{i}")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if fl.me == 1:
            cache.release(dslot)
    if fl.me == 0:
        cache.release(pslot)
    ms = statistics.median(times[1:])
    b.update({"migrate_ms": ms, "migrate_ms_all": times,
              "wire_GBps": b["wire_bytes"] / ms / 1e6,
              "pair_GBps": b["wire_bytes"] / tp / ms / 1e6,
              "seconds": time.perf_counter() - t_build, "card": card})
    log_fn(b)
    if not (b["bitwise"] and set(b["seq_lens"]) == {FLEET_PROMPT}
            and b["wire_bytes"] == b["plan_wire_bytes"]
            == b["spc_wire_bytes"] == b["fleet_migrated_bytes"] > 0
            and b["spc_native_arms"] == 1
            and b["peak_bytes"] <= b["bound_bytes"]
            and all(f["rejected"] for f in faults)):
        raise AssertionError(f"15b: migration on {world} cards: {b}")
    del fl, cache
    torch.cuda.empty_cache()
    return {k: v for k, v in b.items() if k != "phase"}


def fleet_tokens(torch, np, tfm, world: int, card: str, log_fn) -> dict:
    """15c: 13a's four requests in f32 through the fleets of
    FLEET_TOKEN_TOPOS: every request's tokens equal the first fleet's, and
    each disaggregated fleet migrates every request that outlives its first
    token."""
    from ompi_tpu_torch import serving
    cfg = dataclasses.replace(tfm.flagship_config(), dtype=torch.float32)
    prompts = serve_prompts(np, cfg.vocab)
    pages = serve_pages(max(SERVE_PROMPT_LENS) + SERVE_NEW)
    t0 = time.perf_counter()
    runs = []
    for name, replicas, tp, prefill in FLEET_TOKEN_TOPOS:
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
        fl = fleet_of(params, cfg, replicas, tp, prefill, pages)
        del params
        serving.reset()
        serving.enable()
        out = fl.run(spec_requests(np, prompts))
        # the prefill lane's ledger (rank 0's) holds every migration
        migrations = int(gathered(torch, serving.fleet_pvar_value(
            "fleet_migrations"))[0])
        serving.disable()
        streams = [out["results"][i]["tokens"] for i in range(len(prompts))]
        runs.append({"fleet": name, "replicas": replicas, "tp": tp,
                     "prefill_replicas": prefill, "streams": streams,
                     "completed": out["completed"],
                     "decode_steps": out["decode_steps"],
                     "migrations": migrations,
                     "outlive_first_token": sum(len(s) > 1 for s in streams),
                     "pages_used": fl.engine.cache.pages_used})
        del fl
        torch.cuda.empty_cache()
    want = runs[0]["streams"]
    for r in runs:
        r["tokens_equal"] = r["streams"] == want
        r["migrations_ok"] = r["migrations"] == (
            r["outlive_first_token"] if r["prefill_replicas"] else 0)
    c = {"phase": "fleet_check", "check": "fleet_tokens_f32",
         "requests": len(prompts), "new_tokens": SERVE_NEW,
         "runs": [{k: v for k, v in r.items() if k != "streams"}
                  for r in runs],
         "seconds": time.perf_counter() - t0, "card": card}
    log_fn(c)
    if not all(r["tokens_equal"] and r["migrations_ok"]
               and r["completed"] == len(prompts) and not r["pages_used"]
               for r in runs):
        raise AssertionError(f"15c: fleet tokens on {world} cards: {c}")
    return {k: v for k, v in c.items() if k != "phase"}


@contextlib.contextmanager
def host_token_times(stamps: dict):
    """Each request's tokens on this process's host clock, into
    ``stamps[rid]``: a serving replica's first token when its prefill
    returns (colocated) or its pages land (a decode replica, at the end of
    ``migrate``), every later token when the scheduler emits it."""
    from ompi_tpu_torch.serving import fleet
    on_token = fleet._ReplicaScheduler._on_token
    migrate = fleet.ServingFleet.migrate

    def note(rid):
        stamps.setdefault(rid, []).append(time.perf_counter())

    def token(self, st):
        note(st.req.rid)
        on_token(self, st)

    def landed(self, *args, rid=None, **kw):
        slot = migrate(self, *args, rid=rid, **kw)
        if slot is not None:
            note(rid)
        return slot

    with planted(fleet._ReplicaScheduler, "_on_token", token), \
            planted(fleet.ServingFleet, "migrate", landed):
        yield


def fleet_timings(torch, np, tfm, world: int, card: str, log_fn) -> dict:
    """15d: 13c's stream in bf16 through each fleet of FLEET_TIMED_TOPOS
    on the same cards: tokens/s and ITL p50/p99 on the virtual clock and
    on the host's (the command's wall time; the gaps between a request's
    tokens on its serving replica's first rank), decode steps,
    migrations, the command's share spent migrating, and every card's
    idle share (one more run, profiled).  A measurement, not a check."""
    from ompi_tpu_torch import serving
    from ompi_tpu_torch.serving.fleet import _percentile
    cfg = tfm.flagship_config()
    pages = serve_pages(SCHED_PROMPT[1] + SCHED_NEW[1])
    rows = []
    for name, replicas, tp, prefill in FLEET_TIMED_TOPOS:
        t_build = time.perf_counter()
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
        fl = fleet_of(params, cfg, replicas, tp, prefill, pages)
        del params
        serving.reset()
        serving.enable()
        stamps = {}
        torch.distributed.barrier()
        t0 = time.perf_counter()
        with host_token_times(stamps):
            out = fl.run(sched_stream(cfg))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        led = serving.fleet_report()
        serving.disable()
        migrate_ms = sum(m["dur_ms"] for m in led["migration_log"])
        gaps = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
        _, spans, _ = traced(torch, lambda: fl.run(sched_stream(cfg)),
                             warm=False, cpu=False)
        idle = idle_shares(spans, wall_ms)
        ranks = gathered(torch, {"migrations": led["migrations"],
                                 "migrate_ms": migrate_ms,
                                 "ledger_rows": len(led["migration_log"]),
                                 "gaps": gaps, **idle})
        # the host gaps of every serving replica, from its first rank
        host_gaps = sorted(g for r in range(prefill, replicas)
                           for g in ranks[r * tp]["gaps"])
        r = {"phase": "fleet_numbers", "fleet": name, "replicas": replicas,
             "tp": tp, "prefill_replicas": prefill, "cards": world,
             "requests": SCHED_N, "qps": SCHED_QPS, "tokens": out["tokens"],
             "completed": out["completed"], "wall_s": wall_ms / 1e3,
             "tokens_per_wall_s": out["tokens"] / (wall_ms / 1e3),
             "host_itl_p50_ms": 1e3 * _percentile(host_gaps, 0.50),
             "host_itl_p99_ms": 1e3 * _percentile(host_gaps, 0.99),
             "host_gaps": len(host_gaps),
             "clock_s": out["clock_s"],
             "tokens_per_s": out["tokens_per_s"],
             "itl_p50_ms": out["itl"]["p50_ms"],
             "itl_p99_ms": out["itl"]["p99_ms"],
             "decode_steps": out["decode_steps"],
             "migrations": ranks[0]["migrations"],
             # rank 0 is on the prefill lane when there is one, and takes
             # part in every migration; its ledger is capped at
             # serve_fleet_table_cap rows
             "migrate_share": ranks[0]["migrate_ms"] / wall_ms,
             "migrate_ledger_rows": ranks[0]["ledger_rows"],
             "idle_share_by_rank": [x["idle_share"] for x in ranks],
             "compute_idle_share_by_rank": [x["compute_idle_share"]
                                            for x in ranks],
             "kernels_by_rank": [x["kernels"] for x in ranks],
             "nccl_kernels_by_rank": [x["nccl_kernels"] for x in ranks],
             "seconds": time.perf_counter() - t_build,
             "per_replica": out["per_replica"], "card": card}
        log_fn(r)
        if None in r["idle_share_by_rank"]:
            raise AssertionError(f"15d: {name}: a card's trace held no "
                                 f"kernel in 3 tries: {r}")
        rows.append({k: v for k, v in r.items() if k != "phase"})
        del fl
        torch.cuda.empty_cache()
    return {"numbers": rows}


def fleet_multi_card(torch, np, tfm, world: int, card: str, log_fn) -> dict:
    """15b-d across the cards (module docstring)."""
    row = {"migration": fleet_migration(torch, np, tfm, world, card, log_fn)}
    row["tokens_f32"] = fleet_tokens(torch, np, tfm, world, card, log_fn)
    row.update(fleet_timings(torch, np, tfm, world, card, log_fn))
    return row


# -- 16. hierarchy and sequence parallelism (P13) -----------------------------

# The simulated slow plane of phase 16: "outer" (16a) and "dpo" (16b, 16c)
# classify as DCN (OMPI_TPU_topo_sim_dcn_axes); four cards of one host are
# one NVLink plane, so the two-tier arms are eligible only under it.
HIER_SIM_AXES = "outer,dpo"
# 16a: counts a rank the inner size (2) does not divide, f32 and bf16
HIER_COUNTS = (7, 1_000_003)
# 16a, 16b: the timed sizes, MB a rank (f32)
HIER_SIZES_MB = (1, 16, 64)
# 16b: the shim's stated cost in its timed rows: 40 µs a MiB, about 25 GB/s
# (a 200 Gb/s host NIC); 0 in every other timed row
HIER_US_PER_MIB = 40.0
# 16d: the flagship's attention shape on {"sp": 4}, bf16 causal
ULYSSES_SP = 4
# 16f: the flagship's layers in PIPE_STAGES stages, PIPE_MICRO microbatches
# of one sequence; the pipeline runs the same layer calls on the same
# microbatches as the layers applied in order, so its outputs and gradients
# differ from those only by the order of the gradient sums over
# microbatches (f32): relative RMS PIPE_REL
PIPE_STAGES, PIPE_MICRO = 2, 4
PIPE_REL = 1e-3
# phase 9's checks a tuple-axis comm does not run: the cartesian exchange
# needs one line's geometry (as in the reference)
CART_CASES = ("neighbor_allgather_cart", "neighbor_alltoall_cart")

_WORLD_MESHES: dict = {}


def world_mesh(axes: dict):
    """One mesh per layout for the life of the world: its groups (and the
    product groups ``axes_group`` makes on it) are made once, by every
    rank, in the same order."""
    from ompi_tpu_torch.parallel import make_mesh
    key = tuple(axes.items())
    if key not in _WORLD_MESHES:
        _WORLD_MESHES[key] = make_mesh(dict(axes))
    return _WORLD_MESHES[key]


@contextlib.contextmanager
def outer_stage_skipped():
    """Planted: the hierarchical allreduce's outer stage skipped (each
    rank keeps its inner partial sum)."""
    from ompi_tpu_torch.parallel import hierarchy
    real = hierarchy._stages

    def skipped(x, inner, outer, mesh, outer_stage):
        return real(x, inner, outer, mesh, lambda t, group: t)

    with planted(hierarchy, "_stages", skipped):
        yield


def hier_quant_allow(np, x, n_outer: int):
    """hierarchical_psum_quant's error allowance, elementwise and
    conservative: the outer stage rounds each of the n_outer inner
    partial sums once and the reduced chunk once, each within half a step
    (amax / 254) of its block (the reduced chunk's amax within the first
    roundings of the exact sum's); the global amax bounds every block's."""
    parts = x.reshape(n_outer, -1, x.shape[-1]).sum(axis=1)
    first = np.abs(parts).max(axis=-1).sum() / 254.0
    return first + (np.abs(x.sum(axis=0)).max() + first) / 254.0


def hier_collectives(torch, np, card: str, log_fn) -> dict:
    """16a: a DeviceComm over ("outer", "inner") on {"outer": 2,
    "inner": 2}: phase 9's checks of every flat method; the hierarchical
    allreduce against numpy and its quantized form against the codec's
    error model, each rejecting a planted skipped outer stage; the
    hierarchical allreduce timed beside the flat native one over the same
    four ranks with hier_wire_bytes' split, the shim off."""
    from ompi_tpu_torch.parallel import DeviceComm, hierarchy
    mesh = world_mesh({"outer": 2, "inner": 2})
    dc = DeviceComm(mesh, ("outer", "inner"))
    checked = coll_check(torch, np, dc, COLL_ROWS, log_fn, skip=CART_CASES)
    rows = []
    for dtype in ("float32", "bfloat16"):
        for count in HIER_COUNTS:
            rng = np.random.default_rng(count)
            x = rng.integers(-8, 9, (dc.n, count)).astype(np.float32)
            mine = torch.from_numpy(x[dc.pos]).to(
                getattr(torch, dtype)).cuda()
            run = lambda: hierarchy.hierarchical_allreduce(
                mine, mesh, "inner", "outer").float().cpu().numpy()
            got = run()
            with outer_stage_skipped():
                bad = run()
            want = x.sum(axis=0)
            rtol = COLL_RTOL[dtype]
            row = {"phase": "hier_check", "what": "hierarchical_allreduce",
                   "dtype": dtype, "count": count, "rtol": rtol,
                   "max_abs_err": float(np.abs(got - want).max()),
                   "ok": coll_agree(np, got, want, rtol),
                   "planted_outer_skipped_passes": coll_agree(
                       np, bad, want, rtol), "card": card}
            log_fn(row)
            rows.append(row)
    for count in HIER_COUNTS:
        x = np.random.default_rng(count + 1).standard_normal(
            (dc.n, count)).astype(np.float32)
        mine = torch.from_numpy(x[dc.pos]).cuda()
        run = lambda: hierarchy.hierarchical_psum_quant(
            mine, "inner", "outer", 2, mesh=mesh).cpu().numpy()
        got = run()
        with outer_stage_skipped():
            bad = run()
        allow = hier_quant_allow(np, x, 2)
        exact = x.sum(axis=0)
        row = {"phase": "hier_check", "what": "hierarchical_psum_quant",
               "dtype": "float32", "count": count,
               "max_abs_err": float(np.abs(got - exact).max()),
               "allowance": float(allow),
               "ok": bool(np.abs(got - exact).max() <= allow),
               "planted_outer_skipped_passes": bool(
                   np.abs(bad - exact).max() <= allow), "card": card}
        log_fn(row)
        rows.append(row)
    for row in rows:
        if not row["ok"] or row["planted_outer_skipped_passes"]:
            raise AssertionError(f"16a: {row}")
    times = []
    for mb in HIER_SIZES_MB:
        count = (mb << 20) // 4
        t = torch.randn(count, device="cuda")
        hw = hierarchy.hier_wire_bytes(count, torch.float32, 2, 2)
        kw = dict(n=10, warmup=3, reps=KERNEL_REPS)
        hier_ms = median_ms(lambda: hierarchy.hierarchical_psum(
            t, "inner", "outer", mesh), **kw)
        flat_ms = median_ms(lambda: dc.allreduce(t[None]), **kw)
        row = {"phase": "hier_numbers", "bytes_per_rank": count * 4,
               "cards": dc.n, "sim_dcn_us_per_mib": 0.0,
               "hier_ms": hier_ms, "flat_native_ms": flat_ms,
               "hier_over_flat": hier_ms / flat_ms,
               "inner_bytes": hw["inner_bytes"],
               "outer_bytes": hw["outer_bytes"],
               "hier_wire_bytes": hw["total_bytes"],
               "flat_wire_bytes": 2 * (dc.n - 1) * count * 4 // dc.n,
               "card": card}
        log_fn(row)
        times.append(row)
        del t
        torch.cuda.empty_cache()
    return {"coll_checked": checked, "checks": len(rows), "numbers": times}


@contextlib.contextmanager
def grad_sync_forced(arm):
    """The bucketed sync's arm forced (None: decided)."""
    from ompi_tpu_torch.coll import nccl  # noqa: F401 (its variables)
    from ompi_tpu_torch.core import var
    if arm is not None:
        var.registry.set_override("coll_nccl_grad_sync_mode", arm)
    try:
        yield
    finally:
        var.registry.reset_cache()


@contextlib.contextmanager
def hier_bucket_skipped(which: int):
    """Planted: the ``which``-th bucket's hierarchical allreduce not run,
    on every rank alike (the bucket keeps this rank's own gradient)."""
    from ompi_tpu_torch.parallel import hierarchy
    real, seen = hierarchy.hierarchical_psum, [0]

    def psum(x, *args, **kwargs):
        seen[0] += 1
        return x.clone() if seen[0] == which + 1 else real(x, *args,
                                                            **kwargs)

    with planted(hierarchy, "hierarchical_psum", psum):
        yield


def hier_quant_use(torch, grads, local, mesh, plan, block: int) -> float:
    """The hier+quant buckets against the codec's error model: for each
    bucket, this rank's chunk of the inner (dp) sums of every rank's own
    gradients, the outer (dpo) ranks' chunks all-gathered, and the
    synced chunk (× n) within half a step of each contribution's block
    and of the output's block (its amax within the first roundings of the
    exact sum's) from their exact sum.  Returns the largest
    error over its allowance (<= 1 passes).  Collective."""
    from ompi_tpu_torch.coll import quant
    from ompi_tpu_torch.parallel.mesh import axis_rank, axis_size
    dist = torch.distributed
    gi, go = mesh.get_group("dp"), mesh.get_group("dpo")
    ni, no = axis_size(mesh, "dp"), axis_size(mesh, "dpo")
    me, n = axis_rank(mesh, "dp"), ni * no
    pad = torch.nn.functional.pad
    worst = 0.0
    for b in plan.buckets:
        flat = torch.cat([local[j].reshape(-1).float() for j in b.indices])
        got = torch.cat([grads[j].reshape(-1).float()
                         for j in b.indices]) * n
        extra = (-flat.numel()) % ni
        part = pad(flat, (0, extra))
        dist.all_reduce(part, group=gi)
        c = part.numel() // ni
        mine = part[me * c:(me + 1) * c].contiguous()
        contrib = torch.empty((no, c), device=mine.device)
        dist.all_gather_into_tensor(contrib.view(-1), mine, group=go)
        exact = contrib.sum(dim=0)
        out = pad(got, (0, extra))[me * c:(me + 1) * c]
        qpad = quant.padded_len(c, no, block) - c
        blocks = lambda t: pad(t, (0, qpad)).reshape(
            t.shape[:-1] + (-1, block))
        first = blocks(contrib).abs().amax(dim=-1).sum(dim=0) / 254.0
        allow = first + (blocks(exact).abs().amax(dim=-1) + first) / 254.0
        err = (blocks(out) - blocks(exact)).abs().amax(dim=-1)
        worst = max(worst, float((err / (allow * (1 + 1e-4) + 1e-12))
                                 .max()))
        del flat, got, part, contrib, exact
    return worst


def hier_grad_sync(torch, np, tfm, optim, world: int, card: str, sync,
                   log_fn) -> dict:
    """16c: the flagship train step at full width on {"dpo": 2, "dp": 2},
    attn "flash", grad_sync="bucketed": each bucket arm (forced native,
    decided, forced hier, forced hier+quant) against the native arm's
    gradients (hier within SYNC_GRAD_RMS, hier+quant within the codec's
    error model), a skipped hier bucket and a zeroed scale block rejected,
    SYNC_STEPS losses against one card's, K1-K3 launches counted, every
    arm timed under remat "dots" and "none" beside native on {"dp": 4}
    from phase 12d (``sync``)."""
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import overlap
    cfg = dataclasses.replace(tfm.flagship_config(), grad_sync="bucketed",
                              grad_bucket_bytes=4 << 20)
    pristine = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, cfg.seq + 1))).cuda()
    mesh = world_mesh({"dpo": 2, "dp": 2})
    leaves = optim.tree_leaves(pristine)
    plan = overlap.bucket_plan(leaves, cfg.grad_bucket_bytes)
    ref = run_steps(tfm, dataclasses.replace(cfg, grad_sync="native"),
                    clone_tree(optim, pristine), tokens, SYNC_STEPS)
    torch.cuda.empty_cache()
    vg = tfm.make_value_and_grad(cfg, mesh)
    with grad_sync_forced("native"):
        native = vg(clone_tree(optim, pristine), tokens)[1]
    local = tfm.value_and_grad(clone_tree(optim, pristine),
                               overlap.dp_batch(tokens, mesh), cfg)[1]
    n = cfg.n_layers
    checks = []
    for arm in ("native", None, "hier", "hier+quant"):
        decided = []
        real = overlap._decide_buckets

        def spy(*args, **kwargs):
            decided[:] = real(*args, **kwargs)
            return tuple(decided)

        zero_counts(attention)
        with grad_sync_forced(arm), planted(overlap, "_decide_buckets",
                                            spy):
            grads = vg(clone_tree(optim, pristine), tokens)[1]
            torch.cuda.synchronize()
        launches = launch_counts(attention)
        want_arm = arm or "native"
        row = {"phase": "hier_sync_check", "arm": arm or "decided",
               "mesh": {"dpo": 2, "dp": 2}, "buckets": plan.n_buckets,
               "bucket_arms": sorted(set(decided)),
               "k1_k2_k3_k4_launches_per_step": list(launches),
               "grad_rel_rms_vs_native": grads_rel_rms(grads, native)}
        ok = decided == [want_arm] * plan.n_buckets
        if want_arm == "hier+quant":
            row["error_model_use"] = hier_quant_use(
                torch, grads, local, mesh, plan, cfg.grad_sync_block)
            with grad_sync_forced(arm), scale_block_zeroed():
                bad = vg(clone_tree(optim, pristine), tokens)[1]
            row["planted_scale_zeroed_use"] = hier_quant_use(
                torch, bad, local, mesh, plan, cfg.grad_sync_block)
            ok = ok and (row["error_model_use"] <= 1.0
                         and row["planted_scale_zeroed_use"] > 1.0)
        else:
            ok = ok and row["grad_rel_rms_vs_native"] <= SYNC_GRAD_RMS
            if want_arm == "hier":
                with grad_sync_forced(arm), \
                        hier_bucket_skipped(plan.n_buckets // 2):
                    bad = vg(clone_tree(optim, pristine), tokens)[1]
                row["planted_bucket_skipped_rel_rms"] = grads_rel_rms(
                    bad, native)
                ok = ok and (row["planted_bucket_skipped_rel_rms"]
                             > SYNC_GRAD_RMS)
        bad = None
        del grads
        torch.cuda.empty_cache()
        init_opt, step = tfm.make_train_step(cfg, mesh, learning_rate=1e-3)
        params = clone_tree(optim, pristine)
        state, losses = init_opt(params), []
        with grad_sync_forced(arm):
            for _ in range(SYNC_STEPS):
                params, state, loss = step(params, state, tokens)
                losses.append(float(loss))
        del params, state
        torch.cuda.empty_cache()
        row["losses"], row["one_card_losses"] = losses, ref
        row["loss_max_rel_diff"] = max(abs(a - b) / abs(b)
                                       for a, b in zip(losses, ref))
        ok = (ok and row["loss_max_rel_diff"] < TRAIN_LOSS_REL
              and launches == (2 * n, n, n, 0))
        row["ok"] = ok
        row["card"] = card
        log_fn(row)
        checks.append(row)
        if not ok:
            raise AssertionError(f"16c {row['arm']}: {row}")
    del native, local
    torch.cuda.empty_cache()
    numbers = {}
    for remat in ("dots", "none"):
        times = {}
        for arm in ("native", None, "hier", "hier+quant"):
            c = dataclasses.replace(cfg, remat=remat)
            with grad_sync_forced(arm):
                t = time_train(torch, tfm, optim, c, pristine, tokens, card,
                               mesh=mesh, log_fn=log_fn)
            torch.cuda.empty_cache()
            times[arm or "decided"] = {k: t[k] for k in (
                "step_ms", "host_issue_ms", "tokens_per_s", "mfu")}
        dp4 = (sync["numbers"][remat]["native"]["step_ms"] if sync
               else None)
        numbers[remat] = times
        log_fn({"phase": "hier_sync_numbers", "remat": remat,
                "mesh": {"dpo": 2, "dp": 2}, "arms": times,
                "dp4_native_step_ms": dp4, "card": card})
    return {"checks": [{k: v for k, v in r.items() if k != "phase"}
                       for r in checks], "numbers": numbers}


@contextlib.contextmanager
def sequence_out_of_order():
    """Planted: after the seq->heads exchange, the sequence's chunks one
    member along (a causal check must see it)."""
    from ompi_tpu_torch.parallel import ulysses
    real = ulysses._seq_to_heads

    def rolled(x, group, n):
        out = real(x, group, n)
        b, s, h, d = out.shape
        return out.reshape(b, n, s // n, h, d).roll(1, dims=1).reshape(
            b, s, h, d)

    with planted(ulysses, "_seq_to_heads", rolled):
        yield


@contextlib.contextmanager
def heads_to_seq_skipped():
    """Planted: the heads->seq exchange skipped: each member keeps its own
    heads' output on its own sequence block, in every head slot."""
    from ompi_tpu_torch.parallel import ulysses
    dist = __import__("torch").distributed

    def local(x, group, n):
        me = dist.get_rank(group)
        s = x.shape[1] // n
        return x[:, me * s:(me + 1) * s].repeat(1, 1, n, 1)

    with planted(ulysses, "_heads_to_seq", local):
        yield


def ulysses_phase(torch, np, cfg, card: str, log_fn) -> dict:
    """16d: ulysses_attention at the flagship's attention shape, (BATCH,
    seq, heads, head_dim) bf16 causal, on {"sp": 4}: with flash_mha (K1,
    then K2/K3) and with the dense default, the output and q/k/v
    gradients of this rank's shard against one card's flash_mha on the
    whole tensors (GRAD_RMS_BF16; the dense default within
    FLASH_VS_DENSE_RMS), a planted out-of-order sequence rejected; ms
    beside ring_attention at the same shape."""
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import ring, ulysses
    mesh = world_mesh({"sp": ULYSSES_SP})
    n, pos = ULYSSES_SP, mesh.get_local_rank("sp")
    shape = (BATCH, cfg.seq, cfg.n_heads, cfg.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    q = q * Q_SCALE
    sl = cfg.seq // n
    shard = lambda t: t[:, pos * sl:(pos + 1) * sl].contiguous()
    flash = lambda a, b, c: attention.flash_mha(a, b, c, True)
    out1 = flash(q, k, v)
    grads1 = mha_grads(torch, flash, q, k, v, g)
    want = [shard(t) for t in (out1, *grads1)]
    del out1, grads1
    qs, ks, vs, gs = (shard(t) for t in (q, k, v, g))
    fns = {"flash": lambda a, b, c: ulysses.ulysses_attention(
               a, b, c, mesh, "sp", attn_fn=flash),
           "dense": lambda a, b, c: ulysses.ulysses_attention(
               a, b, c, mesh, "sp", causal=True),
           "ring": lambda a, b, c: ring.ring_attention(
               a, b, c, mesh, "sp", causal=True)}

    def run(fn):
        a, b, c = (t.detach().requires_grad_() for t in (qs, ks, vs))
        out = fn(a, b, c)
        return [out.detach()] + list(torch.autograd.grad(out, (a, b, c),
                                                         gs))

    def errs(got):
        return [rel_rms(x.float(), w.float()) for x, w in zip(got, want)]

    rows = []
    for name, tol in (("flash", GRAD_RMS_BF16),
                      ("dense", FLASH_VS_DENSE_RMS)):
        zero_counts(attention)
        got = run(fns[name])
        torch.cuda.synchronize()
        launches = launch_counts(attention)
        with sequence_out_of_order():
            bad = run(fns[name])
        e, pe = errs(got), errs(bad)
        want_launches = (1, 1, 1, 0) if name == "flash" else (0, 0, 0, 0)
        row = {"phase": "ulysses_check", "attn_fn": name,
               "shape": list(shape), "sp": n,
               "rel_rms_out_dq_dk_dv": e, "tol": tol,
               "planted_out_of_order_rel_rms": pe,
               "k1_k2_k3_k4_launches": list(launches),
               "ok": (max(e) < tol and min(pe[:1]) > tol
                      and launches == want_launches), "card": card}
        log_fn(row)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"16d {name}: {row}")
        del got, bad
    torch.cuda.empty_cache()
    timing = {}
    for name, fn in fns.items():
        with torch.no_grad():
            fwd = median_ms(lambda: fn(qs, ks, vs), n=10, warmup=2)
        both = median_ms(lambda: run(fn), n=10, warmup=2)
        timing[name] = {"forward_ms": fwd, "forward_backward_ms": both}
    one = median_ms(lambda: mha_grads(torch, flash, q, k, v, g), n=10,
                    warmup=2)
    row = {"phase": "ulysses_numbers", "shape": list(shape), "sp": n,
           "ms": timing, "one_card_flash_mha_forward_backward_ms": one,
           "card": card}
    log_fn(row)
    return {"checks": rows, "numbers": row}


def ulysses_mesh_steps(torch, np, tfm, optim, world: int, card: str,
                       log_fn) -> list:
    """16e: the flagship's mesh step, attn "flash" and "dense", at each
    layout of MULTI_LAYOUTS from 10c's weights and tokens, against the
    one-card step within 10c's bounds (the gradient sum over dp × sp
    skipped and the heads->seq exchange skipped each rejected), K1/K2/K3
    launches a rank counted; step ms, tokens/s and MFU a card beside attn
    "ring" on the same mesh."""
    from ompi_tpu_torch.ops import attention
    base = tfm.flagship_config()
    pristine = tfm.init_params(torch.Generator().manual_seed(0), base)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab, (BATCH, base.seq + 1))).cuda()
    n = base.n_layers
    rows = []
    refs = {}
    for attn in ("flash", "dense"):
        refs[attn] = run_steps(tfm, dataclasses.replace(base, attn=attn),
                               clone_tree(optim, pristine), tokens,
                               MESH_STEPS)
    torch.cuda.empty_cache()
    for dp, sp, tp in MULTI_LAYOUTS:
        mesh = world_mesh({"dp": dp, "sp": sp, "tp": tp})
        row = {"mesh": {"dp": dp, "sp": sp, "tp": tp}, "cards": world}
        for attn in ("flash", "dense"):
            cfg = dataclasses.replace(base, attn=attn)
            want = (2 * n, n, n, 0) if attn == "flash" else (0, 0, 0, 0)
            check = mesh_losses(torch, tfm, optim, attention, cfg, mesh,
                                pristine, tokens, refs[attn], want, log_fn,
                                bounds=(TRAIN_LOSS_REL, TRAIN_GRAD_RMS))
            torch.cuda.empty_cache()
            row[attn] = {k: check[k] for k in (
                "loss_max_rel_diff", "grad_rel_rms", "planted_grad_rel_rms",
                "k1_k2_k3_k4_launches_per_step")}
        for attn in ("flash", "dense", "ring"):
            cfg = dataclasses.replace(base, attn=attn)
            t = time_train(torch, tfm, optim, cfg, pristine, tokens, card,
                           mesh=mesh, log_fn=log_fn)
            torch.cuda.empty_cache()
            row.setdefault(attn, {}).update(
                {k: t[k] for k in ("step_ms", "host_issue_ms",
                                   "tokens_per_s", "mfu", "peak_bytes")})
        log_fn({"phase": "ulysses_mesh_numbers", **row, "card": card})
        rows.append(row)
    return rows


@contextlib.contextmanager
def shift_dropped(which: int):
    """Planted: the pipeline's ``which``-th stage shift delivers zeros (on
    every rank alike; the hop stays in the graph)."""
    from ompi_tpu_torch.parallel import pipeline
    real, seen = pipeline.ring_hop, [0]

    def hop(y, *args, **kwargs):
        seen[0] += 1
        out = real(y, *args, **kwargs)
        return out * 0 if seen[0] == which + 1 else out

    with planted(pipeline, "ring_hop", hop):
        yield


def pipeline_phase(torch, np, tfm, card: str, log_fn) -> dict:
    """16f: pipeline() of the flagship's layers, attn "flash", in
    PIPE_STAGES stages on {"dp": 2, "pp": 2}, PIPE_MICRO microbatches of
    one sequence (the embedded tokens, bf16): the output and this stage's
    parameter gradients of sum(out · cot) against the layers applied in
    order on this card (PIPE_REL), one dropped shift rejected, K1/K2/K3
    launches counted, the run's ms beside the layers in order and the
    GPipe bubble (P - 1) / (M + P - 1)."""
    from ompi_tpu_torch import optim
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import pipeline as pp
    cfg = tfm.flagship_config()
    mesh = world_mesh({"dp": 2, "pp": PIPE_STAGES})
    stage = mesh.get_local_rank("pp")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    layers = params["layers"]
    per = len(layers) // PIPE_STAGES
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (PIPE_MICRO, cfg.seq))).cuda()
    mbs = params["embed"].to(cfg.dtype)[tokens][:, None]   # (M, 1, s, d)
    cot = torch.randn(mbs.shape, generator=torch.Generator(
        device="cuda").manual_seed(17), device="cuda").to(cfg.dtype)
    mine = pp.shard_stage_params(pp.stack_stage_params(layers, PIPE_STAGES),
                                 mesh, "pp")
    del params

    def stage_fn(p, x):
        for i in range(per):
            # a dense layer's router aux is None
            x, _ = tfm._layer_apply(x, {k: w[i] for k, w in p.items()}, cfg)
        return x

    leaves = optim.tree_leaves(mine)

    def run():
        for t in leaves:
            t.requires_grad_(True)
        out = pp.pipeline(stage_fn, mine, mbs, mesh, "pp")
        loss = (out.float() * cot.float()).sum()
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return out.detach(), grads

    # the layers in order on this card: each microbatch through every
    # layer, the same calls the stages make
    own = layers[stage * per:(stage + 1) * per]
    own_leaves = [t for lay in own for t in optim.tree_leaves(lay)]

    def sequential():
        for t in own_leaves:
            t.requires_grad_(True)
        outs = []
        for m in range(PIPE_MICRO):
            h = mbs[m]
            for lay in layers:
                h, _ = tfm._layer_apply(h, lay, cfg)
            outs.append(h)
        out = torch.stack(outs)
        loss = (out.float() * cot.float()).sum()
        grads = torch.autograd.grad(loss, own_leaves)
        for t in own_leaves:
            t.requires_grad_(False)
        return out.detach(), grads

    zero_counts(attention)
    out, grads = run()
    torch.cuda.synchronize()
    launches = launch_counts(attention)
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    want_launches = (2 * per * ticks, per * ticks, per * ticks, 0)
    ref_out, ref_grads = sequential()
    # the stacked leaves hold (per, ...) of each name; the layers' own
    # leaves are per layer: regroup them by name
    names = sorted(own[0])
    ref_by_name = {}
    for i, lay in enumerate(own):
        for k, gr in zip(sorted(lay), ref_grads[i * len(names):
                                                (i + 1) * len(names)]):
            ref_by_name.setdefault(k, []).append(gr)
    want_grads = [torch.stack(ref_by_name[k]) for k in names]
    out_rel = rel_rms(out.float(), ref_out.float())
    grad_rel = grads_rel_rms(grads, want_grads)
    with shift_dropped(PIPE_STAGES - 1):
        bad_out, bad_grads = run()
    planted_rel = rel_rms(bad_out.float(), ref_out.float())
    del bad_out, bad_grads, grads, want_grads, ref_grads
    torch.cuda.empty_cache()
    pipe_ms = median_ms(run, n=3, warmup=1)
    seq_ms = median_ms(sequential, n=3, warmup=1)
    row = {"phase": "pipeline_check", "stages": PIPE_STAGES,
           "microbatches": PIPE_MICRO, "microbatch": [1, cfg.seq],
           "layers": len(layers), "mesh": {"dp": 2, "pp": PIPE_STAGES},
           "stage": stage, "out_rel_rms": out_rel,
           "grad_rel_rms": grad_rel, "bound": PIPE_REL,
           "planted_shift_dropped_out_rel_rms": planted_rel,
           "k1_k2_k3_k4_launches": list(launches),
           "want_launches": list(want_launches),
           "pipeline_ms": pipe_ms, "layers_in_order_ms": seq_ms,
           "bubble_fraction": (PIPE_STAGES - 1) / ticks,
           "card": card}
    row["ok"] = (out_rel < PIPE_REL and grad_rel < PIPE_REL
                 and planted_rel > PIPE_REL and launches == want_launches)
    log_fn(row)
    if not row["ok"]:
        raise AssertionError(f"16f: {row}")
    return {k: v for k, v in row.items() if k != "phase"}


def p13_multi_card(torch, np, tfm, optim, world: int, card: str, sync,
                   log_fn) -> dict:
    """Phase 16 across the cards (module docstring), after phase 15, with
    the simulated slow plane HIER_SIM_AXES."""
    import os
    from ompi_tpu_torch.parallel.mesh import SIM_DCN_ENV
    os.environ[SIM_DCN_ENV] = HIER_SIM_AXES
    out = {"collectives": hier_collectives(torch, np, card, log_fn)}
    torch.cuda.empty_cache()
    out["grad_sync"] = hier_grad_sync(torch, np, tfm, optim, world, card,
                                      sync, log_fn)
    torch.cuda.empty_cache()
    out["ulysses"] = ulysses_phase(torch, np, tfm.flagship_config(), card,
                                   log_fn)
    torch.cuda.empty_cache()
    out["mesh_steps"] = ulysses_mesh_steps(torch, np, tfm, optim, world,
                                           card, log_fn)
    torch.cuda.empty_cache()
    out["pipeline"] = pipeline_phase(torch, np, tfm, card, log_fn)
    torch.cuda.empty_cache()
    return out


def hier_rank(torch, np) -> None:
    """16b, one rank of the tpurun program: runtime.init(),
    init_device_plane(ctx), a {"dpo": 2, "dp": 2} mesh with dpo on the
    simulated slow plane, attach_mesh(comm_world, mesh, ("dpo", "dp")),
    then comm.coll.allreduce on CUDA tensors as decided and with the arm
    forced hier and hier+quant: results, arm counts, spc wire =
    hier_wire_bytes' total; a MAX allreduce refused the hier arm; with
    the shim on, its charges; timed at HIER_SIZES_MB with the shim off and
    at HIER_US_PER_MIB.  Every rank checks; rank 0 prints."""
    import os
    from ompi_tpu_torch import op as ops
    from ompi_tpu_torch import runtime
    from ompi_tpu_torch.coll import quant
    from ompi_tpu_torch.core import var
    from ompi_tpu_torch.parallel import (attach_mesh, hierarchy,
                                         init_device_plane, make_mesh,
                                         simdcn)
    from ompi_tpu_torch.parallel.mesh import SIM_DCN_ENV
    os.environ[SIM_DCN_ENV] = "dpo"
    ctx = runtime.init()
    out = log if ctx.rank == 0 else (lambda obj: None)
    init_device_plane(ctx)
    comm = ctx.comm_world
    mesh = make_mesh({"dpo": 2, "dp": 2})
    attach_mesh(comm, mesh, ("dpo", "dp"))
    dc = comm.device_comm
    card = card_line()
    spc = ctx.spc._v
    keys = ("coll_arm_native_count", "coll_arm_hier_count",
            "coll_arm_hier+quant_count", "coll_wire_bytes")
    snap = lambda: [spc.get(k, 0) for k in keys]
    force = lambda arm: var.registry.set_override(
        "coll_nccl_allreduce_mode", arm or "")
    if (comm.device_plane, comm.coll.provider("allreduce")) != ("dcn",
                                                                 "nccl"):
        raise AssertionError(f"16b: plane {comm.device_plane}, provider "
                             f"{comm.coll.provider('allreduce')}")
    count = HIER_COUNTS[-1]
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, (dc.n, count)).astype(np.float32)
    xq = rng.standard_normal((dc.n, count)).astype(np.float32)
    dev = lambda a: torch.from_numpy(a[dc.pos:dc.pos + 1]).cuda()
    f32 = torch.float32
    wires = {None: quant.wire_bytes("allreduce", count, dc.n,
                                    f32)["native_bytes"],
             "hier": hierarchy.hier_wire_bytes(count, f32, 2, 2)[
                 "total_bytes"],
             "hier+quant": hierarchy.hier_wire_bytes(
                 count, f32, 2, 2, quant=True)["total_bytes"]}
    checks = []
    for arm in (None, "hier", "hier+quant"):
        data = xq if arm == "hier+quant" else x
        force(arm)
        before = snap()
        got = comm.coll.allreduce(comm, dev(data)).cpu().numpy()
        delta = [a - b for a, b in zip(snap(), before)]
        force(None)
        exact = data.sum(axis=0)[None]
        if arm == "hier+quant":
            allow = hier_quant_allow(np, data, 2)
            err = float(np.abs(got - exact).max())
            ok = err <= allow
            bad = got.copy()
            bad[0, -1] = bad[0, -1] * 1.1 + 1
            planted_passes = bool(np.abs(bad - exact).max() <= allow)
        else:
            err = float(np.abs(got - exact).max())
            ok = coll_agree(np, got, exact, COLL_RTOL["float32"])
            bad = got.copy()
            bad[0, -1] = bad[0, -1] * 1.1 + 1
            planted_passes = coll_agree(np, bad, exact, COLL_RTOL["float32"])
        want_delta = [1 if arm is None else 0, 1 if arm == "hier" else 0,
                      1 if arm == "hier+quant" else 0, wires[arm]]
        row = {"phase": "hier_mpi_check", "arm": arm or "decided",
               "count": count, "max_abs_err": err,
               "native_hier_hierquant_wire_delta": delta,
               "want_delta": want_delta,
               "planted_row_passes": planted_passes,
               "ok": ok and not planted_passes and delta == want_delta,
               "card": card}
        out(row)
        checks.append(row)
        if not row["ok"]:
            raise AssertionError(f"16b {row['arm']}: {row}")
    # a MAX allreduce: the hier arm refused with the reference's reason
    force("hier")
    try:
        comm.coll.allreduce(comm, dev(x), op=ops.MAX)
        refused = None
    except ValueError as e:
        refused = str(e)
    force(None)
    reason = "op max has no hierarchical reduce (psum stages are sum-only)"
    out({"phase": "hier_mpi_check", "arm": "hier, op max",
         "refused": refused, "ok": refused is not None and reason in refused,
         "card": card})
    if refused is None or reason not in refused:
        raise AssertionError(f"16b: a MAX allreduce forced hier: {refused}")
    # the shim on: hier pays its outer stage, native the DCN share of its
    # ring's wire
    charged = []
    real_charge = simdcn.charge

    def charge(nbytes):
        charged.append(int(nbytes))
        real_charge(nbytes)

    var.registry.set_override("topo_sim_dcn_us_per_mib", HIER_US_PER_MIB)
    frac = simdcn.ring_dcn_fraction(mesh, ("dpo", "dp"),
                                    kinds=comm.device_kinds)
    simdcn.charge = charge
    try:
        for arm in ("native", "hier"):
            force(arm)
            charged.clear()
            comm.coll.allreduce(comm, dev(x))
            want = ([hierarchy.hier_wire_bytes(count, f32, 2, 2)[
                "outer_bytes"]] if arm == "hier"
                else [int(wires[None] * frac)])
            row = {"phase": "hier_mpi_check", "arm": f"{arm}, shim on",
                   "sim_dcn_us_per_mib": HIER_US_PER_MIB,
                   "charged_bytes": list(charged), "want": want,
                   "ok": charged == want, "card": card}
            out(row)
            checks.append(row)
            if charged != want:
                raise AssertionError(f"16b shim: {row}")
    finally:
        simdcn.charge = real_charge
        force(None)
        var.registry.set_override("topo_sim_dcn_us_per_mib", 0.0)
    numbers = []
    for us in (0.0, HIER_US_PER_MIB):
        var.registry.set_override("topo_sim_dcn_us_per_mib", us)
        for mb in HIER_SIZES_MB:
            n_el = (mb << 20) // 4
            t = torch.randn((1, n_el), device="cuda")
            ms = {}
            for arm in ("native", "hier", "hier+quant"):
                force(arm)
                ms[arm] = median_ms(lambda: comm.coll.allreduce(comm, t),
                                    n=10, warmup=3)
            force(None)
            hw = hierarchy.hier_wire_bytes(n_el, f32, 2, 2)
            hq = hierarchy.hier_wire_bytes(n_el, f32, 2, 2, quant=True)
            row = {"phase": "hier_mpi_numbers", "bytes_per_rank": n_el * 4,
                   "cards": dc.n, "sim_dcn_us_per_mib": us,
                   "native_ms": ms["native"], "hier_ms": ms["hier"],
                   "hier_quant_ms": ms["hier+quant"],
                   "native_wire_bytes": 2 * (dc.n - 1) * n_el * 4 // dc.n,
                   "hier_inner_bytes": hw["inner_bytes"],
                   "hier_outer_bytes": hw["outer_bytes"],
                   "hier_quant_outer_bytes": hq["outer_bytes"],
                   "card": card}
            out(row)
            numbers.append(row)
            del t
            torch.cuda.empty_cache()
    var.registry.set_override("topo_sim_dcn_us_per_mib", 0.0)
    comm.barrier()
    out({"hier_rank0": {"checks": checks, "numbers": numbers}})
    torch.distributed.destroy_process_group()
    runtime.finalize()


# -- 17. MoE (P12a): the einsum block, moe_block_ep, the engine's decode -----

# 17a: the narrow f32 MoE model of the checks (TF32 off), MOE_BATCH rows
MOE_NARROW = dict(vocab=512, d_model=128, n_layers=2, n_heads=8,
                  head_dim=16, d_ff=256, seq=64, mlp="moe", n_experts=8,
                  moe_top_k=2)
MOE_BATCH = 4
# card against CPU, f32, the same port code and weights: the logits to
# MOE_REL of their largest value on the tokens before the first routing
# flip (capacity is first come first served in flat token order and
# attention is causal, so no earlier token sees a later flip), the aux and
# the loss to MOE_REL relative; both sides run the same f32 products in
# other orders (~1e-7 a product), and more than MOE_FLIPS of the routes
# flipping is a fault, not a tie
MOE_REL = 1e-5
MOE_FLIPS = 0.01
# moe_block_ep against moe_block on the same tokens with nothing dropped:
# the reference test's bounds (tests/test_moe_ep.py)
MOE_EP_ATOL = 2e-5
MOE_AUX_TOL = 1e-5
# moe_eval_loss against the one-card loss_fn (tests/test_moe_ep.py)
MOE_EVAL_TOL = 5e-4
# the engine's capacity factor: C = T, so no token is dropped and the
# requests of one batch do not meet (tests/test_decode.py:344-375)
MOE_ENGINE_CF = 4.0
MOE_ENGINE_NEW = 8
# 17b: the flagship with mlp="moe" trains at batch MOE_TRAIN_BATCH x 2049
MOE_TRAIN_BATCH = 4
# 17c: the hier arms against native on the same cards and tokens: the lane
# split changes no sum a token sees, only the shapes of the f32 products
# (1e-4 of the largest value); the int8 lane within the reference test's
# 0.05 of it
MOE_HIER_REL = 1e-4
MOE_QUANT_REL = 0.05
MOE_SIM_AXES = "epo"
MOE_DECODE = (8, 512)            # the engine's decode step: max_seqs, context


def moe_cfg(tfm, torch, **kw):
    return tfm.Config(dtype=torch.float32, **{**MOE_NARROW, **kw})


@contextlib.contextmanager
def routing_recorded(moe_mod, out: list):
    """Each routing of the forward (models.moe._route, the seam every MoE
    block routes through) records its expert ids in ``out``."""
    real = moe_mod._route

    def rec(probs, top_k):
        gate_vals, expert_idx = real(probs, top_k)
        out.append(expert_idx)
        return gate_vals, expert_idx

    with planted(moe_mod, "_route", rec):
        yield


def routing_counts(ids, cfg) -> list:
    """Per layer: the tokens routed and dropped (an expert keeps the first
    C of its arrivals, so it drops max(0, load - C))."""
    out = []
    for layer in ids:
        t, k = layer.shape
        cap = max(math.ceil(t * k * cfg.moe_capacity_factor / cfg.n_experts),
                  k)
        loads = layer.reshape(-1).bincount(minlength=cfg.n_experts)
        dropped = int((loads - cap).clamp(min=0).sum())
        out.append({"routed": t * k - dropped, "dropped": dropped,
                    "capacity": cap, "max_load": int(loads.max())})
    return out


def gates_not_renormalised(torch, moe_mod):
    """Planted: the top-k gates left as the raw probabilities."""
    return planted(moe_mod, "_route",
                   lambda probs, k: torch.topk(probs, k, dim=-1))


def inverse_map_rolled(np, moe_mod):
    """Planted: the combine's inverse map one token off."""
    real = moe_mod._lane_arrays

    def rolled(*args, **kw):
        ln = real(*args, **kw)
        return ln if ln is None else dict(ln, inv=np.roll(ln["inv"], 1, 1))
    return planted(moe_mod, "_lane_arrays", rolled)


def outer_lane_dropped(moe_mod):
    """Planted: the hier dispatch's second lane (the cross-plane one)
    never built, so its tokens are never exchanged."""
    real, calls = moe_mod._lane_arrays, []

    def drop(*args, **kw):
        calls.append(1)
        return None if len(calls) == 2 else real(*args, **kw)
    return planted(moe_mod, "_lane_arrays", drop)


def experts_reversed(torch):
    """Planted: the engine's local experts laid out in reverse order."""
    from ompi_tpu_torch.serving.engine import ServingEngine
    real = ServingEngine._local_experts

    def rev(self, moe):
        return {k: (v if k == "router" else torch.flip(v, [0]))
                for k, v in real(self, moe).items()}
    return planted(ServingEngine, "_local_experts", rev)


def moe_forward_rows(tfm, moe_mod, params, tokens, cfg, dev):
    """The MoE forward's logits, aux, expert ids per layer and loss."""
    ids = []
    with routing_recorded(moe_mod, ids):
        logits, aux = tfm.forward(params, tokens[:, :-1], cfg, device=dev)
    loss = tfm.loss_fn(params, tokens, cfg, device=dev)
    return {"logits": logits.reshape(-1, logits.shape[-1]).cpu(),
            "aux": float(aux), "loss": float(loss),
            "ids": [i.cpu() for i in ids]}


def moe_card_vs_cpu(torch, np, tfm, optim, moe_mod, card, log_fn) -> dict:
    """17a: the MoE forward and loss on the card against the same code on
    the CPU (f32, attn "dense", the plain einsum block on both), routing
    flips counted and the values held where the routing agrees; a gate
    left unnormalised must fail the check."""
    cfg = moe_cfg(tfm, torch, attn="dense")
    cpu = tfm.init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    params = optim.tree_map(lambda t: t.cuda(), cpu)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (MOE_BATCH, cfg.seq + 1)))
    with torch.inference_mode():
        want = moe_forward_rows(tfm, moe_mod, cpu, tokens, cfg, "cpu")

        def check(got):
            flips = [(g != w).any(dim=1) for g, w in zip(got["ids"],
                                                         want["ids"])]
            n_flips = sum(int(f.sum()) for f in flips)
            first = min([int(f.nonzero()[0]) for f in flips if f.any()],
                        default=len(flips[0]))
            scale = float(want["logits"].abs().max())
            err = float((got["logits"][:first] - want["logits"][:first])
                        .abs().max()) / scale if first else 0.0
            aux_err = abs(got["aux"] - want["aux"]) / abs(want["aux"])
            loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            ok = (n_flips <= MOE_FLIPS * sum(f.numel() for f in flips)
                  and max(err, aux_err, loss_err) < MOE_REL)
            return ok, {"route_flips": n_flips, "tokens_held": first,
                        "logits_rel_err": err, "aux_rel_err": aux_err,
                        "loss_rel_err": loss_err}

        ok, row = check(moe_forward_rows(tfm, moe_mod, params, tokens, cfg,
                                         "cuda"))
        with gates_not_renormalised(torch, moe_mod):
            fault_ok, fault = check(moe_forward_rows(tfm, moe_mod, params,
                                                     tokens, cfg, "cuda"))
    out = {"phase": "moe_check", "case": "card_vs_cpu", **row,
           "bound": MOE_REL, "tokens": int(tokens[:, :-1].numel()),
           "routing": routing_counts(want["ids"], cfg),
           "aux": want["aux"], "loss": want["loss"],
           "fault": {"fault": "gates not renormalised", **fault,
                     "rejected": not fault_ok}, "card": card}
    log_fn(out)
    if not ok or fault_ok:
        raise AssertionError(f"17a: the MoE forward, card against CPU: {out}")
    return out


def moe_ep_check(torch, np, moe_mod, dc, rows: int, card, log_fn) -> dict:
    """``moe_block_ep`` over ``dc`` with ``rows`` rows of 64 tokens at
    capacity factor 8 (nothing dropped), f32, narrow: every row's mixture
    against ``moe_block`` on the same tokens (MOE_EP_ATOL), the aux, the
    info and the spc's wire; the combine's inverse map rolled one token
    must fail the check."""
    from ompi_tpu_torch import spc as spc_mod
    from ompi_tpu_torch.models.moe import _all_rows
    c = MOE_NARROW
    E, k, t, d = c["n_experts"], c["moe_top_k"], 64, c["d_model"]
    gen = torch.Generator().manual_seed(9)
    full = {name: w.cuda() for name, w in moe_mod.init_moe_params(
        gen, d, c["d_ff"], E, device="cpu").items()}
    h = torch.randn((rows, t, d), generator=gen).cuda()
    local = moe_mod.local_experts(full, dc)
    r = rows // dc.n
    mine = h[dc.pos * r:(dc.pos + 1) * r]
    want, want_aux = moe_mod.moe_block(h.reshape(1, rows * t, d), full, E,
                                       k, 8.0)
    want = want.reshape(rows, t, d)

    def run():
        dc.spc = spc_mod.Counters()
        out, aux, info = moe_mod.moe_block_ep(dc, mine, local, E, k, 8.0)
        err = float((_all_rows(dc, out) - want).abs().max())
        return err, float(aux), info, dc.spc.get("coll_wire_bytes")

    err, aux, info, wire = run()
    with inverse_map_rolled(np, moe_mod):
        fault_err = run()[0]
    ok = (err < MOE_EP_ATOL and abs(aux - float(want_aux)) < MOE_AUX_TOL
          and info["dropped_tokens"] == 0
          and info["routed_tokens"] == rows * t * k
          and wire == info["dispatch"]["wire_bytes"]
          + info["combine"]["wire_bytes"])
    out = {"phase": "moe_check", "case": "block_ep_vs_block",
           "rows": rows, "processes": dc.n, "tokens_per_row": t,
           "max_abs_err": err, "bound": MOE_EP_ATOL,
           "aux_err": abs(aux - float(want_aux)), "info": info,
           "spc_wire_bytes": wire, "a2av": dict(dc._last_a2av),
           "fault": {"fault": "inverse map rolled one token",
                     "max_abs_err": fault_err,
                     "rejected": not fault_err < MOE_EP_ATOL},
           "card": card}
    log_fn(out)
    if not ok or fault_err < MOE_EP_ATOL:
        raise AssertionError(f"moe_block_ep against moe_block: {out}")
    return out


def moe_engine_check(torch, np, tfm, world: int, card, log_fn) -> dict:
    """The engine with mlp="moe" on a {"tp": world} mesh, f32, narrow, at
    MOE_ENGINE_CF: 13a's four requests answered together, the streams
    equal ``tfm.greedy``'s one request at a time (attn "flash", the
    einsum block) and every step's logits within SERVE_REL of forward's;
    the engine's experts laid out in reverse must fail the check."""
    from ompi_tpu_torch import spc as spc_mod
    from ompi_tpu_torch.parallel import DeviceComm
    cfg = moe_cfg(tfm, torch, attn="flash",
                  moe_capacity_factor=MOE_ENGINE_CF)
    params = tfm.init_params(torch.Generator().manual_seed(8), cfg)
    prompts = serve_prompts(np, cfg.vocab)
    want_streams = [tfm.greedy(params, [p], MOE_ENGINE_NEW, cfg)[0]
                    for p in prompts]
    want_rows = [torch.stack([tfm.forward(params, [p + s[:t]], cfg)[0][0, -1]
                              for t in range(len(s))])
                 for p, s in zip(prompts, want_streams)]
    mesh = world_mesh({"tp": world})
    dc = DeviceComm(mesh, "tp")
    dc.spc = spc_mod.Counters()
    train = tfm.shard_params(params, mesh, cfg)
    pages = serve_pages(max(SERVE_PROMPT_LENS) + MOE_ENGINE_NEW)
    check = f32_check(want_streams, want_rows)
    eng = serve_engine(tfm, dc, train, cfg, SERVE_SEQS, pages)
    streams, rows = serve_requests(torch, np, eng, prompts, MOE_ENGINE_NEW)
    ok, err = check(streams, rows)
    with experts_reversed(torch):
        bad = serve_engine(tfm, dc, train, cfg, SERVE_SEQS, pages)
    f_streams, f_rows = serve_requests(torch, np, bad, prompts,
                                       MOE_ENGINE_NEW)
    fault_ok, fault_err = check(f_streams, f_rows)
    out = {"phase": "moe_check", "case": f"engine_tp{world}_f32",
           "requests": len(prompts), "new_tokens": MOE_ENGINE_NEW,
           "capacity_factor": MOE_ENGINE_CF,
           "tokens_equal": streams == want_streams, "max_rel_err": err,
           "bound": SERVE_REL,
           "fault": {"fault": "experts in reverse order",
                     "max_rel_err": fault_err,
                     "tokens_equal": f_streams == want_streams,
                     "rejected": not fault_ok}, "card": card}
    log_fn(out)
    if not ok or fault_ok:
        raise AssertionError(f"the MoE engine against greedy: {out}")
    return out


def moe_issued_flops_per_token(cfg, tokens: int) -> float:
    """The FLOPs a MoE train step issues a token (forward + backward, 3 x
    the forward's products; remat's recompute not counted, as in
    train_flops_per_token): the attention and logits products of the
    reference's count, the router, both one-hot einsums (2·T·E·C·d each)
    and the experts over their whole capacity (6·E·C·d·f), where
    train_flops_per_token counts one dense MLP a token."""
    h = cfg.n_heads * cfg.head_dim
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.moe_top_k
    cap = max(math.ceil(tokens * k * cfg.moe_capacity_factor / E), k)
    layer = (2 * tokens * (d * 3 * h + h * d + d * E)
             + 2 * 2 * tokens * E * cap * d + 6 * E * cap * d * f
             + 2 * cfg.seq * h * tokens)                  # causal attention
    fwd = cfg.n_layers * layer + 2 * tokens * d * cfg.vocab
    return 3.0 * fwd / tokens


def moe_parts_ms(torch, moe_mod, cfg, tokens: int, card, log_fn) -> dict:
    """Where the einsum block's forward time goes at the flagship's shapes
    (bf16): the whole block, and apart from it the dispatch einsum, the
    three expert products over (E, C) rows and the combine einsum on a
    one-hot of the same shape; the rest of the block (the router, the
    one-hot build, the weights' casts) by difference."""
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.moe_top_k
    cap = max(math.ceil(tokens * k * cfg.moe_capacity_factor / E), k)
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = moe_mod.init_moe_params(gen, d, f, E)
    h = torch.randn((1, tokens, d), generator=gen, device="cuda",
                    dtype=cfg.dtype)
    block_ms = median_ms(lambda: moe_mod.moe_block(
        h, p, E, k, cfg.moe_capacity_factor), n=10)
    onehot = torch.zeros((tokens, E, cap), device="cuda", dtype=cfg.dtype)
    onehot[torch.arange(tokens, device="cuda"),
           torch.randint(E, (tokens,), generator=gen, device="cuda"),
           torch.randint(cap, (tokens,), generator=gen, device="cuda")] = 1
    x = h[0]
    w = {n: p[n].to(cfg.dtype) for n in ("w_gate", "w_up", "w_down")}
    ein = torch.einsum("tec,td->ecd", onehot, x)

    def experts():
        g = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", ein,
                                                  w["w_gate"]))
        u = torch.einsum("ecd,edf->ecf", ein, w["w_up"])
        return torch.einsum("ecf,efd->ecd", g * u, w["w_down"])

    eout = experts()
    row = {"phase": "moe_numbers", "metric": "block_parts_fwd",
           "tokens": tokens, "capacity": cap, "block_ms": block_ms,
           "dispatch_einsum_ms": median_ms(lambda: torch.einsum(
               "tec,td->ecd", onehot, x), n=10),
           "experts_ms": median_ms(experts, n=10),
           "combine_einsum_ms": median_ms(lambda: torch.einsum(
               "tec,ecd->td", onehot, eout), n=10),
           "einsum_flops": 2 * tokens * E * cap * d,
           "experts_flops": 6 * E * cap * d * f, "card": card}
    row["rest_ms"] = block_ms - (row["dispatch_einsum_ms"]
                                 + row["experts_ms"]
                                 + row["combine_einsum_ms"])
    log_fn(row)
    del p, h, onehot, ein, eout, w
    torch.cuda.empty_cache()
    return row


def moe_time_train(torch, tfm, optim, attention, cfg, tokens, card,
                   log_fn, profile=False) -> dict:
    """The MoE train step at full width from the seed-0 weights: K1/K2/K3/K4
    launches of one step counted (the counts set to 0 just before it),
    then the median ms of TIMED_STEPS chained steps after WARMUP_STEPS by
    CUDA events, tokens/s, MFU by the reference's count and by the FLOPs
    the step issues, and the peak memory."""
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    init_opt, step = tfm.make_train_step(cfg, learning_rate=1e-3)
    state = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = cfg.n_layers
    zero_counts(attention)
    params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    per_step = launch_counts(attention)
    want = (2 * n if cfg.remat != "none" else n, n, n, 0)
    losses = [float(loss)]
    for _ in range(WARMUP_STEPS - 1):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    params, state, times, host, timed = timed_steps(torch, step, params,
                                                    state, tokens)
    losses += timed
    ms = statistics.median(times)
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    tokens_per_s = n_tokens / ms * 1e3
    issued = moe_issued_flops_per_token(cfg, n_tokens)
    row = {"phase": "moe_train_numbers", "remat": cfg.remat,
           "batch": list(tokens.shape), "step_ms": ms, "step_ms_all": times,
           "host_issue_ms": statistics.median(host),
           "tokens_per_s": tokens_per_s,
           "mfu_reference_count": tokens_per_s
           * tfm.train_flops_per_token(cfg) / PEAK_BF16_FLOPS,
           "flops_per_token_reference_count": tfm.train_flops_per_token(cfg),
           "mfu_issued": tokens_per_s * issued / PEAK_BF16_FLOPS,
           "flops_per_token_issued": issued,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "k1_k2_k3_k4_launches_per_step": list(per_step),
           "losses": losses, "card": card}
    log_fn(row)
    if per_step != want:
        raise AssertionError(f"K1/K2/K3/K4 launches in one MoE train step "
                             f"({cfg.remat}): {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"MoE train losses on one repeated batch "
                             f"({cfg.remat}): {losses}")
    if profile:
        def one_step():
            nonlocal params, state
            params, state, _ = step(params, state, tokens)
        row["profile"] = profile_run(torch, one_step, ms, card,
                                     "moe_train_step", {
                                         "K1 partials_sm90": want[0],
                                         "K2 dkdv": n, "K3 dq": n,
                                         "K4 attention_sm90": 0},
                                     log_fn=log_fn)
    del params, state
    torch.cuda.empty_cache()
    return row


def moe_flagship(torch, np, tfm, optim, attention, moe_mod, card,
                 log_fn) -> dict:
    """17b: the flagship with mlp="moe" (8 experts, top 2, cf 1.25) at full
    width, bf16: the forward's ms and each layer's routed and dropped
    tokens, the block's parts, then the train step under remat "dots",
    "none" and "full"."""
    cfg = dataclasses.replace(tfm.flagship_config(), mlp="moe")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (MOE_TRAIN_BATCH, cfg.seq + 1))).cuda()
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    n_params = sum(p.numel() for p in optim.tree_leaves(params))
    n_expert = sum(w.numel() for layer in params["layers"]
                   for name, w in layer["moe"].items() if name != "router")
    with torch.inference_mode():
        ids = []
        with routing_recorded(moe_mod, ids):
            logits, aux = tfm.forward(params, tokens[:, :-1], cfg)
        torch.cuda.synchronize()
        if logits.shape != (MOE_TRAIN_BATCH, cfg.seq, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()) or \
                not math.isfinite(float(aux)):
            raise AssertionError(f"MoE logits {tuple(logits.shape)}, aux "
                                 f"{float(aux)}")
        del logits
        fwd_ms = median_ms(lambda: tfm.forward(params, tokens[:, :-1], cfg),
                           n=5, warmup=1)
    n_tokens = MOE_TRAIN_BATCH * cfg.seq
    fwd = {"phase": "moe_forward", "config": dataclasses.asdict(cfg)
           | {"dtype": str(cfg.dtype)}, "batch": [MOE_TRAIN_BATCH, cfg.seq],
           "n_params": n_params, "n_expert_params": n_expert,
           "forward_ms": fwd_ms, "forward_tokens_per_s": n_tokens / fwd_ms
           * 1e3, "aux": float(aux),
           "routing_per_layer": routing_counts(ids, cfg), "card": card}
    log_fn(fwd)
    del params, ids
    torch.cuda.empty_cache()
    parts = moe_parts_ms(torch, moe_mod, cfg, n_tokens, card, log_fn)
    train = [moe_time_train(torch, tfm, optim, attention,
                            dataclasses.replace(cfg, remat=remat), tokens,
                            card, log_fn, profile=remat == "dots")
             for remat in ("dots", "none", "full")]
    return {"forward": fwd, "parts": parts, "train": train}


def moe_one_card(torch, np, tfm, optim, attention, card, log_fn=log) -> dict:
    """Phase 17 on one card (17a, 17b), in phase 9's one-process world."""
    from ompi_tpu_torch.models import moe as moe_mod
    from ompi_tpu_torch.parallel import DeviceComm
    out = {"card_vs_cpu": moe_card_vs_cpu(torch, np, tfm, optim, moe_mod,
                                          card, log_fn)}
    torch.cuda.empty_cache()
    dc = DeviceComm(world_mesh({"x": 1}), "x")
    out["block_ep"] = moe_ep_check(torch, np, moe_mod, dc, 8, card, log_fn)
    out["engine"] = moe_engine_check(torch, np, tfm, 1, card, log_fn)
    torch.cuda.empty_cache()
    out["flagship"] = moe_flagship(torch, np, tfm, optim, attention,
                                   moe_mod, card, log_fn)
    return out


def moe_ep_numbers(torch, np, moe_mod, dc, cfg, dtype, arms, card,
                   log_fn) -> dict:
    """``moe_block_ep`` at the flagship's width over ``dc`` (one row of
    2048 tokens a card, cf 1.25) for each arm of ``arms`` (name -> the
    force variables): each arm's host-clock ms a call (it ends in a
    device sync), its info and spc wire, the last exchange's plan, and
    its mixture (for the checks)."""
    from ompi_tpu_torch import spc as spc_mod
    from ompi_tpu_torch.core import var
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.moe_top_k
    t = MOE_TRAIN_BATCH * cfg.seq // dc.n
    gen = torch.Generator(device="cuda").manual_seed(5)
    full = moe_mod.init_moe_params(gen, d, f, E)
    local = {n: (w if n == "router" else w.to(dtype))
             for n, w in moe_mod.local_experts(full, dc).items()}
    del full
    h = torch.randn((dc.n, t, d), generator=gen, device="cuda",
                    dtype=dtype)[dc.pos:dc.pos + 1]
    out = {}
    for arm, force in arms.items():
        for name, value in force.items():
            var.registry.set_cli(name, value)
        try:
            dc.spc = spc_mod.Counters()
            mix, aux, info = moe_mod.moe_block_ep(dc, h, local, E, k,
                                                  cfg.moe_capacity_factor)
            wire = dc.spc.get("coll_wire_bytes")
            a2av = dict(dc._last_a2av)

            def call():
                moe_mod.moe_block_ep(dc, h, local, E, k,
                                     cfg.moe_capacity_factor)
                torch.cuda.synchronize()
            ms = timed_ms(torch, call, n=5, warmup=1)
        finally:
            for name in force:
                var.registry.clear_cli(name)
        row = {"phase": "moe_ep_numbers", "arm": arm,
               "axes": dc.axis, "dtype": str(dtype), "tokens_per_card": t,
               "ms": ms, "tokens_per_s": t * dc.n / ms * 1e3,
               "info": info, "spc_wire_bytes": wire, "a2av": a2av,
               "card": card}
        log_fn(row)
        out[arm] = {"row": row, "mix": mix.float()}
    return out


def moe_hier_check(rows: dict) -> dict:
    """The hier arms against native on the same tokens, and their
    bookkeeping: inner + outer = wire in each leg, the spc's wire the two
    legs', hier+quant's dispatch the hier dispatch and only its outer
    combine smaller."""
    native = rows["native"]["mix"]
    scale = float(native.abs().max())
    err = {a: float((rows[a]["mix"] - native).abs().max()) / scale
           for a in ("hier", "hier+quant")}
    info = {a: rows[a]["row"]["info"] for a in rows}
    conserve = all(
        info[a][leg]["inner_bytes"] + info[a][leg]["outer_bytes"]
        == info[a][leg]["wire_bytes"]
        and rows[a]["row"]["spc_wire_bytes"] == info[a]["dispatch"][
            "wire_bytes"] + info[a]["combine"]["wire_bytes"]
        for a in info for leg in ("dispatch", "combine"))
    h, q = info["hier"], info["hier+quant"]
    split = (h["dispatch"]["arm"] == h["combine"]["arm"] == "hier"
             and h["dispatch"]["outer_bytes"] > 0
             and q["dispatch"] == h["dispatch"]
             and q["combine"]["arm"] == "hier+quant"
             and q["combine"]["inner_bytes"] == h["combine"]["inner_bytes"]
             and q["combine"]["outer_bytes"] < h["combine"]["outer_bytes"])
    ok = (err["hier"] < MOE_HIER_REL and err["hier+quant"] < MOE_QUANT_REL
          and conserve and split)
    return {"ok": ok, "rel_err": err, "conserved": conserve,
            "lanes_split": split}


def moe_multi_card(torch, np, tfm, world: int, card: str, log_fn) -> dict:
    """17c across the cards (module docstring)."""
    import os
    from ompi_tpu_torch.models import moe as moe_mod
    from ompi_tpu_torch.parallel import DeviceComm
    from ompi_tpu_torch.parallel.mesh import SIM_DCN_ENV
    cfg = dataclasses.replace(tfm.flagship_config(), mlp="moe")
    ep = DeviceComm(world_mesh({"ep": world}), "ep")
    out = {"block_ep": moe_ep_check(torch, np, moe_mod, ep, 2 * world,
                                    card, log_fn)}
    out["native"] = moe_ep_numbers(torch, np, moe_mod, ep, cfg,
                                   torch.bfloat16, {"native": {}}, card,
                                   log_fn)["native"]["row"]
    torch.cuda.empty_cache()
    # hier and hier+quant on {"epo": 2, "epi": world/2}, epo the simulated
    # slow plane, f32 (the reference's combine quantizes float32, not
    # bfloat16)
    os.environ[SIM_DCN_ENV] = MOE_SIM_AXES
    try:
        two = DeviceComm(world_mesh({"epo": 2, "epi": world // 2}),
                         ("epo", "epi"))
        force = lambda arm: {"coll_nccl_moe_dispatch_mode": arm,
                             "coll_nccl_moe_combine_mode": arm}
        arms = moe_ep_numbers(torch, np, moe_mod, two, cfg, torch.float32,
                              {"native": force("native"),
                               "hier": force("hier"),
                               "hier+quant": force("hier+quant")},
                              card, log_fn)
        check = moe_hier_check(arms)
        with outer_lane_dropped(moe_mod):
            faulty = moe_ep_numbers(torch, np, moe_mod, two, cfg,
                                    torch.float32, {"hier": force("hier")},
                                    card, lambda row: None)
        fault = moe_hier_check({**arms, "hier": faulty["hier"]})
    finally:
        os.environ.pop(SIM_DCN_ENV, None)
    row = {"phase": "moe_check", "case": "hier_arms", **{
        k: v for k, v in check.items() if k != "ok"},
        "bounds": {"hier": MOE_HIER_REL, "hier+quant": MOE_QUANT_REL},
        "fault": {"fault": "the outer dispatch lane dropped",
                  "rel_err": fault["rel_err"], "rejected": not fault["ok"]},
        "card": card}
    log_fn(row)
    if not check["ok"] or fault["ok"]:
        raise AssertionError(f"17c: the hier arms: {row}")
    out["hier"] = row
    del arms, faulty
    torch.cuda.empty_cache()
    out["eval_loss"] = moe_eval_check(torch, np, tfm, moe_mod, ep, card,
                                      log_fn)
    out["engine"] = moe_engine_check(torch, np, tfm, world, card, log_fn)
    torch.cuda.empty_cache()
    out["decode"] = moe_decode_numbers(torch, np, tfm, moe_mod, world, cfg,
                                       card, log_fn)
    return out


def moe_eval_check(torch, np, tfm, moe_mod, dc, card, log_fn) -> dict:
    """``moe_eval_loss`` over ``dc`` (one row a card; f32, narrow,
    attn "flash", cf 8) against the one-card ``loss_fn`` on the same
    weights and batch (MOE_EVAL_TOL); gates left unnormalised in the
    expert-parallel path must fail it."""
    cfg = moe_cfg(tfm, torch, attn="flash", moe_capacity_factor=8.0)
    params = tfm.init_params(torch.Generator().manual_seed(11), cfg)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (MOE_BATCH, cfg.seq + 1))).cuda()
    with torch.inference_mode():
        want = float(tfm.loss_fn(params, tokens, cfg))
    local = dict(params, layers=[
        dict(layer, moe=moe_mod.local_experts(layer["moe"], dc))
        for layer in params["layers"]])
    got = float(tfm.moe_eval_loss(dc, local, tokens, cfg))
    with gates_not_renormalised(torch, moe_mod):
        bad = float(tfm.moe_eval_loss(dc, local, tokens, cfg))
    row = {"phase": "moe_check", "case": "eval_loss", "processes": dc.n,
           "loss": got, "one_card_loss": want, "abs_err": abs(got - want),
           "bound": MOE_EVAL_TOL,
           "fault": {"fault": "gates not renormalised",
                     "abs_err": abs(bad - want),
                     "rejected": not abs(bad - want) < MOE_EVAL_TOL},
           "card": card}
    log_fn(row)
    if not abs(got - want) < MOE_EVAL_TOL or abs(bad - want) < MOE_EVAL_TOL:
        raise AssertionError(f"moe_eval_loss against loss_fn: {row}")
    return row


def moe_decode_numbers(torch, np, tfm, moe_mod, world: int, cfg, card,
                       log_fn) -> dict:
    """The MoE engine's decode step at the flagship's width, bf16, on a
    {"tp": world} mesh, every slot of MOE_DECODE at its context: the
    host-clock ms a step and the tokens each MoE layer routed in it."""
    from ompi_tpu_torch.parallel import DeviceComm
    max_seqs, context = MOE_DECODE
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    mesh = world_mesh({"tp": world})
    train = tfm.shard_params(params, mesh, cfg)
    del params
    torch.cuda.empty_cache()
    eng = serve_engine(tfm, DeviceComm(mesh, "tp"), train, cfg, max_seqs,
                       serve_pages(context + 1))
    del train
    for _ in range(max_seqs):
        eng.cache.admit(context, 1)
    tokens = np.arange(max_seqs, dtype=np.int64)
    positions = np.full(max_seqs, context - 1, np.int64)
    step = lambda: eng.decode_step(tokens, positions)
    ms = timed_ms(torch, step)
    infos = []
    real = moe_mod.moe_block_ep

    def rec(*args, **kw):
        res = real(*args, **kw)
        infos.append(res[2])
        return res
    with planted(moe_mod, "moe_block_ep", rec):
        step()
    row = {"phase": "moe_numbers", "metric": "decode_step", "cards": world,
           "max_seqs": max_seqs, "context": context, "step_ms": ms,
           "tokens_per_s": max_seqs / ms * 1e3,
           "routed_per_layer": [i["routed_tokens"] for i in infos],
           "dropped_per_layer": [i["dropped_tokens"] for i in infos],
           "wire_per_layer": [i["dispatch"]["wire_bytes"]
                              + i["combine"]["wire_bytes"] for i in infos],
           "card": card}
    log_fn(row)
    if len(infos) != cfg.n_layers:
        raise AssertionError(f"a MoE decode step ran moe_block_ep "
                             f"{len(infos)} times, want {cfg.n_layers}")
    del eng
    torch.cuda.empty_cache()
    return row


# -- 17d. the MoE mesh train step (P12b) across the cards --------------------

# the reference's dp2·ep2·tp2 cut to four cards, as 10c cuts dp2·sp2·tp2
MOE_MESH_LAYOUTS = [{"dp": 1, "ep": 2, "tp": 2}, {"dp": 2, "ep": 2, "tp": 1}]
# the parity check: the flagship's width, depth cut to MOE_MESH_LAYERS, f32
# (TF32 off), remat "none"; the mesh step against the one-card step on the
# same weights and tokens, routed with the mesh's expert ids.  The same f32
# products summed in other orders (over ranks, over tp's halves of each
# product): the loss to MOE_MESH_LOSS_REL, the gradients by relative RMS
# over all leaves to MOE_MESH_GRAD_RMS; each planted fault must fail the
# gradient check.  The router's f32 logits move by those orders too, so a
# token whose k-th and next probability nearly tie can route otherwise on
# the mesh than on one card (one token of 8192 did at (1, 2, 2) on four
# H100s): such flips are counted against the one card's own routing, each
# with its probability gap, which must stay under MOE_MESH_TIE.
MOE_MESH_LAYERS = 2
MOE_MESH_LOSS_REL = 1e-5
MOE_MESH_GRAD_RMS = 1e-4
MOE_MESH_TIE = 1e-4
# the capacity factor is cut by this factor while the routing over each dp
# shard's own tokens drops as many tokens as the global routing in every
# layer (fault (a) must be able to show), down to MOE_MESH_CF_MIN
MOE_MESH_CF_CUT = 0.8
MOE_MESH_CF_MIN = 0.1


def mesh_drops(torch, ids, cfg, shards: int) -> dict:
    """Per layer, the (token, slot) pairs dropped by the global routing
    and by each of ``shards`` batch shards routed over its own tokens (its
    own capacity and positions: moe_block's loop on each), and how many
    pairs the two keep apart."""
    from ompi_tpu_torch.models import moe as moe_mod

    def kept(ids):
        t, k = ids.shape
        cap = max(math.ceil(t * k * cfg.moe_capacity_factor
                            / cfg.n_experts), k)
        return moe_mod._positions(ids, cfg.n_experts, cap) < cap

    glob, local, apart = [], [], []
    for layer in ids:
        keep = kept(layer)
        n = layer.shape[0] // shards
        mine = torch.cat([kept(layer[i * n:(i + 1) * n])
                          for i in range(shards)])
        glob.append(int((~keep).sum()))
        local.append(int((~mine).sum()))
        apart.append(int((keep != mine).sum()))
    return {"global": glob, "rank_local": local, "kept_apart": apart}


def one_card_ids(torch, tfm, moe_mod, params, tokens, cfg,
                 probs=None) -> list:
    """Each MoE layer's (T, k) expert ids in the one-card forward (and
    its router probabilities into ``probs``, a list, when given)."""
    ids, real = [], moe_mod._route

    def rec(p, top_k):
        if probs is not None:
            probs.append(p)
        return real(p, top_k)

    with torch.inference_mode(), planted(moe_mod, "_route", rec), \
            routing_recorded(moe_mod, ids):
        tfm.forward(params, tokens[:, :-1], cfg)
    return ids


def routed_as(moe_mod, ids):
    """The one-card block routed with ``ids``, each layer's (T, k) expert
    ids in layer order (remat "none": one routing a layer), its gates read
    from its own probabilities at those experts."""
    it = iter(ids)

    def route(probs, top_k):
        idx = next(it)
        gate_vals = probs.gather(-1, idx)
        if top_k > 1:
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        return gate_vals, idx
    return planted(moe_mod, "_route", route)


def routing_flips(got, want, probs) -> list:
    """Per layer, the tokens whose ids in ``got`` differ from ``want``
    (the one card's), each with the gap between the one card's
    probabilities at the first expert where they part and the next one
    down its order."""
    out = []
    for g, w, p in zip(got, want, probs):
        rows = (g != w).any(dim=1).nonzero()[:, 0]
        top = p[rows].sort(dim=-1, descending=True).values
        part = [int((g[r] != w[r]).nonzero()[0]) for r in rows.tolist()]
        out.append([{"token": r, "slot": s_,
                     "gap": float(top[i, s_] - top[i, s_ + 1])}
                    for i, (r, s_) in enumerate(zip(rows.tolist(), part))])
    return out


def moe_mesh_cf(torch, tfm, moe_mod, params, tokens, cfg, shards: int):
    """The capacity factor of the parity check: cfg's, cut by
    MOE_MESH_CF_CUT while the routing over each of ``shards`` dp shards'
    own tokens drops as many tokens as the global routing in every layer;
    agreed over the world (the smallest).  Returns (cfg at that factor,
    the drops at it)."""
    while True:
        drops = mesh_drops(torch, one_card_ids(torch, tfm, moe_mod, params,
                                               tokens, cfg), cfg, shards)
        if drops["global"] != drops["rank_local"] or \
                cfg.moe_capacity_factor * MOE_MESH_CF_CUT < MOE_MESH_CF_MIN:
            break
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.moe_capacity_factor
            * MOE_MESH_CF_CUT)
    cf = torch.tensor([cfg.moe_capacity_factor], device="cuda")
    torch.distributed.all_reduce(cf, op=torch.distributed.ReduceOp.MIN)
    if float(cf) != cfg.moe_capacity_factor:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cf))
        drops = mesh_drops(torch, one_card_ids(torch, tfm, moe_mod, params,
                                               tokens, cfg), cfg, shards)
    return cfg, drops


def local_routing(torch):
    """Planted (a): the capacity and positions taken over this rank's own
    tokens (its ids alone, not the batch's)."""
    from ompi_tpu_torch.models import moe as moe_mod

    def local(expert_idx, plan):
        k = expert_idx.shape[-1]
        return (expert_idx.reshape(-1, k),
                torch.arange(expert_idx[..., 0].numel(),
                             device=expert_idx.device))
    return planted(moe_mod, "_global_ids", local)


def dispatch_ep_sum_skipped():
    """Planted (b): the dispatch input's cotangent not summed over ep (each
    rank keeps its own experts' part)."""
    from ompi_tpu_torch.models import moe as moe_mod
    return planted(moe_mod, "_dispatch_input", lambda x, plan: x)


def combine_gather_reduce_scattered(torch):
    """Planted (c): the combine gather's backward a reduce-scatter over ep
    (every ep rank's identical cotangent summed)."""
    from ompi_tpu_torch.models import moe as moe_mod
    from ompi_tpu_torch.parallel.collectives import (all_gather_axis,
                                                     reduce_scatter_axis)

    class Summed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mesh):
            ctx.mesh = mesh
            return all_gather_axis(x.contiguous(), "ep", mesh=mesh)

        @staticmethod
        def backward(ctx, g):
            return reduce_scatter_axis(g.contiguous(), "ep",
                                       mesh=ctx.mesh), None

    return planted(moe_mod, "_combine_gather",
                   lambda eout, plan: Summed.apply(eout, plan.mesh))


def world_max(torch, x: float) -> float:
    """The largest of every rank's ``x``."""
    t = torch.tensor([x], dtype=torch.float64, device="cuda")
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t)


def moe_mesh_parity(torch, tfm, optim, moe_mod, cfg, mesh, pristine,
                    tokens, card, log_fn) -> dict:
    """17d's check on one layout: the mesh step's loss and each rank's
    gradient shards against the one-card step's routed with the mesh's
    expert ids, its gradients cut to this rank's slices by shard_params,
    and each planted fault rejected; the mesh's ids against the one card's
    own routing (flips and their gaps); every rank's figures, the worst
    over the world."""
    dims = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    ids, real = [], moe_mod._global_ids

    def rec(expert_idx, plan):
        everyone, rows = real(expert_idx, plan)
        ids.append(everyone)
        return everyone, rows

    def mesh_step():
        return tfm.value_and_grad(tfm.shard_params(pristine, mesh, cfg),
                                  tokens, cfg, mesh=mesh)

    with planted(moe_mod, "_global_ids", rec):
        loss, grads = mesh_step()
    with routed_as(moe_mod, ids):
        wloss, wgrads = tfm.value_and_grad(
            optim.tree_map(lambda t: t.clone(), pristine), tokens, cfg)
    wloss = float(wloss)
    of = dict(zip(map(id, optim.tree_leaves(pristine)), wgrads))
    mine = optim.tree_leaves(tfm.shard_params(
        optim.tree_map(lambda p: of[id(p)], pristine), mesh, cfg))
    del of, wgrads
    loss_rel = world_max(torch, abs(float(loss) - wloss) / abs(wloss))
    grad_rel = world_max(torch, grads_rel_rms(grads, mine))
    del grads
    probs = []
    natural = one_card_ids(torch, tfm, moe_mod, pristine, tokens, cfg,
                           probs)
    flips = routing_flips(ids, natural, probs)
    del probs, natural
    gap = max([f["gap"] for layer in flips for f in layer] + [0.0])
    faults = {"dispatch_ep_sum_skipped": dispatch_ep_sum_skipped,
              "combine_gather_reduce_scattered":
                  lambda: combine_gather_reduce_scattered(torch)}
    if dims.get("dp", 1) * dims.get("sp", 1) > 1:
        faults = {"local_capacity": lambda: local_routing(torch), **faults}
    planted_rel = {}
    for name, fault in faults.items():
        with fault():
            planted_rel[name] = world_max(torch, grads_rel_rms(
                mesh_step()[1], mine))
    row = {"phase": "moe_mesh_step", "mesh": dims, "cf":
           cfg.moe_capacity_factor, "loss": float(loss),
           "one_card_loss": wloss, "loss_rel": loss_rel,
           "loss_bound": MOE_MESH_LOSS_REL, "grad_rel_rms": grad_rel,
           "grad_bound": MOE_MESH_GRAD_RMS,
           "routing_flips": [len(layer) for layer in flips],
           "flips": flips, "largest_flip_gap": gap, "tie_bound": MOE_MESH_TIE,
           "planted_grad_rel_rms": planted_rel, "card": card}
    log_fn(row)
    if not (loss_rel < MOE_MESH_LOSS_REL and grad_rel < MOE_MESH_GRAD_RMS
            and gap < MOE_MESH_TIE
            and all(x > MOE_MESH_GRAD_RMS for x in planted_rel.values())):
        raise AssertionError(f"17d, the MoE mesh step: {row}")
    return row


def moe_mesh_multi_card(torch, np, tfm, optim, attention, world: int,
                        card: str, log_fn) -> dict:
    """17d across the cards (module docstring): the parity check on each
    layout of MOE_MESH_LAYOUTS, then the full flagship with mlp="moe"
    timed on each."""
    from ompi_tpu_torch.models import moe as moe_mod
    cfg = dataclasses.replace(tfm.flagship_config(), mlp="moe",
                              n_layers=MOE_MESH_LAYERS,
                              dtype=torch.float32, remat="none")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (MOE_TRAIN_BATCH, cfg.seq + 1))).cuda()
    pristine = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg)
    shards = max(lay.get("dp", 1) for lay in MOE_MESH_LAYOUTS)
    cfg, drops = moe_mesh_cf(torch, tfm, moe_mod, pristine, tokens, cfg,
                             shards)
    log_fn({"phase": "moe_mesh_drops", "cf": cfg.moe_capacity_factor,
            "tokens": tokens.shape[0] * (tokens.shape[1] - 1),
            "shards": shards, **drops, "card": card})
    rows = [moe_mesh_parity(torch, tfm, optim, moe_mod, cfg,
                            world_mesh(lay), pristine, tokens, card, log_fn)
            for lay in MOE_MESH_LAYOUTS]
    del pristine
    torch.cuda.empty_cache()
    full = dataclasses.replace(tfm.flagship_config(), mlp="moe")
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             full)
    n = full.n_layers
    timed = []
    for lay in MOE_MESH_LAYOUTS:
        t = time_train(torch, tfm, optim, full, params, tokens, card,
                       mesh=world_mesh(lay), log_fn=log_fn,
                       attention=attention)
        if t["k1_k2_k3_k4_launches_per_step"] != [2 * n, n, n, 0]:
            raise AssertionError(f"17d: K1/K2/K3/K4 launches a MoE mesh "
                                 f"step: {t}")
        timed.append({k: t[k] for k in (
            "mesh", "step_ms", "tokens_per_s", "mfu", "peak_bytes",
            "host_issue_ms", "k1_k2_k3_k4_launches_per_step")})
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return {"cf": cfg.moe_capacity_factor, "drops": drops,
            "checks": rows, "timed": timed}


def moe_card_worker(rank: int, world: int, init_method: str,
                    card: str) -> None:
    """One rank of phases 17c and 17d across the cards, in an NCCL world
    of its own."""
    import numpy as np
    import torch
    from ompi_tpu_torch import optim
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import init_device_plane
    torch.backends.cuda.matmul.allow_tf32 = False
    init_device_plane(rank=rank, world_size=world, init_method=init_method,
                      timeout_s=600)
    out = log if rank == 0 else (lambda obj: None)
    moe = moe_multi_card(torch, np, tfm, world, card, out)
    torch.cuda.empty_cache()
    # 17d: the MoE mesh train step on the cards
    moe["mesh_step"] = moe_mesh_multi_card(torch, np, tfm, optim, attention,
                                           world, card, out)
    out({"moe": moe})
    leave_world(torch, out)


# -- 11. the MPI surface: runtime, comm and coll/nccl under tpurun ----------

# the entries coll/nccl serves (every one must be its provider)
MPI_ENTRIES = ("allreduce", "reduce", "bcast", "allgather", "alltoall",
               "reduce_scatter_block", "scan", "exscan", "barrier",
               "allgatherv", "gather", "gatherv", "scatter", "scatterv",
               "alltoallv", "reduce_scatter")
# coll/tuned's host allreduce is timed up to 4 MB a rank (f32 counts)
HOST_SIZES = [2, 256, 16 * 1024, 262_144, 1 << 20]
RING_LAPS = 200          # the timed ring, after the example's 10 laps


def mpi_cases(torch, np, comm, dc, R: int, lo: int, hi: int):
    """(entry, run, want, rtol) for comm.coll on this process's rows
    [lo, hi) of R: run() gives the local result as numpy (bf16 as f32),
    want the MPI result's same rows from numpy; rtol None = bitwise."""
    rng = np.random.default_rng(0)
    ints = lambda *s: rng.integers(-8, 9, s).astype(np.float32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(
        dc.device)
    host = lambda t: (t.float() if t.dtype == torch.bfloat16 else t
                      ).cpu().numpy()
    rep = lambda row: np.broadcast_to(row, (R,) + row.shape)[lo:hi]
    bf16 = lambda a: dev(a).to(torch.bfloat16)
    cc, cases = comm.coll, []
    add = lambda name, run, want, rtol=None: cases.append(
        (name, run, want, rtol))
    x = ints(R, 64)
    add("allreduce f32", lambda: host(cc.allreduce(comm, dev(x))),
        rep(x.sum(0)), COLL_RTOL["float32"])
    add("allreduce bf16", lambda: host(cc.allreduce(comm, bf16(x))),
        rep(x.sum(0)), COLL_RTOL["bfloat16"])
    root = R - 1
    add("bcast", lambda: host(cc.bcast(comm, dev(x), root=root)),
        rep(x[root]))
    x3 = ints(R, 4, 2)
    add("allgather", lambda: host(cc.allgather(comm, dev(x3))),
        rep(x3.reshape(R * 4, 2)))
    xs = ints(R, R * 6)
    add("reduce_scatter_block f32",
        lambda: host(cc.reduce_scatter_block(comm, dev(xs))),
        xs.sum(0).reshape(R, 6)[lo:hi], COLL_RTOL["float32"])
    add("reduce_scatter_block bf16",
        lambda: host(cc.reduce_scatter_block(comm, bf16(xs))),
        xs.sum(0).reshape(R, 6)[lo:hi], COLL_RTOL["bfloat16"])
    xa = ints(R, R, 3)
    add("alltoall", lambda: host(cc.alltoall(comm, dev(xa))),
        np.swapaxes(xa, 0, 1)[lo:hi])
    counts = [int(c) for c in rng.integers(1, 6, R)]
    cap = dc._bucket(max(counts))
    padded = np.zeros((R, cap), np.float32)
    for i, c in enumerate(counts):
        padded[i, :c] = ints(c)
    cat = np.concatenate([padded[i, :c] for i, c in enumerate(counts)])
    add("allgatherv", lambda: host(cc.allgatherv(comm, dev(padded),
                                                 counts=counts)), rep(cat))
    C = rng.integers(0, 4, (R, R))
    dense = ints(R, int(C.sum(1).max()) + 1)
    out_cap = dc._bucket(max(1, int(C.sum(0).max())))
    # destination j receives, source by source, source i's C[i, j] values
    # that follow what i sends to destinations before j
    end = np.cumsum(C, axis=1)
    recv = np.zeros((R, out_cap), np.float32)
    for j in range(R):
        got = np.concatenate([dense[i, end[i, j] - C[i, j]:end[i, j]]
                              for i in range(R)])
        recv[j, :got.size] = got
    add("alltoallv", lambda: host(cc.alltoallv(comm, dev(dense), None, C,
                                               C.sum(0))), recv[lo:hi])
    return cases, x, dev, host


def mpi_rank(torch, np, r_per: int, timed, host_timed: bool) -> None:
    """One rank of phase 11's device program (under the port's tpurun):
    runtime.init(), init_device_plane(ctx) on NCCL, attach_mesh, then
    comm.coll on CUDA tensors — coll/nccl's checks and its times beside
    DeviceComm's.  Every rank checks; rank 0 prints."""
    from ompi_tpu_torch import runtime
    from ompi_tpu_torch.core import var
    from ompi_tpu_torch.parallel import (attach_mesh, init_device_plane,
                                         make_mesh)
    import os
    ctx = runtime.init()
    out = log if ctx.rank == 0 else (lambda obj: None)
    dev0 = init_device_plane(ctx)
    # NCCL on the card; gloo only when the launcher asked for the CPU
    # plane (a rehearsal on a machine without a card)
    want = (("cpu", "gloo") if os.environ.get("OMPI_TPU_DEVICE_PLANE")
            == "cpu" else ("cuda", "nccl"))
    if (dev0.type, torch.distributed.get_backend()) != want:
        raise AssertionError(f"device plane on {dev0}, "
                             f"{torch.distributed.get_backend()}")
    comm = ctx.comm_world
    attach_mesh(comm, make_mesh({"x": ctx.size}), "x")
    dc = comm.device_comm
    providers = {e: comm.coll.provider(e) for e in MPI_ENTRIES}
    if set(providers.values()) != {"nccl"}:
        raise AssertionError(f"providers {providers}")
    R, lo, hi = r_per * ctx.size, ctx.rank * r_per, (ctx.rank + 1) * r_per
    spc = ctx.spc._v
    arm = lambda: (spc.get("coll_arm_native_count", 0),
                   spc.get("coll_arm_staged_count", 0),
                   spc.get("device_stage_out_bytes", 0))
    cases, x, dev, host = mpi_cases(torch, np, comm, dc, R, lo, hi)
    checked = []
    for name, run, want, rtol in cases:
        before = arm()
        got = run()
        after = arm()
        ok = coll_agree(np, got, want, rtol)
        bad = got.copy()
        last = bad.reshape(bad.shape[0], -1)[-1]
        last[:] = last * 1.1 + 1                   # one row 10% and 1 off
        planted = coll_agree(np, bad, want, rtol)
        err = float(np.abs(got.astype(np.float64) - want).max())
        delta = [a - b for a, b in zip(after, before)]
        # one native call, nothing staged; only the CPU plane's own
        # default (the JAX package's) stages a dense alltoall
        want_delta = [1, 0, 0]
        if dc.device.type == "cpu" and name == "alltoall":
            want_delta = [0, 1, int(want.nbytes)]
        out({"phase": "mpi_check", "entry": name, "rows": [lo, hi, R],
             "rtol": rtol, "max_abs_err": err, "planted_row_passes": planted,
             "native_staged_stageout_delta": delta,
             "ok": ok and not planted and delta == want_delta})
        if not ok or planted:
            raise AssertionError(f"comm.coll {name}: ok={ok}, a planted "
                                 f"wrong row passes={planted} (err {err})")
        if delta != want_delta:
            raise AssertionError(f"comm.coll {name}: arm counts moved by "
                                 f"{delta}, want {want_delta} (native, "
                                 f"staged, bytes staged out)")
        checked.append(name)
    # the staged arm, forced: the same result, this process's rows counted
    var.registry.set_override("coll_nccl_allreduce_mode", "staged")
    before = arm()
    got = host(comm.coll.allreduce(comm, dev(x)))
    staged_delta = [a - b for a, b in zip(arm(), before)]
    var.registry.set_override("coll_nccl_allreduce_mode", "")
    want = np.broadcast_to(x.sum(0), x.shape)[lo:hi]
    if not coll_agree(np, got, want, COLL_RTOL["float32"]) or \
            staged_delta != [0, 1, (hi - lo) * x[0].nbytes]:
        raise AssertionError(f"forced staged allreduce: counts "
                             f"{staged_delta}")
    out({"phase": "mpi_check", "entry": "allreduce forced staged",
         "native_staged_stageout_delta": staged_delta, "ok": True})
    # a numpy buffer on the same communicator: the host algorithms
    before = arm()
    got = comm.coll.allreduce(comm, np.full(16, ctx.rank + 1.0, np.float32))
    if arm() != before or not np.all(got == ctx.size * (ctx.size + 1) / 2):
        raise AssertionError("a numpy buffer did not take the host path")
    out({"phase": "mpi_check", "entry": "allreduce numpy (host path)",
         "provider": "tuned", "ok": True})
    # 12c: the quant arm, forced: one quant count; exact in one process
    # (the rows fold in f32, nothing is quantized), else within the
    # reference's error model
    quant_rows = mpi_quant(torch, np, comm, dc, x, dev, host, R, lo, hi,
                           out)
    comm.barrier()

    # times: comm.coll beside DeviceComm called directly, the staged arm,
    # the HBM bound; bench.py's sizes
    card = card_line()
    rows = []
    rng = np.random.default_rng(1)
    for count in COLL_SIZES:
        nbytes, big = count * 4, count * 4 >= 1 << 24
        t = torch.from_numpy(rng.standard_normal(
            (r_per, count), dtype=np.float32)).to(dc.device)
        for coll in timed:
            if coll == "alltoall" and count % R:
                continue
            arg = t.reshape(r_per, R, count // R) if coll == "alltoall" \
                else t
            comp = getattr(comm.coll, coll)
            direct = {"allreduce": dc.allreduce, "bcast": dc.bcast,
                      "allgather": dc.allgather,
                      "alltoall": dc.alltoall}[coll]
            kw = dict(n=10 if big else 20, warmup=10, reps=KERNEL_REPS)
            comm_ms = median_ms(lambda: comp(comm, arg), **kw)
            dc_ms = median_ms(lambda: direct(arg), **kw)
            staged_ms = None
            if coll == "allreduce":
                var.registry.set_override("coll_nccl_allreduce_mode",
                                          "staged")
                staged_ms = median_ms(lambda: comp(comm, arg),
                                      n=1 if big else 3,
                                      warmup=0 if big else 1)
                var.registry.set_override("coll_nccl_allreduce_mode", "")
            bound_b = coll_bytes(coll, R, ctx.size, nbytes, count, 0)
            hbm_ms = bound_b / PEAK_BYTES * 1e3
            # across cards the data crosses NVLink, which has no bound
            # here yet: the HBM time is given as such, and bound_ms only
            # on one card, where HBM is the limit
            row = {"phase": "mpi_numbers", "collective": coll,
                   "bytes_per_rank": nbytes, "ranks": R, "cards": ctx.size,
                   "comm_coll_ms": comm_ms, "device_comm_ms": dc_ms,
                   "dispatch_ratio": comm_ms / dc_ms,
                   "staged_ms": staged_ms, "bound_bytes": bound_b,
                   "hbm_only_bound_ms": hbm_ms,
                   "bound_ms": hbm_ms if ctx.size == 1 else None,
                   "card": card}
            out(row)
            rows.append(row)
        del t
        torch.cuda.empty_cache()
    host_rows = []
    if host_timed:
        # coll/tuned's host allreduce of the same bytes (host clock)
        for count in HOST_SIZES:
            h = rng.standard_normal(count).astype(np.float32)
            comm.barrier()
            times = []
            for i in range(12):
                t0 = time.perf_counter()
                comm.coll.allreduce(comm, h)
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
            row = {"phase": "mpi_numbers", "collective": "allreduce",
                   "arm": "tuned (host, tcp)", "bytes_per_rank": count * 4,
                   "ranks": ctx.size, "host_ms": statistics.median(times),
                   "card": card}
            out(row)
            host_rows.append(row)
    if ctx.size > 1:
        # 12f: the quant arm across the cards, timed beside native
        quant_rows += mpi_quant_numbers(torch, np, comm, dc, R, lo, hi,
                                        card, out)
    comm.barrier()
    out({"mpi_rank0": {"ranks": R, "processes": ctx.size,
                       "providers": sorted(set(providers.values())),
                       "checked": checked, "staged_delta": staged_delta,
                       "numbers": rows, "host_numbers": host_rows,
                       "quant": quant_rows}})
    torch.distributed.destroy_process_group()
    runtime.finalize()


# 12c, 12f: the forced quant allreduce is held to the reference's bounds
# against the exact sum (tests/test_quant_coll.py: 1e-2 of the largest
# value, SNR >= 30 dB), and moves at most QUANT_WIRE_RATIO of the native
# arm's modeled wire bytes (its 1 MiB contract, test_wire_ratio_at_1mib)
QUANT_REL = 1e-2
QUANT_SNR_DB = 30.0
QUANT_WIRE_RATIO = 0.3
QUANT_SIZES = [1 << 20, 64 << 20]       # bytes a rank, f32


def quant_errors(np, got, want):
    """(largest error over the largest value, SNR in dB)."""
    diff = got.astype(np.float64) - want
    rel = float(np.abs(diff).max()) / (float(np.abs(want).max()) or 1.0)
    noise = max(float(np.square(diff).sum()), 1e-30)
    return rel, 10 * math.log10(float(np.square(want.astype(
        np.float64)).sum()) / noise)


def quant_ok(np, got, want, exact: bool) -> bool:
    if exact:
        return coll_agree(np, got, want, COLL_RTOL["float32"])
    rel, snr = quant_errors(np, got, want)
    return rel <= QUANT_REL and snr >= QUANT_SNR_DB


def mpi_quant(torch, np, comm, dc, x, dev, host, R, lo, hi, out) -> list:
    """comm.coll.allreduce forced onto the quant arm on phase 11's rows:
    one quant arm count, nothing native; exact with one process, else
    within the error model; a planted wrong row rejected."""
    from ompi_tpu_torch.core import var
    spc = comm.ctx.spc._v
    keys = ("coll_arm_quant_count", "coll_arm_native_count",
            "device_quant_collectives")
    before = [spc.get(k, 0) for k in keys]
    var.registry.set_override("coll_nccl_allreduce_mode", "quant")
    got = host(comm.coll.allreduce(comm, dev(x)))
    var.registry.set_override("coll_nccl_allreduce_mode", "")
    delta = [spc.get(k, 0) - b for k, b in zip(keys, before)]
    want = np.broadcast_to(x.sum(0), x.shape)[lo:hi]
    exact = dc.n == 1
    ok = quant_ok(np, got, want, exact)
    bad = got.copy()
    bad[-1] = bad[-1] * 1.1 + 1
    planted = quant_ok(np, bad, want, exact)
    row = {"phase": "mpi_check", "entry": "allreduce forced quant",
           "processes": dc.n, "exact": exact,
           "quant_native_quantcoll_delta": delta,
           "errors": quant_errors(np, got, want),
           "planted_row_passes": planted,
           "ok": ok and not planted and delta == [1, 0, 1]}
    out(row)
    if not row["ok"]:
        raise AssertionError(f"forced quant allreduce: {row}")
    return [row]


def mpi_quant_numbers(torch, np, comm, dc, R, lo, hi, card, out) -> list:
    """12f: f32 allreduce forced onto the quant arm at QUANT_SIZES a rank,
    against numpy (every rank draws all R rows from one seed) within the
    error model, its audited wire bytes against the native arm's, and both
    arms timed by CUDA events."""
    from ompi_tpu_torch.core import var
    spc = comm.ctx.spc._v
    rows = []
    for nbytes in QUANT_SIZES:
        count = nbytes // 4
        full = np.random.default_rng(nbytes).standard_normal(
            (R, count), dtype=np.float32)
        t = torch.from_numpy(full[lo:hi]).to(dc.device)
        want = full.sum(0)
        del full
        wire = {}
        for arm in ("native", "quant"):
            var.registry.set_override("coll_nccl_allreduce_mode", arm)
            w0 = spc.get("coll_wire_bytes", 0)
            res = comm.coll.allreduce(comm, t)
            wire[arm] = spc.get("coll_wire_bytes", 0) - w0
            if arm == "quant":
                got = res[0].cpu().numpy()
            del res
            wire[arm + "_ms"] = median_ms(
                lambda: comm.coll.allreduce(comm, t), n=10, warmup=3)
        var.registry.set_override("coll_nccl_allreduce_mode", "")
        rel, snr = quant_errors(np, got, want)
        bad = got.copy()
        bad[: count // 64] *= 1.1                # one slice 10% off
        planted = quant_ok(np, bad, want, False)
        row = {"phase": "mpi_numbers", "collective": "allreduce",
               "arm": "quant (forced)", "bytes_per_rank": nbytes,
               "ranks": R, "cards": dc.n, "quant_ms": wire["quant_ms"],
               "native_ms": wire["native_ms"],
               "quant_over_native": wire["quant_ms"] / wire["native_ms"],
               "wire_bytes_quant": wire["quant"],
               "wire_bytes_native": wire["native"],
               "wire_ratio": wire["quant"] / wire["native"],
               "max_rel_err": rel, "snr_db": snr,
               "planted_passes": planted, "card": card}
        out(row)
        rows.append(row)
        del t, got, want, bad
        torch.cuda.empty_cache()
        if not (rel <= QUANT_REL and snr >= QUANT_SNR_DB and not planted
                and row["wire_ratio"] <= QUANT_WIRE_RATIO):
            raise AssertionError(f"quant allreduce across cards: {row}")
    return rows


def ring_rank(np, laps: int) -> None:
    """The ring program of examples/ring.py on the port (host p2p, tcp),
    then ``laps`` more laps timed for the µs a hop."""
    from ompi_tpu_torch import runtime
    ctx = runtime.init()
    me, n = ctx.rank, ctx.size
    nxt, prv = (me + 1) % n, (me - 1) % n
    for total in (10, laps):
        buf = np.zeros(1, np.int32)
        t0 = time.perf_counter()
        if me == 0:
            buf[0] = total
            ctx.p2p.send(buf, dst=nxt, tag=201)
        while True:
            ctx.p2p.recv(buf, src=prv, tag=201)
            if me == 0:
                buf[0] -= 1
            ctx.p2p.send(buf, dst=nxt, tag=201)
            if buf[0] == 0:
                break
        if me == 0:
            ctx.p2p.recv(buf, src=prv, tag=201)
            dt = time.perf_counter() - t0
            print(f"rank 0 done: {total} laps x {n} hops in "
                  f"{dt * 1e3:.2f} ms ({dt * 1e6 / (total * n):.1f} us/hop)",
                  flush=True)
            if total == laps:
                log({"phase": "mpi_ring", "ranks": n, "laps": laps,
                     "us_per_hop": dt * 1e6 / (laps * n)})
    runtime.finalize()


# -- 18. the audit planes: trace, perf and traffic -----------------------------

AUDIT_STEPS = 5                # timed steps a side, after one warm-up step
AUDIT_BUCKET = 4 << 20         # phase 12d's bucket bytes
AUDIT_PEAK_TFLOPS = 989.0      # perf_peak_tflops: the card's dense bf16
AUDIT_SIZES_MB = (1, 64)       # MB a row of the sampled allreduces
AUDIT_DISPATCHES = 10          # allreduces a size the cost model samples
AUDIT_SKEW_CALLS = 20
AUDIT_SKEW_SLEEP_S = 5e-3
AUDIT_STRAGGLER = 2
AUDIT_Z = 2.0                  # entry_skew's z threshold (the reference's
#                                doctor tests use 2.0)


@contextlib.contextmanager
def audit_planes(on: bool):
    """The three audit planes switched on (emptied first) or off, with
    perf_peak_tflops at AUDIT_PEAK_TFLOPS; all three off after."""
    from ompi_tpu_torch import perf, trace, traffic
    from ompi_tpu_torch.core import var
    for mod in (trace, perf, traffic):
        if on:
            mod.enable()
        else:
            mod.disable()
    trace.clear()
    perf.reset()
    traffic.reset()
    var.registry.set_override("perf_peak_tflops", AUDIT_PEAK_TFLOPS)
    try:
        yield
    finally:
        for mod in (trace, perf, traffic):
            mod.disable()
        var.registry.set_override("perf_peak_tflops", 0.0)


def lane_overlaps(doc) -> int:
    """Complete spans of a Chrome document that start before the previous
    span of their (pid, tid) lane ends."""
    lanes = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            lanes.setdefault((e["pid"], e["tid"]), []).append(e)
    bad = 0
    for spans in lanes.values():
        spans.sort(key=lambda e: e["ts"])
        bad += sum(a["ts"] + a["dur"] > b["ts"]
                   for a, b in zip(spans, spans[1:]))
    return bad


def audit_train(torch, tfm, optim, attention, cfg, pristine, tokens, mesh,
                card: str, log_fn) -> dict:
    """18a/18c: the flagship step on a dp mesh, grad_sync "bucketed" in
    AUDIT_BUCKET buckets, AUDIT_STEPS steps timed by CUDA events with the
    planes off and then on, in one call.  With them on: the events a step
    by category, the ring's dropped count, the goodput rows the step
    records, and the checks — K1-K4 launches unchanged (2n/n/n/0 a step),
    one decide:grad_sync event a bucket and one grad_sync:run span a step,
    the traffic plane's grad_sync charge 2(n-1)/n × the gradient bytes."""
    from ompi_tpu_torch import perf, trace, traffic
    from ompi_tpu_torch.parallel import overlap
    c = dataclasses.replace(cfg, grad_sync="bucketed",
                            grad_bucket_bytes=AUDIT_BUCKET)
    n = cfg.n_layers
    cards = mesh.mesh.numel()
    grad_bytes = sum(4 * p.numel() for p in optim.tree_leaves(pristine))
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    fpt = tfm.train_flops_per_token(cfg)
    rows = {}
    for on in (False, True):
        gp_rows = []

        def spy(wall_s, _real=perf.record_step, **kw):
            row = _real(wall_s, **kw)
            gp_rows.append(row)
            return row

        with audit_planes(on), planted(perf, "record_step", spy):
            init_opt, step = tfm.make_train_step(c, mesh, learning_rate=1e-3)
            params = tfm.shard_params(pristine, mesh, c)
            state = init_opt(params)
            params, state, _ = step(params, state, tokens)     # warm-up
            torch.cuda.synchronize()
            trace.clear()
            perf.reset()
            traffic.reset()
            gp_rows.clear()
            zero_counts(attention)
            params, state, times, host, losses = timed_steps(
                torch, step, params, state, tokens, AUDIT_STEPS)
            launches = [x / AUDIT_STEPS for x in launch_counts(attention)]
            buckets = overlap.pvar_value("grad_bucket_count")
            by_cat, by_name = {}, {}
            for e in trace.events():
                by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + 1
                by_name[e["name"]] = by_name.get(e["name"], 0) + 1
            per_step = lambda d: {k: v / AUDIT_STEPS for k, v in d.items()}
            charge = traffic.matrix.per_coll().get("grad_sync", 0)
            dropped = trace.dropped_events()
        del params, state
        torch.cuda.empty_cache()
        ms = statistics.median(times)
        tokens_per_s = n_tokens / ms * 1e3
        row = {"phase": "audit_train", "planes": "on" if on else "off",
               "cards": cards, "mesh": dict(zip(mesh.mesh_dim_names,
                                                mesh.mesh.shape)),
               "bucket_bytes": AUDIT_BUCKET, "buckets": buckets,
               "step_ms": ms, "step_ms_all": times,
               "host_issue_ms": statistics.median(host),
               "tokens_per_s": tokens_per_s,
               "mfu_phase8": tokens_per_s * fpt / (PEAK_BF16_FLOPS * cards),
               "k1_k2_k3_k4_launches_per_step": launches,
               "events_per_step_by_category": per_step(by_cat),
               "events_per_step_by_name": per_step(by_name),
               "dropped_events": dropped, "final_loss": losses[-1],
               "card": card}
        if on:
            walls = [r["wall_s"] for r in gp_rows]
            row["goodput"] = {
                "rows": len(gp_rows), "wall_ms": statistics.median(walls)
                * 1e3, "tokens": gp_rows[0]["tokens"],
                "tokens_per_s": gp_rows[0]["tokens"]
                / statistics.median(walls),
                "mfu_pct": statistics.median(r["mfu_pct"] for r in gp_rows),
                "peak_tflops": AUDIT_PEAK_TFLOPS}
            want_charge = AUDIT_STEPS * (2 * (cards - 1) * grad_bytes
                                         // cards)
            checks = {
                "launches_unchanged": launches == [2 * n, n, n, 0],
                "one_decision_a_bucket": by_name.get("decide:grad_sync", 0)
                == AUDIT_STEPS * buckets,
                "one_run_span_a_step": by_name.get("grad_sync:run", 0)
                == AUDIT_STEPS,
                "bucket_spans": by_name.get("grad_sync:bucket", 0)
                == AUDIT_STEPS * buckets,
                "grad_sync_charge": charge == want_charge,
                "goodput_row_a_step": len(gp_rows) == AUDIT_STEPS
                and gp_rows[0]["tokens"] == n_tokens,
                "no_dropped_events": dropped == 0}
            log_fn({"phase": "audit_check", "check": "train_step",
                    "cards": cards, "checks": checks,
                    "grad_sync_charge_bytes": charge,
                    "want_charge_bytes": want_charge,
                    "ok": all(checks.values())})
            if not all(checks.values()):
                raise AssertionError(f"18: the audited step: {checks}")
        elif launches != [2 * n, n, n, 0]:
            raise AssertionError(f"18: K1-K4 launches a step {launches}")
        log_fn(row)
        rows[row["planes"]] = {k: row[k] for k in (
            "step_ms", "tokens_per_s", "mfu_phase8",
            "events_per_step_by_category", "dropped_events") if k in row}
        if on:
            rows["on"]["goodput"] = row["goodput"]
    rows["overhead_ms"] = rows["on"]["step_ms"] - rows["off"]["step_ms"]
    return rows


def audit_one_card(torch, np, tfm, optim, attention, cfg, pristine, tokens,
                   card: str, log_fn=log) -> dict:
    """18a, in phase 9's world: the audited step on {"dp": 1} with the
    planes off and on; then DeviceComm.allreduce at AUDIT_SIZES_MB a row,
    R = 8, with perf on: the host's dispatch time of each call (what
    timed_coll samples: no synchronize) beside the CUDA-event ms, and the
    cost model's cells (none: with one process the model's busbw needs
    ndev >= 2, the reference's rule)."""
    from ompi_tpu_torch import perf
    from ompi_tpu_torch.parallel import DeviceComm, make_mesh
    row = {"train": audit_train(torch, tfm, optim, attention, cfg, pristine,
                                tokens, make_mesh({"dp": 1}), card,
                                log_fn)}
    dc = DeviceComm(make_mesh({"x": 1}), "x")
    numbers = []
    with audit_planes(True):
        for mb in AUDIT_SIZES_MB:
            x = torch.randn((COLL_ROWS, (mb << 20) // 4), device="cuda")
            dc.allreduce(x)
            torch.cuda.synchronize()
            dispatch = []
            for _ in range(AUDIT_DISPATCHES):
                t0 = time.perf_counter()
                dc.allreduce(x)
                dispatch.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            device = median_ms(lambda: dc.allreduce(x), n=AUDIT_DISPATCHES)
            num = {"phase": "audit_numbers", "cards": 1, "rows": COLL_ROWS,
                   "size_mb_a_row": mb,
                   "dispatch_ms_p50": statistics.median(dispatch),
                   "device_ms_p50": device,
                   "dispatch_over_device": statistics.median(dispatch)
                   / device,
                   "cost_model_cells": perf.model.table(), "card": card}
            log_fn(num)
            numbers.append(num)
            del x
            torch.cuda.empty_cache()
    if any(n["cost_model_cells"] for n in numbers):
        raise AssertionError("18a: the cost model folded a one-process "
                             "sample")
    row["numbers"] = [{k: v for k, v in n.items() if k != "phase"}
                      for n in numbers]
    return row


AUDIT_OPS = ("allreduce", "bcast", "allgather", "alltoall",
             "reduce_scatter_block", "reduce", "scan", "exscan", "gather",
             "scatter", "reduce_scatter", "allgatherv")


def audit_entries(comm, d, R: int) -> None:
    """The twelve comm.coll entries of the JAX package's audit test
    (tests/test_observability.py), ``d(key)`` this rank's rows."""
    c, cc = comm, comm.coll
    cc.allreduce(c, d("x"))
    cc.bcast(c, d("x"))
    cc.allgather(c, d("x"))
    cc.alltoall(c, d("xa"))
    cc.reduce_scatter_block(c, d("x"))
    cc.reduce(c, d("x"))
    cc.scan(c, d("x"))
    cc.exscan(c, d("x"))
    cc.gather(c, d("x"))
    cc.scatter(c, d("x3"))
    cc.reduce_scatter(c, d("x"), None, [64 // R] * R)
    cc.allgatherv(c, d("x2"), counts=[R] * R)


def audit_rank(torch, np) -> None:
    """18b and 18c, one rank of the tpurun program (one card a rank):
    comm_world attached to {"x": 4} with the three planes on.  18b: the
    twelve entries leave one decision event each on every rank, with the
    same arm, reason and chain on every rank; traffic_attributed_bytes ==
    the spc's coll_wire_bytes, nothing unattributed, the edges summing to
    the wire, all of them ICI; mpisync's offsets and best RTT; trace.gather
    to rank 0, timed, and the merged Chrome trace monotonic with no overlap
    in any lane; three planted faults, each failing its check: (a) one
    edge's charge dropped, (b) a second decision event for one bcast, (c)
    rank AUDIT_STRAGGLER sleeping before each of AUDIT_SKEW_CALLS
    allreduces (entry_skew must flag exactly it, and nobody without the
    sleep); the cost model's cells for comm.coll.allreduce at
    AUDIT_SIZES_MB a rank beside their CUDA-event ms.  18c: the flagship
    step on {"dp": 4} (audit_train).  Every rank checks; rank 0 prints."""
    import os
    import torch.distributed as dist
    from ompi_tpu_torch import optim, perf, runtime, trace, traffic
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import (attach_mesh, init_device_plane,
                                         make_mesh)
    from ompi_tpu_torch.tools import mpisync
    from ompi_tpu_torch.trace import analyze, merge
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = runtime.init()
    out = log if ctx.rank == 0 else (lambda obj: None)
    init_device_plane(ctx)
    comm = ctx.comm_world
    n, rank = comm.size, ctx.rank
    card = card_line()
    mesh = make_mesh({"x": n})
    attach_mesh(comm, mesh, "x")
    rng = np.random.default_rng(5)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    data = {"x": f32(n, 64), "x2": f32(n, n), "x3": f32(n, n, 4),
            "xa": f32(n, n, 8)}
    d = lambda k: torch.from_numpy(data[k][rank:rank + 1]).cuda()  # noqa
    spc = ctx.spc

    def agree(obj) -> list:
        got = [None] * n
        dist.all_gather_object(got, obj)
        return got

    def gate(name: str, ok: bool, **info) -> bool:
        """Every rank's verdict; the check holds where all ranks' do."""
        oks = agree(bool(ok))
        out({"phase": "audit_check", "check": name, "ok_by_rank": oks,
             **info})
        return all(oks)

    def one_per_coll() -> tuple:
        per = {}
        for e in trace.events(rank):
            if e["cat"] == "decision":
                per[e["args"]["op"]] = per.get(e["args"]["op"], 0) + 1
        return per == {op: 1 for op in AUDIT_OPS}, per

    def conserved(wire: int) -> tuple:
        edges = sum(r["bytes"] for r in traffic.matrix.rows())
        planes = sorted(traffic.matrix.plane_totals())
        ok = (traffic.matrix.placed_bytes == wire
              and traffic.matrix.unattributed_bytes == 0
              and edges == wire and planes == ["ici"])
        return ok, {"wire": wire, "attributed": traffic.matrix.placed_bytes,
                    "unattributed": traffic.matrix.unattributed_bytes,
                    "edge_bytes": edges, "planes": planes}

    def audited(fn) -> int:
        """Run ``fn`` from an empty trace and matrix; its wire bytes."""
        trace.clear()
        traffic.reset()
        before = spc.get("coll_wire_bytes")
        fn()
        torch.cuda.synchronize()
        return int(spc.get("coll_wire_bytes") - before)

    failed = []
    with audit_planes(True):
        # 18b: the twelve entries
        wire = audited(lambda: audit_entries(comm, d, n))
        ok_one, per = one_per_coll()
        mine = [(e["args"]["op"], e["args"]["arm"], e["args"]["reason"],
                 e["args"]["chain"]) for e in trace.events(rank)
                if e["cat"] == "decision"]
        same = all(m == mine for m in agree(mine))
        ok_cons, cons = conserved(wire)
        edge_count = traffic.matrix.edge_count()
        arms = sorted({m[1] for m in mine})
        for name, ok, info in (
                ("one_decision_per_entry", ok_one, {"per_op": per}),
                ("same_decisions_on_every_rank", same, {"arms": arms}),
                ("conservation", ok_cons and edge_count == n * (n - 1),
                 dict(cons, edge_count=edge_count))):
            if not gate(name, ok, **info):
                failed.append(name)
        # (a) one edge's charge dropped
        real_spread = traffic.spread

        def drop_one(total, edges, weights=None):
            return real_spread(total, edges, weights)[1:]

        with planted(traffic, "spread", drop_one):
            wire = audited(lambda: comm.coll.allreduce(comm, d("x")))
        ok_a, info = conserved(wire)
        if not gate("planted_edge_dropped_fails_conservation", not ok_a,
                    **info):
            failed.append("planted (a)")
        # (b) a second decision event for one collective
        real_decision = trace.decision

        def twice(op, *a, **kw):
            real_decision(op, *a, **kw)
            if op == "bcast":
                real_decision(op, *a, **kw)

        with planted(trace, "decision", twice):
            audited(lambda: audit_entries(comm, d, n))
        ok_b, per = one_per_coll()
        if not gate("planted_second_decision_fails_one_per_collective",
                    not ok_b, per_op=per):
            failed.append("planted (b)")
        # mpisync, then the straggler without and with the sleep
        offsets, rtt = mpisync.clock_sync_ex(comm)
        out({"phase": "audit_numbers", "what": "mpisync",
             "offsets_s": offsets.tolist(), "best_rtt_s": rtt.tolist(),
             "card": card})
        x = d("x")
        for sleep in (False, True):
            trace.clear()
            for _ in range(AUDIT_SKEW_CALLS):
                if sleep and rank == AUDIT_STRAGGLER:
                    time.sleep(AUDIT_SKEW_SLEEP_S)
                with trace.span("audit:allreduce", "audit", rank=rank):
                    comm.coll.allreduce(comm, x)
                    torch.cuda.synchronize()
            t0 = time.perf_counter()
            tl = merge.gather(comm)
            gather_s = time.perf_counter() - t0
            verdict = None
            if rank == 0:
                sk = analyze.entry_skew(tl, z_thresh=AUDIT_Z)
                doc_dir = os.path.join(os.path.dirname(
                    os.path.abspath(__file__)), "build", "audit")
                os.makedirs(doc_dir, exist_ok=True)
                path = os.path.join(doc_dir, f"merged_sleep{int(sleep)}"
                                    ".json")
                tl.save_chrome(path)
                with open(path) as fh:
                    doc = json.load(fh)
                rows = [e for e in doc["traceEvents"] if e["ph"] != "M"]
                ts = [e["ts"] for e in rows]
                verdict = {"flagged": sk["flagged"],
                           "lateness_us": sk["rank_lateness_us"],
                           "z": sk["z_scores"],
                           "skew_p50_us": sk["per_coll"]["allreduce"]["p50"],
                           "overlaps": lane_overlaps(doc),
                           "monotonic": ts == sorted(ts),
                           "ranks": tl.ranks, "events": len(tl.events)}
            verdict = agree(verdict)[0]
            want = [AUDIT_STRAGGLER] if sleep else []
            name = ("planted_straggler_flagged" if sleep
                    else "no_straggler_flagged")
            ok = (verdict["flagged"] == want and verdict["overlaps"] == 0
                  and verdict["monotonic"] and verdict["ranks"]
                  == list(range(n)))
            if not gate(name, ok, gather_s=gather_s, **verdict):
                failed.append(name)
        # the cost model's cells (dispatch-time samples, ndev = n) beside
        # the CUDA-event ms of the same calls
        for mb in AUDIT_SIZES_MB:
            perf.reset()
            xs = torch.randn((1, (mb << 20) // 4), device="cuda")
            comm.coll.allreduce(comm, xs)
            torch.cuda.synchronize()
            perf.reset()
            for _ in range(AUDIT_DISPATCHES):
                comm.coll.allreduce(comm, xs)
            torch.cuda.synchronize()
            cells = perf.model.table()
            device = median_ms(lambda: comm.coll.allreduce(comm, xs),
                               n=AUDIT_DISPATCHES)
            flat = [c for c in cells if c["coll"] == "allreduce"]
            out({"phase": "audit_numbers", "cards": n, "size_mb_a_rank": mb,
                 "cost_model_cells": cells,
                 "cost_model_lat_us_p50": flat[0]["lat_us_p50"]
                 if flat else None,
                 "device_ms_p50": device,
                 "dispatch_over_device": flat[0]["lat_us_p50"] / 1e3
                 / device if flat else None, "card": card})
            if not flat or flat[0]["count"] != AUDIT_DISPATCHES:
                failed.append(f"cost model cells at {mb} MB")
            del xs
    if failed:
        raise AssertionError(f"18b: {failed}")
    # 18c: the flagship step on {"dp": n}
    cfg = tfm.flagship_config()
    pristine = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, cfg.seq + 1))).cuda()
    train = audit_train(torch, tfm, optim, attention, cfg, pristine, tokens,
                        make_mesh({"dp": n}), card, out)
    out({"audit_rank0": {"entries": list(AUDIT_OPS), "arms": arms,
                         "train": train}})
    runtime.finalize()


RANK_SCRIPT = """import sys
sys.path.insert(0, {root!r})
import chip_smoke
sys.exit(chip_smoke.rank_main(sys.argv[1:]))
"""


def rank_main(argv) -> int:
    """Entry of phase 11's rank programs: ``device R_PER TIMED HOST`` or
    ``ring LAPS``; of phase 16b's, ``hier``; of phase 18b-c's, ``audit``."""
    import numpy as np
    if argv[0] == "ring":
        ring_rank(np, int(argv[1]))
        return 0
    import torch
    if argv[0] == "hier":
        hier_rank(torch, np)
        return 0
    if argv[0] == "audit":
        audit_rank(torch, np)
        return 0
    mpi_rank(torch, np, int(argv[1]), argv[2].split(","), argv[3] == "1")
    return 0


def tpurun(np_: int, args, extra=(), timeout: int = 900) -> list:
    """Run this file's rank program under the port's tpurun (the script
    written to a temporary file); pass its lines through and return them.
    A failed rank fails the phase."""
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "rank.py")
        with open(script, "w") as fh:
            fh.write(RANK_SCRIPT.format(root=root))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np",
             str(np_), "--timeout", str(timeout - 30), *extra, script,
             *args], env=env, capture_output=True, text=True,
            timeout=timeout, cwd=root)
    lines = r.stdout.splitlines()
    for line in lines:
        print(line, flush=True)
    if r.returncode != 0:
        print(r.stderr[-4000:], file=sys.stderr, flush=True)
        raise AssertionError(f"tpurun -np {np_} {' '.join(args)}: exit "
                             f"{r.returncode}")
    return lines


def last_json(lines, key: str):
    for line in reversed(lines):
        if line.startswith("{") and key in line:
            return json.loads(line)[key]
    raise AssertionError(f"no {key!r} line")


def mpi_phase(r_per: int, np_: int, timed, host_timed: bool,
              extra=()) -> dict:
    """Phase 11: the device program under tpurun, then (one card) the
    ring program on the host plane."""
    lines = tpurun(np_, ["device", str(r_per), ",".join(timed),
                         "1" if host_timed else "0"], extra)
    row = {"device": last_json(lines, "mpi_rank0")}
    if np_ == 1:
        lines = tpurun(4, ["ring", str(RING_LAPS)])
        if not any("done: 10 laps" in line for line in lines):
            raise AssertionError("the ring did not finish its 10 laps")
        row["ring"] = next(json.loads(line) for line in lines
                           if line.startswith("{") and "mpi_ring" in line)
    return row


def multi_card_worker(rank: int, world: int, init_method: str,
                      card: str) -> None:
    """One rank of the multi-card run: an NCCL world of ``world``
    processes, one card each.  Phase 9 (R = 8 rank rows over the cards),
    then phases 10c, 12d-e, 13e, 14c, 15b-d and 16 (but 16b) across
    them."""
    import numpy as np
    import torch
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch import optim
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import DeviceComm, init_device_plane
    from ompi_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    init_device_plane(rank=rank, world_size=world, init_method=init_method,
                      timeout_s=600)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             tfm.flagship_config())
    grad_numel = sum(p.numel() for p in optim.tree_leaves(params))
    del params
    torch.cuda.empty_cache()
    dc = DeviceComm(make_mesh({"x": world}), "x")
    out = log if rank == 0 else (lambda obj: None)
    # the staged arm is single-controller code: phase 9 on one card runs it
    rows = device_coll(torch, np, dc, card, grad_numel, out, staged=False)
    torch.cuda.empty_cache()
    mesh_rows = mesh_multi_card(torch, np, tfm, optim, world, card, out)
    torch.cuda.empty_cache()
    # 12d, 12e: the grad-sync arms on a dp mesh, the fused tp step
    sync = grad_sync_multi_card(torch, np, tfm, optim, world, card, out)
    torch.cuda.empty_cache()
    fused = fused_multi_card(torch, np, tfm, optim, world, card, out)
    torch.cuda.empty_cache()
    # 13e: convert_params and the engine on a {"tp": world} mesh
    serve = serve_multi_card(torch, np, tfm, attention, world, card, out)
    torch.cuda.empty_cache()
    # 14c: the fused decode program on a {"tp": world} mesh
    decode = decode_multi_card(torch, np, tfm, world, card, out)
    torch.cuda.empty_cache()
    # 15b-d: the serving fleet across the cards
    fleet = fleet_multi_card(torch, np, tfm, world, card, out)
    torch.cuda.empty_cache()
    # 16a, 16c-f: hierarchy and sequence parallelism (16c beside 12d's
    # native timings)
    hier = p13_multi_card(torch, np, tfm, optim, world, card, sync, out)
    out({"collectives": rows})
    out({"mesh": mesh_rows})
    out({"grad_sync": sync})
    out({"fused": fused})
    out({"serve": serve})
    out({"decode": decode})
    out({"fleet": fleet})
    out({"hier": hier})
    leave_world(torch, out)


def group_purposes() -> dict:
    """What made each process group this process holds, where the script
    knows it: the axes of each world_mesh layout and the product groups
    mesh.axes_group made on it (group name -> text)."""
    from ompi_tpu_torch.parallel import mesh as mesh_mod
    out = {}
    for axes, mesh in _WORLD_MESHES.items():
        layout = ".".join(f"{a}{n}" for a, n in axes)
        for name in mesh.mesh_dim_names:
            out[mesh.get_group(name).group_name] = f"{layout} axis {name}"
        for key, group in mesh_mod._AXES_GROUPS.get(mesh, {}).items():
            out[group.group_name] = f"{layout} axes {'×'.join(key)}"
    return out


def watched(fn, timeout_s: float):
    """Run ``fn`` in a daemon thread: (whether it returned within
    ``timeout_s``, its seconds)."""
    import threading
    t0 = time.perf_counter()
    done = threading.Thread(target=fn, daemon=True)
    done.start()
    done.join(timeout_s)
    return not done.is_alive(), time.perf_counter() - t0


def leave_world(torch, log_fn, timeout_s: float = 60.0) -> None:
    """End a multi-card rank: every rank's work on the card done, a
    barrier, then the world torn down one process group at a time, the
    last made first and the world's own group last; each group's members,
    what made it and its seconds are logged (teardown_group lines, then
    the teardown line).  A group whose teardown has not returned in
    ``timeout_s`` fails the run: the rank says which and exits with 1 at
    once, without Python's own shutdown, which would wait on it.

    The order is the one every member of a group shares: the groups are
    made in one order on every rank.  destroy_process_group() of the
    whole world takes them by name instead, and torch names a group split
    from the world by a hash of its ranks and of how many groups the rank
    already holds, which differs between ranks: with enough groups two
    members reach a shared communicator at different points of their
    orders, and NCCL's teardown of a communicator waits for its members,
    so the ranks wait on each other (the world of phases 9-16 on four
    H100s)."""
    import os
    from torch.distributed import distributed_c10d as c10d
    torch.cuda.synchronize()
    torch.distributed.barrier()
    world = c10d._world
    rank = torch.distributed.get_rank()
    # the process groups the world holds, its own included
    groups = len(world.pg_map)
    made_by = group_purposes()
    default = c10d._get_default_group()
    made = [g for g in world.pg_map if g is not default]
    rows = []
    t0 = time.perf_counter()
    for pg in made[::-1] + [None]:
        if pg is None:
            name, ranks, what = "world", list(range(
                torch.distributed.get_world_size())), "the world's own group"
        else:
            name = world.pg_names[pg]
            ranks = sorted(world.pg_group_ranks[pg])
            what = made_by.get(pg.group_name) or getattr(
                pg, "group_desc", "") or "unnamed"
        ok, seconds = watched(
            lambda: torch.distributed.destroy_process_group(pg), timeout_s)
        row = {"group": name, "ranks": ranks, "made_by": what,
               "seconds": seconds, "destroyed": ok}
        rows.append(row)
        log_fn({"phase": "teardown_group", **row})
        if not ok:
            print(f"chip_smoke: rank {rank}: the teardown of process group "
                  f"{row} did not return in {timeout_s} s", file=sys.stderr)
            log_fn({"phase": "teardown", "destroyed": False,
                    "seconds": time.perf_counter() - t0,
                    "process_groups": groups, "groups": rows})
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
    log_fn({"phase": "teardown", "destroyed": True,
            "seconds": time.perf_counter() - t0, "process_groups": groups,
            "groups": rows})


def multi_card_main() -> int:
    """Phases 9, 10c, 12d-e, 13e, 14c, 15b-d and 16 (but 16b) across the
    host's MULTI_CARDS cards, one spawned process a card; phases 17c and
    17d in a second such world; then phases 11 and 16b under tpurun, one
    rank bound to each card."""
    import os
    import tempfile
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    world = torch.cuda.device_count()
    if world != MULTI_CARDS:
        print(f"chip_smoke: --multi-card runs on {MULTI_CARDS} cards; "
              f"{world} visible", file=sys.stderr)
        return 1
    card = card_line()
    log({"phase": "device", "card": card, "cards": world,
         "torch": torch.__version__, "cuda": torch.version.cuda})
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(multi_card_worker, args=(
            world, "file://" + os.path.join(tmp, "store"), card),
            nprocs=world)
        # 17c, 17d: MoE expert parallelism and the MoE mesh step, a world
        # of its own
        mp.spawn(moe_card_worker, args=(
            world, "file://" + os.path.join(tmp, "store17"), card),
            nprocs=world)
    # 11. the MPI surface across the cards, one rank bound to each
    log({"mpi": mpi_phase(1, world, ["allreduce", "bcast", "allgather",
                                     "alltoall"], True,
                          extra=("--gpus-per-rank", "1"))})
    # 16b: comm.coll.allreduce on a comm attached to ("dpo", "dp")
    lines = tpurun(world, ["hier"], extra=("--gpus-per-rank", "1"))
    log({"hier_mpi": last_json(lines, "hier_rank0")})
    # 18b, 18c: the audit planes on comm_world attached to {"x": 4}, then
    # the flagship step on {"dp": 4}
    lines = tpurun(world, ["audit"], extra=("--gpus-per-rank", "1"))
    log({"audit": last_json(lines, "audit_rank0")})
    log(card)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": world}})
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    from ompi_tpu_torch import _build, optim
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import ring

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    props = torch.cuda.get_device_properties(0)
    log({"phase": "device", "card": card, "name": props.name,
         "sm_count": props.multi_processor_count,
         "memory_bytes": props.total_memory,
         "capability": f"{props.major}.{props.minor}",
         "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    log({"phase": "build", "seconds": build_s, "built": sorted(reports),
         "sources": [s.name for s in _build.sources()]})
    check_ptxas(_build, _build.library("flash_attention"),
                _build.library("flash_bwd"))

    # 3. kernels against their plain versions
    path_err = None
    for case in K1_CASES:
        err = check_k1(torch, attention, case)
        log({"phase": "k1_check", "case": case[0], "dtype": case[1],
             "causal": case[2], "shape": list(case[3:7]),
             "offsets": list(case[7:]), "max_abs_err": err,
             "tol": TOL[case[1]], "ok": True})
        if case[0] == PATH_CASE:
            path_err = err
    for dtype in ("float32", "bfloat16"):
        check_merge(torch, attention, ring, dtype)
    bwd_err = None
    bwd_lib = _build.library("flash_bwd")
    for case in BWD_CASES:
        errs, used, planted = check_bwd(
            torch, attention, case, bwd_tile_rows(bwd_lib, case[1], case[6]))
        log({"phase": "k2_k3_check", "case": case[0], "dtype": case[1],
             "causal": case[2], "shape": list(case[3:]), "max_abs_err": errs,
             "row_tol": BWD_TOL[case[1]], "atol_of_max": BWD_ATOL,
             "bound_use": used, "planted_fault_bound_use": planted,
             "ok": True})
        if case[0] == PATH_CASE:
            bwd_err = errs
    check_grad(torch, attention, ring)
    torch.cuda.empty_cache()

    # 4. flash_attention (K4): against its plain version, then its path at
    # full flagship width
    cfg = tfm.flagship_config()
    k4_lib = _build.library("flash_attention")
    for case in K4_CASES:
        name, dtype, kv_dtype, causal, b, h, s_q, s_k, d = case
        gen = torch.Generator(device="cuda").manual_seed(s_q * 1000 + d + 2)
        q, k, v = k4_inputs(torch, gen, b, h, s_q, s_k, d, dtype, kv_dtype)
        err, used, planted, rows = check_k4(torch, attention, k4_lib, name,
                                            dtype, causal, q, k, v)
        log({"phase": "k4_check", "case": name, "dtype": dtype,
             "kv_dtype": kv_dtype, "causal": causal,
             "b_h_sq_sk_d": list(case[4:]), "max_abs_err": err,
             "tol": TOL[dtype], "bound_use": used, "planted_rows": rows,
             "planted_fault_bound_use": planted, "ok": True})
    for name, layout, dtype, causal, b, h, s, d in K4_VIEWS:
        gen = torch.Generator(device="cuda").manual_seed(s * 1000 + d + 4)
        q, k, v = k4_view_inputs(torch, gen, layout, dtype, b, h, s, d)
        err, used, planted, rows = check_k4(torch, attention, k4_lib, name,
                                            dtype, causal, q, k, v)
        log({"phase": "k4_check", "case": name, "layout": layout,
             "dtype": dtype, "causal": causal, "b_h_s_d": [b, h, s, d],
             "q_strides": list(q.stride()), "max_abs_err": err,
             "tol": TOL[dtype], "bound_use": used, "planted_rows": rows,
             "planted_fault_bound_use": planted, "ok": True})
    check_sdpa_alignment(torch, attention)
    k4_rows = k4_path(torch, attention, cfg, card)
    torch.cuda.empty_cache()

    # 5. the forward path at full width
    rng = np.random.default_rng(0)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, cfg.seq)))
    prompts = rng.integers(0, cfg.vocab, (4, cfg.seq - 4)).tolist()
    with torch.inference_mode():
        zero_counts(attention)
        logits = tfm.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        fwd_counts = launch_counts(attention)
        per_forward = fwd_counts[0]
        if fwd_counts[1:] != (0, 0, 0):
            raise AssertionError(f"K2/K3/K4 launched in one forward: "
                                 f"{fwd_counts}")
        streams = tfm.greedy(params, prompts, 4, cfg)
        torch.cuda.synchronize()
        launches = attention.launches
        if per_forward != cfg.n_layers or launches != 5 * cfg.n_layers:
            raise AssertionError(
                f"K1 launches: {per_forward} in one forward, {launches} "
                f"over forward + 4 greedy steps; want {cfg.n_layers} per "
                f"forward")
        if logits.shape != (4, cfg.seq, cfg.vocab) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"logits {tuple(logits.shape)} "
                                 f"{logits.dtype}, finite="
                                 f"{bool(torch.isfinite(logits).all())}")
        log({"phase": "main_path", "config": dataclasses.asdict(
            cfg) | {"dtype": str(cfg.dtype)}, "batch": 4,
            "k1_k2_k3_k4_launches_per_forward": list(fwd_counts),
            "k1_launches_main_path": launches})
        for i, (p, s) in enumerate(zip(prompts, streams)):
            log({"phase": "greedy", "request": i, "prompt_len": len(p),
                 "prompt_tail": p[-4:], "tokens": s})

        dense = dataclasses.replace(cfg, attn="dense")
        logits_d = tfm.forward(params, tokens, dense)
        streams_d = tfm.greedy(params, prompts, 4, dense)
        truth = tfm.forward(params, tokens, dataclasses.replace(
            dense, dtype=torch.float32))
        torch.cuda.synchronize()
        if attention.launches != launches:
            raise AssertionError("the dense path launched K1")
        rel = rel_rms(logits, logits_d)
        agree = float((logits.argmax(-1) == logits_d.argmax(-1))
                      .float().mean())
        log({"phase": "flash_vs_dense", "rel_rms": rel,
             "bound": FLASH_VS_DENSE_RMS, "argmax_agree": agree,
             "greedy_streams_equal": sum(a == b for a, b in
                                         zip(streams, streams_d)),
             "flash_vs_f32_rel_rms": rel_rms(logits, truth),
             "dense_vs_f32_rel_rms": rel_rms(logits_d, truth)})
        if not rel < FLASH_VS_DENSE_RMS:
            raise AssertionError(f"flash vs dense logits: relative RMS "
                                 f"{rel:.4g} >= {FLASH_VS_DENSE_RMS}")
        del logits, logits_d, truth

        # 6. numbers, CUDA-event medians
        bh, s, d = 4 * cfg.n_heads, cfg.seq, cfg.head_dim
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        k1_ms = median_ms(lambda: attention.flash_attention_partials(
            q, k, v, causal=True), reps=KERNEL_REPS)
        plain_ms = median_ms(
            lambda: attention.flash_attention_partials_reference(
                q, k, v, causal=True))
        unfold = lambda x: x.reshape(4, cfg.n_heads, s, d)
        sdpa_ms = median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                unfold(q), unfold(k), unfold(v), is_causal=True),
            reps=KERNEL_REPS)
        qm, km, vm = (unfold(x).transpose(1, 2) for x in (q, k, v))
        mha_ms = median_ms(lambda: attention.flash_mha(qm, km, vm, True),
                           reps=KERNEL_REPS)
        fwd_ms = median_ms(lambda: tfm.forward(params, tokens, cfg), n=10)
        dense_ms = median_ms(lambda: tfm.forward(params, tokens, dense), n=10)
        profile_run(torch, lambda: tfm.forward(params, tokens, cfg), fwd_ms,
                    card, "forward")

    pairs = bh * s * (s + 1) // 2                # causal, offsets 0
    tile = bh * s * d * 2                        # one bf16 (bh, s, d) tensor
    vec = bh * s * 4                             # one f32 (bh, s) vector
    # K1: q, k, v in; o (f32), m, l out; QK^T and PV
    flops, n_bytes = 4 * d * pairs, 3 * tile + 2 * tile + 2 * vec
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    k1_bound, k1_by = bound(flops, n_bytes)
    for metric, value in (("k1_ms", k1_ms), ("k1_plain_ms", plain_ms),
                          ("sdpa_ms", sdpa_ms), ("flash_mha_ms", mha_ms),
                          ("forward_ms", fwd_ms),
                          ("forward_tokens_per_s", 4 * s / fwd_ms * 1e3),
                          ("forward_dense_ms", dense_ms)):
        log({"phase": "numbers", "metric": metric, "value": value,
             "card": card})
    log({"phase": "numbers", "metric": "k1_bound", "flop": flops,
         "bytes": n_bytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
         "k1_tflops": flops / k1_ms / 1e9, "roofline_share":
         k1_bound / k1_ms, "card": card})

    del params
    torch.cuda.empty_cache()

    # 7. the train path at full width
    pristine = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    train_tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, cfg.seq + 1))).cuda()
    per_step = train_path(torch, tfm, optim, attention, cfg, pristine,
                          train_tokens)
    torch.cuda.empty_cache()

    # 8. train numbers, CUDA-event medians
    args = bwd_args(torch, attention, "bfloat16", True, bh, s, s, d)
    k2_ms = median_ms(lambda: attention.flash_mha_bwd_dkdv(*args,
                                                           causal=True),
                      reps=KERNEL_REPS)
    k3_ms = median_ms(lambda: attention.flash_mha_bwd_dq(*args, causal=True),
                      reps=KERNEL_REPS)
    k2_plain_ms = median_ms(lambda: attention.flash_mha_bwd_dkdv_reference(
        *args, causal=True), n=5, warmup=1)
    k3_plain_ms = median_ms(lambda: attention.flash_mha_bwd_dq_reference(
        *args, causal=True), n=5, warmup=1)
    q, k, v, do = args[:4]
    b4 = lambda x: x.reshape(BATCH, cfg.n_heads, s, d)   # (b, h, s, d)
    qs, ks, vs = (b4(x).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                           is_causal=True)
    sdpa_bwd_ms = median_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), b4(do), retain_graph=True), reps=KERNEL_REPS)
    qm, km, vm = (b4(x).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = attention.flash_mha(qm, km, vm, True)
    g = b4(do).transpose(1, 2)
    mha_bwd_ms = median_ms(lambda: torch.autograd.grad(
        out, (qm, km, vm), g, retain_graph=True), reps=KERNEL_REPS)
    del out, qs, ks, vs, qm, km, vm, args
    # the step's two halves at the path: value-and-grad, then AdamW
    params = clone_tree(optim, pristine)
    grads_ms = median_ms(lambda: tfm.value_and_grad(params, train_tokens,
                                                    cfg), n=5)
    grads = list(tfm.value_and_grad(params, train_tokens, cfg)[1])
    state = optim.adamw_init(params, cfg.opt_moment_dtype)
    adamw_ms = median_ms(lambda: optim.adamw_update(params, grads, state,
                                                    1e-3), n=10)
    del params, grads, state
    torch.cuda.empty_cache()
    for remat in ("dots", "none", "full"):
        time_train(
            torch, tfm, optim, dataclasses.replace(cfg, remat=remat),
            pristine, train_tokens, card, profile=remat == "dots")
        torch.cuda.empty_cache()
    time_train(torch, tfm, optim, dataclasses.replace(cfg, attn="dense"),
               pristine, train_tokens, card)
    grad_numel = sum(p.numel() for p in optim.tree_leaves(pristine))
    torch.cuda.empty_cache()

    # 9. device collectives: DeviceComm in a one-process NCCL world, R = 8
    # rank rows on this card
    from ompi_tpu_torch.parallel import DeviceComm, init_device_plane
    from ompi_tpu_torch.parallel import make_mesh
    init_device_plane(rank=0, world_size=1,
                      store=torch.distributed.HashStore())
    dc = DeviceComm(make_mesh({"x": 1}), "x")
    coll_rows = device_coll(torch, np, dc, card, grad_numel, log)
    del dc
    torch.cuda.empty_cache()

    # 10. the flagship on a mesh, in the same world: K1 on every ring hop,
    # then the mesh step at dp·sp·tp = 1·1·1
    ring_row = ring_hops(torch, attention, ring, cfg, card)
    torch.cuda.empty_cache()
    mesh_rows = mesh_world_of_one(torch, tfm, optim, attention, cfg,
                                  pristine, train_tokens, card)
    torch.cuda.empty_cache()

    # 12. the grad-sync arms in the same world: the codec at the
    # gradients' size, then every arm on a {"dp": 1} mesh
    sync_row = {"codec": codec_check(torch, grad_numel, card),
                "dp1": grad_sync_one_card(torch, tfm, optim, cfg, pristine,
                                          train_tokens, card)}
    torch.cuda.empty_cache()

    # 18a. the audit planes in the same world: the step on {"dp": 1} with
    # trace, perf and traffic off and on; DeviceComm.allreduce's dispatch
    # time beside its device time
    audit_row = audit_one_card(torch, np, tfm, optim, attention, cfg,
                               pristine, train_tokens, card)
    del pristine, train_tokens
    torch.cuda.empty_cache()

    # 13. serving in the same world: the engine against greedy (f32) and
    # forward (bf16), its planted faults, the scheduler, the numbers
    serve_row = serve_one_card(torch, np, tfm, attention, card)
    torch.cuda.empty_cache()

    # 14. speculative decoding in the same world: stream identity (f32),
    # its planted faults, decode_window beside decode_step (bf16)
    decode_row = decode_one_card(torch, np, tfm, card)
    torch.cuda.empty_cache()

    # 15. the serving fleet in the same world: a fleet of one replica
    # against the bare scheduler
    fleet_row = fleet_one_card(torch, np, tfm, attention, card)
    torch.cuda.empty_cache()

    # 17. MoE in the same world: the einsum block card against CPU,
    # moe_block_ep against moe_block, the MoE engine against greedy, then
    # the flagship with mlp="moe" at full width (forward, train step)
    moe_row = moe_one_card(torch, np, tfm, optim, attention, card)
    # each kernel's launches in one MoE train step, by remat mode
    moe_steps = [{r["remat"]: r["k1_k2_k3_k4_launches_per_step"][i]
                  for r in moe_row["flagship"]["train"]} for i in range(4)]
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    # 11. the MPI surface under the port's tpurun: the device program on
    # this card, R = 8 rows in one rank; the ring on the host plane
    mpi_row = mpi_phase(COLL_ROWS, 1, ["allreduce"], False)

    # K2: q, k, v, dO, lse, delta in; dk, dv out; 4 causal products
    k2_flops, k3_flops = 8 * d * pairs, 6 * d * pairs
    k2_bound, k2_by = bound(k2_flops, 6 * tile + 2 * vec)
    # K3: q, k, v, dO, lse, delta in; dq out; 3 causal products
    k3_bound, k3_by = bound(k3_flops, 5 * tile + 2 * vec)
    for metric, value in (("k2_ms", k2_ms), ("k2_plain_ms", k2_plain_ms),
                          ("k3_ms", k3_ms), ("k3_plain_ms", k3_plain_ms),
                          ("flash_mha_bwd_ms", mha_bwd_ms),
                          ("train_value_and_grad_ms", grads_ms),
                          ("train_adamw_ms", adamw_ms),
                          ("sdpa_bwd_ms", sdpa_bwd_ms),
                          ("k2_bound_ms", k2_bound), ("k3_bound_ms", k3_bound),
                          ("k2_tflops", k2_flops / k2_ms / 1e9),
                          ("k3_tflops", k3_flops / k3_ms / 1e9)):
        log({"phase": "numbers", "metric": metric, "value": value,
             "card": card})
    # like for like: flash_mha's whole backward (fold of dO, delta, K2, K3)
    # against SDPA's on the same (b, h, s, d) inputs
    log({"phase": "numbers", "metric": "bwd_vs_sdpa",
         "flash_mha_bwd_ms": mha_bwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
         "ratio": mha_bwd_ms / sdpa_bwd_ms, "card": card})

    log({"collectives": coll_rows})
    log({"mesh": mesh_rows})
    log({"mpi": mpi_row})
    log({"grad_sync": sync_row})
    log({"serve": serve_row})
    log({"decode": decode_row})
    log({"fleet": fleet_row})
    log({"moe": moe_row})
    log({"audit": audit_row})
    log({"kernels": [
        {"name": "flash_partials", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/flash_partials.cu",
         "replaces": "ompi_tpu/ops/attention.py:248",
         "launches": per_step[0], "moe_step_launches": moe_steps[0],
         "max_abs_err": path_err, "ms": k1_ms,
         "plain_ms": plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": sdpa_ms, "tflops": flops / k1_ms / 1e9,
         "bound_share": k1_bound / k1_ms,
         "serve_greedy_launches": serve_row["f32"]["k1_launches_greedy"],
         **ring_row},
        {"name": "flash_bwd_dkdv", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ompi_tpu/ops/attention.py:381",
         "launches": per_step[1], "moe_step_launches": moe_steps[1],
         "max_abs_err": max(bwd_err["dk"], bwd_err["dv"]), "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": sdpa_bwd_ms, "flash_mha_bwd_ms": mha_bwd_ms,
         "tflops": k2_flops / k2_ms / 1e9, "bound_share": k2_bound / k2_ms},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ompi_tpu/ops/attention.py:436",
         "launches": per_step[2], "moe_step_launches": moe_steps[2],
         "max_abs_err": bwd_err["dq"],
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": sdpa_bwd_ms,
         "flash_mha_bwd_ms": mha_bwd_ms, "tflops": k3_flops / k3_ms / 1e9,
         "bound_share": k3_bound / k3_ms},
        # the causal call at full width is K4's path run; its other two
        # shapes are in the k4_path lines
        {"name": "flash_attention", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/flash_attention.cu",
         "replaces": "ompi_tpu/ops/attention.py:139",
         "launches": k4_rows[0]["launches"],
         "launches_per_train_step": per_step[3],
         "moe_step_launches": moe_steps[3],
         "max_abs_err": k4_rows[0]["max_abs_err"], "ms": k4_rows[0]["k4_ms"],
         "plain_ms": k4_rows[0]["plain_ms"],
         "bound_ms": k4_rows[0]["bound_ms"],
         "bound_by": k4_rows[0]["bound_by"],
         "library_ms": k4_rows[0]["sdpa_ms"],
         "tflops": k4_rows[0]["k4_tflops"],
         "bound_share": k4_rows[0]["roofline_share"]}]})
    log(card)
    # count: the cards this run used
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": 1}})
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-card", action="store_true",
                    help="run only phases 9, 10c, 11, 12d-f, 13e, 14c, "
                         "15b-d, 16, 17c, 17d and 18b-c, across every "
                         "visible card")
    ns = ap.parse_args()
    sys.exit(multi_card_main() if ns.multi_card else main())
