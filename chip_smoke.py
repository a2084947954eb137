#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srsran_edgeric_5g_tpu_torch) on one
NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — nvcc-build every kernel in srsran_edgeric_5g_tpu_torch/csrc/
               (one process per source, in parallel); per kernel ptxas's
               registers, stack and spill bytes, and from cuobjdump -sass its
               instructions, branch-sync blocks and local-memory accesses.
  2. slice   — the main path: dl_slot_batch then ul_slot_batch at the 20 MHz
               cell (106 PRB, nfft 1536, 4 UEs x 26 PRB, 64QAM r0.5, S = 256
               slots) through 25 dB AWGN; every TB must pass CRC with the
               exact payload, also on a HARQ retransmission step; launch
               counts are read around this run only.
  3. small   — the same pipeline at a small cell on the CPU (plain decoder)
               and on the card (kernel): equal payloads and CRC flags.
  4. kernels — each kernel against its plain PyTorch version on the card at
               the main path's decode shape (2048 x 15232, BG1 Zc=224, the
               real decoder input of phase 2) and at BG2 Zc=128, both modes,
               and at BG2 Zc=40 (wire mode only), fixed sweeps, early stop
               per codeblock and the batch exit that decode() runs (a group
               exit over the whole batch): equal hard bits, ok, sweeps.
  5. timing  — bench.py --data-only: its inputs and DL+UL step (the bench
               module's), chained over its 30 steps, and its JSON line; a per-stage
               breakdown; the kernel alone (early stop, and fixed 0, 1 and 6
               sweeps: the slope is the cost of a sweep), its resident CTAs
               per SM, its plain version, its bound, and the sweeps its
               launches ran (executed_sweeps: the group exit repeats none, so
               they are the sum of the sweeps per codeblock; checked here and
               on every kernel_time path, the 4x4 data plane among them).
  6. full_cell — the full gNB slot (bench.py's bench_full_cell) at
               FullCellConfig() (20 MHz, 106 PRB, 4 UEs, 64QAM) and S = 256,
               through the bench module's inputs (bench.py's default_rng(0)
               draws) and chained step: UE UL generated once, 25 dB AWGN, one
               DL+UL step with the HARQ carry and new_data = 1, bench.py's
               asserts (PUSCH CRC + exact payload, exact F1 ACKs, F2 CSI
               valid and exact, PRACH preamble 7 alone on every occasion);
               K1's launches are read around this run.  Then bench.py's 30
               chained steps (ms per slot, x real time, samples/s, and
               bench.py's JSON line), each a replay of the DL and the UL
               call's CUDA graph (utils.tracing.graph_calls, printed for
               the warm and the timed steps), a per-channel breakdown, and
               the device's busy time and idle share over chained steps
               (torch.profiler's device records).
  7. kernel_int8 — K2 (decode_int8) against its plain version on the card:
               BG1 Zc=384 B=128 at 100 dB and 6.5 dB (the shape of
               tools/tpu_pallas_earlystop.py) and the full cell's decoder
               input (2048 x 15232), early stop off/on, b_tile 1 and 32:
               equal hard bits, ok, sweeps.  K2's own path (decode_int8 as
               its callers call it, on the full cell's decoder input) is
               driven with the counts reset around it; its time, its plain
               version's time, its bound.
  8. mimo_full_cell — bench.py's bench_full_cell_mimo(256, 2) at
               FullCellConfig(n_layers=2): the UE UL generated once, mixed
               through bench.py's static 2x2 channel, 25 dB; the same asserts
               and launch count as full_cell, then the chained steps, the
               per-stage breakdown (the LxP front, the 2-port DL grids) and the
               device profile.
  9. mimo_data_plane — bench.py's bench_mimo(256, 4): 106 PRB, 4 UEs x 26
               PRB, 64QAM r0.5, 4 layers through a 4x4 channel at 25 dB;
               bench.py's payload and CRC assert held against the reference
               decoder's own outcome at this point (check_wire_floor), K1's
               launches, chained steps and
               bench.py's line, a short breakdown; then the setup step on
               bench.py's own draw (mimo_data_plane_bench_draw: its TBs at
               the wire floor, passing TBs exact, the f32 decode recovering
               every TB).
 10. qam256_full_cell — bench.py's --qam256 point: 256QAM r682.5/1024 both
               ways, ul_delay_spread_us = 1.0 (the TA + smoothing estimator),
               33 dB; as full_cell.
 10a. bench_modes — bench.py --clean, --no-csirs and --qam256 --chest=ls
               (the modes no other phase times) through the bench module's
               main in this process at S = 256, 30 steps: bench.py's asserts,
               its JSON line, K1 once per step.
 10b. streaming — bench.py --streaming=S at S = 8, 16, 32, 64, depth 2, 400
               batches each (bench_streaming: the full gNB slot with the HARQ
               carry, batch k+1 issued before the host waits on batch k's
               CUDA event): sustained x real time, p50 / p99 latency from
               submit to result, compute ms per batch and the overhead, the
               synchronising calls of one warm step (set_sync_debug_mode), the
               device's idle share over a profiled window, bench.py's line.
 11. kernels on each new path — K1 against its plain version on that
               phase's real decoder input (early stop and fixed sweeps), its
               time (early stop; fixed 0, 1 and 6 sweeps), resident CTAs per
               SM, its bound; the streaming path's at S = 8.
 12. hetero_cell — the per-UE channel processors through the scheduler's
               entry point, HeteroCellProcessor, at 20 MHz (106 PRB) with a
               4-UE grant set on the 8-PRB RBG grid (QPSK DFT-s-OFDM at BG2
               Zc = 26, 16QAM, 64QAM, and a 5-codeblock 64QAM r0.93 UE with
               one DM-RS symbol and non-uniform E): HC_SLOTS slots at 25 dB,
               fresh payloads every slot, DL TX -> UE RX and UE TX -> gNB RX;
               every TB exact, K1 (wire mode) launched 8 times per slot.  Ms
               per slot of each call, a per-UE breakdown of pusch.process and
               the device profile of chained slots.
 13. hetero_harq — a 12-PRB 64QAM r0.8 UE at HARQ_SNR_DB both ways: rv 0
               fails, rv 2 from a zero buffer fails, the combined decode is
               exact (UL and DL).
 14. pusch_uci — UE 1 alone with the two UCI configurations (polar CSI with
               CRC11 and with CRC6 + PC; short-block ACK in the reserved
               mode): ACK, CSI and payload exact; decode_scl's time.
 15. mimo_ue — models/mimo.py's per-UE receiver at L = 2 (52 PRB) and L = 4
               (36 PRB, 7 codeblocks, non-uniform E), MIMO_DRAWS draws each,
               exact payloads, K1's f32 mode ("auto" decode) launched.
 16. kernels on the per-UE paths — K1 against its plain version on each
               UE's decoder input (wire mode, BG2 Zc = 26 among them) and on
               the MIMO receiver's (f32 mode, l <= 0 rule), and f32 mode at
               BG2 Zc = 40; K1's time per launch at each shape, plain, bound.
 17. cell_processor — the loopback app's slot loop (loopback_app.
               run_slot_loop, run-ahead 2) over a CellProcessor built from
               PhyConfig(bandwidth_mhz=20, nof_ue=4, qam64, r0.5) (106 PRB,
               nfft 1536, 4 UEs x 26 PRB): CP_SLOTS slots through in-process
               25 dB AWGN, every TB exact, K1 launched once per UL slot, the
               metrics hub holding every slot with positive throughput; ms per
               slot of process_dl_slot and process_ul_slot (CUDA events), the
               loop's wall ms per slot and x real time, the device profile of
               a serial slot.  Then the app's default PhyConfig() (10 MHz, 2
               UEs, 16QAM r0.5) for CP_DEFAULT_SLOTS slots, the same asserts.
 18. cell_harq — tests/test_cell_processor.py's HARQ scenario at 20 MHz:
               rv 0 fails for a UE, the rv 2 retransmission on the same pid
               decodes every TB exactly, decoded UEs' processes reset.
 19. cell_control — one occasion of each processor hook at 20 MHz (SSB +
               PDCCH overlay with the PDSCH exact, MIB and DCI decoded, PRACH
               preamble 9 alone on an unrestricted and a restricted set, PUCCH
               F0 / F1 / F2, SRS |h|); each hook's ms per call.
 20. kernels on the cell processor's path — K1 against its plain version on
               the UL slot's decoder input, its time, plain, bound.
 21. sched_cell — the MAC and EdgeRIC layers through the app's scheduled
               loop (loopback_app.run_scheduled, --sched pf) on CELL_PHY's
               cell, SCHED_SLOTS slots at 25 dB through an in-process AWGN
               radio, with an in-process EdgeRIC (StandInRic: the port's
               MuAppScheduler behind EdgericAgent's interface, since the
               card's machine has no pyzmq or protobuf): max_cqi weights,
               then round_robin through an AlgorithmSwitch file.  Every DL TB
               delivered, every weighted grant's PRB count what its weight
               gives, K1 once per granted UE and slot; wall ms per slot,
               layouts and build ms, host reads per slot; the same run
               warm (every layout's lazy tables made), timed, and profiled
               over SCHED_PROFILE's slots.
 22. sched_ul_harq — UL traffic with SR and BSR, a deep UL fade (5 dB) and a
               DL fade (4 dB), SCHED_UL_SLOTS slots: a UL and a DL
               retransmission recovered by soft combining, nothing dropped,
               every SR detected, a BSR, UL bytes served.
 23. sched_rach_bcch — the cell starting empty: 2 UEs attach (PRACH, RAR,
               Msg3, Msg4) while SIB1 and paging go out, SCHED_RACH_SLOTS
               slots; both connected, SIB1 and the page received, scheduled
               TBs after the attach.
 24. kernels on the scheduled paths — K1 against its plain version on
               each scheduled phase's decoder inputs (wire mode, kept by a
               SchedRecorder): sched_cell's last DL slot (one per UE);
               sched_ul_harq's first faded UL retransmission (the float32
               soft-combined buffer), first DL retransmission and a new UL
               TB; sched_rach_bcch's first control PDSCH per RNTI (SIB1,
               paging, RAR, Msg4), its first Msg3 and a data TB after the
               attach; its time per launch, plain, bound.
 25. ric_train — the RIC's training half on the card: ppo_train (2
               iterations x 1024 steps) on the digital twin of the scheduled
               cell (4 UEs, 106 PRB) and neurwin_train (20 episodes), finite
               weights and rewards; the trained policy saved as a checkpoint,
               loaded by MuAppScheduler's TorchWeightPolicy, and serving
               RIC_SERVE_SLOTS slots of the scheduled cell (algorithm "rl"
               in the EdgeRIC stand-in) with every TB delivered; ms per
               iteration and episode.
 26. scale_out — the mesh path (parallel/mesh.py, mesh= of the slot and
               full-cell programs) as a world of 1 over NCCL in this
               process: parallel.dryrun's programs at 20 MHz (the (ue, cb)
               slot step, the time-block stream, the SISO and 2x2 full gNB
               slot at S = 10 with the HARQ carry, the 4x4 data plane),
               payload-exact; the full gNB slot at S = 256 on a (1, 1) mesh
               equal to mesh=None (payloads, tb_ok, the carry, ACK, CSI and
               PRACH exact, samples within 1e-4, noise_var and cfo within
               1e-4 of the peak), ms per slot of both in turns and the
               collectives per step, the device profile of both steps;
               K1 against its plain version on one
               rank's codeblock share, and on no codeblocks (no launch); the
               early stop over the mesh's codeblock groups on waterfall input
               (multihost.exit_inputs: bler_sweep's MCS 24, 16 dB pairs and
               _ul_back at 16.5 dB) equal to mesh=None; then
               parallel.multihost as 2 processes on the card over gloo
               (MULTIHOST_OK, seconds per step beside world 1's), with the
               exit program: one waterfall codeblock per rank through K1 and
               the all-reduced rounds, a rank with none, and _ul_back on a
               2-rank 'cb' mesh, each equal to mesh=None (scale_out_exit).
 27. validation — the validation entry points (srsran_edgeric_5g_tpu_torch/
               tools/), each through its own functions: bler_awgn
               (bler_sweep's BLER_R1.md grid, 15 points x VAL_BLOCKS TBs, the
               per-TB outcomes and hard bits equal to the plain "layered"
               decode at every point), bler_parity (the three port columns at
               every CASES point on VAL_PARITY_BLOCKS TBs, K1 wire equal to
               the plain layered_wire on every 512-codeblock chunk),
               bler_channels (AWGN and TDL-A at VAL_BLOCKS TBs, the RLF run
               decoding 12 of 20) and chest_bler (MCS 15, both estimators),
               both with the tool's per-TB outcomes equal to the plain
               version's exit per TB, sched_churn (layouts of
               VAL_SCHED_SLOTS PF slots, first-use and warm ms of the top
               layouts) and kernel_bench (a line per stage); K1 (with the
               path's exit group: the call, a 512-codeblock chunk or a TB)
               against its plain version on each path's decoder inputs, its
               ms, bound and sweeps per codeblock; the phases' seconds.
 28. entry — the single-device entry point (srsran_edgeric_5g_tpu_torch.
               entry.entry(): the UL slot step of __graft_entry__.entry(), 52
               PRB, 4 UEs x 12 PRB, 16QAM r0.4, on one slot of seeded noise)
               on the card equal to the CPU: payload bits and tb_ok exact,
               noise variance and CFO within ENTRY_RTOL of the peak.

Between phases 1 and 2:
  1a. pdsch_code — PDSCH coding's two kernels (ops/pdsch_code.py:
               pdsch_encode, pdsch_modulate) against the plain chain they
               replace, run on the card (segment_tb -> encoder.encode ->
               rate_match; scramble_bits -> modulate on CUDA tensors), at the
               benchmark cells' shapes: the normal and the SSB slots of the
               SISO step (S = 1024) and of the 2x2 step (S = 512).  Equal
               bits and symbols; each one's ms per call, the plain chain's,
               and the byte bound (int8 in, int8 or complex64 out, at
               HBM_BYTES_PER_S).

  1b. pusch_front — the PUSCH front's kernel (ops/pusch_front.py:
               pusch_demap) against the plain chain it replaces, run on the
               card (pusch_front.demap_plain on CUDA tensors), on the inputs
               the UL front hands it at the benchmark cells' UL shapes (SISO
               S = 1024, 2x2 S = 512; 25 dB data-plane waveforms): equal
               int8 LLRs; its ms per call, the plain chain's, and the byte
               bound (REs, estimate or weights, derotation and inits in, one
               int8 per LLR out, at HBM_BYTES_PER_S).

Between phases 5 and 6 (they reuse the slice phase's tensors):
  5a. multi_cell — bench.py --cells=4 --sbatch=64 (the bench module's inputs
               and chained step, and its JSON line): 4 carriers x 64 slots of the 20 MHz
               4-UE data plane, each carrier with its own RNTIs, through 25
               dB AWGN: multi_cell_dl_slot_batch, multi_cell_ul_slot_batch
               with K1 launched exactly once (counts read around the UL
               call), every one of the 1024 TBs exact; 30 chained
               steps (ms per cell-slot beside the slice's ms per slot), the
               per-stage breakdown, the device profile; K1 on this path's
               decoder input with the other batched paths (phase 11).
  5b. fronthaul — the slice's DL resource grids (256 slots x 14 x 1272),
               scaled to a peak of 1 through iq_scaling, BFP-compressed at 9
               and 14 bits on the card: mantissas and exponents equal to the
               CPU's, the decompressed grid's SNR above FH_SNR_FLOOR_DB, one
               slot framed and deframed through native/ofh to the same grid;
               ms per slot of compress and decompress.
  5c. time_block — one second of the 20 MHz stream (1000 slots) modulated
               and demodulated in 4 time blocks on the card, DFT windows 16
               samples early: equal to one block and to the grids within
               tests/test_timeblock.py's tolerance; ms per slot.
  5d. decode_schedules — decode("flooding") and decode("layered_rolls_i8")
               on the slice's decoder input (2048 x BG1 Zc = 224): hard bits
               equal to the CPU's (flooding on its first 256 codeblocks,
               within FLOODING_BIT_SHARE), their ms.

Prints the card (nvidia-smi name, power limit), a JSON line per phase (the
last, "total", the run's seconds from the build on), the
{"kernels": [...]} line (K1's entry with its launches on every path), and
last {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time

SEED = 1234
SNR_DB = 25.0
S_BATCH = 256            # bench.py's --sbatch default
# The bench modes that no phase below times, run through the bench module's
# main (phase bench_modes); the others print bench.py's line from the phase
# that times them.
BENCH_MODES = (["--clean"], ["--no-csirs"], ["--qam256", "--chest=ls"])
# bench.py --streaming=S: slots per batch of the streaming phase, the
# batches of its profiled window, and the synchronising calls a streaming
# step may still make (file:line, each listed in ROADMAP.md Queue C).
STREAM_SLOTS = (8, 16, 32, 64)
STREAM_PROFILE_BATCHES = 16
HOST_SYNCS_KNOWN = ()
# entry() on the card against the CPU: noise variance and CFO, of the peak.
ENTRY_RTOL = 1e-4
# At the 4x4 point the reference's wire decode leaves 0.24 % of the TBs
# undecoded over 24,576 TBs of chip_smoke's channel (at most 5 of 1024 in
# one draw; ROADMAP.md Queue C): a failure share above this bound is a fault.
WIRE_FLOOR_MAX_TB_SHARE = 0.01
NUM_ITERS = 6
# K1's exits held against the plain version, (early_stop, exit_group):
# fixed sweeps, per codeblock, and the batch rule that decode("auto") /
# decode("wire_auto") run (the whole call as one group).
EXITS = ((False, None), (True, 1), (True, None))
# H100 SXM data sheet (see PERF.md): HBM
# rate, and the 32-bit ALU rate = 67 TFLOP/s fp32 (FMA counted as two) / 2.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12 / 2
# Arithmetic the layered check-node update needs per edge, lane and sweep
# (subtract, saturate, abs, min/second-min update, sign parity, magnitude
# select, scale, sign, add, pin) — a floor, not the kernel's instruction count.
OPS_PER_EDGE_LANE = 16
# The per-UE paths (phases 12-16).
HC_SLOTS = 64
HC_PROFILE_SLOTS = 8
# tests/test_harq_retx.py's operating point (6.5 dB at 10 MHz) moved to 20
# MHz, where the noise spreads over nfft 1536 bins instead of 768: at 4.0 dB
# rv 0 and rv 2 each fail alone and their combination decodes, in every one
# of 12 noise draws per direction on the CPU (tests/test_torch_hetero_cell.py
# pins one).
HARQ_SNR_DB = 4.0
UCI_CONFIGS = (
    dict(n_ack=4, g_ack=64, n_csi1=20, g_csi1=160, n_csi2=14, g_csi2=96),
    dict(n_ack=2, g_ack=32, g_ack_rvd=64, n_csi1=8, g_csi1=64),
)
MIMO_DRAWS = 8
# The cell processor and the app's slot loop (phases 17-19): the 20 MHz
# 4-UE 64QAM cell through PhyConfig, and the app's default PhyConfig().
CELL_PHY = dict(bandwidth_mhz=20, nof_ue=4, modulation="qam64", target_rate=0.5)
CP_SLOTS = 64
CP_DEFAULT_SLOTS = 16
CP_PROFILE_SLOTS = 8
# tests/test_cell_processor.py's HARQ point (3.2 dB at 10 MHz) at 20 MHz,
# where the noise spreads over twice the bins: rv 0 at 0 dB, rv 2 at 6 dB.
# Over 32 draws on the CPU each rv 0 failed for both UEs, each rv 2 alone
# failed and every combination decoded.
CELL_HARQ_SNR_DB = (0.0, 6.0)
# The MAC and EdgeRIC layers through the app's scheduled loop (phases 21-24)
# on CELL_PHY's cell: RNTIs 0x4601-0x4604 on 106 PRB, RBG 8.
SCHED_SLOTS = 64
SCHED_SWITCH_TTI = 32          # max_cqi weights before, round_robin from here
SCHED_PROFILE = (24, 32)       # the slots profiled in a warm repeat of sched_cell
SCHED_UL_SLOTS = 24
SCHED_RACH_SLOTS = 40
# bench.py --cells=4: NC carriers of the 20 MHz 4-UE data plane, MC_SLOTS
# slots each (2048 codeblocks: the slice phase's decode shape).
MC_CARRIERS = 4
MC_SLOTS = 64
# The fronthaul: BFP widths, and the decompressed grid's SNR floor against
# the peak-scaled input.  On the CPU (8 slots of this grid, 3 seeds) 9 bits
# gave 49.77-49.81 dB and 14 bits 80.39-80.43 dB.
FH_WIDTHS = (9, 14)
FH_SNR_FLOOR_DB = {9: 48.0, 14: 78.0}
# One second of the 20 MHz stream in TB_BLOCKS time blocks on one card,
# DFT windows TB_SHIFT samples early; tests/test_timeblock.py's tolerance.
TB_SLOTS = 1000
TB_BLOCKS = 4
TB_SHIFT = 16
TB_ATOL = 3e-4
# flooding's sums run in another order on the card (index_add_'s atomics):
# the share of its hard bits that may differ from the CPU's.
FLOODING_BIT_SHARE = 1e-4
FLOODING_CPU_CODEBLOCKS = 256
# The RIC's training half at the scheduled cell's 4 UEs and 106 PRB.
RIC_PPO = dict(iterations=2, batch_steps=1024)
RIC_NEURWIN_EPISODES = 20
RIC_SERVE_SLOTS = 8
# The scale-out (phase 26): the mesh full slot against mesh=None, chained
# steps per turn, and the 2-process gloo worker's wait.
SO_SAMPLE_ATOL = 1e-4
SO_RTOL = 1e-4
SO_STEPS = 10
SO_GLOO_WAIT_S = 240
# The validation entry points (phase 27): TBs per point of each waterfall
# (bler_parity cut from the tool's 1000 and bler_channels from its record's
# 400, to keep the phases within a minute), the channel profiles run, the
# layouts timed.
VAL_BLOCKS = 64
VAL_PARITY_BLOCKS = 256
VAL_PROFILES = ("awgn", "tdla")
VAL_SCHED_SLOTS = 1000
VAL_SCHED_TOP = 3
VAL_SCHED_PHY_SLOTS = 10


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def main_cell(sp):
    return sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=4, prb_per_ue=26,
                         modulation="qam64", target_rate=0.5)


def awgn(td, snr_db, gen):
    """Complex AWGN at ``snr_db`` below the mean sample power."""
    import torch
    sigma = torch.sqrt(td.abs().pow(2).mean() * 10.0 ** (-snr_db / 10.0) / 2.0)
    real = torch.randn(td.shape, generator=gen, device=td.device)
    imag = torch.randn(td.shape, generator=gen, device=td.device)
    return torch.complex(real, imag) * sigma


def phase_pdsch_code(sp, fcm, dev) -> dict:
    """Phase 1a: the PDSCH kernels against the plain chain on the card at
    the cells' shapes; {path: its row}."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops import modulation, pdsch_code, sequences
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import encoder, rate_match, segmenter
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    rows = {}
    for tag, fc, s in (("siso", fcm.FullCellConfig(), 1024),
                       ("mimo2x2", fcm.FullCellConfig(n_layers=2), 512)):
        mimo = fc.n_layers > 1
        parts = {"normal": (fc.dl_cell_mimo() if mimo else fc.dl_cell(),
                            len(fc.norm_slots(s))),
                 "ssb": (fc.dl_cell_ssb_mimo() if mimo else fc.dl_cell_ssb(),
                         len(fc.ssb_slots(s)))}
        for part, (cell, n_slots) in parts.items():
            seg, rm = sp._plans(cell)
            b_tb = n_slots * cell.nof_ue
            pay = torch.randint(0, 2, (b_tb, seg.a), generator=gen, device=dev,
                                dtype=torch.int8)
            ci = sp._scrambling_inits(fcm._rntis(fc, dev), cell, n_slots)
            cbs = slice(0, b_tb * seg.c)
            kernel_encode = lambda: pdsch_code.encode(pay, seg, rm, cbs)
            plain_encode = lambda: rate_match.rate_match(encoder.encode(
                segmenter.segment_tb(pay, seg), seg.bg, seg.zc), rm)
            bits = kernel_encode().reshape(b_tb, -1)
            check(torch.equal(bits.reshape(-1, rm.e), plain_encode()),
                  f"pdsch_encode {tag} {part}: bits differ from the plain chain")
            kernel_mod = lambda: pdsch_code.modulate(bits, ci, cell.modulation)
            plain_mod = lambda: modulation.modulate(sequences.scramble_bits(bits, ci),
                                                    cell.modulation)
            check(torch.equal(kernel_mod().view(torch.float32),
                              plain_mod().view(torch.float32)),
                  f"pdsch_modulate {tag} {part}: symbols differ from the plain chain")
            g = bits.shape[1]
            row = dict(tbs=b_tb, a=seg.a, bg=seg.bg, zc=seg.zc, c=seg.c, e=rm.e, g=g,
                       qm=cell.qm, equal=True,
                       encode_ms=cuda_ms(kernel_encode, 20),
                       encode_plain_ms=cuda_ms(plain_encode, 5),
                       encode_bound_ms=(pay.numel() + bits.numel()) / HBM_BYTES_PER_S * 1e3,
                       modulate_ms=cuda_ms(kernel_mod, 20),
                       modulate_plain_ms=cuda_ms(plain_mod, 5),
                       modulate_bound_ms=(bits.numel() + 8 * b_tb * (g // cell.qm))
                       / HBM_BYTES_PER_S * 1e3)
            emit("pdsch_code", path=f"{tag}_{part}", **row)
            rows[f"{tag}_{part}"] = row
    return rows


def phase_pusch_front(sp, fcm, dev) -> dict:
    """Phase 1b: pusch_demap against the plain chain on the card at the
    cells' UL shapes; {path: its row}."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops import pusch_front
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    rows = {}
    for tag, fc, s in (("siso", fcm.FullCellConfig(), 1024),
                       ("mimo2x2", fcm.FullCellConfig(n_layers=2), 512)):
        cell = fc.ul_cell()
        rntis = fcm._rntis(fc, dev)
        pay = torch.randint(0, 2, (s, cell.nof_ue, cell.derived_tbs()), generator=gen,
                            device=dev, dtype=torch.int8)
        t = cell.timing
        if fc.n_layers > 1:
            td = sp.dl_slot_batch_mimo(pay, rntis, cell, device=dev)
            grid = sp.ofdm.demodulate_slot((td + awgn(td, SNR_DB, gen)).reshape(
                s * fc.n_layers, -1), t, scale=1.0).reshape(s, fc.n_layers, t.nsymb, -1)
            front = lambda: sp._ul_front_mimo(None, rntis, cell, rx_grid=grid)
        else:
            td = sp.dl_slot_batch(pay, rntis, cell, device=dev)
            grid = sp.ofdm.demodulate_slot(td + awgn(td, SNR_DB, gen), t, scale=1.0)
            front = lambda: sp._ul_front(None, rntis, cell, rx_grid=grid)
        calls, demap = [], pusch_front.demap
        pusch_front.demap = lambda *a: calls.append(a) or demap(*a)
        try:
            front()
        finally:
            pusch_front.demap = demap
        args = calls[0]
        kernel = lambda: pusch_front.demap(*args)
        plain = lambda: pusch_front.demap_plain(*args)
        out = kernel()
        check(torch.equal(out, plain()),
              f"pusch_demap {tag}: LLRs differ from the plain chain")
        n_ports = grid.shape[1] if grid.ndim == 4 else 1
        n_in = (out.shape[0] * len(cell.data_symbols) * cell.ue_width_sc * n_ports * 8
                + sum(x.numel() * x.element_size() for x in args[4:8] if x is not None))
        row = dict(rows=out.shape[0], g=out.shape[1], qm=cell.qm, layers=fc.n_layers,
                   ports=n_ports, equal=True, bytes_in=n_in, bytes_out=out.numel(),
                   ms=cuda_ms(kernel, 20), plain_ms=cuda_ms(plain, 5),
                   front_ms=cuda_ms(front, 10),
                   bound_ms=(n_in + out.numel()) / HBM_BYTES_PER_S * 1e3)
        emit("pusch_front", path=tag, **row)
        rows[tag] = row
    return rows


def phase_slice(sp, cuda_build, dev, s_batch):
    """Drive the main path; return what later phases reuse."""
    import torch
    cell = main_cell(sp)
    u = cell.nof_ue
    gen = torch.Generator(device=dev).manual_seed(SEED)
    payloads = torch.randint(0, 2, (s_batch, u, cell.derived_tbs()),
                             generator=gen, device=dev, dtype=torch.int8)
    rntis = torch.arange(u, device=dev) + 0x4601
    t0 = time.perf_counter()
    cuda_build.reset_launches()
    td = sp.dl_slot_batch(payloads, rntis, cell, device=dev)
    noise = awgn(td, SNR_DB, gen)
    rx = td + noise
    pay, ok, nv, cfo, soft = sp.ul_slot_batch(rx, rntis, cell, device=dev)
    # HARQ: a new transmission through the returned carry (new_data = 1
    # clears it), then a chase-combined retransmission (new_data = 0).
    ones = torch.ones((s_batch, u), device=dev)
    pay2, ok2, _, _, soft2 = sp.ul_slot_batch(rx, rntis, cell, soft_buffer=soft,
                                              new_data=ones, device=dev)
    pay3, ok3, _, _, soft3 = sp.ul_slot_batch(rx, rntis, cell, soft_buffer=soft,
                                              new_data=0 * ones, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = dict(cuda_build.LAUNCHES)
    seconds = time.perf_counter() - t0

    seg, rm = sp._plans(cell)
    check(tuple(td.shape) == (s_batch, cell.timing.cp.total), f"DL shape {td.shape}")
    check(bool(torch.isfinite(td.real).all() and torch.isfinite(td.imag).all()),
          "DL samples finite")
    for tag, (p, o) in {"first": (pay, ok), "new_data": (pay2, ok2),
                        "combined": (pay3, ok3)}.items():
        check(bool(o.all()), f"{tag}: {int((~o).sum())} TBs failed CRC")
        check(torch.equal(p, payloads), f"{tag}: payload mismatch")
    check(tuple(soft.shape) == (s_batch, u * seg.c, rm.n_cb)
          and soft.dtype == torch.int8, f"soft carry {soft.shape} {soft.dtype}")
    check(torch.equal(soft2, soft), "new_data=1 must reproduce the fresh carry")
    check(bool((soft3.abs() >= soft.abs()).all()), "chase combine shrank |LLR|")
    check(bool(torch.isfinite(nv).all() and (nv > 0).all()), "noise variance")
    check(bool(torch.isfinite(cfo).all()), "cfo finite")
    emit("slice", cell="106PRB nfft1536 4UEx26PRB qam64 r0.5", slots=s_batch,
         snr_db=SNR_DB, tbs=cell.derived_tbs(), codeblocks=s_batch * u * seg.c,
         bg=seg.bg, zc=seg.zc, e=rm.e, n_cb=rm.n_cb, seconds=seconds,
         tb_ok=int(ok.sum()), launches=launches,
         mean_noise_var=float(nv.mean()))
    return dict(cell=cell, payloads=payloads, rntis=rntis, noise=noise, rx=rx,
                launches=launches)


def phase_small(sp, dev):
    """Small cell on the CPU (plain versions) and on ``dev``: same result."""
    import numpy as np
    import torch
    cell = sp.CellConfig(nof_prb=52, nfft=768, nof_ue=4, prb_per_ue=12,
                         modulation="qam16", target_rate=0.4)
    rng = np.random.default_rng(SEED)
    pay = rng.integers(0, 2, (2, 4, cell.derived_tbs()), dtype=np.int8)
    rntis = 0x4601 + np.arange(4)
    out = {}
    for d in (torch.device("cpu"), dev):
        td = sp.dl_slot_batch(pay, rntis, cell, device=d).cpu()
        out[d.type] = [td]
    td = out["cpu"][0].numpy()
    nvar = float(np.mean(np.abs(td) ** 2)) * 10 ** (-20 / 10)
    noise = (rng.normal(size=td.shape) + 1j * rng.normal(size=td.shape)) \
        * np.sqrt(nvar / 2)
    rx = (td + noise).astype(np.complex64)
    for d in (torch.device("cpu"), dev):
        res = sp.ul_slot_batch(rx, rntis, cell, device=d)
        out[d.type] += [r.cpu() for r in res]
    a, b = out["cpu"], out[dev.type]
    dl_err = float((a[0] - b[0]).abs().max() / a[0].abs().max())
    check(dl_err < 1e-5, f"small cell DL rel err {dl_err}")
    check(bool(a[2].all()), "small cell CPU CRC")
    check(torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]),
          "small cell payload/CRC differ between CPU and card")
    check(torch.equal(a[1], torch.as_tensor(pay)), "small cell payload")
    soft_diff = int((a[5] != b[5]).sum())
    check(soft_diff <= 1e-3 * a[5].numel(), f"small cell carry differs in {soft_diff}")
    emit("small", cell="52PRB nfft768 4UEx12PRB qam16 r0.4", dl_rel_err=dl_err,
         carry_entries_differing=soft_diff, carry_entries=a[5].numel())


def synthetic_wire(encoder, dev, bg, zc, b, snr_db, gen):
    """(float32 LLRs, int8 wire LLRs) of random codewords through BPSK AWGN."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    g = get_graph(bg, zc)
    msgs = torch.randint(0, 2, (b, g.k), generator=gen, device=dev, dtype=torch.int8)
    cw = encoder.encode(msgs, bg, zc)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * cw[:, 2 * zc:].float()) + sigma * torch.randn(
        cw[:, 2 * zc:].shape, generator=gen, device=dev)
    llr = torch.cat([torch.zeros((b, 2 * zc), device=dev), 2 * y / sigma ** 2], 1)
    wire = torch.clamp(torch.round(torch.clamp(llr, -20, 20) * 6.0), -120, 120)
    return llr.contiguous(), wire.to(torch.int8).contiguous()


def phase_kernels(sp, dec, encoder, dev, ctx):
    """Kernel == plain at the main-path decode shape and at BG2 Zc=128."""
    import torch
    cell = ctx["cell"]
    seg, _ = sp._plans(cell)
    llr, _, _ = sp._ul_front(ctx["rx"], ctx["rntis"], cell)
    full = sp._decoder_input(llr.reshape(-1, llr.shape[-1]), cell)
    ctx["decoder_input"] = full
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bg2_f32, bg2_wire = synthetic_wire(encoder, dev, 2, 128, full.shape[0], 1.5, gen)
    # A lifting size under 64, which only wire mode takes (TBS 288 gives
    # BG2 Zc = 40), at the main path's batch.
    _, small_wire = synthetic_wire(encoder, dev, 2, 40, full.shape[0], 1.5, gen)
    cases = [(f"BG{seg.bg} Zc={seg.zc}", seg.bg, seg.zc,
              {True: full, False: (full.float() / 6.0).contiguous()}),
             ("BG2 Zc=128", 2, 128, {True: bg2_wire, False: bg2_f32}),
             ("BG2 Zc=40", 2, 40, {True: small_wire})]
    max_err = 0
    for name, bg, zc, inputs in cases:
        for wire, x in inputs.items():
            for early_stop, group in EXITS:
                k = dec.decode_layered(x, bg, zc, NUM_ITERS, wire=wire,
                                       early_stop=early_stop, exit_group=group)
                p = dec.decode_layered_plain(x, bg, zc, NUM_ITERS, wire=wire,
                                             early_stop=early_stop, exit_group=group)
                err = int((k[0].int() - p[0].int()).abs().max())
                max_err = max(max_err, err)
                same = all(torch.equal(a, b) for a, b in zip(k, p))
                check(same, f"{name} wire={wire} early_stop={early_stop} group={group}: "
                            f"kernel != plain (max |hard diff| {err})")
                emit("kernel_vs_plain", case=name, mode="wire" if wire else "f32",
                     early_stop=early_stop, exit_group=group, codeblocks=x.shape[0],
                     equal=same, ok=int(k[1].sum()),
                     mean_sweeps=float(k[2].float().mean()))
    return max_err


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_line(pb, argv, slot_ms, timing, desc) -> None:
    """bench.py's JSON line for the mode ``argv`` from a phase's own timed
    steps (``bench_modes`` runs the modes no phase times)."""
    line = pb.result_line(pb.parse(argv).metric, slot_ms * 1e-3, timing)
    emit("bench_line", argv=" ".join(argv), line=line, desc=desc)


def phase_timing(sp, pb, dec, dev, ctx):
    import torch
    cell = ctx["cell"]
    t = cell.timing
    payloads, rntis, noise = ctx["payloads"], ctx["rntis"], ctx["noise"]
    s_batch = payloads.shape[0]
    # bench.py --data-only: its inputs and chained step.
    x = pb.data_plane_inputs(s_batch, 1, SNR_DB, dev)
    step = pb.data_plane_step(x, dev)
    _, state, _ = pb.chained(step, pb._start(dev), 2, dev)
    torch.cuda.reset_peak_memory_stats()
    res, _, dt = pb.chained(step, state, pb.ITERS, dev)
    check(bool(res[1].all()), "timed steps: CRC")
    slot_ms = dt / (pb.ITERS * s_batch) * 1e3
    slot_duration_ms = 1.0 / (1 << cell.mu)
    emit("e2e", steps=pb.ITERS, slots_per_step=s_batch, seconds=dt,
         ms_per_slot=slot_ms, x_real_time=slot_duration_ms / slot_ms,
         samples_per_s=pb.ITERS * s_batch * t.cp.total / dt,
         srate=t.srate, peak_mem_bytes=torch.cuda.max_memory_allocated())
    bench_line(pb, ["--data-only"], slot_ms, t,
               f"data-plane only, S={s_batch} x 1 cell(s), TBS {cell.derived_tbs()} x 4 UE")

    # Per-stage device time of one step (CUDA events, mean of 5).
    full = ctx["decoder_input"]
    seg, _ = sp._plans(cell)
    td = sp.dl_slot_batch(payloads, rntis, cell, device=dev)
    rx = td + noise
    llr = sp._ul_front(rx, rntis, cell)[0].reshape(s_batch * cell.nof_ue, -1)
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder, segmenter
    hard, _ = decoder.decode(full, seg.bg, seg.zc, NUM_ITERS, schedule="wire_auto")
    stages = {
        "dl_code": lambda: sp._dl_code(payloads.reshape(-1, payloads.shape[-1]),
                                       rntis, cell),
        "dl_slot_batch": lambda: sp.dl_slot_batch(payloads, rntis, cell, device=dev),
        "ul_front": lambda: sp._ul_front(rx, rntis, cell),
        "ul_dematch": lambda: sp._decoder_input(llr, cell),
        "ul_decode": lambda: decoder.decode(full, seg.bg, seg.zc, NUM_ITERS,
                                            schedule="wire_auto"),
        "ul_desegment": lambda: segmenter.desegment_tb(hard, seg),
        "ul_slot_batch": lambda: sp.ul_slot_batch(rx, rntis, cell, device=dev),
    }
    breakdown = {k: cuda_ms(f, 5) for k, f in stages.items()}
    emit("breakdown_ms_per_step", slots_per_step=s_batch, **breakdown)

    # The kernel alone at the main path's settings (wire, early stop), its
    # plain version, fixed-sweep and f32-mode times, and the bound.
    bg, zc = seg.bg, seg.zc
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    g = get_graph(bg, zc)
    # The path's decode: wire mode with the batch exit; the sweeps K1 ran.
    sweeps, executed = k1_executed(dec, full, bg, zc)
    ms = cuda_ms(lambda: dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True,
                                            early_stop=True), 20)
    ms_cb = cuda_ms(lambda: dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True,
                                               early_stop=True, exit_group=1), 20)
    # Fixed 0, 1 and 6 sweeps: 0 is load, syndrome and store alone; the
    # slope is the cost of one sweep.
    fixed = {n: cuda_ms(lambda n=n: dec.decode_layered(full, bg, zc, n, wire=True,
                                                       early_stop=False), 10)
             for n in (0, 1, NUM_ITERS)}
    f32_in = (full.float() / 6.0).contiguous()
    ms_f32 = cuda_ms(lambda: dec.decode_layered(f32_in, bg, zc, NUM_ITERS,
                                                wire=False, early_stop=False), 5)
    plain_ms = cuda_ms(lambda: dec.decode_layered_plain(
        full, bg, zc, NUM_ITERS, wire=True, early_stop=True), 3, warmup=1)
    total_sweeps = int(sweeps.sum())
    n_bytes = full.numel() + full.shape[0] * (g.kb * zc + 1 + 4)
    bound_ms, bound_by = kernel_bound(g, zc, total_sweeps, n_bytes)
    blocks = {m: dec.blocks_per_sm(mode, bg, zc) for m, mode in
              (("f32", dec.MODE_F32), ("wire", dec.MODE_WIRE), ("int8", dec.MODE_INT8))}
    emit("kernel_time", kernel="ldpc_layered", codeblocks=full.shape[0],
         blocks_per_sm=blocks,
         sweeps_total=total_sweeps, executed_sweeps=executed,
         mean_sweeps=total_sweeps / full.shape[0],
         wire_batch_exit_ms=ms, device_ms_by_kernel=k1_split(dec, full, bg, zc),
         wire_early_stop_ms=ms_cb, wire_fixed_0_ms=fixed[0],
         wire_fixed_1_ms=fixed[1], wire_fixed_6_ms=fixed[NUM_ITERS],
         f32_fixed_6_ms=ms_f32, plain_wire_batch_exit_ms=plain_ms, bytes=n_bytes,
         bound_ms=bound_ms, bound_by=bound_by)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                executed_sweeps=executed, slice_ms_per_slot=slot_ms,
                slice_breakdown=breakdown)


def k1_executed(dec, full, bg, zc):
    """K1 as the path runs it (wire mode, the batch exit) on ``full``: its
    sweeps per codeblock and the sweeps its launches ran (the device's
    counter), which must be their sum: no codeblock decoded twice."""
    import torch
    dec.reset_executed_sweeps()
    _, _, sweeps = dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True, early_stop=True)
    torch.cuda.synchronize()
    executed = dec.executed_sweeps(full.device)
    check(executed == int(sweeps.sum()),
          f"K1 ran {executed} sweeps for {int(sweeps.sum())} the batch rule takes")
    return sweeps, executed


def k1_split(dec, full, bg, zc, n_prof: int = 5) -> dict:
    """Device ms per call of the path's decode (wire mode, the batch exit)
    by kernel, from torch.profiler: the fused pass (layered_kernel), the
    group exit's rounds (resume_kernel, num_iters launches), the rest
    (zeroing its bookkeeping)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True, early_stop=True)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = KERNEL_NAME.search(e.name)
            name = m.group(1) if m else "other"
            out[name] = out.get(name, 0.0) + e.time_range.end - e.time_range.start
    return {k: v / n_prof / 1e3 for k, v in out.items()}


def kernel_bound(g, zc, total_sweeps, n_bytes):
    """(bound ms, what bounds it): the layered update's operation floor for
    the sweeps this run's data needed, or its bytes, whichever is longer."""
    ops = OPS_PER_EDGE_LANE * g.num_edges * zc * total_sweeps
    t_ops, t_bytes = ops / ALU_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def device_profile(step_fn, n_prof: int, wall_ms: float) -> dict:
    """Device busy time per step from torch.profiler's device records (the
    union of their intervals) against the unprofiled wall time per step: the
    idle share; and the operations that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            step_fn()
        torch.cuda.synchronize()
    return profile_summary(prof, n_prof, wall_ms)


def profile_summary(prof, n_prof: int, wall_ms: float) -> dict:
    """``device_profile``'s figures from a finished torch.profiler run over
    ``n_prof`` steps of ``wall_ms`` unprofiled wall time each."""
    import torch
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, -math.inf
    by_name = {}
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        t0_us, t1_us = e.time_range.start, e.time_range.end
        if t1_us > end:
            busy_us += t1_us - max(t0_us, end)
            end = t1_us
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (t1_us - t0_us)
    busy_ms = busy_us / n_prof / 1e3 if dev_events else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(steps=n_prof, wall_ms_per_step=wall_ms,
                device_busy_ms_per_step=busy_ms,
                idle_share=None if busy_ms is None else 1.0 - busy_ms / wall_ms,
                device_ops_per_step=len(dev_events) / n_prof,
                top_ms_per_step={k: v / n_prof / 1e3 for k, v in top})


def graph_calls_between(before: dict, after: dict) -> dict:
    """{entry point: {how: calls}} made between two snapshots of
    ``utils.tracing.graph_calls``."""
    out = {}
    for entry, counts in after.items():
        made = {k: n - before.get(entry, {}).get(k, 0) for k, n in counts.items()}
        made = {k: n for k, n in made.items() if n}
        if made:
            out[entry] = made
    return out


def phase_full_cell(fcm, sp, pb, cuda_build, dec, dev, argv, tag):
    """bench.py's mode ``argv`` of the full gNB slot (bench_full_cell, or
    bench_full_cell_mimo) on the port, through the bench module's inputs
    and chained step: bench.py's asserts, K1's launches, the chained timed
    steps (and bench.py's line from them), the per-channel breakdown and
    the device profile.  Phases ``<tag>``, ``<tag>_e2e``,
    ``<tag>_breakdown_ms_per_step``, ``<tag>_graph_calls`` and
    ``<tag>_device_profile``."""
    import torch
    from srsran_edgeric_5g_tpu_torch.utils import tracing
    mode = pb.parse(argv)
    n_l = mode.args[1] if mode.fn is pb.bench_full_cell_mimo else 1
    fc, snr_db, steps = fcm.FullCellConfig(n_layers=n_l, **mode.fc_kw), mode.args[-1], mode.iters
    mimo = fc.n_layers > 1
    s, u = S_BATCH, fc.nof_ue
    t = fc.timing
    chain = pb.FullCellChain(fc, s, snr_db, dev)
    x = chain.x
    cell_u, cell_n, cell_s, seg, rm = (x[k] for k in ("cell_u", "cell_n", "cell_s",
                                                       "seg", "rm"))
    pay_n, pay_s, dci, pbch = (x[k] for k in ("pay_n", "pay_s", "dci", "pbch"))
    gnb_dl, gnb_ul, ul, noise, ones, soft0 = (
        x[k] for k in ("gnb_dl", "gnb_ul", "ul", "noise", "ones", "soft0"))
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    start_calls = tracing.graph_calls.snapshot()
    t0 = time.perf_counter()
    res, td = chain(), chain.td
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    first_s = time.perf_counter() - t0
    # The normal and the SSB slots' PDSCH coding: one launch of each kernel.
    check(all(launches.get(k, 0) == 2 for k in ("pdsch_encode", "pdsch_modulate")),
          f"{tag}: PDSCH kernel launches per step {launches}")
    td_shape = (s, n_l, t.cp.total) if mimo else (s, t.cp.total)
    check(tuple(td.shape) == td_shape and bool(torch.isfinite(td.real).all()
                                                and torch.isfinite(td.imag).all()),
          f"{tag} DL samples {tuple(td.shape)}")
    ok = res["tb_ok"]
    pb.full_cell_asserts(res, x)
    det = res["prach_detected"]
    check(tuple(res["soft"].shape) == (s * u * seg.c, rm.n_cb)
          and res["soft"].dtype == torch.int8, f"{tag} flat HARQ carry")
    check(launches.get(dec.KERNEL, 0) > 0, f"{tag} launched no {dec.KERNEL} kernel")
    emit(tag, cell=f"{fc.nof_prb}PRB nfft{fc.nfft} {u}UE {fc.ul_modulation} "
         f"r{fc.ul_target_rate:.4g} {n_l}x{n_l} delay_spread_us={fc.ul_delay_spread_us}",
         slots=s, snr_db=snr_db, tbs_ul=cell_u.derived_tbs(),
         tbs_dl=cell_n.derived_tbs(), codeblocks=s * u * seg.c, bg=seg.bg,
         zc=seg.zc, e=rm.e, n_cb=rm.n_cb, carry_bytes=res["soft"].numel(),
         first_step_seconds=first_s, launches=launches, tb_ok=int(ok.sum()),
         prach_occasions=int(det.shape[0]),
         srs_snr_db_mean=float(res["srs_snr_db"].mean()),
         prach_delay=sorted(set(res["prach_delay"][:, 7].tolist())))

    for _ in range(2):
        chain()
    warm_calls = tracing.graph_calls.snapshot()
    torch.cuda.reset_peak_memory_stats()
    slot_ms = chain.timed(steps) * 1e3
    dt = slot_ms * 1e-3 * steps * s
    check(bool(chain.res["tb_ok"].all()), f"{tag} timed steps: CRC")
    # The CUDA graph per call: the 3 warm steps run each key eager once and
    # capture it; every timed step replays both calls.
    timed_calls = graph_calls_between(warm_calls, tracing.graph_calls.snapshot())
    check(timed_calls == {gnb_dl.__name__: {"replay": steps},
                          gnb_ul.__name__: {"replay": steps}},
          f"{tag}: the timed steps did not all replay: {timed_calls}")
    emit(f"{tag}_graph_calls", warm=graph_calls_between(start_calls, warm_calls),
         timed=timed_calls)
    emit(f"{tag}_e2e", steps=steps, slots_per_step=s, seconds=dt,
         ms_per_slot=slot_ms, x_real_time=(1.0 / (1 << fc.mu)) / slot_ms,
         samples_per_s=t.cp.total / (slot_ms * 1e-3), srate=t.srate,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    bench_line(pb, argv, slot_ms, t, f"full gNB slot, {n_l}x{n_l}, S={s}")

    # Per-channel device time of one step (CUDA events, mean of 5).
    from srsran_edgeric_5g_tpu_torch.ops import ofdm, prach
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder
    rntis = fcm._rntis(fc, dev)
    rx = pb._noisy(ul, noise, 1.0)
    grid = ofdm.demodulate_slot(td, t, scale=float(t.nfft))
    if mimo:
        rx_flat = rx.reshape(s * n_l, -1)
        rx_grid = ofdm.demodulate_slot(rx_flat, t, scale=1.0).reshape(
            s, n_l, t.nsymb, t.nof_subc)
        rx_grid0, rx0 = rx_grid[:, 0], rx[:, 0]
        llr = sp._ul_front_mimo(None, rntis, cell_u, rx_grid=rx_grid)[0]
        extra = fcm._dl_control_rows(dci, fc, s)
        stages = {
            "dl_total": lambda: gnb_dl(pay_n, pay_s, dci, pbch, fc, s, device=dev),
            "dl_pdsch_grids": lambda: (
                sp.dl_slot_batch_mimo(pay_n, rntis, cell_n, return_grid=True,
                                      extra_rows=fcm._slot_drop_period(
                                          extra, fc.ssb_period),
                                      device=dev),
                sp.dl_slot_batch_mimo(pay_s, rntis, cell_s, return_grid=True,
                                      extra_rows=extra[0::fc.ssb_period],
                                      device=dev)),
            "dl_pdcch": lambda: fcm.pdcch_rows(dci, fc, s),
            "dl_ssb": lambda: fcm.ssb_blocks(pbch, fc, s),
            "dl_ofdm_mod": lambda: ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft),
            "ul_total": lambda: gnb_ul(rx, fc, s, soft_in=soft0, new_data=ones,
                                       soft_flat=True, device=dev),
            "ul_ofdm_demod": lambda: ofdm.demodulate_slot(rx_flat, t, scale=1.0),
            "ul_pusch_front": lambda: sp._ul_front_mimo(None, rntis, cell_u,
                                                        rx_grid=rx_grid),
        }
    else:
        rx_grid = rx_grid0 = ofdm.demodulate_slot(rx, t, scale=1.0)
        rx0 = rx
        llr = sp._ul_front(None, rntis, cell_u, rx_grid=rx_grid)[0].reshape(s * u, -1)
        stages = {
            "dl_total": lambda: gnb_dl(pay_n, pay_s, dci, pbch, fc, s, device=dev),
            "dl_pdsch_code": lambda: (
                sp._dl_code(pay_n.reshape(-1, pay_n.shape[-1]), rntis, cell_n),
                sp._dl_code(pay_s.reshape(-1, pay_s.shape[-1]), rntis, cell_s)),
            "dl_pdcch": lambda: fcm.pdcch_rows(dci, fc, s),
            "dl_ssb": lambda: fcm.ssb_blocks(pbch, fc, s),
            "dl_ofdm_mod": lambda: ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft),
            "ul_total": lambda: gnb_ul(rx, fc, s, soft_in=soft0, new_data=ones,
                                       soft_flat=True, device=dev),
            "ul_ofdm_demod": lambda: ofdm.demodulate_slot(rx, t, scale=1.0),
            "ul_pusch_front": lambda: sp._ul_front(None, rntis, cell_u,
                                                   rx_grid=rx_grid),
        }
    full = sp._decoder_input(llr, cell_u)
    info = fc.prach_info()
    win = fcm._slot_take(rx0, fc.prach_slots(s))[:, :info.cp_samples + info.dft_size]
    stages.update({
        "ul_dematch": lambda: sp._decoder_input(llr, cell_u, 0, soft0, ones.reshape(-1)),
        "ul_decode": lambda: decoder.decode(full, seg.bg, seg.zc, NUM_ITERS,
                                            schedule="wire_auto"),
        "ul_pucch_f1": lambda: fcm._f1_detect(rx_grid0, fc, s),
        "ul_pucch_f2": lambda: fcm._f2_decode(fcm._slot_take(rx_grid0, fc.csi_slots(s)),
                                              fc, s),
        "ul_srs": lambda: fcm._srs_estimate(fcm._slot_take(rx_grid0, fc.srs_slots(s)),
                                            fc),
        "ul_prach": lambda: fcm._prach_detect_batch(
            prach.ofdm_demodulate_prach(win, info), fc),
    })
    emit(f"{tag}_breakdown_ms_per_step", slots_per_step=s,
         **{k: cuda_ms(f, 5) for k, f in stages.items()})

    emit(f"{tag}_device_profile", **device_profile(chain, 3, slot_ms * s))
    return dict(decoder_input=full, launches=launches, bg=seg.bg, zc=seg.zc)


def mix_matrix(n, gen, dev):
    """bench.py's static LxL spatial channel: 0.35 (N(0,1) + jN(0,1))/sqrt(2)
    plus the DFT matrix / sqrt(L), from the seeded generator."""
    import torch
    a = torch.complex(torch.randn((n, n), generator=gen, device=dev),
                      torch.randn((n, n), generator=gen, device=dev)) / math.sqrt(2)
    k = torch.arange(n, device=dev, dtype=torch.float32)
    ph = -2.0 * math.pi * torch.outer(k, k) / n
    dft = torch.complex(torch.cos(ph), torch.sin(ph)) / math.sqrt(n)
    return (0.35 * a + dft).to(torch.complex64)


def mimo_data_plane_inputs(sp, dev, n_l):
    """bench_mimo's cell and, from the seeded generator, its payloads, the
    LxL channel and the noise, as pb.mimo_inputs' dict.  (bench.py's own
    draw is checked apart: at 4x4 the reference decoder leaves 3.6 % of its
    TBs, ROADMAP.md Queue C.)"""
    import torch
    cell = sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=4, prb_per_ue=26,
                         modulation="qam64", target_rate=0.5, n_layers=n_l)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    payloads = torch.randint(0, 2, (S_BATCH, cell.nof_ue, cell.derived_tbs()),
                             generator=gen, device=dev, dtype=torch.int8)
    rntis = torch.arange(cell.nof_ue, device=dev) + 0x4601
    mix = mix_matrix(n_l, gen, dev)
    noise = awgn(sp.dl_slot_batch_mimo(payloads, rntis, cell, device=dev),
                 SNR_DB, gen)
    return dict(cell=cell, payloads=payloads, rntis=rntis, mix=mix, noise=noise)


def check_wire_floor(pb, res, rx, x, tag) -> int:
    """bench.py's assert at the 4x4 point held against the reference
    decoder's own outcome (pb.wire_floor: passing TBs exact, the f32 decode
    recovers every TB), and on chip_smoke's channel also: a TB fails CRC
    where, and only where, a codeblock of it never meets parity in the wire
    decode, at most WIRE_FLOOR_MAX_TB_SHARE of the TBs.  Returns the TBs
    that failed."""
    n_fail, mismatch = pb.wire_floor(res, rx, x)
    ok = res[1]
    check(n_fail <= WIRE_FLOOR_MAX_TB_SHARE * ok.numel(),
          f"{tag}: {n_fail}/{ok.numel()} TBs failed CRC")
    check(mismatch == 0, f"{tag}: {mismatch} TBs' CRC outcome differs from "
                         "their codeblocks' parity")
    return n_fail


def phase_mimo_data_plane(sp, pb, cuda_build, dec, dev, n_l):
    """bench.py's bench_mimo (--mimo=n_l) through the bench module's
    chained step: the 20 MHz data plane (106 PRB, 4 UEs x 26 PRB, 64QAM
    r0.5) at n_l layers through an LxL channel at 25 dB:
    dl_slot_batch_mimo -> mix -> ul_slot_batch_mimo, held to the reference
    decoder's outcome (check_wire_floor); K1's launches; the chained step
    (and bench.py's line from it) and a short breakdown.  Then the setup
    step on bench.py's own draw (pb.mimo_inputs), held to the same outcome
    with its failing TBs reported (phase mimo_data_plane_bench_draw)."""
    import torch
    x = mimo_data_plane_inputs(sp, dev, n_l)
    cell, payloads, rntis, mix, noise = (x[k] for k in ("cell", "payloads", "rntis",
                                                        "mix", "noise"))
    t = cell.timing
    s, u = S_BATCH, cell.nof_ue
    seg, rm = sp._plans(cell)
    step = pb.mimo_step(x, dev)
    eps, flip = pb._start(dev)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    res, eps, flip, rx = step(eps, flip)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    check(launches.get(dec.KERNEL, 0) > 0, f"the MIMO data plane launched no {dec.KERNEL}")
    wire_fail = check_wire_floor(pb, res, rx, x, "mimo_data_plane")
    emit("mimo_data_plane", cell=f"106PRB nfft1536 4UEx26PRB qam64 r0.5 {n_l}x{n_l}",
         slots=s, snr_db=SNR_DB, tbs=cell.derived_tbs(), codeblocks=s * u * seg.c,
         bg=seg.bg, zc=seg.zc, e=rm.e, n_cb=rm.n_cb, launches=launches,
         tb_ok=int(res[1].sum()), tb_failed_wire_floor=wire_fail,
         mean_noise_var=float(res[2].mean()))

    for _ in range(2):
        res, eps, flip, rx = step(eps, flip)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(pb.ITERS):
        res, eps, flip, rx = step(eps, flip)
    _ = int(eps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_wire_floor(pb, res, rx, x, "mimo timed steps")
    slot_ms = dt / (pb.ITERS * s) * 1e3
    emit("mimo_data_plane_e2e", steps=pb.ITERS, slots_per_step=s, seconds=dt,
         ms_per_slot=slot_ms, x_real_time=(1.0 / (1 << cell.mu)) / slot_ms,
         samples_per_s=t.cp.total / (slot_ms * 1e-3), srate=t.srate,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    bench_line(pb, [f"--mimo={n_l}"], slot_ms, t,
               f"{n_l}x{n_l} MIMO data plane, S={s}, chip_smoke's channel draw, "
               f"{wire_fail} TBs at the wire-decode floor")
    xb = pb.mimo_inputs(s, n_l, SNR_DB, dev)
    res_b, _, _, rx_b = pb.mimo_step(xb, dev)(*pb._start(dev))
    failed, mismatch = pb.wire_floor(res_b, rx_b, xb)
    emit("mimo_data_plane_bench_draw", slots=s, tbs_total=res_b[1].numel(),
         tb_failed_wire_floor=failed, tb_crc_unlike_parity=mismatch)
    del xb, res_b, rx_b

    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder
    td = sp.dl_slot_batch_mimo(payloads, rntis, cell, device=dev)
    rx = pb._noisy(torch.einsum("pl,slt->spt", mix, td), noise, 1.0)
    llr = sp._ul_front_mimo(rx, rntis, cell)[0]
    full = sp._decoder_input(llr, cell)
    stages = {
        "dl_slot_batch_mimo": lambda: sp.dl_slot_batch_mimo(payloads, rntis, cell,
                                                            device=dev),
        "ul_front": lambda: sp._ul_front_mimo(rx, rntis, cell),
        "ul_dematch": lambda: sp._decoder_input(llr, cell),
        "ul_decode": lambda: decoder.decode(full, seg.bg, seg.zc, NUM_ITERS,
                                            schedule="wire_auto"),
        "ul_slot_batch_mimo": lambda: sp.ul_slot_batch_mimo(rx, rntis, cell,
                                                            device=dev),
    }
    emit("mimo_data_plane_breakdown_ms_per_step", slots_per_step=s,
         **{k: cuda_ms(f, 5) for k, f in stages.items()})
    return dict(decoder_input=full, launches=launches, bg=seg.bg, zc=seg.zc)


def phase_path_kernel(dec, path, ctx):
    """K1 on one path's real decoder input: == its plain version (early stop
    and fixed sweeps), its time (early stop; fixed 0 / 1 / 6 sweeps), the
    plain version's time, resident CTAs per SM and the bound."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    full, bg, zc = ctx["decoder_input"], ctx["bg"], ctx["zc"]
    max_err = 0
    for early_stop, group in EXITS:
        k = dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True, early_stop=early_stop,
                               exit_group=group)
        p = dec.decode_layered_plain(full, bg, zc, NUM_ITERS, wire=True,
                                     early_stop=early_stop, exit_group=group)
        err = int((k[0].int() - p[0].int()).abs().max())
        max_err = max(max_err, err)
        same = all(torch.equal(a, b) for a, b in zip(k, p))
        check(same, f"{path} BG{bg} Zc={zc} early_stop={early_stop} group={group}: "
                    f"kernel != plain (max |hard diff| {err})")
        emit("kernel_vs_plain", case=f"{path} BG{bg} Zc={zc}", mode="wire",
             early_stop=early_stop, exit_group=group, codeblocks=full.shape[0],
             equal=same, ok=int(k[1].sum()), mean_sweeps=float(k[2].float().mean()))
    g = get_graph(bg, zc)
    sweeps, executed = k1_executed(dec, full, bg, zc)
    ms = cuda_ms(lambda: dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True,
                                            early_stop=True), 20)
    ms_cb = cuda_ms(lambda: dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True,
                                               early_stop=True, exit_group=1), 20)
    fixed = {n: cuda_ms(lambda n=n: dec.decode_layered(full, bg, zc, n, wire=True,
                                                       early_stop=False), 10)
             for n in (0, 1, NUM_ITERS)}
    plain_ms = cuda_ms(lambda: dec.decode_layered_plain(
        full, bg, zc, NUM_ITERS, wire=True, early_stop=True), 3, warmup=1)
    total_sweeps = int(sweeps.sum())
    n_bytes = full.numel() + full.shape[0] * (g.kb * zc + 1 + 4)
    bound_ms, bound_by = kernel_bound(g, zc, total_sweeps, n_bytes)
    emit("kernel_time", kernel=dec.KERNEL, path=path, bg=bg, zc=zc,
         codeblocks=full.shape[0], blocks_per_sm=dec.blocks_per_sm(dec.MODE_WIRE, bg, zc),
         sweeps_total=total_sweeps, executed_sweeps=executed,
         mean_sweeps=total_sweeps / full.shape[0],
         wire_batch_exit_ms=ms, device_ms_by_kernel=k1_split(dec, full, bg, zc),
         wire_early_stop_ms=ms_cb, wire_fixed_0_ms=fixed[0],
         wire_fixed_1_ms=fixed[1], wire_fixed_6_ms=fixed[NUM_ITERS],
         plain_wire_batch_exit_ms=plain_ms, bytes=n_bytes, bound_ms=bound_ms,
         bound_by=bound_by)
    return dict(launches=ctx["launches"].get(dec.KERNEL, 0),
                resume_launches=ctx["launches"].get(dec.KERNEL_RESUME, 0),
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, sweeps=total_sweeps, executed_sweeps=executed)


def phase_bench_modes(pb, cuda_build, dec):
    """The bench modes no other phase times (BENCH_MODES), each through
    bench.main in this process at bench.py's defaults (S = 256, 30 steps):
    bench.py's asserts on the setup step, its JSON line, K1 launched once
    per step (counts read around each run)."""
    import contextlib
    import io
    import torch
    launches = {}
    for argv in BENCH_MODES:
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = pb.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(cuda_build.LAUNCHES)
        check(rc == 0, f"bench {argv}: rc {rc}")
        line = json.loads(out.getvalue())
        check(line["metric"] == pb.parse(argv).metric and line["value"] > 0,
              f"bench {argv}: {line}")
        check(counts.get(dec.KERNEL, 0) == pb.ITERS + 1,
              f"bench {argv}: {counts} (one K1 launch per step expected)")
        emit("bench_line", argv=" ".join(argv), line=line, desc=err.getvalue().strip(),
             seconds=seconds, launches=counts)
        launches["bench " + " ".join(argv)] = counts.get(dec.KERNEL, 0)
    return launches


def phase_streaming(sp, pb, cuda_build, dec, dev):
    """bench.py --streaming=S at STREAM_SLOTS (bench_streaming: the full
    gNB slot at FullCellConfig(), S slots per batch, STREAM_DEPTH deep,
    STREAM_BATCHES batches, the HARQ carry chained): sustained x real time,
    p50 / p99 batch latency from submit to the batch's CUDA event, the
    program's compute ms per batch (30 deep-chained steps) and the submit
    -> result overhead, the synchronising calls of one warm step
    (pb.host_syncs; every one must be in HOST_SYNCS_KNOWN), the device's
    idle share over a profiled window of STREAM_PROFILE_BATCHES batches
    against the run's wall time per batch, and bench.py's line.  K1's
    launches are read around each run (setup, batches and compute steps,
    one each); the S = STREAM_SLOTS[0] step's decoder input is returned for
    K1 against its plain version."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from srsran_edgeric_5g_tpu_torch.ops import ofdm
    from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
    launches, resumes, ctx = 0, 0, None
    for s in STREAM_SLOTS:
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        run = pb.stream(s, SNR_DB, depth=pb.STREAM_DEPTH, n_batches=pb.STREAM_BATCHES,
                        device=dev)
        torch.cuda.synchronize()
        counts = dict(cuda_build.LAUNCHES)
        steps = 1 + pb.STREAM_BATCHES + pb.STREAM_COMPUTE_STEPS
        check(counts.get(dec.KERNEL, 0) == steps,
              f"streaming S={s}: {counts} (one K1 launch per step, {steps} steps)")
        launches += counts.get(dec.KERNEL, 0)
        resumes += counts.get(dec.KERNEL_RESUME, 0)
        chain = run.chain
        check(bool(chain.res["tb_ok"].all())
              and torch.equal(chain.res["payload"], chain.x["pay_u"]),
              f"streaming S={s}: PUSCH not recovered")
        syncs = pb.host_syncs(chain)
        unknown = [w for w in syncs if w.split(" ")[0] not in HOST_SYNCS_KNOWN]
        check(not unknown, f"streaming S={s}: host syncs outside ROADMAP.md "
                           f"Queue C: {unknown}")
        wall_ms = run.wall_s / run.n_batches * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pb.stream_batches(chain, STREAM_PROFILE_BATCHES, run.depth, dev)
            torch.cuda.synchronize()
        prof_sum = profile_summary(prof, STREAM_PROFILE_BATCHES, wall_ms)
        p50, p99 = run.percentile(50), run.percentile(99)
        emit("streaming", slots_per_batch=s, depth=run.depth, batches=run.n_batches,
             seconds=run.wall_s, ms_per_slot=run.slot_s * 1e3,
             x_real_time=run.x_real_time, latency_p50_ms=p50, latency_p99_ms=p99,
             latency_mean_ms=float(run.latency_ms.mean()),
             latency_max_ms=float(run.latency_ms.max()),
             compute_ms_per_batch=run.compute_ms, overhead_ms=p50 - run.compute_ms,
             run_ahead_budget_ms=p99 + s, host_syncs_per_step=len(syncs),
             host_syncs=syncs, launches=counts,
             device_busy_ms_per_batch=prof_sum["device_busy_ms_per_step"],
             idle_share=prof_sum["idle_share"],
             device_ops_per_batch=prof_sum["device_ops_per_step"])
        emit("bench_line", argv=f"--streaming={s}",
             line=pb.result_line("streaming_full_gnb_slot_samples_per_sec",
                                 run.slot_s, chain.fc.timing), desc=run.desc())
        if ctx is None:
            fc, x = chain.fc, chain.x
            cell_u, seg = x["cell_u"], x["seg"]
            rx = pb._noisy(x["ul"], x["noise"], chain.flip)
            grid = ofdm.demodulate_slot(rx, fc.timing, scale=1.0)
            llr = sp._ul_front(None, fcm._rntis(fc, dev), cell_u,
                               rx_grid=grid)[0].reshape(s * fc.nof_ue, -1)
            ctx = dict(decoder_input=sp._decoder_input(llr, cell_u), bg=seg.bg,
                       zc=seg.zc, launches=counts)
        del run, chain
    ctx["launches"] = {dec.KERNEL: launches, dec.KERNEL_RESUME: resumes}
    return ctx


def phase_entry(pe, cuda_build, dec, dev):
    """entry() (the UL slot step of __graft_entry__.entry(), 52 PRB, nfft
    768, 4 UEs x 12 PRB, 16QAM r0.4, one slot of noise) on the card against
    entry("cpu"): payload bits and tb_ok exact, noise variance and CFO
    within ENTRY_RTOL of the peak; K1's launches read around it."""
    import torch
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    fn, args = pe.entry(dev)
    got = fn(*args)
    torch.cuda.synchronize()
    counts = dict(cuda_build.LAUNCHES)
    got = [v.cpu() for v in got]
    fn_c, args_c = pe.entry("cpu")
    want = fn_c(*args_c)
    check(counts.get(dec.KERNEL, 0) == 1, f"entry: {counts} (one K1 launch expected)")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "entry: payload bits or tb_ok differ between the card and the CPU")
    rel = {}
    for i, name in ((2, "noise_var"), (3, "cfo")):
        rel[name] = float((got[i] - want[i]).abs().max() / want[i].abs().max())
        check(rel[name] <= ENTRY_RTOL, f"entry {name}: {rel[name]} of the peak")
    emit("entry", shapes=[list(v.shape) for v in got], tb_ok=got[1].tolist(),
         rel_err=rel, carry_entries_differing=int((got[4] != want[4]).sum()),
         carry_entries=got[4].numel(), launches=counts)
    return counts.get(dec.KERNEL, 0)


def tools_shape_llrs(encoder, dev, snr_db, gen):
    """tools/tpu_pallas_earlystop.py's input: BG1 Zc=384, B=128, BPSK
    codewords, LLRs clipped to ±120, the 2*Zc punctured columns zero."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    bg, zc, b = 1, 384, 128
    g = get_graph(bg, zc)
    msgs = torch.randint(0, 2, (b, g.k), generator=gen, device=dev, dtype=torch.int8)
    sym = 1 - 2 * encoder.encode(msgs, bg, zc).float()
    sigma = 10 ** (-snr_db / 20)
    y = sym + sigma * torch.randn(sym.shape, generator=gen, device=dev)
    llr = 20 * torch.clamp(2 * y / max(sigma, 1e-3) ** 2 / 20, -6.0, 6.0)
    llr[:, :2 * zc] = 0
    return llr.contiguous()


def phase_kernel_int8(dec, encoder, cuda_build, dev, full):
    """K2 == plain on the card; K2's own path, its times and bound."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = [(f"BG1 Zc=384 B=128 {snr} dB", 1, 384,
              tools_shape_llrs(encoder, dev, snr, gen)) for snr in (100.0, 6.5)]
    cases.append((f"full cell decoder input {tuple(full.shape)}", 1, 224, full))
    max_err = 0
    for name, bg, zc, x in cases:
        for early_stop in (False, True):
            for b_tile in (1, 32):
                k = dec.decode_int8(x, bg, zc, NUM_ITERS, b_tile, early_stop,
                                    with_sweeps=True)
                p = dec.decode_int8_plain(x, bg, zc, NUM_ITERS, b_tile, early_stop,
                                          with_sweeps=True)
                err = int((k[0].int() - p[0].int()).abs().max())
                max_err = max(max_err, err)
                same = all(torch.equal(a, b) for a, b in zip(k, p))
                check(same, f"K2 {name} early_stop={early_stop} b_tile={b_tile}: "
                            f"kernel != plain (max |hard diff| {err})")
                emit("kernel_int8_vs_plain", case=name, early_stop=early_stop,
                     b_tile=b_tile, codeblocks=x.shape[0], equal=same,
                     ok=int(k[1].sum()), mean_sweeps=float(k[2].float().mean()))

    # K2's path: decode_int8 with its defaults (6 sweeps, b_tile 32, no early
    # stop), as decode_pallas_int8's callers call it, on the full cell's
    # decoder input; the counts are reset just before and read just after.
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    hard, ok, sweeps = dec.decode_int8(full, 1, 224, with_sweeps=True)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    check(launches.get(dec.KERNEL_INT8, 0) > 0, "K2's path launched no kernel")
    g = get_graph(1, 224)
    ms = cuda_ms(lambda: dec.decode_int8(full, 1, 224), 10)
    ms_es_tile32 = cuda_ms(lambda: dec.decode_int8(full, 1, 224, early_stop=True), 10)
    ms_es_tile1 = cuda_ms(lambda: dec.decode_int8(full, 1, 224, b_tile=1,
                                                  early_stop=True), 10)
    plain_ms = cuda_ms(lambda: dec.decode_int8_plain(full, 1, 224), 3, warmup=1)
    n_bytes = full.numel() + full.shape[0] * (g.kb * 224 + 1)
    total_sweeps = int(sweeps.sum())
    bound_ms, bound_by = kernel_bound(g, 224, total_sweeps, n_bytes)
    emit("kernel_int8_time", kernel=dec.KERNEL_INT8, codeblocks=full.shape[0],
         launches=launches, sweeps_total=total_sweeps, ok=int(ok.sum()),
         default_fixed_6_ms=ms, early_stop_tile32_ms=ms_es_tile32,
         early_stop_tile1_ms=ms_es_tile1, plain_default_ms=plain_ms,
         bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by)
    return dict(max_err=max_err, launches=launches.get(dec.KERNEL_INT8, 0), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def hetero_grants(pdsch, tbs):
    """The 4-UE grant set of the MAC scheduler at 20 MHz: spans on the 8-PRB
    RBG grid of a 106-PRB BWP, rates from TS 38.214 Table 5.1.3.1-1."""
    def grant(rnti, start, n, mcs, **kw):
        m = tbs.mcs_config(mcs, "qam64")
        return pdsch.PdschConfig(rnti=rnti, start_prb=start, nof_prb=n,
                                 modulation=m.modulation,
                                 target_rate=m.target_rate, **kw)
    return [grant(0x4601, 0, 4, 2, transform_precoding=True),
            grant(0x4602, 4, 24, 13),
            grant(0x4603, 28, 32, 20),
            grant(0x4604, 60, 46, 28, dmrs_symbols=(2,))]


def grid_noise(grid, snr_db, gen):
    """Complex AWGN on a resource grid at ``snr_db`` below unit symbol energy."""
    import torch
    sigma = math.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    return torch.complex(torch.randn(grid.shape, generator=gen, device=grid.device),
                         torch.randn(grid.shape, generator=gen, device=grid.device)) * sigma


def pusch_stages(pusch, pdsch, rx_grid, cfg, t, times):
    """pusch.process (no UCI) stage by stage on one received grid: ({stage:
    thunk}, the (C, cols*Zc) float32 decoder input)."""
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder, segmenter
    seg, rms = pdsch._plans(cfg, 0)
    h, nv, cfo = pusch.channel_estimate(rx_grid, cfg, t.srate, times)
    x_hat, nv_out = pusch.equalize(rx_grid, cfg, h, nv, cfo, times)
    llr = pusch.demap(x_hat, nv_out, cfg)
    full = pusch.dematch(llr, seg, rms)
    hard, _ = decoder.decode(full, seg.bg, seg.zc, NUM_ITERS, schedule="wire_auto")
    return {
        "estimate": lambda: pusch.channel_estimate(rx_grid, cfg, t.srate, times),
        "equalise": lambda: pusch.equalize(rx_grid, cfg, h, nv, cfo, times),
        "demap_quantise_descramble": lambda: pusch.demap(x_hat, nv_out, cfg),
        "dematch": lambda: pusch.dematch(llr, seg, rms),
        "decode": lambda: decoder.decode(full, seg.bg, seg.zc, NUM_ITERS,
                                         schedule="wire_auto"),
        "desegment": lambda: segmenter.desegment_tb(hard, seg),
        "process": lambda: pusch.process(rx_grid, cfg, t.srate, times),
    }, full


def phase_hetero_cell(cuda_build, dec, dev):
    """HeteroCellProcessor at 20 MHz with the 4-UE grant set: HC_SLOTS slots
    of DL TX -> UE RX and UE TX -> gNB RX at 25 dB, every TB exact, 8 K1
    launches per slot; per-call ms per slot, a per-UE pusch.process
    breakdown, the device profile of chained slots."""
    import torch
    from srsran_edgeric_5g_tpu_torch.models import hetero_cell, pdsch, pusch
    from srsran_edgeric_5g_tpu_torch.ops import ofdm
    from srsran_edgeric_5g_tpu_torch.ran import numerology, tbs
    t = numerology.slot_timing(**numerology.CELL_20MHZ)
    cfgs = hetero_grants(pdsch, tbs)
    proc = hetero_cell.HeteroCellProcessor(t, cfgs, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def payloads():
        return [torch.randint(0, 2, (1, n), generator=gen, device=dev,
                              dtype=torch.int8) for n in proc.tbs]

    def slot(pay, timed=None):
        """One slot both ways; with ``timed``, each call's host-clock ms
        between two synchronisations is appended to timed[call]."""
        out = {}
        for name, fn, src in (("dl_tx", proc.process_dl_slot, None),
                              ("dl_rx", proc.process_dl_rx_slot, "dl_tx"),
                              ("ul_tx", proc.process_ul_tx_slot, None),
                              ("ul_rx", proc.process_ul_slot, "ul_tx")):
            x = pay if src is None else out[src] + awgn(out[src], SNR_DB, gen)
            if timed is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out[name] = fn(x)
            if timed is not None:
                torch.cuda.synchronize()
                timed[name].append((time.perf_counter() - t0) * 1e3)
        return out

    slot(payloads())                      # plans, caches, the kernel's tables
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    timed = {k: [] for k in ("dl_tx", "dl_rx", "ul_tx", "ul_rx")}
    results = []
    for _ in range(HC_SLOTS):
        pay = payloads()
        out = slot(pay, timed)
        results.append((pay, out["dl_rx"], out["ul_rx"]))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    for i, (pay, dl, ul) in enumerate(results):
        for d, outs in (("DL", dl), ("UL", ul)):
            for u, (p, ok, nv, cfo) in enumerate(outs):
                check(bool(ok.all()), f"hetero_cell slot {i} {d} UE {u}: CRC failed")
                check(torch.equal(p, pay[u]), f"hetero_cell slot {i} {d} UE {u}: payload")
                check(bool(torch.isfinite(nv) & torch.isfinite(cfo)),
                      f"hetero_cell slot {i} {d} UE {u}: nv / cfo not finite")
    k1 = launches.get(dec.KERNEL, 0)
    check(k1 == 8 * HC_SLOTS, f"hetero_cell: {k1} K1 launches in {HC_SLOTS} slots, "
                              f"want 8 per slot")
    ms = {k: sum(v) / len(v) for k, v in timed.items()}
    segs = [pdsch._plans(c, 0)[0] for c in cfgs]
    emit("hetero_cell", cell="106PRB nfft1536 4UE grant set", slots=HC_SLOTS,
         snr_db=SNR_DB, tbs=proc.tbs, codeblocks=[s.c for s in segs],
         bg=[s.bg for s in segs], zc=[s.zc for s in segs],
         e=[list(s.e) for s in segs], launches=launches, ms_per_slot=ms,
         ms_per_slot_max={k: max(v) for k, v in timed.items()},
         gnb_pair_ms=ms["dl_tx"] + ms["ul_rx"],
         x_real_time_gnb_pair=1.0 / (ms["dl_tx"] + ms["ul_rx"]))

    # Per-UE breakdown of pusch.process on one slot's received grid, and
    # each UE's decoder input for the kernel phase (wire mode takes int8
    # after the ±64 load clamp, as decode("wire_auto") converts it).
    td = proc.process_ul_tx_slot(payloads())
    rx_grid = ofdm.demodulate_slot(td + awgn(td, SNR_DB, gen), t, scale=1.0)
    breakdown, inputs = [], []
    for u, cfg in enumerate(cfgs):
        stages, full = pusch_stages(pusch, pdsch, rx_grid, cfg, t, proc.times)
        breakdown.append({k: cuda_ms(f, 10) for k, f in stages.items()})
        inputs.append((f"hetero_cell UE {u}", segs[u].bg, segs[u].zc, True,
                       torch.clamp(full, -64, 64).to(torch.int8).contiguous()))
    emit("hetero_cell_pusch_breakdown_ms", per_ue=breakdown)

    # Chained slots (no host synchronisation inside): wall time per slot and
    # the device's busy time and idle share over them.
    pays = [payloads() for _ in range(2 * HC_PROFILE_SLOTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pay in pays[:HC_PROFILE_SLOTS]:
        slot(pay)
    torch.cuda.synchronize()
    chained_ms = (time.perf_counter() - t0) * 1e3 / HC_PROFILE_SLOTS
    rest = iter(pays[HC_PROFILE_SLOTS:])
    emit("hetero_cell_device_profile", chained_ms_per_slot=chained_ms,
         **device_profile(lambda: slot(next(rest)), HC_PROFILE_SLOTS, chained_ms))
    return dict(launches=k1, inputs=inputs)


def phase_hetero_harq(dev):
    """tests/test_harq_retx.py's combined decode at 20 MHz, UL and DL: rv 0
    fails, rv 2 from a zero buffer fails, the combined decode is exact."""
    import torch
    from srsran_edgeric_5g_tpu_torch.models import hetero_cell, pdsch
    from srsran_edgeric_5g_tpu_torch.ran import numerology
    t = numerology.slot_timing(**numerology.CELL_20MHZ)
    cfg = pdsch.PdschConfig(rnti=0x4601, start_prb=0, nof_prb=12,
                            modulation="qam64", target_rate=0.8)
    proc = hetero_cell.HeteroCellProcessor(t, [cfg], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    pay = [torch.randint(0, 2, (1, proc.tbs[0]), generator=gen, device=dev,
                         dtype=torch.int8)]
    zeros = [torch.zeros(proc.soft_buffer_shape(0), device=dev)]
    res = {}
    for d, tx, rx in (("ul", proc.process_ul_tx_rv_slot, proc.process_ul_harq_slot),
                      ("dl", proc.process_dl_rv_slot, proc.process_dl_rx_harq_slot)):
        td1 = tx(pay, (0,))
        _, ok1, _, _, soft1 = rx(td1 + awgn(td1, HARQ_SNR_DB, gen), zeros, (0,))[0]
        td2 = tx(pay, (2,))
        rx2 = td2 + awgn(td2, HARQ_SNR_DB, gen)
        _, ok_fresh, *_ = rx(rx2, zeros, (2,))[0]
        hat, ok_comb, _, _, soft2 = rx(rx2, [soft1], (2,))[0]
        check(not bool(ok1.any()), f"hetero_harq {d}: rv 0 alone decoded")
        check(not bool(ok_fresh.any()), f"hetero_harq {d}: rv 2 alone decoded")
        check(bool(ok_comb.all()) and torch.equal(hat, pay[0]),
              f"hetero_harq {d}: the combined decode is not exact")
        res[d] = dict(soft_abs_mean_rv0=float(soft1.abs().mean()),
                      soft_abs_mean_combined=float(soft2.abs().mean()))
    emit("hetero_harq", cell="106PRB nfft1536 12PRB qam64 r0.8", snr_db=HARQ_SNR_DB,
         tbs=proc.tbs[0], soft_buffer_shape=list(proc.soft_buffer_shape(0)), **res)


def phase_pusch_uci(dev):
    """UE 1 of the grant set alone with each UCI configuration at 25 dB on
    the grid: ACK, CSI and payload exact; pusch.process's time and each UCI
    decode's alone (decode_scl for the polar ones)."""
    import torch
    from srsran_edgeric_5g_tpu_torch.models import pdsch, pusch
    from srsran_edgeric_5g_tpu_torch.ops import uci as uci_ops
    from srsran_edgeric_5g_tpu_torch.ops import ulsch_demux
    from srsran_edgeric_5g_tpu_torch.ran import numerology, tbs
    t = numerology.slot_timing(**numerology.CELL_20MHZ)
    times = [x / t.srate for x in t.cp.data_starts]
    cfg = hetero_grants(pdsch, tbs)[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def bits(n):
        return torch.randint(0, 2, (1, n), generator=gen, device=dev, dtype=torch.int8)

    out = []
    for ucfg in UCI_CONFIGS:
        u = pusch.UciConfig(**ucfg)
        pay, ack, c1 = bits(cfg.derived_tbs()), bits(u.n_ack), bits(u.n_csi1)
        c2 = bits(u.n_csi2) if u.n_csi2 else None
        grid = pusch.transmit(pay, cfg, t.nsymb, t.nof_subc, uci=u, ack_bits=ack,
                              csi1_bits=c1, csi2_bits=c2)
        rx = grid + grid_noise(grid, SNR_DB, gen)
        r = pusch.process(rx, cfg, t.srate, times, uci=u)
        check(bool(r.tb_crc_ok.all()) and torch.equal(r.payload, pay),
              f"UCI {ucfg}: payload")
        check(torch.equal(r.ack_bits, ack), f"UCI {ucfg}: ACK")
        check(torch.equal(r.csi1_bits, c1), f"UCI {ucfg}: CSI part 1")
        check(c2 is None or torch.equal(r.csi2_bits, c2), f"UCI {ucfg}: CSI part 2")
        h, nv, cfo = pusch.channel_estimate(rx, cfg, t.srate, times)
        llr = pusch.demap(*pusch.equalize(rx, cfg, h, nv, cfo, times), cfg)
        _, ack_l, c1_l, c2_l = ulsch_demux.demultiplex(llr, pusch._uci_plan(cfg, u))
        decode_ms = {
            f"{name}_k{n}_e{g}": cuda_ms(lambda l=l, n=n, g=g: uci_ops.decode(l, n, g),
                                         3, warmup=1)
            for name, l, n, g in (("ack", ack_l, u.n_ack, u.g_ack),
                                  ("csi1", c1_l, u.n_csi1, u.g_csi1),
                                  ("csi2", c2_l, u.n_csi2, u.g_csi2)) if n}
        out.append(dict(uci=ucfg, process_ms=cuda_ms(
            lambda: pusch.process(rx, cfg, t.srate, times, uci=u), 3, warmup=1),
            uci_decode_ms=decode_ms))
    emit("pusch_uci", cell="106PRB UE 1 (PRB 4-27, 16QAM r0.479)", snr_db=SNR_DB,
         tbs=cfg.derived_tbs(), configs=out)


def mimo_channels(n_l):
    """tests/test_mimo.py's mixing channels: the 2x2 of
    test_2x2_mixing_channel and the 4x4 of test_4x4_mixing_channel."""
    import numpy as np
    if n_l == 2:
        return np.array([[1.0 + 0.2j, 0.45 - 0.3j],
                         [-0.35 + 0.4j, 0.9 - 0.1j]], dtype=np.complex64)
    return (np.eye(4) + 0.3 * np.exp(1j * 0.7) * np.eye(4, k=1)
            + 0.25 * np.exp(-1j * 1.1) * np.eye(4, k=-1)
            + 0.15 * np.exp(1j * 2.0) * np.eye(4, k=2)).astype(np.complex64)


def phase_mimo_ue(cuda_build, dec, dev):
    """models/mimo.py: process_mimo -> static LxL channel -> receive_mimo at
    L = 2 (52 PRB, 27 dB) and L = 4 (36 PRB from PRB 52, 30 dB), 64QAM r0.5,
    MIMO_DRAWS draws each; exact payloads, K1's f32 mode launched."""
    import torch
    from srsran_edgeric_5g_tpu_torch.models import mimo, pdsch
    from srsran_edgeric_5g_tpu_torch.ran import numerology
    t = numerology.slot_timing(**numerology.CELL_20MHZ)
    times = [x / t.srate for x in t.cp.data_starts]
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    points = []
    for n_l, nprb, start, snr_db in ((2, 52, 0, 27.0), (4, 36, 52, 30.0)):
        cfg = pdsch.PdschConfig(rnti=0x4605, start_prb=start, nof_prb=nprb,
                                modulation="qam64", target_rate=0.5)
        h = torch.as_tensor(mimo_channels(n_l), device=dev)
        seg, _ = mimo._plans(cfg, 0, n_l)
        draws = []
        for _ in range(MIMO_DRAWS):
            pay = torch.randint(0, 2, (1, mimo.derived_tbs(cfg, n_l)), generator=gen,
                                device=dev, dtype=torch.int8)
            rx = torch.einsum("ap,psk->ask", h, mimo.process_mimo(
                pay, cfg, t.nsymb, t.nof_subc, n_layers=n_l))
            sig = (rx.abs() ** 2).sum() / (rx.abs() > 0).sum()
            rx = rx + torch.complex(
                torch.randn(rx.shape, generator=gen, device=dev),
                torch.randn(rx.shape, generator=gen, device=dev)
            ) * torch.sqrt(sig * 10.0 ** (-snr_db / 10.0) / 2.0)
            draws.append((pay, rx))
        mimo.receive_mimo(draws[0][1], cfg, t.srate, times, n_layers=n_l)   # warm
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        res = [mimo.receive_mimo(rx, cfg, t.srate, times, n_layers=n_l)
               for _, rx in draws]
        torch.cuda.synchronize()
        rx_ms = (time.perf_counter() - t0) * 1e3 / MIMO_DRAWS
        launches = dict(cuda_build.LAUNCHES)
        for i, ((pay, _), r) in enumerate(zip(draws, res)):
            check(bool(r.tb_crc_ok.all()) and torch.equal(r.payload, pay),
                  f"mimo_ue L={n_l} draw {i}: payload")
        check(launches.get(dec.KERNEL, 0) == MIMO_DRAWS,
              f"mimo_ue L={n_l}: {launches} (want one K1 launch per TB)")
        full, _, _ = mimo.decoder_input(draws[0][1], cfg, times, n_layers=n_l)
        points.append(dict(
            n_layers=n_l, nof_prb=nprb, start_prb=start, snr_db=snr_db,
            tbs=mimo.derived_tbs(cfg, n_l), codeblocks=seg.c, bg=seg.bg, zc=seg.zc,
            e=list(seg.e), launches=launches, receive_ms_per_tb=rx_ms,
            process_ms=cuda_ms(lambda: mimo.process_mimo(
                draws[0][0], cfg, t.nsymb, t.nof_subc, n_layers=n_l), 5),
            input=(f"mimo_ue L={n_l}", seg.bg, seg.zc, False, full.contiguous())))
    emit("mimo_ue", cell="106PRB nfft1536 qam64 r0.5", draws=MIMO_DRAWS,
         points=[{k: v for k, v in p.items() if k != "input"} for p in points])
    return dict(launches=sum(p["launches"].get(dec.KERNEL, 0) for p in points),
                inputs=[p["input"] for p in points])


def phase_per_ue_kernel(dec, path, inputs, launches):
    """K1 on each per-UE decoder input (wire mode: the heterogeneous cell's
    UEs; f32 mode with the l <= 0 rule: the MIMO receiver's, and a synthetic
    BG2 Zc = 40 batch): equal hard bits, ok and sweeps to the plain version
    at early stop and fixed sweeps; K1's time per launch at each shape, the
    plain version's, the bound.  The path's figures are sums over its
    shapes (one launch each)."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    rows, max_err = [], 0
    for name, bg, zc, wire, x in inputs:
        strict = None if wire else False
        for early_stop, group in EXITS:
            k = dec.decode_layered(x, bg, zc, NUM_ITERS, wire=wire,
                                   early_stop=early_stop, strict=strict, exit_group=group)
            p = dec.decode_layered_plain(x, bg, zc, NUM_ITERS, wire=wire,
                                         early_stop=early_stop, strict=strict,
                                         exit_group=group)
            err = int((k[0].int() - p[0].int()).abs().max())
            max_err = max(max_err, err)
            same = all(torch.equal(a, b) for a, b in zip(k, p))
            check(same, f"{name} BG{bg} Zc={zc} early_stop={early_stop} group={group}: "
                        f"kernel != plain (max |hard diff| {err})")
            emit("kernel_vs_plain", case=f"{name} BG{bg} Zc={zc}",
                 mode="wire" if wire else "f32 l<=0", early_stop=early_stop,
                 exit_group=group, codeblocks=x.shape[0], equal=same,
                 ok=int(k[1].sum()), mean_sweeps=float(k[2].float().mean()))
        g = get_graph(bg, zc)
        _, _, sweeps = dec.decode_layered(x, bg, zc, NUM_ITERS, wire=wire,
                                          early_stop=True, strict=strict)

        def run(fn=dec.decode_layered, x=x, bg=bg, zc=zc, wire=wire, strict=strict):
            return fn(x, bg, zc, NUM_ITERS, wire=wire, early_stop=True, strict=strict)

        n_bytes = x.numel() * x.element_size() + x.shape[0] * (g.kb * zc + 1 + 4)
        bound_ms, bound_by = kernel_bound(g, zc, int(sweeps.sum()), n_bytes)
        rows.append(dict(case=name, bg=bg, zc=zc, mode="wire" if wire else "f32 l<=0",
                         codeblocks=x.shape[0], sweeps_total=int(sweeps.sum()),
                         ms=cuda_ms(run, 50),
                         plain_ms=cuda_ms(lambda: run(dec.decode_layered_plain), 3,
                                          warmup=1),
                         bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by))
    emit("kernel_time_per_ue", kernel=dec.KERNEL, path=path, shapes=rows)
    ms, plain, bound = (sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms"))
    return dict(launches=launches, max_abs_err=max_err, ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by="operations" if all(
                    r["bound_by"] == "operations" for r in rows) else "bytes",
                shapes=[{k: r[k] for k in ("case", "zc", "ms", "plain_ms", "bound_ms")}
                        for r in rows])


def cell_processor_loop(cuda_build, dec, dev, phy_kw, slots, tag):
    """The loopback app's pipelined slot loop (run_slot_loop, run-ahead 2)
    over a CellProcessor at PhyConfig(**phy_kw), an in-process AWGN radio at
    SNR_DB and payloads from a seeded generator: every TB exact, one K1
    launch per UL slot, the metrics hub holding every slot with positive
    throughput.  Returns (processor, loop result, K1 launches, the radio,
    the payload source)."""
    import torch
    from srsran_edgeric_5g_tpu_torch import config, loopback_app
    from srsran_edgeric_5g_tpu_torch.models.cell_processor import CellProcessor
    from srsran_edgeric_5g_tpu_torch.runtime.events import RadioEventNotifier
    cfg = config.PhyConfig(**phy_kw)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    shape = (cfg.nof_ue, cfg.cell_config().derived_tbs())

    def payloads(slot):
        return torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.int8)

    def radio(slot, td):
        return td + awgn(td, SNR_DB, gen)

    # Plans, constant tensors and the kernel's tables, on a processor of its
    # own (the caches are per cell and device).
    loopback_app.run_slot_loop(CellProcessor(cfg.cell_config(), pci=cfg.pci,
                                             device=dev),
                               radio, 3, payloads, log=lambda s: None)
    proc = CellProcessor(cfg.cell_config(), pci=cfg.pci, device=dev)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    logged = []

    def log(s):
        print(f"{tag}: {s}", flush=True)
        logged.append(s)

    notifier = RadioEventNotifier(log=log)
    res = loopback_app.run_slot_loop(proc, radio, slots, payloads, run_ahead=2,
                                     notifier=notifier, log=log)
    torch.cuda.synchronize()
    k1 = cuda_build.LAUNCHES.get(dec.KERNEL, 0)
    ev = notifier.events
    check(ev.errors == 0, f"{tag}: {ev.errors} UL slots raised; the loop logged {logged}")
    check(res.exact_count == res.ok_count == res.nof_tbs == slots * cfg.nof_ue,
          f"{tag}: {res.exact_count} exact, {res.ok_count} CRC ok of {res.nof_tbs}")
    check(k1 == slots, f"{tag}: {k1} K1 launches in {slots} UL slots, want one each")
    hist = list(proc.metrics.history)
    check(len(hist) == slots and all(
        all(u.tb_crc_ok and u.dl_bytes > 0 for u in m.ues) for m in hist),
        f"{tag}: metrics hub holds {len(hist)} slots, or a slot without throughput")
    tp = proc.metrics.throughput_mbps()
    check(len(tp) == cfg.nof_ue and all(v > 0 for v in tp.values()),
          f"{tag}: throughput {tp}")
    return proc, res, k1, radio, payloads, tp


def phase_cell_processor(cuda_build, dec, dev):
    """CellProcessor through the app's slot loop at 20 MHz 4-UE 64QAM (64
    slots) and at the app's default PhyConfig() (16 slots): every TB exact,
    one K1 launch per UL slot; ms per slot of each call (CUDA events), the
    loop's wall ms per slot and x real time, the device profile of the loop
    slot; K1's input on this path for the kernel phase."""
    import numpy as np
    import torch
    from srsran_edgeric_5g_tpu_torch.models.cell_processor import CellProcessor
    from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp
    out = {}
    for tag, phy_kw, slots in (
            ("cell_processor", CELL_PHY, CP_SLOTS),
            ("cell_processor_default", {}, CP_DEFAULT_SLOTS)):
        proc, res, k1, radio, payloads, tp = cell_processor_loop(
            cuda_build, dec, dev, phy_kw, slots, tag)
        cell = proc.cell
        t = cell.timing
        # Each call alone (CUDA events over 20 calls), on a processor of its
        # own so the loop's metrics stay as they were.
        tproc = CellProcessor(cell, pci=proc.pci, device=dev)
        pay = payloads(0)
        td = tproc.process_dl_slot(pay)
        rx = radio(0, td)
        dl_ms = cuda_ms(lambda: tproc.process_dl_slot(pay), 20)
        ul_ms = cuda_ms(lambda: tproc.process_ul_slot(rx), 20)

        def slot():
            tproc.process_ul_slot(radio(0, tproc.process_dl_slot(pay)))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CP_PROFILE_SLOTS):
            slot()
        torch.cuda.synchronize()
        serial_ms = (time.perf_counter() - t0) * 1e3 / CP_PROFILE_SLOTS
        loop_ms = res.seconds * 1e3 / slots
        seg, rm = sp._plans(cell)
        emit(tag, cell=f"{cell.nof_prb}PRB nfft{cell.nfft} {cell.nof_ue}UEx"
                       f"{cell.prb_per_ue}PRB {cell.modulation} r{cell.target_rate}",
             slots=slots, snr_db=SNR_DB, tbs=proc.tbs, codeblocks=seg.c, bg=seg.bg,
             zc=seg.zc, e=rm.e, tb_exact=res.exact_count, tbs_total=res.nof_tbs,
             k1_launches=k1, dl_ms_per_slot=dl_ms, ul_ms_per_slot=ul_ms,
             loop_wall_ms_per_slot=loop_ms,
             x_real_time_loop=(1.0 / (1 << cell.mu)) / loop_ms,
             latency_ms_p50=float(np.percentile(res.latency_ms, 50)),
             latency_ms_p99=float(np.percentile(res.latency_ms, 99)),
             throughput_mbps={hex(k): v for k, v in tp.items()},
             serial_slot_wall_ms=serial_ms)
        emit(f"{tag}_device_profile",
             **device_profile(slot, CP_PROFILE_SLOTS, serial_ms))
        if tag == "cell_processor":
            # The UL slot's decoder input (its int8 HARQ carry layout), for K1
            # against its plain version on this path.
            llr, _, _ = sp._ul_front(rx[None], tproc.rntis, cell)
            full = sp._decoder_input(llr.reshape(cell.nof_ue, -1), cell)
            out = dict(launches=k1, inputs=[(tag, seg.bg, seg.zc, True,
                                             full.contiguous())])
    return out


def phase_cell_harq(dev):
    """tests/test_cell_processor.py's HARQ scenario at 20 MHz: 2 UEs x 12 PRB
    16QAM r0.6, rv 0 and rv 2 at the two CELL_HARQ_SNR_DB points; rv 0 fails
    for a UE, rv 2 alone fails, the rv 2 retransmission on the same pid
    combines with the pool's buffers and decodes every TB exactly; the
    processes are reset."""
    import torch
    from srsran_edgeric_5g_tpu_torch.models.cell_processor import CellProcessor
    from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp
    cell = sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=2, prb_per_ue=12,
                         modulation="qam16", target_rate=0.6)
    proc = CellProcessor(cell, pci=5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    pay = torch.randint(0, 2, (2, proc.tbs), generator=gen, device=dev,
                        dtype=torch.int8)
    pid, rntis = 3, proc.rntis.tolist()

    def tx(rv, snr_db):
        td = proc.process_dl_slot(pay, rv=rv)
        return td + awgn(td, snr_db, gen)

    _, ok1 = proc.process_ul_slot(tx(0, CELL_HARQ_SNR_DB[0]), pid=pid, rv=0)
    held = [proc.harq.get(r, pid).soft_buffer for r in rntis]
    check(not bool(ok1.all()), "cell_harq: rv 0 decoded every TB")
    check(all((b is None) == bool(o) for b, o in zip(held, ok1.tolist())),
          "cell_harq: the pool holds a buffer exactly for the failed UEs")
    rx2 = tx(2, CELL_HARQ_SNR_DB[1])
    _, ok_alone = CellProcessor(cell, pci=5, device=dev).process_ul_slot(rx2, pid=pid,
                                                                         rv=2)
    check(not bool(ok_alone.all()), "cell_harq: rv 2 alone decoded every TB")
    hat, ok2 = proc.process_ul_slot(rx2, pid=pid, rv=2)
    check(bool(ok2.all()) and torch.equal(hat, pay),
          "cell_harq: the combined rv 2 decode is not exact")
    check(all(proc.harq.get(r, pid).soft_buffer is None
              and proc.harq.get(r, pid).tx_count == 0 for r in rntis),
          "cell_harq: a decoded UE's process was not reset")
    emit("cell_harq", cell="106PRB nfft1536 2UEx12PRB qam16 r0.6",
         snr_db=CELL_HARQ_SNR_DB, tbs=proc.tbs, rv0_ok=ok1.tolist(),
         rv2_alone_ok=ok_alone.tolist(), combined_ok=ok2.tolist(),
         held_buffer_shapes=[None if b is None else list(b.shape) for b in held],
         held_buffer_dtype=str(next(b for b in held if b is not None).dtype))


def phase_cell_control(dev):
    """One occasion of each control hook of the CellProcessor at 20 MHz:
    SSB (MIB) and PDCCH (DCI) overlaid on the PDSCH with the PDSCH exact,
    and their clean grids decoded (SC polar); PRACH preamble 9 alone on an
    unrestricted and a restricted set; PUCCH F0 m0, F1 bit, F2 bits; SRS |h|
    at the applied gain.  Each hook's ms per call."""
    import torch
    from srsran_edgeric_5g_tpu_torch.models import pdcch, ssb
    from srsran_edgeric_5g_tpu_torch.models.cell_processor import CellProcessor
    from srsran_edgeric_5g_tpu_torch.ops import csi_rs, prach, pucch
    from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp
    # tests/test_cell_processor.py's layout at 20 MHz: the UE span above the
    # SSB's 20 PRB, the PDSCH from symbol 4 (PDCCH on symbol 0, SSB 0-3).
    cell = sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=4, prb_per_ue=20,
                         modulation="qam64", target_rate=0.5, first_prb=24,
                         first_symbol=4, nof_symbols=10, dmrs_symbols=(4, 11))
    proc = CellProcessor(cell, pci=5, ssb_period_slots=1, device=dev)
    t = cell.timing
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.int8)

    def noisy(grid, sigma=0.1):
        return grid + torch.complex(torch.randn(grid.shape, generator=gen, device=dev),
                                    torch.randn(grid.shape, generator=gen, device=dev)) * sigma

    ms = {}
    pay, mib, dci = bits(4, proc.tbs), bits(1, 24), bits(1, 40)
    td = proc.process_dl_slot(pay, mib=mib, dci=dci)
    hat, ok = proc.process_ul_slot(td + awgn(td, SNR_DB, gen))
    check(bool(ok.all()) and torch.equal(hat, pay), "cell_control: PDSCH under SSB + PDCCH")
    ms["dl_slot_ssb_pdcch"] = cuda_ms(lambda: proc.process_dl_slot(pay, mib=mib, dci=dci), 5)
    scfg = ssb.SsbConfig(pci=5)
    g_ssb = ssb.process(mib, scfg, t.nsymb, t.nof_subc)
    mib_hat, mib_ok = ssb.decode(g_ssb, scfg)
    check(bool(mib_ok.all()) and torch.equal(mib_hat, mib), "cell_control: MIB")
    ms["ssb_decode"] = cuda_ms(lambda: ssb.decode(g_ssb, scfg), 3, warmup=1)
    pcfg = pdcch.PdcchConfig(rnti=proc.rntis.tolist()[0], n_id=cell.n_id,
                             aggregation_level=4, cce_index=0, payload_bits=40)
    g_pdcch = pdcch.process(dci, pcfg, t.nsymb, t.nof_subc)
    dci_hat, dci_ok = pdcch.blind_decode(g_pdcch, pcfg)
    check(bool(dci_ok.all()) and torch.equal(dci_hat, dci), "cell_control: DCI")
    ms["pdcch_blind_decode"] = cuda_ms(lambda: pdcch.blind_decode(g_pdcch, pcfg), 3,
                                       warmup=1)

    prach_out = {}
    for name, pc in (("unrestricted", prach.PrachConfig(1, 13)),
                     ("restricted_a", prach.PrachConfig(1, 15, restricted="a"))):
        info = prach.prach_ofdm_info(t.srate, pc.l_ra)
        occ = prach.ofdm_modulate_prach(prach.generate(pc, 9, device=dev), info)
        det = proc.process_prach_occasion(occ, pc)
        found = torch.nonzero(det.detected).flatten().tolist()
        check(found == [9], f"cell_control: PRACH {name} detected {found}")
        ms[f"prach_{name}"] = cuda_ms(lambda: proc.process_prach_occasion(occ, pc), 10)
        prach_out[name] = dict(metric=float(det.metrics[9]), delay=int(det.delays[9]))

    c0 = pucch.Pucch01Config(n_id=5, slot=0, start_symbol=12, nof_symbols=2,
                             initial_cs=0, prb=1)
    grid = torch.zeros((t.nsymb, t.nof_subc), dtype=torch.complex64, device=dev)
    grid[12:14, 12:24] = pucch.format0_generate(c0, m0=6, device=dev)
    rx0 = noisy(grid)
    _, best = proc.process_pucch_f0(rx0, c0, (0, 3, 6, 9))
    check(int(best) == 2, f"cell_control: F0 picked m0 index {int(best)}")
    ms["pucch_f0"] = cuda_ms(lambda: proc.process_pucch_f0(rx0, c0, (0, 3, 6, 9)), 10)
    c1 = pucch.Pucch01Config(n_id=5, slot=0, start_symbol=4, nof_symbols=8,
                             initial_cs=3, prb=2)
    rx1 = noisy(pucch.format1_process([1], c1, t.nsymb, t.nof_subc, occ_index=1,
                                      device=dev))
    b1, _ = proc.process_pucch_f1(rx1, c1, nof_bits=1, occ_index=1)
    check(b1.tolist() == [1], f"cell_control: F1 bit {b1.tolist()}")
    ms["pucch_f1"] = cuda_ms(lambda: proc.process_pucch_f1(rx1, c1, 1, 1), 10)
    u2 = pucch.Pucch2Config(rnti=0x4601, n_id=31, n_id0=7, slot=0, start_symbol=12,
                            nof_symbols=2, start_prb=0, nof_prb=4, uci_bits=5)
    uci = bits(1, 5)
    rx2 = noisy(pucch.format2_process(uci, u2, t.nsymb, t.nof_subc), 0.05)
    uci_hat, uci_ok = proc.process_pucch(rx2, u2)
    check(bool(uci_ok.all()) and torch.equal(uci_hat, uci), "cell_control: F2 bits")
    ms["pucch_f2"] = cuda_ms(lambda: proc.process_pucch(rx2, u2), 10)
    srs = csi_rs.SrsConfig(sequence_id=3, slot=0, symbol=13, start_prb=0,
                           nof_prb=8, comb=2)
    g_srs = csi_rs.map_srs(torch.zeros((t.nsymb, t.nof_subc), dtype=torch.complex64,
                                       device=dev), srs) * 0.8
    h, _ = proc.process_srs(g_srs, srs)
    h_err = float((h.abs() - 0.8).abs().max())
    check(h_err < 1e-5, f"cell_control: SRS |h| off 0.8 by {h_err}")
    ms["srs"] = cuda_ms(lambda: proc.process_srs(g_srs, srs), 10)
    emit("cell_control", cell="106PRB nfft1536 4UEx20PRB from PRB 24 qam64 r0.5",
         snr_db=SNR_DB, prach=prach_out, srs_abs_h_err=h_err, ms_per_call=ms)


class AwgnRadio:
    """The scheduled loop's radio on the card: complex AWGN at the SNR the
    loop asks for, from a seeded generator; keeps the host clock at each
    slot's first transmission and calls ``hook(slot)`` first."""

    def __init__(self, gen, hook=None):
        self.gen, self.hook, self.first_call = gen, hook, {}

    def __call__(self, slot, td, snr_db):
        self.first_call.setdefault(slot, time.perf_counter())
        if self.hook is not None:
            self.hook(slot)
        return td + awgn(td, snr_db, self.gen)


class StandInRic:
    """An in-process EdgeRIC, since the card's machine has neither pyzmq nor
    protobuf: ``runtime.edgeric.EdgericAgent``'s interface to the RAN
    (``send_metrics``, ``get_weights``, ``get_mcs``, ``tti``,
    ``weights_age``) and ``ric.messenger.RicMessenger``'s to the port's
    ``MuAppScheduler`` (``get_metrics``, ``send_scheduling_weight``), so the
    policy functions get the ``ue_data`` dict that RicMessenger.get_metrics
    builds.  What the wire does is kept: the protobuf float fields are
    float32, the decision echoes the ``ran_index`` it was computed from, and
    a policy is read once (a drained, conflating SUB; fail-open after).  The
    muApp answers each TTI's metrics before the next TTI.  Before TTI k of
    ``plan`` the AlgorithmSwitch's key is set to plan[k]."""

    def __init__(self, muapp_cls, switch, plan):
        self.tti = 0
        self.weights_age = None
        self.mcs_age = None
        self._metrics = None
        self._weights = None
        self.switch, self.plan = switch, plan
        self.algorithms = []          # per TTI, the algorithm the muApp ran
        self.muapp = muapp_cls(self, switch=switch)

    # ---- the RAN side (EdgericAgent) ----

    def send_metrics(self, reports) -> None:
        import numpy as np

        def f32(x):
            return float(np.float32(x))
        self._metrics = (self.tti, {
            r.rnti: {"cqi": r.cqi, "snr": f32(r.snr), "tx_bytes": f32(r.tx_bytes),
                     "rx_bytes": f32(r.rx_bytes), "dl_buffer": r.dl_buffer,
                     "ul_buffer": r.ul_buffer, "dl_tbs": f32(r.dl_tbs)}
            for r in reports})
        if self.tti in self.plan:
            self.switch.set(self.plan[self.tti])
        check(self.muapp.step(blocking=False), f"the muApp skipped TTI {self.tti}")
        self.algorithms.append(self.muapp.algorithm)
        self.tti += 1

    def get_weights(self, rntis):
        msg, self._weights = self._weights, None
        if msg is None:
            self.weights_age = None
            return None
        ran_index, vals = msg
        pairs = {int(vals[i]): float(vals[i + 1]) for i in range(0, len(vals) - 1, 2)}
        out = {r: pairs[r] for r in rntis if r in pairs}
        if not out:
            self.weights_age = None
            return None
        total = sum(out.values())
        if total > 0:
            out = {r: v / total for r, v in out.items()}
        self.weights_age = self.tti - ran_index
        return out

    def get_mcs(self, rntis):
        self.mcs_age = None           # the muApp sends no MCS overrides
        return None

    # ---- the muApp side (RicMessenger) ----

    def get_metrics(self, blocking=True, timeout_ms=1000):
        msg, self._metrics = self._metrics, None
        return (None, {}) if msg is None else msg

    def send_scheduling_weight(self, ran_tti, weights) -> None:
        import numpy as np
        flat = []
        for rnti, w in weights.items():
            flat += [float(rnti), float(w)]
        self._weights = (int(ran_tti or 0), np.asarray(flat, np.float32).tolist())


class SchedRecorder:
    """While open, what a scheduled run's layers did, without the loop
    keeping it: each DL slot's scheduler inputs and grants and each
    HARQ-ACK (``CellScheduler.run_slot`` / ``handle_dl_ack`` wrapped), and
    K1's inputs by receive call (``HeteroCellProcessor._rx`` and
    ``decoder.decode`` wrapped).  A receive call's kind is its direction
    ("dl": UE-side PDSCH, "ul": gNB-side PUSCH) and whether it combines
    (HARQ: "retx" when a UE sends rv != 0, else "new"; "single": a control
    PDSCH or Msg3, with its RNTI); the first and the last call of each kind
    are kept, each as (redundancy versions or None, [(llrs, bg, zc) per
    UE])."""

    def __init__(self):
        self.slots, self.acks = [], []
        self.first, self.last = {}, {}

    def __enter__(self):
        from srsran_edgeric_5g_tpu_torch.mac import scheduler as mac
        from srsran_edgeric_5g_tpu_torch.models import hetero_cell, pdsch
        from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder
        cls, hc = mac.CellScheduler, hetero_cell.HeteroCellProcessor
        run_slot, handle_dl_ack, rx, decode = (cls.run_slot, cls.handle_dl_ack, hc._rx,
                                               decoder.decode)
        calls = []

        def rec_run_slot(sched, *a, **k):
            buffers = {r: u.dl_buffer for r, u in sched.ues.items()}
            grants = run_slot(sched, *a, **k)
            self.slots.append(dict(weights=k.get("weights"), dl_buffers=buffers,
                                   grants=grants))
            return grants

        def rec_ack(sched, rnti, pid, ack):
            self.acks.append((rnti, pid, bool(ack)))
            return handle_dl_ack(sched, rnti, pid, ack)

        def rec_rx(proc, rx_samples, fn, soft_buffers=None, rvs=None):
            calls.append([])
            try:
                out = rx(proc, rx_samples, fn, soft_buffers, rvs)
            finally:
                inputs = calls.pop()
            kind = ("dl" if fn is pdsch.receive else "ul",
                    ("single", proc.ue_cfgs[0].rnti) if rvs is None
                    else "retx" if any(rvs) else "new")
            check(len(inputs) == len(proc.ue_cfgs), f"{kind}: {len(inputs)} decodes "
                                                    f"for {len(proc.ue_cfgs)} UEs")
            self.first.setdefault(kind, (rvs, inputs))
            self.last[kind] = (rvs, inputs)
            return out

        def rec_decode(llrs, bg, zc, *a, **k):
            if calls:
                calls[-1].append((llrs, bg, zc))
            return decode(llrs, bg, zc, *a, **k)

        self._restore = lambda: (setattr(cls, "run_slot", run_slot),
                                 setattr(cls, "handle_dl_ack", handle_dl_ack),
                                 setattr(hc, "_rx", rx), setattr(decoder, "decode", decode))
        cls.run_slot, cls.handle_dl_ack, hc._rx, decoder.decode = (
            rec_run_slot, rec_ack, rec_rx, rec_decode)
        return self

    def __exit__(self, *exc):
        self._restore()

    def grants(self):
        return [[dataclasses.asdict(g) for g in s["grants"]] for s in self.slots]


def k1_inputs(name, call, ues=None):
    """K1's inputs of one kept receive call, as phase_per_ue_kernel takes
    them: the wire decode's int8 after its ±64 load clamp; ``ues``: which
    UEs (default all; "retx": those that sent rv != 0)."""
    import torch
    rvs, inputs = call
    if ues == "retx":
        ues = [u for u, rv in enumerate(rvs) if rv]
    return [(f"{name} UE {u}" + (f" rv{rvs[u]}" if rvs else ""), bg, zc, True,
             torch.clamp(x, -64, 64).to(torch.int8).contiguous())
            for u, (x, bg, zc) in enumerate(inputs) if ues is None or u in ues]


def run_sched(cuda_build, dec, dev, tag, slots, argv=(), seed=0, agent=None,
              hook=None):
    """The app's scheduled loop (``loopback_app.run_scheduled``, ``--sched
    pf`` and ``argv``) for ``slots`` slots on CELL_PHY's cell, through an
    AwgnRadio on the card and traffic from ``default_rng(seed)``, under a
    SchedRecorder; K1's launches are counted from 0 around it.  No radio
    event may occur.  Returns (result, K1 launches, radio, recorder)."""
    import numpy as np
    import torch
    from srsran_edgeric_5g_tpu_torch import config, loopback_app
    from srsran_edgeric_5g_tpu_torch.runtime.events import RadioEventNotifier
    cfg = config.PhyConfig(**CELL_PHY)
    args = loopback_app._parser().parse_args(
        ["--sched", "pf", "--slots", str(slots), *argv])
    radio = AwgnRadio(torch.Generator(device=dev).manual_seed(SEED + 20 + seed), hook)

    def log(s):
        print(f"{tag}: {s}", flush=True)

    notifier = RadioEventNotifier(log=log)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    with SchedRecorder() as rec:
        res = loopback_app.run_scheduled(args, cfg, cfg.cell_config(), radio, agent,
                                         notifier, np.random.default_rng(seed),
                                         device=dev, log=log)
        torch.cuda.synchronize()
    k1 = cuda_build.LAUNCHES.get(dec.KERNEL, 0)
    check(notifier.events.total() == 0, f"{tag}: radio events {notifier.events.as_dict()}")
    return res, k1, radio, rec


def weighted_prbs(mac, tbs, nof_prb, g, w, buf):
    """A new-tx grant's PRB count under EdgeRIC weight ``w`` at DL buffer
    ``buf`` (scheduler.py:486-499): min(int(w * BWP), the buffer's PRB
    need), at least 1, within what is left, snapped up to the RBG grid."""
    remaining = nof_prb - g.start_prb
    need = mac.prbs_for_bytes(buf, tbs.mcs_config(g.mcs), 12, 24, remaining)
    n = min(max(min(int(w * nof_prb), need), 1), remaining)
    rbg = mac.rbg_size_for_bwp(nof_prb)
    return min(-(-n // rbg) * rbg, remaining)


def phase_sched_cell(cuda_build, dec, dev):
    """The scheduled cell with the EdgeRIC stand-in: SCHED_SLOTS slots of
    --sched pf on CELL_PHY's cell, max_cqi weights, then round_robin from
    TTI SCHED_SWITCH_TTI through an AlgorithmSwitch file.  Every DL TB
    delivered, each weighted grant's PRB count what its weight gives, one K1
    launch per granted UE and slot.  Wall ms per slot, layouts and their
    build ms, host reads per slot, K1's launches; then the same run warm
    (the same grants), timed, and once more profiled over SCHED_PROFILE's
    slots.  Returns K1's launches and the last DL slot's K1 inputs."""
    import os
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from srsran_edgeric_5g_tpu_torch.mac import scheduler as mac
    from srsran_edgeric_5g_tpu_torch.ops import crc
    from srsran_edgeric_5g_tpu_torch.ran import tbs
    from srsran_edgeric_5g_tpu_torch.ric import AlgorithmSwitch, MuAppScheduler
    nof_prb = 106

    with tempfile.TemporaryDirectory() as tmp:
        def stand_in():
            switch = AlgorithmSwitch(os.path.join(tmp, "scheduling_algorithm"))
            switch.set("max_cqi")
            return StandInRic(MuAppScheduler, switch,
                              {SCHED_SWITCH_TTI: "round_robin"})

        ric = stand_in()
        crc_misses = crc.remainder_table.cache_info().misses
        res, k1, radio, rec = run_sched(cuda_build, dec, dev, "sched_cell", SCHED_SLOTS,
                                        agent=ric)
        crc_misses = crc.remainder_table.cache_info().misses - crc_misses
        # Twice more, with every layout's lazily built tables (plans,
        # decoder tables per lifting size) made by the first run: unprofiled
        # (what a slot costs after its layout's first use), then profiled
        # over SCHED_PROFILE's slots.
        res_w, _, radio_w, rec_w = run_sched(cuda_build, dec, dev, "sched_cell_warm",
                                             SCHED_SLOTS, agent=stand_in())
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def window(slot):
            if slot in SCHED_PROFILE:
                torch.cuda.synchronize()
                (prof.start if slot == SCHED_PROFILE[0] else prof.stop)()

        run_sched(cuda_build, dec, dev, "sched_cell_profiled", SCHED_SLOTS,
                  agent=stand_in(), hook=window)

    check(res.code == 0 and res.dl_dropped == 0 and res.dl_in_flight == 0,
          f"sched_cell: {res.ok_count}/{res.tb_count} TBs, {res.dl_dropped} dropped, "
          f"{res.dl_in_flight} in flight")
    grants = sum(len(r["grants"]) for r in rec.slots)
    check(len(rec.slots) == SCHED_SLOTS and len(rec.acks) == grants == res.tb_count,
          f"sched_cell: {len(rec.slots)} slots scheduled, {grants} grants, "
          f"{len(rec.acks)} ACKs, {res.tb_count} TBs received")
    check(k1 == grants, f"sched_cell: {k1} K1 launches for {grants} granted UE slots")
    # The weights: slot s applies the muApp's decision on TTI s - 1.
    per_algo, checked = {}, 0
    for slot, r in enumerate(rec.slots):
        if r["weights"] is None:
            continue
        algo = ric.algorithms[slot - 1]
        per_algo[algo] = per_algo.get(algo, 0) + 1
        for g in r["grants"]:
            if g.is_retx:
                continue
            want = weighted_prbs(mac, tbs, nof_prb, g, r["weights"][g.rnti],
                                 r["dl_buffers"][g.rnti])
            check(g.nof_prb == want, f"sched_cell slot {slot}: {g.rnti:#x} got "
                                     f"{g.nof_prb} PRB, its weight gives {want}")
            checked += 1
    check(set(per_algo) == {"max_cqi", "round_robin"} and checked > 0,
          f"sched_cell: weighted slots per algorithm {per_algo}")
    check(ric.weights_age == 1, f"sched_cell: weights age {ric.weights_age}")

    def slot_walls(radio):
        t = [radio.first_call[s] for s in range(SCHED_SLOTS)]
        return t, [(b - a) * 1e3 for a, b in zip(t, t[1:])]

    _, slot_ms = slot_walls(radio)
    t_warm, slot_ms_w = slot_walls(radio_w)
    # A new message length needs a new CRC remainder table, built on the
    # host bit by bit: the TB CRC tables of the last slot's sizes, rebuilt.
    crc_lens = sorted({g.tbs for g in rec.slots[-1]["grants"]})
    t0 = time.perf_counter()
    for n in crc_lens:
        crc.remainder_table.__wrapped__("crc24a", n)
    crc_ms = (time.perf_counter() - t0) * 1e3 / len(crc_lens)
    wall_ms = res.seconds * 1e3 / SCHED_SLOTS
    p0, p1 = SCHED_PROFILE
    window_ms = (t_warm[p1] - t_warm[p0]) * 1e3 / (p1 - p0)
    emit("sched_cell", cell="106PRB nfft1536 4UE qam64-table PF + EdgeRIC weights",
         slots=SCHED_SLOTS, snr_db=SNR_DB, tbs=res.tb_count, tb_ok=res.ok_count,
         grants=grants, k1_launches=k1, weighted_slots=per_algo, prbs_checked=checked,
         weights_age=ric.weights_age, bytes_served={hex(k): v for k, v in
                                                    res.bytes_served.items()},
         wall_ms_per_slot=wall_ms, x_real_time=1.0 / wall_ms,
         slot_wall_ms_first_8=slot_ms[:8],
         slot_wall_ms_after_8_mean=float(np.mean(slot_ms[8:])),
         layouts=res.layouts, build_ms_mean=float(np.mean(res.build_ms)),
         build_ms_total=float(np.sum(res.build_ms)),
         build_share_of_wall=float(np.sum(res.build_ms)) / (res.seconds * 1e3),
         host_syncs=res.host_syncs, host_syncs_per_slot=res.host_syncs / SCHED_SLOTS,
         crc_tables_built=crc_misses, crc_table_lengths=crc_lens,
         crc_table_host_ms_per_build=crc_ms)
    check(rec_w.grants() == rec.grants(), "sched_cell: the warm run's grants differ")
    emit("sched_cell_device_profile", slots=[p0, p1],
         warm_wall_ms_per_slot=res_w.seconds * 1e3 / SCHED_SLOTS,
         warm_slot_wall_ms_first_8=slot_ms_w[:8],
         warm_slot_wall_ms_after_8_mean=float(np.mean(slot_ms_w[8:])),
         warm_build_ms_total=float(np.sum(res_w.build_ms)),
         **profile_summary(prof, p1 - p0, window_ms))
    return dict(launches=k1, inputs=k1_inputs("sched_cell last DL slot",
                                              rec.last[("dl", "new")]))


def phase_sched_ul_harq(cuda_build, dec, dev):
    """The scheduled loop's HARQ and UL legs on CELL_PHY's cell: UL traffic
    (SR, BSR, PUSCH) with a deep UL fade and a deep DL fade, SCHED_UL_SLOTS
    slots; the reference app's criteria: a UL and a DL retransmission
    recovered by soft combining, nothing dropped, every SR detected, a BSR,
    UL bytes served."""
    res, k1, _, rec = run_sched(cuda_build, dec, dev, "sched_ul_harq", SCHED_UL_SLOTS,
                           ("--ul-traffic", "400", "--ul-fade", "4", "--ul-fade-snr", "5",
                            "--dl-fade", "3", "--dl-fade-snr", "4"), seed=1)
    check(res.code == 0 and res.ul_retx_ok >= 1 and res.dl_retx_ok >= 1
          and res.ul_dropped == res.dl_dropped == 0 and res.sr_detected == res.sr_sent
          and res.bsr_rx >= 1 and sum(res.ul_served.values()) > 0,
          f"sched_ul_harq: {vars(res)}")
    check(k1 == res.tb_count + res.ul_tb, f"sched_ul_harq: {k1} K1 launches for "
                                          f"{res.tb_count} DL and {res.ul_tb} UL TBs")
    emit("sched_ul_harq", slots=SCHED_UL_SLOTS, dl_tbs=res.tb_count, dl_ok=res.ok_count,
         dl_retx=res.dl_retx, dl_retx_ok=res.dl_retx_ok, ul_tbs=res.ul_tb,
         ul_ok=res.ul_ok, ul_retx=res.ul_retx, ul_retx_ok=res.ul_retx_ok,
         sr_sent=res.sr_sent, sr_detected=res.sr_detected, bsrs=res.bsr_rx,
         ul_bytes_served={hex(k): v for k, v in res.ul_served.items()},
         k1_launches=k1, layouts=res.layouts, host_syncs=res.host_syncs,
         wall_ms_per_slot=res.seconds * 1e3 / SCHED_UL_SLOTS)
    # K1's inputs: the first faded UL retransmission (gNB side, the float32
    # soft-combined buffer) and DL retransmission (UE side), and a new UL TB.
    inputs = (k1_inputs("sched_ul_harq UL retx", rec.first[("ul", "retx")], "retx")
              + k1_inputs("sched_ul_harq DL retx", rec.first[("dl", "retx")], "retx")
              + k1_inputs("sched_ul_harq UL new", rec.first[("ul", "new")], [0]))
    return dict(launches=k1, inputs=inputs)


def phase_sched_rach_bcch(cuda_build, dec, dev):
    """The cell starting empty: two UEs attach through PRACH, RAR, Msg3 and
    Msg4 while SIB1 and paging go out, SCHED_RACH_SLOTS slots; both UEs
    connected, SIB1 received every 20 slots, every paged id received,
    scheduled TBs after the attach."""
    res, k1, _, rec = run_sched(cuda_build, dec, dev, "sched_rach_bcch", SCHED_RACH_SLOTS,
                           ("--rach", "2", "--bcch"), seed=2)
    check(res.code == 0 and len(res.attached) == 2 and res.ue_states == {"connected"}
          and res.sib1_rx >= 1 + (SCHED_RACH_SLOTS - 1) // 20
          and res.paging_rx == len(res.paged_ids) > 0 and res.tb_count > 0,
          f"sched_rach_bcch: {vars(res)}")
    emit("sched_rach_bcch", slots=SCHED_RACH_SLOTS, attached=[hex(r) for r in res.attached],
         ue_states=sorted(res.ue_states), sib1_rx=res.sib1_rx, paging_rx=res.paging_rx,
         paged_ids=res.paged_ids, dl_tbs=res.tb_count, dl_ok=res.ok_count,
         k1_launches=k1, layouts=res.layouts, host_syncs=res.host_syncs,
         wall_ms_per_slot=res.seconds * 1e3 / SCHED_RACH_SLOTS)
    # K1's inputs: the first control PDSCH per RNTI (SIB1, paging, RAR, each
    # Msg4), the first Msg3, and the first data slot after the attach.
    single = sorted(k for k in rec.first if k[1][0] == "single")
    check(len({k[0] for k in single}) == 2, f"sched_rach_bcch: single-shot receives {single}")
    inputs = [x for k in single for x in k1_inputs(
        f"sched_rach_bcch {'PDSCH' if k[0] == 'dl' else 'Msg3'} rnti={k[1][1]:#x}",
        rec.first[k])]
    inputs += k1_inputs("sched_rach_bcch DL data", rec.first[("dl", "new")], [0])
    return dict(launches=k1, inputs=inputs)


KERNEL_NAME = re.compile(
    r"(layered_kernel|resume_kernel|int8_tiled_sweep_kernel)(?:ILi(\d)E)?")


def phase_multi_cell(sp, pb, cuda_build, dec, dev, tm):
    """bench.py --cells=4 --sbatch=64 on the port, through the bench
    module's inputs and chained step: MC_CARRIERS carriers of the 20 MHz
    4-UE data plane (106 PRB, 4 UEs x 26 PRB, 64QAM r0.5), MC_SLOTS slots
    each, every carrier with its own RNTIs (0x4601 + arange(16) by
    carrier), through 25 dB AWGN: multi_cell_dl_slot_batch, then
    multi_cell_ul_slot_batch with K1's launches read around the UL call
    (one decode of every codeblock of every carrier); every TB exact.  Then
    bench.py's chained DL+UL steps (ms per cell-slot beside the single-
    carrier slice's, and bench.py's line), the per-stage breakdown and the
    device profile."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder, segmenter
    cell = main_cell(sp)
    nc, s, u = MC_CARRIERS, MC_SLOTS, cell.nof_ue
    t = cell.timing
    seg, rm = sp._plans(cell)
    x = pb.data_plane_inputs(s, nc, SNR_DB, dev)
    payloads, rntis, noise = x["payloads"], x["rntis"], x["noise"]
    td = sp.multi_cell_dl_slot_batch(payloads, rntis, cell, device=dev)
    rx = td + noise
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    res = sp.multi_cell_ul_slot_batch(rx, rntis, cell, device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    pay, ok, nv, cfo, soft = res
    check(tuple(td.shape) == (nc, s, t.cp.total), f"multi_cell DL shape {td.shape}")
    check(launches.get(dec.KERNEL, 0) == 1,
          f"multi_cell UL: {launches} (one K1 launch expected)")
    check(bool(ok.all()), f"multi_cell: {int((~ok).sum())} of {ok.numel()} TBs failed CRC")
    check(torch.equal(pay, payloads), "multi_cell: payload mismatch")
    check(tuple(soft.shape) == (nc, s, u * seg.c, rm.n_cb) and soft.dtype == torch.int8,
          f"multi_cell soft carry {tuple(soft.shape)}")
    check(bool(torch.isfinite(nv).all() and (nv > 0).all() and torch.isfinite(cfo).all()),
          "multi_cell noise variance / cfo")
    emit("multi_cell", cell="106PRB nfft1536 4UEx26PRB qam64 r0.5", carriers=nc,
         slots_per_carrier=s, snr_db=SNR_DB, tbs=cell.derived_tbs(), tb_ok=int(ok.sum()),
         tbs_total=ok.numel(), codeblocks=nc * s * u * seg.c, bg=seg.bg, zc=seg.zc,
         ul_launches=launches, iq_bytes=rx.numel() * rx.element_size())

    step = pb.data_plane_step(x, dev)
    _, state, _ = pb.chained(step, pb._start(dev), 2, dev)
    torch.cuda.reset_peak_memory_stats()
    res, state, dt = pb.chained(step, state, pb.ITERS, dev)
    check(bool(res[1].all()), "multi_cell timed steps: CRC")
    cell_slot_ms = dt / (pb.ITERS * nc * s) * 1e3
    emit("multi_cell_e2e", steps=pb.ITERS, cell_slots_per_step=nc * s, seconds=dt,
         ms_per_cell_slot=cell_slot_ms, x_real_time=(1.0 / (1 << cell.mu)) / cell_slot_ms,
         single_carrier_ms_per_slot=tm["slice_ms_per_slot"],
         ratio_to_single_carrier=cell_slot_ms / tm["slice_ms_per_slot"],
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    bench_line(pb, [f"--cells={nc}", f"--sbatch={s}"], cell_slot_ms, t,
               f"data-plane only, S={s} x {nc} cell(s), TBS {cell.derived_tbs()} x 4 UE")

    ci = sp._cell_ci(rntis, cell, nc, s)
    flat_pay = payloads.reshape(-1, payloads.shape[-1])
    syms = sp._dl_code(flat_pay, None, cell, ci=ci).reshape(nc * s, u, -1)
    rx_flat = rx.reshape(nc * s, -1)
    llr = sp._ul_front(rx_flat, None, cell, ci=ci)[0].reshape(nc * s * u, -1)
    full = sp._decoder_input(llr, cell)
    hard, _ = decoder.decode(full, seg.bg, seg.zc, NUM_ITERS, schedule="wire_auto")
    stages = {
        "dl_code": lambda: sp._dl_code(flat_pay, None, cell, ci=ci),
        "dl_grid_ofdm": lambda: sp._dl_grid_ofdm(syms, cell),
        "dl_total": lambda: sp.multi_cell_dl_slot_batch(payloads, rntis, cell, device=dev),
        "ul_front": lambda: sp._ul_front(rx_flat, None, cell, ci=ci),
        "ul_dematch": lambda: sp._decoder_input(llr, cell),
        "ul_decode": lambda: decoder.decode(full, seg.bg, seg.zc, NUM_ITERS,
                                            schedule="wire_auto"),
        "ul_desegment": lambda: segmenter.desegment_tb(hard, seg),
        "ul_total": lambda: sp.multi_cell_ul_slot_batch(rx, rntis, cell, device=dev),
    }
    emit("multi_cell_breakdown_ms_per_step", cell_slots_per_step=nc * s,
         **{k: cuda_ms(f, 5) for k, f in stages.items()},
         single_carrier_breakdown_ms_per_step=tm["slice_breakdown"])

    def prof_step():
        nonlocal state
        state = step(*state)[1:3]

    emit("multi_cell_device_profile",
         **device_profile(prof_step, 3, cell_slot_ms * nc * s))
    return dict(decoder_input=full, launches=launches, bg=seg.bg, zc=seg.zc)


def phase_fronthaul(sp, dev, ctx):
    """The O-RAN fronthaul on the card: the slice phase's DL resource grids
    (S_BATCH slots x 14 symbols x 1272 subcarriers), scaled to a peak of 1
    through iq_scaling, BFP-compressed at FH_WIDTHS; mantissas and exponents
    bit-equal to the CPU's on the same grids; the decompressed grid's SNR
    against the scaled input above FH_SNR_FLOOR_DB; one slot framed and
    deframed through native/ofh back to the same decompressed grid; ms per
    slot of compress and decompress."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops import ofh_compression as comp
    from srsran_edgeric_5g_tpu_torch.runtime import ofh
    cell = ctx["cell"]
    payloads = ctx["payloads"]
    s = payloads.shape[0]
    syms = sp._dl_code(payloads.reshape(-1, payloads.shape[-1]), ctx["rntis"], cell)
    grid = sp._dl_grid(syms.reshape(s, cell.nof_ue, -1), cell)
    peak = float(torch.view_as_real(grid).abs().max())
    scaling = 1.0 / peak
    grid_cpu = grid.cpu()
    rows = {}
    for w in FH_WIDTHS:
        mant, exp = comp.bfp_compress(grid, w, scaling)
        mant_c, exp_c = comp.bfp_compress(grid_cpu, w, scaling)
        check(torch.equal(mant.cpu(), mant_c) and torch.equal(exp.cpu(), exp_c),
              f"fronthaul width {w}: card != CPU")
        dec = comp.bfp_decompress(mant, exp)
        ref = grid * scaling
        snr_db = 10.0 * math.log10(float(ref.abs().pow(2).sum())
                                   / float((dec - ref).abs().pow(2).sum()))
        check(snr_db > FH_SNR_FLOOR_DB[w], f"fronthaul width {w}: SNR {snr_db} dB")
        frames = ofh.frame_dl_slot(grid[0], 1, 0, 0, 0, width=w, iq_scaling=scaling,
                                   device=dev)
        back = ofh.deframe_dl_slot(frames, w, device=dev)
        check(len(frames) == grid.shape[1] and torch.equal(back, dec[0]),
              f"fronthaul width {w}: framed slot != decompressed grid")
        rows[w] = dict(snr_db=snr_db, snr_floor_db=FH_SNR_FLOOR_DB[w],
                       exp_max=int(exp.max()), frame_bytes=len(frames[0]),
                       compress_ms_per_slot=cuda_ms(
                           lambda w=w: comp.bfp_compress(grid, w, scaling), 5) / s,
                       decompress_ms_per_slot=cuda_ms(
                           lambda: comp.bfp_decompress(mant, exp), 5) / s)
    emit("fronthaul", slots=s, grid=list(grid.shape), peak=peak, iq_scaling=scaling,
         widths=rows)


def phase_time_block(dev):
    """One second of the 20 MHz stream (TB_SLOTS slots of random unit-power
    grids) modulated and demodulated in TB_BLOCKS time blocks on the card
    with the DFT windows TB_SHIFT samples early: every slot equal to the
    one-block demodulation and to the transmitted grids within TB_ATOL;
    ms per slot."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops import ofdm
    from srsran_edgeric_5g_tpu_torch.parallel import timeblock
    from srsran_edgeric_5g_tpu_torch.ran import numerology
    t = numerology.slot_timing(nof_prb=106, nfft=1536, mu=0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    shape = (TB_SLOTS, t.nsymb, t.nof_subc)
    grids = torch.complex(torch.randn(shape, generator=gen, device=dev),
                          torch.randn(shape, generator=gen, device=dev)) / math.sqrt(2)
    mesh = timeblock.make_time_mesh(devices=[dev] * TB_BLOCKS)
    td = timeblock.modulate_stream_sharded(grids, t, mesh)
    mod_err = float((td - ofdm.modulate_slot(grids, t)).abs().max())
    check(mod_err < TB_ATOL, f"time_block modulate: {mod_err}")
    blocks = timeblock.demodulate_stream_sharded(td, t, mesh, shift=TB_SHIFT)
    single = timeblock.demodulate_stream_sharded(td, t, [dev], shift=TB_SHIFT)
    vs_single = float((blocks - single).abs().max())
    vs_grids = float((blocks - grids).abs().max())
    check(vs_single < TB_ATOL and vs_grids < TB_ATOL,
          f"time_block: {vs_single} from one block, {vs_grids} from the grids")
    ms = cuda_ms(lambda: timeblock.demodulate_stream_sharded(td, t, mesh,
                                                             shift=TB_SHIFT), 3)
    ms_single = cuda_ms(lambda: timeblock.demodulate_stream_sharded(
        td, t, [dev], shift=TB_SHIFT), 3)
    emit("time_block", slots=TB_SLOTS, blocks=TB_BLOCKS, shift=TB_SHIFT,
         samples=td.numel(), max_err_vs_one_block=vs_single, max_err_vs_grids=vs_grids,
         modulate_max_err=mod_err, demod_ms_per_slot=ms / TB_SLOTS,
         one_block_demod_ms_per_slot=ms_single / TB_SLOTS)


def phase_decode_schedules(sp, ctx):
    """decode("flooding") and decode("layered_rolls_i8") on the card on the
    slice's full decoder input (2048 x BG1 Zc = 224, int8 wire): hard bits
    and ok equal to the same call on the CPU (flooding's float sums within
    FLOODING_BIT_SHARE of the bits; flooding has no early stop, so each
    codeblock is decoded alone and the CPU decodes the first
    FLOODING_CPU_CODEBLOCKS), and their ms."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder
    full = ctx["decoder_input"]
    seg, _ = sp._plans(ctx["cell"])
    rows = {}
    for name, x, n_cpu in (("flooding", full.float(), FLOODING_CPU_CODEBLOCKS),
                           ("layered_rolls_i8", full, full.shape[0])):
        hard, ok = decoder.decode(x, seg.bg, seg.zc, NUM_ITERS, schedule=name)
        hard_c, ok_c = decoder.decode(x[:n_cpu].cpu(), seg.bg, seg.zc, NUM_ITERS,
                                      schedule=name)
        hard, ok = hard[:n_cpu], ok[:n_cpu]
        differ = int((hard.cpu() != hard_c).sum())
        if name == "flooding":
            check(differ <= FLOODING_BIT_SHARE * hard.numel(),
                  f"flooding: {differ} hard bits differ from the CPU's")
        else:
            check(differ == 0 and torch.equal(ok.cpu(), ok_c),
                  f"layered_rolls_i8: {differ} hard bits differ from the CPU's")
        rows[name] = dict(codeblocks_compared=n_cpu, ok=int(ok.sum()),
                          ok_cpu=int(ok_c.sum()), bits_differing=differ,
                          ms=cuda_ms(lambda x=x, name=name: decoder.decode(
                              x, seg.bg, seg.zc, NUM_ITERS, schedule=name), 3, warmup=1))
    emit("decode_schedules", codeblocks=full.shape[0], bg=seg.bg, zc=seg.zc,
         num_iters=NUM_ITERS, schedules=rows)


def phase_ric_train(cuda_build, dec, dev):
    """The RIC's training half on the card: ppo_train (RIC_PPO) on the twin
    of the scheduled cell (4 UEs, 106 PRB) and neurwin_train
    (RIC_NEURWIN_EPISODES episodes); finite weights and rewards.  The trained
    policy, saved as a checkpoint, is loaded by MuAppScheduler's
    TorchWeightPolicy and serves RIC_SERVE_SLOTS slots of the scheduled cell
    (the EdgeRIC stand-in, algorithm "rl"): every DL TB delivered; ms per
    training iteration and episode."""
    import os
    import tempfile

    import torch
    from srsran_edgeric_5g_tpu_torch.ric import AlgorithmSwitch, MuAppScheduler, neurwin, rl
    from srsran_edgeric_5g_tpu_torch.ric.muapp import TorchWeightPolicy
    env = rl.EdgeRicSimEnv(rl.EnvConfig(num_ues=CELL_PHY["nof_ue"], nof_prb=106,
                                        seed=SEED))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy, history = rl.ppo_train(env, seed=SEED, device=dev, **RIC_PPO)
    torch.cuda.synchronize()
    ppo_s = time.perf_counter() - t0
    params = list(policy.parameters())
    check(all(p.device.type == "cuda" and bool(torch.isfinite(p).all()) for p in params)
          and all(math.isfinite(h) for h in history), f"ppo_train: rewards {history}")
    t0 = time.perf_counter()
    net, nw_hist = neurwin.neurwin_train(neurwin.ArmEnv(neurwin.ArmConfig(seed=SEED)),
                                         episodes=RIC_NEURWIN_EPISODES, seed=SEED,
                                         device=dev)
    torch.cuda.synchronize()
    nw_s = time.perf_counter() - t0
    check(all(bool(torch.isfinite(p).all()) for p in net.parameters())
          and all(math.isfinite(h) for h in nw_hist), "neurwin_train: not finite")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "policy.pt")
        torch.save(policy, path)
        served = TorchWeightPolicy(path)
        switch = AlgorithmSwitch(os.path.join(tmp, "scheduling_algorithm"))
        switch.set("rl")
        ric = StandInRic(lambda m, switch: MuAppScheduler(m, torch_policy=served,
                                                          switch=switch), switch, {})
        res, k1, _, rec = run_sched(cuda_build, dec, dev, "ric_train_serve",
                                    RIC_SERVE_SLOTS, agent=ric)
    grants = sum(len(r["grants"]) for r in rec.slots)
    check(res.code == 0 and res.dl_dropped == 0 and res.ok_count == res.tb_count == grants
          and k1 == grants, f"ric_train serve: {res.ok_count}/{res.tb_count} TBs, "
                            f"{grants} grants, {k1} K1 launches")
    check(set(ric.algorithms) == {"rl"} and ric.weights_age == 1,
          f"ric_train serve: algorithms {set(ric.algorithms)}, age {ric.weights_age}")
    emit("ric_train", ppo=dict(RIC_PPO, seconds=ppo_s,
                               ms_per_iteration=ppo_s * 1e3 / RIC_PPO["iterations"],
                               mean_episode_rewards=history),
         neurwin=dict(episodes=RIC_NEURWIN_EPISODES, seconds=nw_s,
                      ms_per_episode=nw_s * 1e3 / RIC_NEURWIN_EPISODES,
                      last_episode_rewards=nw_hist[-3:]),
         serve=dict(slots=RIC_SERVE_SLOTS, tbs=res.tb_count, tb_ok=res.ok_count,
                    k1_launches=k1, weighted_slots=sum(
                        r["weights"] is not None for r in rec.slots)))


def phase_scale_out(fcm, sp, pb, cuda_build, dec, dev):
    """The scale-out on the card: a world of 1 over NCCL in this process
    runs parallel.dryrun's programs at 20 MHz and the full gNB slot (S =
    S_BATCH, the full_cell inputs) on a (1, 1) mesh against mesh=None (bits
    exact, samples within SO_SAMPLE_ATOL, noise_var and cfo within
    SO_RTOL of the peak), times both in turns and the worker's two programs
    at world 1; K1 against its plain version on the codeblocks that rank
    (0, 0) of a (ue 2, cb 2) mesh decodes, and on no codeblocks (no
    launch); then parallel.multihost as 2 processes on this card over gloo
    (it takes the port's c10d all_gather on CUDA tensors, PERF.md).  K1's
    launches are counted over the dry run and the mesh step; the device
    profile of both steps says whether the mesh path's extra time is the
    device's or the host's."""
    import os
    import tempfile
    import types
    import numpy as np
    import torch
    import torch.distributed as dist
    from srsran_edgeric_5g_tpu_torch.ops import ofdm
    from srsran_edgeric_5g_tpu_torch.parallel import dryrun, mesh as mm, multihost as mh
    t_phase = time.perf_counter()
    fc, s = fcm.FullCellConfig(), S_BATCH
    x = pb.full_cell_inputs(fc, s, SNR_DB, dev)
    rx = x["ul"] + x["noise"]
    store = tempfile.mkdtemp()
    mm.init_distributed(num_processes=1, process_id=0, backend="nccl",
                        init_method=f"file://{os.path.join(store, 'world1')}")
    try:
        mesh = mm.make_mesh(1, 1, device_type=dev.type)

        def step(m):
            td = fcm.gnb_dl_slot_batch(x["pay_n"], x["pay_s"], x["dci"], x["pbch"],
                                       fc, s, device=dev, mesh=m)
            res = fcm.gnb_ul_slot_batch(rx, fc, s, soft_in=x["soft0"],
                                        new_data=x["ones"], soft_flat=True,
                                        device=dev, mesh=m)
            return td, res

        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        report = dryrun.run(1, dev)
        emit("scale_out_dryrun", world=1, backend="nccl",
             seconds=time.perf_counter() - t0, programs=report)
        mm.reset_collectives()
        td_m, res_m = step(mesh)
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        tally = mm.collective_stats()
        td_n, res_n = step(None)
        td_m, res_m = sp.unshard(td_m), {k: sp.unshard(v) for k, v in res_m.items()}
        for k in ("payload", "tb_ok", "soft", "ack_bits", "csi_bits", "csi_ok",
                  "prach_detected", "prach_delay"):
            check(torch.equal(res_m[k], res_n[k]), f"scale_out mesh {k} != mesh=None")
        check(bool(res_m["tb_ok"].all()) and torch.equal(res_m["payload"], x["pay_u"]),
              "scale_out mesh full slot: PUSCH not recovered")
        sample_err = float((td_m - td_n).abs().max())
        check(sample_err <= SO_SAMPLE_ATOL, f"scale_out DL samples off by {sample_err}")
        for k in ("noise_var", "cfo"):
            err = float((res_m[k] - res_n[k]).abs().max())
            check(err <= SO_RTOL * float(res_n[k].abs().max()),
                  f"scale_out {k} off by {err}")
        times = {"none": [], "mesh": []}
        for name in ("none", "mesh", "mesh", "none"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SO_STEPS):
                step(mesh if name == "mesh" else None)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / (SO_STEPS * s) * 1e3)
        walls = {k: sum(v) / len(v) * s for k, v in times.items()}
        emit("scale_out_device_profile",
             **{k: device_profile(lambda k=k: step(mesh if k == "mesh" else None), 3,
                                  walls[k]) for k in ("mesh", "none")})
        world1 = {}
        for name in ("cell", "carrier"):
            _, sec, w_tally, _ = mh.run_program(name, 1, dev, repeat=3)
            world1[name] = {"seconds": sec, "collectives": w_tally}
        emit("scale_out_full_cell", world=1, backend="nccl", slots=s,
             ms_per_slot_mesh=times["mesh"], ms_per_slot_none=times["none"],
             collectives_per_step=tally,
             collective_count_per_step=sum(v["count"] for v in tally.values()),
             collective_bytes_per_step=sum(v["bytes"] for v in tally.values()),
             max_sample_err=sample_err, launches=launches,
             worker_programs_world1=world1)

        # K1 on one rank's share: the codeblocks rank (0, 0) of a (ue 2,
        # cb 2) mesh decodes, from this slot's decoder input.
        cell_u, seg = x["cell_u"], x["seg"]
        grid = ofdm.demodulate_slot(rx, fc.timing, scale=1.0)
        llr = sp._ul_front(None, fcm._rntis(fc, dev), cell_u, rx_grid=grid)[0]
        full = sp._decoder_input(llr.reshape(s * fc.nof_ue, -1), cell_u)
        quad = types.SimpleNamespace(mesh_dim_names=("ue", "cb"), size=lambda d: 2)
        lo, hi = mm.row_block(full.shape[0], quad, ("ue", "cb"), (0, 0))
        per_path = phase_path_kernel(dec, "scale_out", dict(
            decoder_input=full[lo:hi].contiguous(), bg=seg.bg, zc=seg.zc,
            launches=launches))
        cuda_build.reset_launches()
        hard, ok, sweeps = dec.decode_layered(full[:0], seg.bg, seg.zc, NUM_ITERS,
                                              wire=True, early_stop=True)
        torch.cuda.synchronize()
        k_bits = dec.get_graph(seg.bg, seg.zc).kb * seg.zc
        check(tuple(hard.shape) == (0, k_bits) and ok.numel() == 0
              and sweeps.numel() == 0 and not cuda_build.LAUNCHES,
              f"K1 on 0 codeblocks: {tuple(hard.shape)} {dict(cuda_build.LAUNCHES)}")
        # The early stop over the mesh's codeblock groups on waterfall input
        # (one rank: groups of one, no collective) against mesh=None.
        exit_in = mh.exit_inputs()
        world1_exit = exit_against_none(exit_in, dev, [mh.exit_step(exit_in, 1, dev)],
                                        whole=False)
    finally:
        dist.destroy_process_group()

    # The worker as 2 processes on this card over gloo, with the early stop
    # over both ranks on the exit program's waterfall inputs.
    env = dict(os.environ, LOCAL_WORLD_SIZE="2")
    env.pop("LOCAL_RANK", None)
    init = f"file://{os.path.join(store, 'gloo2')}"
    np.savez(os.path.join(store, "exit.npz"), **exit_in)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "srsran_edgeric_5g_tpu_torch.parallel.multihost",
         str(r), "2", init, "--device", "cuda", "--backend", "gloo",
         "--programs", "cell,carrier,exit", "--repeat", "3",
         "--inputs", os.path.join(store, "exit.npz"), "--out", store],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SO_GLOO_WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"multihost rank {r} over gloo: rc {p.returncode}\n"
                                 f"{out[-3000:]}")
    line = next((ln for ln in outs[0].splitlines() if ln.startswith("MULTIHOST_OK")), "")
    check(bool(line), "multihost over gloo printed no MULTIHOST_OK")
    print(line, flush=True)
    gloo = json.loads(line[line.index("{"):])
    gloo_exit = exit_against_none(exit_in, dev, [
        {k[len("exit/"):]: v for k, v in np.load(os.path.join(store, f"rank{r}.npz")).items()
         if k.startswith("exit/")} for r in range(2)])
    emit("scale_out_multihost", ranks=2, backend="gloo", device="cuda",
         wall_seconds=time.perf_counter() - t0,
         seconds_per_step={k: v["seconds"] for k, v in gloo.items()},
         world1_nccl_seconds_per_step={k: v["seconds"] for k, v in world1.items()},
         collectives={k: v["collectives"] for k, v in gloo.items()})
    emit("scale_out_exit", world1_nccl=world1_exit, gloo_2=gloo_exit)
    shutil.rmtree(store, ignore_errors=True)
    emit("scale_out", seconds=time.perf_counter() - t_phase)
    return per_path


def exit_against_none(inputs, dev, parts, whole=True):
    """The exit program's results (``multihost.exit_step``) against the
    same decodes and _ul_back with mesh=None on the card.  ``parts``: every
    rank's outputs, their decode blocks concatenated in rank order; with
    ``whole`` False (a world of 1) each decode case is held to the first
    block of its bounds, the one the rank took.  Returns each case's size,
    its ok and every rank's K1 launches."""
    import numpy as np
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder
    from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp
    joined = lambda key: np.concatenate([p[key] for p in parts])
    out = {}
    for name in ("auto", "wire", "empty"):
        x = torch.as_tensor(inputs[f"{name}/llrs"], device=dev)
        b = inputs[f"{name}/bounds"]
        if not whole:
            x = x[b[0]:b[1]]
        bg, zc, n = (int(v) for v in inputs[f"{name}/meta"])
        sched = "wire_auto" if x.dtype == torch.int8 else "auto"
        hard, ok = decoder.decode(x, bg, zc, n, schedule=sched)
        plain = decoder.decode(x.cpu(), bg, zc, n, schedule=sched)
        check(torch.equal(hard.cpu(), plain[0]) and torch.equal(ok.cpu(), plain[1]),
              f"exit {name}: K1 != plain on the whole batch")
        check(np.array_equal(joined(f"{name}/hard"), plain[0].numpy())
              and np.array_equal(joined(f"{name}/ok"), plain[1].numpy()),
              f"exit {name}: the ranks' decode != mesh=None")
        out[name] = dict(codeblocks=int(x.shape[0]), ok=plain[1].tolist(),
                         launches=[int(p[f"{name}/launches"]) for p in parts])
    check(len(parts) == 1 or out["empty"]["launches"][1] == 0,
          f"exit: a rank with no codeblocks launched K1 {out['empty']['launches']}")
    cell = sp.CellConfig(**json.loads(str(inputs["path/cell"])))
    llr = torch.as_tensor(inputs["path/llr"], device=dev)
    n = int(inputs["path/num_iters"])
    pay, tb_ok, _ = sp._ul_back(llr, cell, num_iters=n)
    seg, _ = sp._plans(cell)
    hard, ok = decoder.decode(sp._decoder_input(llr, cell), seg.bg, seg.zc, n,
                              schedule="wire_auto")
    check(all(np.array_equal(p["path/payload"], pay.cpu().numpy())
              and np.array_equal(p["path/tb_ok"], tb_ok.cpu().numpy()) for p in parts)
          and np.array_equal(joined("path/hard"), hard.cpu().numpy())
          and np.array_equal(joined("path/ok"), ok.cpu().numpy()),
          "exit path: _ul_back on the mesh != mesh=None")
    out["path"] = dict(tbs=int(llr.shape[0]), tb_ok=tb_ok.tolist(), ok=ok.tolist())
    return out


def k1_on(dec, x, bg, zc, num_iters, wire, strict=False, group=None):
    """K1 as a validation path runs it (one call, early stop over groups of
    ``group`` codeblocks: the whole call by default) against its plain
    version on the card: equal hard bits, ok and sweeps; the kernel's time
    (CUDA events), the plain version's, the bound at the sweeps this data
    took, and the plain version's (hard, ok) under ``plain``."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph

    def run(fn):
        return fn(x, bg, zc, num_iters, wire=wire, early_stop=True, strict=strict,
                  exit_group=group)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    p = run(dec.decode_layered_plain)
    end.record()
    k = run(dec.decode_layered)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(k, p))
    err = int((k[0].int() - p[0].int()).abs().max())
    sweeps = int(k[2].sum())
    g = get_graph(bg, zc)
    n_bytes = x.numel() * x.element_size() + x.shape[0] * (g.kb * zc + 1 + 4)
    bound_ms, bound_by = kernel_bound(g, zc, sweeps, n_bytes)
    return dict(equal=same, max_abs_err=err, codeblocks=x.shape[0], bg=bg, zc=zc,
                mode="wire" if wire else ("f32 l<=0" if not strict else "f32"),
                num_iters=num_iters, exit_group=group, mean_sweeps=sweeps / x.shape[0],
                ms=cuda_ms(lambda: run(dec.decode_layered), 3, warmup=1),
                plain_ms=start.elapsed_time(end), bound_ms=bound_ms, bound_by=bound_by,
                plain=p[:2])


def wire_input(llrs):
    """What decode("wire_auto") hands K1 for float wire LLRs: the ±64 load
    clamp, as int8."""
    import torch
    return llrs.clamp(-64, 64).to(torch.int8).contiguous()


def k1_launches(cuda_build, dec):
    """(K1 calls, K1 group-exit launches) since the last reset."""
    return (cuda_build.LAUNCHES.get(dec.KERNEL, 0),
            cuda_build.LAUNCHES.get(dec.KERNEL_RESUME, 0))


def k1_path(rows, launches):
    """One validation path's K1 entry: sums over its decoder inputs;
    ``launches`` is (K1 calls, group-exit launches) of the path's run."""
    check(all(r["equal"] for r in rows), f"K1 != plain on a waterfall input: "
          f"{[{k: v for k, v in r.items() if k != 'plain'} for r in rows if not r['equal']][:2]}")
    n = sum(r["codeblocks"] for r in rows)
    return dict(launches=launches[0], resume_launches=launches[1],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by="operations" if all(r["bound_by"] == "operations" for r in rows)
                else "bytes", inputs=len(rows), codeblocks=n,
                mean_sweeps=sum(r["mean_sweeps"] * r["codeblocks"] for r in rows) / n)


def phase_bler_awgn(cuda_build, dec, dev):
    """tools.bler_sweep's whole BLER_R1.md grid on the card (15 points x
    VAL_BLOCKS TBs, default_rng(0) in the JAX tool's order): per point the
    BLER, K1's launches, mean sweeps per codeblock, K1 ms and its bound.  At
    every point (the steepest two among them) the per-TB outcomes and hard
    bits equal the plain "layered" decode of the same realisations on the
    card."""
    import numpy as np
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder, segmenter
    from srsran_edgeric_5g_tpu_torch.tools import bler_sweep
    rng = np.random.default_rng(bler_sweep.SEED)
    points, rows, launches = [], [], np.zeros(2, dtype=int)
    for mcs_idx, snrs in bler_sweep.CASES.items():
        for snr in snrs:
            cuda_build.reset_launches()
            p = bler_sweep.run_point(mcs_idx, snr, VAL_BLOCKS, rng, device=dev)
            torch.cuda.synchronize()
            n = k1_launches(cuda_build, dec)
            launches += n
            hard, _ = decoder.decode(p.llrs, p.seg.bg, p.seg.zc, bler_sweep.NUM_ITERS,
                                     schedule="layered")
            _, tb_ok = segmenter.desegment_tb(hard, p.seg)
            check(torch.equal(hard, p.hard) and torch.equal(tb_ok, p.tb_ok),
                  f"bler_awgn MCS {mcs_idx} {snr} dB: the card's TBs != plain layered")
            r = k1_on(dec, p.llrs, p.seg.bg, p.seg.zc, bler_sweep.NUM_ITERS, wire=False)
            rows.append(r)
            points.append(dict(mcs=mcs_idx, snr_db=snr, tbs=p.tbs,
                               failed=int((~p.tb_ok).sum()), bler=p.bler,
                               k1_launches=n[0], codeblocks=r["codeblocks"],
                               mean_sweeps=r["mean_sweeps"], k1_ms=r["ms"],
                               plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                               bound_by=r["bound_by"]))
    steep = sorted(points, key=lambda q: -min(q["failed"], VAL_BLOCKS - q["failed"]))[:2]
    emit("bler_awgn", blocks=VAL_BLOCKS, points=points,
         steepest=[(q["mcs"], q["snr_db"]) for q in steep])
    return k1_path(rows, launches.tolist())


def phase_bler_parity(cuda_build, dec, dev):
    """tools.bler_parity's three port columns (wire_auto = K1 wire, the
    plain layered_rolls_i8, auto = K1 f32) at every CASES point on
    VAL_PARITY_BLOCKS TBs (the tool's 1000 cut to fit), each 512-codeblock
    chunk with its own batch exit (one K1 call per point and column); at
    every point K1 wire's hard bits and ok equal the plain layered_wire
    decode of each chunk of the same buffer on the card."""
    import numpy as np
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder
    from srsran_edgeric_5g_tpu_torch.tools import bler_parity as bp
    rows, points, launches = [], [], np.zeros(2, dtype=int)
    for mcs_idx, _, grid in bp.CASES:
        rng = np.random.default_rng(1000 + mcs_idx)
        _, _, seg, rm, tx_cbs, syms = bp.build_point(mcs_idx, VAL_PARITY_BLOCKS,
                                                     rng, device=dev)
        for snr in grid:
            buf = bp.llr_buffer(rm, syms, float(snr), rng, dev)
            cuda_build.reset_launches()
            hards = {s: bp.decode_ours(buf, seg, bp.NUM_ITERS, s) for s in bp.SCHEDULES}
            torch.cuda.synchronize()
            n = k1_launches(cuda_build, dec)
            launches += n
            k = decoder.decode(buf, seg.bg, seg.zc, bp.NUM_ITERS, schedule="wire_auto",
                               exit_group=bp.CHUNK)
            w = decoder.decode(buf, seg.bg, seg.zc, bp.NUM_ITERS,
                               schedule="layered_wire", exit_group=bp.CHUNK)
            check(torch.equal(hards["wire_auto"], k[0]) and torch.equal(k[0], w[0])
                  and torch.equal(k[1], w[1]),
                  f"bler_parity MCS {mcs_idx} {snr:+.2f} dB: K1 wire != layered_wire")
            rows.append(k1_on(dec, buf, seg.bg, seg.zc, bp.NUM_ITERS, wire=True,
                              group=bp.CHUNK))
            points.append(dict(mcs=mcs_idx, snr_db=float(snr), k1_launches=n[0],
                               mean_sweeps=rows[-1]["mean_sweeps"],
                               k1_ms=rows[-1]["ms"], bound_ms=rows[-1]["bound_ms"],
                               bler={s: bp.tb_bler(h, tx_cbs, seg.c)
                                     for s, h in hards.items()}))
    emit("bler_parity", blocks=VAL_PARITY_BLOCKS, cut_from=1000,
         reference=bp.REFERENCE_COLUMN, points=points)
    return k1_path(rows, launches.tolist())


def tb_ok_per_tb(seg, row, ok, what):
    """The tool's per-TB outcomes equal those of the plain version's exit per
    TB (``k1_on``'s ``plain``, exit_group C) on the same decoder input."""
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import segmenter
    _, want = segmenter.desegment_tb(row["plain"][0], seg)
    check(bool((want == ok).all()), f"{what}: the card's TB outcomes != the plain "
          f"exit per TB ({int((want != ok).sum())} TBs differ)")


def phase_bler_channels(cuda_build, dec, dev):
    """tools.bler_channel_sweep's VAL_PROFILES at VAL_BLOCKS TBs per point
    (a cut from the record's 400) and the RLF run, which decodes 12 of its
    20 slots; K1 (wire, one call per point, each TB stopping on its own)
    against its plain version on each point's stacked decoder input, and
    the tool's per-TB outcomes against the plain version's."""
    import numpy as np
    import torch
    from srsran_edgeric_5g_tpu_torch.models import pdsch
    from srsran_edgeric_5g_tpu_torch.tools import bler_channel_sweep as cs
    su = cs.setup(dev)
    seg = pdsch._plans(su.cfg, 0)[0]
    rng = np.random.default_rng(cs.SEED)
    rows, points, launches = [], [], np.zeros(2, dtype=int)
    for i, (prof, grid) in enumerate(cs.PROFILES):
        for j, snr in enumerate(grid):
            payloads = rng.integers(0, 2, (VAL_BLOCKS, su.tbs), dtype=np.int8)
            if prof not in VAL_PROFILES:
                continue
            gen = torch.Generator(device=dev).manual_seed(cs.SEED * 1000 + 10 * i + j)
            cuda_build.reset_launches()
            ok, llrs = cs.run_point(prof, snr, payloads, gen, su)
            torch.cuda.synchronize()
            n = k1_launches(cuda_build, dec)
            launches += n
            rows.append(k1_on(dec, wire_input(llrs), seg.bg, seg.zc, NUM_ITERS,
                              wire=True, group=seg.c))
            tb_ok_per_tb(seg, rows[-1], ok, f"bler_channels {prof} {snr} dB")
            points.append(dict(profile=prof, snr_db=snr, failed=int((~ok).sum()),
                               bler=1.0 - float(ok.float().mean()), k1_launches=n[0],
                               mean_sweeps=rows[-1]["mean_sweeps"]))
    payloads = rng.integers(0, 2, (cs.RLF_SLOTS, su.tbs), dtype=np.int8)
    cuda_build.reset_launches()
    ok, _ = cs.rlf_run(payloads, torch.Generator(device=dev).manual_seed(3), su)
    torch.cuda.synchronize()
    launches += k1_launches(cuda_build, dec)
    check(int(ok.sum()) == 12, f"RLF decoded {int(ok.sum())} of {cs.RLF_SLOTS}, not 12")
    emit("bler_channels", blocks=VAL_BLOCKS, cut_from=400, points=points,
         rlf_decoded=int(ok.sum()), rlf_slots=cs.RLF_SLOTS)
    return k1_path(rows, launches.tolist())


def phase_chest_bler(cuda_build, dec, dev):
    """tools.chest_bler_ab's MCS 15 grid, both estimators, VAL_BLOCKS TBs per
    point (default_rng(77 + 15): the JAX tool's grids); K1 (wire, one call
    per receiver and point, each TB stopping on its own) against its plain
    version on each decoder input, and the tool's per-TB outcomes against
    the plain version's."""
    import numpy as np
    import torch
    from srsran_edgeric_5g_tpu_torch.models import pdsch
    from srsran_edgeric_5g_tpu_torch.tools import chest_bler_ab as ab
    mcs_idx, _, grid = ab.CASES[0]
    case = ab.Case(mcs_idx, VAL_BLOCKS, dev)
    seg = pdsch._plans(case.cfg, 0)[0]
    rows, points, launches = [], [], np.zeros(2, dtype=int)
    for snr in grid:
        g = case.grids(float(snr))
        row = dict(snr_db=float(snr))
        for name, ds in (("default", None), ("ta", ab.TA_DELAY_SPREAD_S)):
            cuda_build.reset_launches()
            ok, llrs = case.rx(g, ds)
            torch.cuda.synchronize()
            launches += k1_launches(cuda_build, dec)
            row[name] = int((~ok).sum())
            rows.append(k1_on(dec, wire_input(llrs), seg.bg, seg.zc, NUM_ITERS,
                              wire=True, group=seg.c))
            tb_ok_per_tb(seg, rows[-1], ok, f"chest_bler {name} {snr} dB")
        points.append(row)
    emit("chest_bler", mcs=mcs_idx, blocks=VAL_BLOCKS, failed_tbs=points,
         reference=ab.REFERENCE_COLUMN)
    return k1_path(rows, launches.tolist())


def phase_sched_churn(dev):
    """tools.sched_churn over VAL_SCHED_SLOTS PF slots (the scheduler runs
    on the host; its layouts equal the JAX tool's in
    tests/test_torch_tools.py): build, first-use and warm ms per slot of
    the top VAL_SCHED_TOP layouts on the card (the DL slot and the UE's DL
    receive)."""
    from srsran_edgeric_5g_tpu_torch.tools import sched_churn as sc
    _, layouts, first = sc.run_scheduler(VAL_SCHED_SLOTS)
    rows = sc.layout_costs(layouts, dev, VAL_SCHED_TOP, VAL_SCHED_PHY_SLOTS)
    check(all(r["tb_ok"] for r in rows), "sched_churn: a layout's first slot failed")
    total = sum(layouts.values())
    emit("sched_churn", slots=VAL_SCHED_SLOTS, layouts=len(layouts),
         scheduled_slots=total, discovered=sc.discovered(first, VAL_SCHED_SLOTS),
         top5_share=sum(c for _, c in layouts.most_common(5)) / total, top=rows)


def phase_kernel_bench(cuda_build, dec, dev):
    """tools.kernel_bench: one line per stage (CUDA events, 20 calls), and
    K1 on its decode lines' input (64 x BG1 Zc = 384 at 6.5 dB): "auto"
    (f32, l <= 0, the batch exit) against its plain version."""
    import numpy as np
    from srsran_edgeric_5g_tpu_torch.tools import kernel_bench as kb
    cuda_build.reset_launches()
    stages = kb.run(20, dev)
    launches = k1_launches(cuda_build, dec)
    emit("kernel_bench", stages=stages)
    _, llr = kb.decode_llrs(np.random.default_rng(0), dev)
    return k1_path([k1_on(dec, llr, 1, 384, NUM_ITERS, wire=False)], launches)


def phase_validation(cuda_build, dec, dev):
    """Phase 27: the validation entry points (srsran_edgeric_5g_tpu_torch/
    tools/); returns K1's per_path entries of the five paths that decode."""
    t0 = time.perf_counter()
    per_path, seconds = {}, {}
    for name, fn in (("bler_awgn", phase_bler_awgn), ("bler_parity", phase_bler_parity),
                     ("bler_channels", phase_bler_channels),
                     ("chest_bler", phase_chest_bler),
                     ("sched_churn", lambda cb, d, v: phase_sched_churn(v)),
                     ("kernel_bench", phase_kernel_bench)):
        t1 = time.perf_counter()
        out = fn(cuda_build, dec, dev)
        seconds[name] = time.perf_counter() - t1
        if out is not None:
            per_path[name] = out
    emit("validation", seconds=time.perf_counter() - t0, phase_seconds=seconds,
         per_path={k: {f: v[f] for f in ("launches", "resume_launches",
                                         "mean_sweeps", "ms", "bound_ms")}
                   for k, v in per_path.items()})
    return per_path


def kernel_name(line: str):
    """layered_kernel<M> or resume_kernel<M> (M: 0 f32, 1 wire, 2 int8)
    or int8_tiled_sweep_kernel from a line naming a mangled kernel, else
    None."""
    m = KERNEL_NAME.search(line)
    return m and m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def ptxas_summary(log: str) -> dict:
    """ptxas -v's registers, stack frame and spill bytes per kernel of one
    build log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln and kernel_name(ln):
            name = kernel_name(ln)
            out[name] = {}
        elif name and "stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[name].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif name and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def sass_summary(library: str) -> dict:
    """Per kernel of a built library, from ``cuobjdump -sass``: SASS
    instructions, branch-synchronisation blocks (BSSY), local-memory accesses
    (LDL/STL) and barriers (BAR).  Empty where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", library], capture_output=True,
                              text=True, timeout=300, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_name(ln)
            if name:
                out[name] = dict(instructions=0, bssy=0, local=0, bar=0)
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln):
            op = ln.split("*/", 1)[1].split()
            op = (op[1] if op and op[0].startswith("@") else op[0]) if op else ""
            out[name]["instructions"] += 1
            out[name]["bssy"] += op.startswith("BSSY")
            out[name]["local"] += op.startswith(("LDL", "STL"))
            out[name]["bar"] += op.startswith("BAR")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    try:
        from srsran_edgeric_5g_tpu_torch import bench as pb, cuda_build, entry as pe
        from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda, encoder
        from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
        from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]

    t_start = t0 = time.perf_counter()
    cuda_build.build_all()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    emit("build", seconds=time.perf_counter() - t0, kernels=list(cuda_build.KERNELS),
         ptxas=[ptxas_summary(log) for log in cuda_build.BUILD_LOGS.values()],
         sass=[sass_summary(str(cuda_build.build(n))) for n in cuda_build.KERNELS],
         torch=torch.__version__, cuda=torch.version.cuda)

    pdsch = phase_pdsch_code(sp, fcm, dev)
    pusch = phase_pusch_front(sp, fcm, dev)
    ctx = phase_slice(sp, cuda_build, dev, S_BATCH)
    check(ctx["launches"].get(decoder_cuda.KERNEL, 0) > 0,
          f"main path launched no {decoder_cuda.KERNEL} kernel")
    phase_small(sp, dev)
    max_err = phase_kernels(sp, decoder_cuda, encoder, dev, ctx)
    tm = phase_timing(sp, pb, decoder_cuda, dev, ctx)
    # bench.py --cells=4: four carriers in one slot batch, one K1 launch per
    # UL step; then the modules of this slice without a kernel.
    mc = phase_multi_cell(sp, pb, cuda_build, decoder_cuda, dev, tm)
    phase_fronthaul(sp, dev, ctx)
    phase_time_block(dev)
    phase_decode_schedules(sp, ctx)
    fcx = phase_full_cell(fcm, sp, pb, cuda_build, decoder_cuda, dev, [], "full_cell")
    k2 = phase_kernel_int8(decoder_cuda, encoder, cuda_build, dev,
                           fcx["decoder_input"])
    # This slice's configurations of the main path: bench.py --mimo-full=2,
    # --mimo=4 and --qam256; K1 on each one's real decoder input.
    paths = {
        "mimo_full_cell": phase_full_cell(fcm, sp, pb, cuda_build, decoder_cuda, dev,
                                          ["--mimo-full=2"], "mimo_full_cell"),
        "mimo_data_plane": phase_mimo_data_plane(sp, pb, cuda_build, decoder_cuda, dev, 4),
        "qam256_full_cell": phase_full_cell(fcm, sp, pb, cuda_build, decoder_cuda, dev,
                                            ["--qam256"], "qam256_full_cell"),
    }
    paths["multi_cell"] = mc
    # bench.py's remaining modes, then its streaming mode (K1 on the
    # S = 8 step's decoder input).
    bench_launches = phase_bench_modes(pb, cuda_build, decoder_cuda)
    paths["streaming"] = phase_streaming(sp, pb, cuda_build, decoder_cuda, dev)
    per_path = {name: phase_path_kernel(decoder_cuda, name, path)
                for name, path in paths.items()}
    # The per-UE channel processors: K1 in wire mode per UE and
    # in f32 mode through the MIMO receiver's decode("auto").
    hc = phase_hetero_cell(cuda_build, decoder_cuda, dev)
    phase_hetero_harq(dev)
    phase_pusch_uci(dev)
    mu = phase_mimo_ue(cuda_build, decoder_cuda, dev)
    per_path["hetero_cell"] = phase_per_ue_kernel(
        decoder_cuda, "hetero_cell", hc["inputs"], hc["launches"])
    per_path["mimo_ue"] = phase_per_ue_kernel(
        decoder_cuda, "mimo_ue", mu["inputs"], mu["launches"])
    # The cell processor through the loopback app's slot loop: K1 in wire
    # mode once per UL slot.
    cpx = phase_cell_processor(cuda_build, decoder_cuda, dev)
    phase_cell_harq(dev)
    phase_cell_control(dev)
    per_path["cell_processor"] = phase_per_ue_kernel(
        decoder_cuda, "cell_processor", cpx["inputs"], cpx["launches"])
    # The MAC and EdgeRIC layers through the app's scheduled loop: K1 in
    # wire mode once per granted UE and slot, UE side and gNB side.
    sched = {"sched_cell": phase_sched_cell(cuda_build, decoder_cuda, dev),
             "sched_ul_harq": phase_sched_ul_harq(cuda_build, decoder_cuda, dev),
             "sched_rach_bcch": phase_sched_rach_bcch(cuda_build, decoder_cuda, dev)}
    for name, x in sched.items():
        per_path[name] = phase_per_ue_kernel(decoder_cuda, name, x["inputs"],
                                             x["launches"])
    emit("sched_kernel", kernel=decoder_cuda.KERNEL,
         per_path={name: per_path[name] for name in sched})
    phase_ric_train(cuda_build, decoder_cuda, dev)
    # The scale-out: the mesh path as a world of 1 over NCCL, the worker as
    # 2 processes over gloo; K1 on one rank's codeblock share.
    per_path["scale_out"] = phase_scale_out(fcm, sp, pb, cuda_build, decoder_cuda, dev)
    # The validation entry points: K1 at full sweeps on waterfall input.
    per_path.update(phase_validation(cuda_build, decoder_cuda, dev))
    # The single-device entry point.
    entry_launches = phase_entry(pe, cuda_build, decoder_cuda, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    zc40_f32, _ = synthetic_wire(encoder, dev, 2, 40, 64, 1.5, gen)
    zc40 = phase_per_ue_kernel(decoder_cuda, "synthetic",
                               [("synthetic B=64", 2, 40, False, zc40_f32)], 0)

    leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "srsran_edgeric_5g_tpu" or m.startswith("srsran_edgeric_5g_tpu.")]
    check(not leaked, f"JAX modules imported: {leaked[:5]}")

    # No PyTorch call computes a layered min-sum decode: library_ms is null.
    src = "srsran_edgeric_5g_tpu_torch/csrc/ldpc_layered.cu"
    launches_per_path = {"data_plane": ctx["launches"].get(decoder_cuda.KERNEL, 0),
                         "full_cell": fcx["launches"].get(decoder_cuda.KERNEL, 0),
                         **{k: v["launches"] for k, v in per_path.items()},
                         **bench_launches, "entry": entry_launches}
    check(all(n > 0 for n in launches_per_path.values()),
          f"a path launched no K1: {launches_per_path}")
    kernels = [{
        "name": decoder_cuda.KERNEL, "route": "cuda", "source": src,
        "replaces": "srsran_edgeric_5g_tpu/ops/ldpc/decoder_pallas.py:224",
        # K1 calls; a call with early stop over more than one codeblock
        # also launches resume_kernel (the group exit's rounds), counted
        # apart.
        "launches": fcx["launches"].get(decoder_cuda.KERNEL, 0),
        "resume_launches": fcx["launches"].get(decoder_cuda.KERNEL_RESUME, 0),
        "max_abs_err": max(max_err, zc40["max_abs_err"],
                           *(v["max_abs_err"] for v in per_path.values())),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": None, "launches_per_path": launches_per_path,
        "per_path": per_path,
    }, {
        "name": decoder_cuda.KERNEL_INT8, "route": "cuda", "source": src,
        "replaces": "srsran_edgeric_5g_tpu/ops/ldpc/decoder_pallas.py:273",
        "launches": k2["launches"], "max_abs_err": k2["max_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None,
    }]
    # The PDSCH kernels replace no Pallas kernel (the JAX package codes the
    # PDSCH with XLA ops); their main path is the SISO step's normal slots.
    siso = pdsch["siso_normal"]
    for name, key in (("pdsch_encode", "encode"), ("pdsch_modulate", "modulate")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "srsran_edgeric_5g_tpu_torch/csrc/pdsch_code.cu", "replaces": None,
            "launches": fcx["launches"].get(name, 0), "max_abs_err": 0.0,
            "ms": siso[f"{key}_ms"], "plain_ms": siso[f"{key}_plain_ms"],
            "bound_ms": siso[f"{key}_bound_ms"], "bound_by": "bytes", "library_ms": None,
            "per_path": {p: {k: v for k, v in r.items() if k.startswith(key)}
                         for p, r in pdsch.items()}})
    # pusch_demap replaces no Pallas kernel either (the JAX package runs the
    # PUSCH front with XLA ops); its main path is the SISO step's front.
    kernels.append({
        "name": "pusch_demap", "route": "cuda",
        "source": "srsran_edgeric_5g_tpu_torch/csrc/pusch_front.cu", "replaces": None,
        "launches": fcx["launches"].get("pusch_demap", 0), "max_abs_err": 0.0,
        "ms": pusch["siso"]["ms"], "plain_ms": pusch["siso"]["plain_ms"],
        "bound_ms": pusch["siso"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "per_path": pusch})
    check(all(math.isfinite(k["ms"]) and k["ms"] > 0 for k in kernels), "kernel times")
    emit("total", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
