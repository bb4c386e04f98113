#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  build     the card's name and power limit (nvidia-smi), then the build
            of the 33 kernels from csrc/ (nvcc, sm_90a) with its time
  scenario  the 30x30 grid regenerated by the port's gridgen into build/,
            compiled by the port's compiler
  kernels   K1-K4 against their plain PyTorch versions on the card, at
            the main path's 30x30 call-site shapes (B=128) with seeded
            numpy inputs; times, bounds and the library yardstick (K1 on
            the foe exchange's shape, the forward exchange's and its three
            ring-step call sites, each beside index_select; K2 reading
            seeded notifier fields through foe_src; K4 on both rings and
            in its lane-change mode, beside the earlier kernel's times);
            then K3, K2, K4 and T1 on every seeded edge case of
            tools/kernel_cases.py (K3 in every mode and instantiation the
            ring paths launch, K2 at R = 1-4 rows and KC = 1-20 crosses,
            both at B = 1, 3, 128 and 130; K4's lane, link and lane-change
            commits at B = 1, 3, 128 and 130, S = 128, MAX_CH channels,
            MAX_A candidates, then at S = 300 and 900, which the kernel
            takes in chunks of rows, with a shift or delete cap longer than
            a chunk's halo; T1 at TP = 1, 3 and 1024 on contiguous and
            misaligned indices), bit for bit; then G12 (f64 and f32, B =
            1, 3, 128 and 130, repeated least uids, misaligned views) bit
            for bit, L2 (both modes, S = 1, 40, 100 and 130) with
            do_change bit for bit and yv within 1e-5, L3 (LCI 1-8, both
            overflow bits, kernel and plain each on a fresh copy of the
            state it writes in place), L1 (neighbour columns out of
            order, NaN and -0.0 distances, S = 1, 40 and 200), G4 (every
            branch of the decision, reach ties, KC = 1-20), G15 (in
            place, each on a fresh copy; too few free slots, several scan
            chunks), L4 (both modes; S = 1-800, C = 1-4, uids near
            INT32_MAX, stale and unpaired matches) and G3 (f32 / f64,
            KC = 1-20, k_link = 1-40, ties, tails at the cross distance,
            NaN and -0.0, table gaps) bit for bit; O2 in both modes (P =
            1 to MAX_P = 64, ties, offsets clipped, 0 phases) and R2's
            exits stage (in place, each on a fresh copy; empty and full
            lanes, crossings past XK, the invalid clamp, removals, link
            blockers, lights over k_phase passes, B = 1, 3, 128 and 130)
            bit for bit (R2's t_rm within 1e-6 relative), with its 32-bit
            and its 64-bit offsets, and R2 refusing a strided view of the
            distances it writes
  agree     B=1 on the card (kernels) against the plain port on the CPU,
            20 steps: same vehicles on the same drivables, |dis| and
            |speed| within 2e-3, same finished count
  main      the main path (tools/bench.run_ring: p1 + p2 batched; the
            warm-up runs one env, copied into the batch) at B=128
            (asserted: no halving on out-of-memory); asserts
            overflow == 0, vehicles > 0, every env equal to env 0 bitwise,
            K1-K4, R1-R7 (R7 in its four modes) and K3's ring-leader mode
            (lane and link rows) launched, and K1 launched three times a
            step (no foe exchange: K2 reads it in place); prints ms per
            batched step,
            env-steps/s, the p1/p2 split, each kernel's share and peak
            memory
  kernels   (ring regions) R1 notify_winners, R2 ring_exits, R3
            ring_admit and R4 route_rows against their plain versions on
            every call of one more step of the main path's own state
            (bitwise; R2's t_rm within 1e-6 relative), timed (R3 on a
            fresh copy of its state each call, R2 on a fresh copy of the
            distances it clamps in place) beside their bounds; the
            same on [lc] (with R2's pair stages @pairs / @finish),
            [mixed] and [mixed-lc] (rows <kernel>@<path>); then R5
            front_leaders (approach mode; with lane change also its
            lane-change mode, front_leaders@ctx), R6 gap_refresh (lane
            change), R7 ring_pack (forward, @entrant, @candidate,
            @approach), K3's ring-leader mode (car_follow@ring lane rows,
            @ring-link link rows) and K2 reading the foe in place
            (cross_caps@link link rows, @approach approach rows) and K3's
            two approach-row calls (the isr mode, min_chain) on every
            call of one more step of each ring path, bit for bit against
            their plain versions, timed beside their bounds (rows
            <base>@<path>, or <base>:<path> for a mode); K4's two calls
            of one more step of each ring path ([main], [lc], [mixed],
            [mixed-lc], [rl]) bit for bit against its plain version,
            timed beside it and its bound (printed)
  agree-lc  lane change, B=1 on the card against the plain port on the
            CPU on tests/fixtures/config_1x1s_lc.json, 80 steps: vehicles
            keyed by (uid, shadow), drift within 2e-3, equal (changing,
            shadow) counts, changes happen; every L4 call on the card (the
            B=1 layout of the ring Engine's step, both modes) bit for bit
            against its plain version
  lc        the lane-change path on benchmarks/config_30x30_lc.json at
            B=128, lane slots 40 (tools/bench.run_ring_ladder, asserted not
            halved): LC_WARMUP warm-up steps, then 40 timed; the main
            path's asserts, plus L1-L4 (L4's match and gather modes) and
            both lane-change modes launched and shadows on the rings in
            the timed window
  kernels   (lane change) L1-L4 and the lane-change modes of K3 / K4
            against their plain versions on the inputs of one more step of
            the lc path's own state (L1, L3, L4 and K4 exact; L2's yv and
            K3 within 1e-5, their not-bitwise counts printed), timed (L3,
            which writes its state in place, on a fresh copy each call);
            L4: one match and two gathers a step, the match's leaves
            unchanged as the commit's pair rounds start and end, each
            gather at the match's match, and L4's time a step (all three
            calls) beside its bound; how many neighbour columns L1 read by
            its linear count; R1-R7 and K3's ring-leader mode as on
            [main]
  agree-mixed  non-uniform vehicle templates, B=1 card against CPU on
            tests/fixtures/config_2x2_mixed.json, 100 steps, skc=99
  mixed     the main path on the 30x30 grid with three vehicle templates
            (benchmarks/flow_30_30.json, flow i given template i mod 3 of
            tests/fixtures/flow_2x2_mixed.json; staged under build/) at
            B=128, lane slots build_sim's default (the densest template's
            capacity); [main]'s asserts, plus T1 and the template modes of
            K2 and K3 launched
  kernels   (templates) T1 and the template modes of K2 and K3 against
            their plain versions on every call of one more [mixed] step
            (T1, K2 exact; K3 within 1e-5), timed, T1 beside the library
            gather table[:, cols][tpl]
  agree-mixed-lc  tests/fixtures/config_1x1s_mixed_lc.json, 80 steps,
            sl=12, sk=6, skc=99, B=1 card against CPU as [agree-lc], L4
            checked as there
  mixed-lc  config_30x30_lc.json staged with the three templates at B=128,
            build_sim's shadow-insert cap for such a scenario: LC_WARMUP
            warm-up steps (the first step with shadows printed), 40 timed;
            [lc]'s asserts, plus T1 and the template modes of K3 (with and
            without v_yield), L1 and L2 launched; the most shadow inserts
            one lane asked for in one warm-up step (printed, and asserted
            within the cap; the window, which runs without that probe, is
            held to the cap by overflow == 0)
  kernels   (templates, lane change) on every call of one more [mixed-lc]
            step: T1, K2, L1, K4, L3 (with the tpl channel) and L4 (both
            modes) exact, K3 (template mode, with v_yield too) and L2
            within 1e-5, against their plain versions; L1, L2 and K3 at
            the v_yield lane call timed, L3 on fresh copies (row
            lc_insert@mixed-lc, and at the peak insert demand and at LCI
            8), L4's modes (rows lc_partner@mixed-lc,
            lc_partner@gather:mixed-lc) and its time a step; L1's linear
            counts
  agree-rl  the RL env (rl/env.RingVecEnv), B=1 on the card against the
            plain port on the CPU on tests/fixtures/config_4x4_rl.json, 60
            steps with MaxPressure every 5: equal actions at every decision,
            equal observations (avg_travel_time within 1e-5 relative)
  agree-hist  the DURATION router's lane-history window, B=1 card against
            CPU on config_2x2.json with routerType DURATION, 40 steps:
            h_num and h_ring_num equal, the speed sums within 1e-5 relative;
            O1's history mode launched
  rl        RingVecEnv on benchmarks/config_30x30.json at B=128, lane slots
            40: RL_WARMUP steps of one env under MaxPressure every 5 steps,
            copied into the batch, then 40 timed steps of step() with
            max_pressure_actions() every 5th (observations and controller
            timed in); asserts overflow == 0, vehicles > 0, every env equal
            to env 0 bitwise, O1 and O2 launched, a phase changed by the
            controller in the window; prints O1 / O2 shares and peak memory
  kernels   (RL) O1 lane_stats in its three modes and O2 phase_pressure in
            its two against their plain versions on the rl path's state
            (integer outputs exact, float sums within 1e-5 relative), timed
  dqn       rl/ring_dqn.make_ring_dqn_split_step from the rl path's state:
            4 iterations of 5 steps at eps 0.3; asserts a finite loss, the
            step advanced by 20, overflow 0, O2's features mode launched;
            then every O2 call of one more iteration bitwise against its
            plain version, the first timed
  golden-gen1  the gen-1 exact Engine (engine.Engine, float64) on the card
            against the reference goldens (tests/goldens, read here):
            grid4x4 300 steps, grid2x2_mixed 200, grid4x4_rl 200 under the
            RL phase schedule at atol=0; lc_single 175 steps (bitwise
            through 150, within 1e-6 with the same change events after);
            history_2x2_40 under routerType DURATION (window sums equal,
            durations within 1e-9 relative); replay_2x2_60 (the replay
            lines); fixtures staged under build/; G1-G12 launched in it
  agree-gen1  the Engine on benchmarks/config_30x30.json, 20 steps, card
            against CPU: every SimState leaf bitwise equal every 10 steps
  gen1      the Engine on config_30x30.json on the card: GEN1_WARMUP
            steps, then GEN1_STEPS timed; ms per step, vehicles, pool size
            and growths, G1-G4 and G9-G12 launches per step, their device
            time per step (CUDA events), the profiler's device time and
            busy share, peak memory; asserts finite state, vehicles > 0
            and those kernels launched
  kernels   (gen-1) G1-G4 and G9-G12 against their plain versions,
            bitwise, on every call of one more step of the gen1 path's
            state (a batch of one), timed (G10 beside
            torch.sort(stable=True) + torch.sum, G12 beside
            scatter_reduce("amin"))
  agree-gen1-lc  tests/fixtures/config_2x2_lc.json under routerType
            DURATION, AGREE_GEN1_LC_STEPS steps, card against CPU as
            [agree-gen1]; the steps with shadows counted (must be > 0)
  gen1-lc   the Engine on benchmarks/config_30x30_lc.json under routerType
            DURATION: GEN1_LC_WARMUP steps (past the first shadows), then
            GEN1_LC_STEPS timed; [gen1]'s prints for G1-G12 and the modes
            of G7 and G8, shadows in the window (must be > 0)
  kernels   (gen-1 lane change) G5-G8 (every mode of G7 and G8), G15,
            G11, G12, G4, G3 and G1 against their plain versions, bitwise,
            on every call of one more [gen1-lc] step; G5-G8 and G15 timed, G5
            beside the library's index_add_
  agree-fast  Engine(exact=False, backend="gen1") (float32) on
            tests/fixtures/config_4x4.json, 200 steps, card against CPU:
            every 10 steps the same vehicles on the same drivables, |dis|
            and |speed| within 2e-3; the same finished count
  gen1-fast  that Engine on config_30x30.json: [gen1]'s window and prints,
            G1-G4, G11 and G12 in float32, G2's fast branch, G9 and G10 in
            fast mode launched
  kernels   (fast mode) on every call of one more [gen1-fast] step: G1-G4,
            G11 and G12 float32 and G2 fast bitwise, G9 fast (and exact on the same
            blockers) bitwise, G10 fast (ints bitwise, the finish sum
            within 1e-6 relative) and exact on the same inputs (bitwise),
            one timed row each
  agree-gen1-lc-fast  config_2x2_lc.json staged with routerType DURATION
            in fast mode, 200 steps, card against CPU as [agree-fast],
            shadows counted (must be > 0); then G5-G8 in float32 against
            their plain versions on every call of one more step (G5's
            speed sums within 1e-6 relative, the rest bitwise)
  agree-ring-engine  Engine(exact=False) (the ring) on the card against
            the gen-1 fast Engine on the card, config_4x4.json, 200 steps,
            as [agree-fast]
  ring-engine  Engine(exact=False) on config_30x30.json (the ring at one
            env): RING_ENGINE_WARMUP steps, then RING_ENGINE_STEPS timed
            with get_lane_vehicle_count() every 5th step, as an RL caller
            reads; ms per step, the step alone, one fetch's ms, growths,
            the device busy share; K1-K4 and R1-R4 launched
  agree-gen1-batch  parallel/batch.make_batched_step (fast mode,
            rl_actions) at B=4 with its own phases per env every step on
            config_4x4.json, 40 steps, card against CPU as [agree-fast]
  agree-gen1-env  rl/env.CityFlowVecEnv at B=1 on config_4x4_rl.json, 60
            steps with MaxPressure every 5, card against CPU as [agree-rl]
  gen1-batch  the batched gen-1 fast step on config_30x30.json at B=128:
            one env (the Engine, growing its pool) runs GEN1B_WARMUP +
            GEN1B_STEPS steps, its state at GEN1B_WARMUP in that pool is
            copied into the batch, GEN1B_STEPS batched steps are timed;
            asserts overflow == 0, vehicles > 0, every env equal to env 0
            bitwise and G1-G4, G9-G12 launched; prints ms per batched
            step, env-steps/s, each kernel's share, the device busy share,
            kernels per step and peak memory
  kernels   (batched gen-1) on every call of one more [gen1-batch] step,
            each asserted to span the B=128 envs: G1-G4, G9, G10 (rows
            <name>@batch), G11 and G12 against their plain versions
            (bitwise; G10's fast finish sum within 1e-6 relative); G13 in
            both modes and G14 in its three on that state (counts and
            pressures bitwise, the in-flight sum within 1e-5 relative);
            timed, G12 beside scatter_reduce("amin"), G13 beside index_add_
  gen1-env  CityFlowVecEnv on config_30x30.json at B=128 with
            [gen1-batch]'s pool: GEN1B_WARMUP steps of one env under
            MaxPressure every 5, copied into the batch, GEN1B_STEPS timed
            steps with max_pressure_actions() every 5th; [gen1-batch]'s
            asserts, G13 / G14 launched and a phase changed by the
            controller; G4, G3 and G1 on every call of one more step
            against their plain versions (bitwise), and G4's funnel
  gen1-dqn  rl/dqn.train on config_30x30.json at B=16 from [gen1-env]'s
            warm state (one env at step GEN1B_WARMUP under MaxPressure,
            copied into the batch), 4 iterations of 5 steps: finite losses,
            a reward that is not zero, overflow 0, ms per iteration after
            the second; then G1 and G3 on every call of one more
            iteration from its final state (bitwise, not timed)
  agree-gen1-lc-batch  make_batched_step with lane change and the
            DURATION history on tests/fixtures/config_2x2_lc.json at B=4:
            one Engine's states at steps AGREE_GEN1_LCB_AT (past the first
            shadows, so the envs differ) stacked, 60 steps on the card
            against the same batch on the CPU and each env stepped alone
            on the card, in exact mode (everything bitwise) and fast mode
            (batched == alone bitwise, card vs CPU as [agree-fast]); the
            env-steps with shadows must be > 0
  gen1-lc-batch  the batched gen-1 fast step with lane change and DURATION
            on config_30x30_lc.json at B=128 (halved, with the reason
            printed, only if the card's memory runs out): [gen1-lc]'s
            state after its warm-up (step 1960, f64, in the pool [gen1-lc]
            ended with) cast to f32 through carry and copied into the
            batch, GEN1_LCB_STEPS timed steps; asserts overflow == 0,
            shadows in the window, every env equal to env 0 bitwise, G1-G12,
            G5-G8 and G15 launched; [gen1-batch]'s prints
  kernels   (batched lane change) on every call of one more [gen1-lc-batch]
            step, each asserted to span the batch: G5-G8 (every mode),
            G15 (in place: kernel and plain version each on a fresh copy),
            G4, G3 and G1 against their plain versions (bitwise; G5's
            speed sums within 1e-6 relative), timed (rows
            <name>@lcbatch; G15 on a fresh copy each call), G5 beside
            index_add_; G15 is also
            checked and timed at one env on [gen1-lc] (f64) and
            [agree-gen1-lc-fast] (f32), G3 and G4 checked on [gen1-lc];
            every G3 call checked asserts G1's table compacted. Each
            gen-1 path that checks G4 prints its funnel first: the
            crosses it considered, how many passed on !self_yield, on
            !o_exists, on t1 > t2, and how many needed reach_steps

The last three lines: the kernel table as JSON, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12              # float32 outside the tensor cores
H100_F64_FLOPS = 34e12              # float64 outside the tensor cores
BATCH = 128                         # envs on the main path and the kernels
STEPS = 40                          # timed main-path steps
WARMUP = 8                          # main-path steps before the timing
AGREE_STEPS = 20                    # card-vs-CPU agreement steps at B=1
AGREE_LC_STEPS = 80                 # the same on the lane-change fixture
LC_WARMUP = 1960                    # lc path steps before the timing: the
                                    # 30x30 routes run 31 roads straight,
                                    # and a vehicle changes lanes only on
                                    # its last road, from step 1779 on
REPS = 10                           # launches per kernel timing
AGREE_RL_STEPS = 60                 # RL env card-vs-CPU steps at B=1
AGREE_HIST_STEPS = 40               # history window card-vs-CPU steps
RL_WARMUP = 300                     # rl path: one env under MaxPressure
DQN_ITERS = 4                       # learner iterations of 5 steps each
MP_EVERY = 5                        # steps between MaxPressure decisions
GOLDEN_GEN1 = (                     # (fixture, golden, steps, RL schedule)
    ("config_4x4.json", "grid4x4_1000.jsonl.gz", 300, False),
    ("config_2x2_mixed.json", "grid2x2_mixed_1000.jsonl.gz", 200, False),
    ("config_4x4_rl.json", "grid4x4_rl_1000.jsonl.gz", 200, True))
AGREE_GEN1_STEPS = 20               # gen-1 card-vs-CPU steps on 30x30
GEN1_WARMUP = 300                   # gen-1 steps before the timing
GEN1_STEPS = 100                    # timed gen-1 steps
# the gen-1 step's kernels (each with an env axis; the Engine's one env is
# a batch of one)
GEN1_KERNELS = ("arrange", "leader_scan", "notify_cross", "cross_pass",
                "blocker_cycles", "update_location", "spawn_slots",
                "admit_heads")
GEN1_LC_KERNELS = ("hist_window", "lc_probe", "lc_plan", "lc_commit",
                   "shadow_insert")
GEN1_LC_MODES = ("lc_plan@signal", "lc_plan@receive", "lc_plan@decide",
                 "lc_plan@yield", "lc_commit@tail", "lc_commit@commit")
AGREE_GEN1_LC_STEPS = 200           # gen-1 lane change + DURATION card vs
                                    # CPU on config_2x2_lc.json (shadows
                                    # from step 70)
GEN1_LC_WARMUP = 1960               # gen-1 lane-change steps before the
                                    # timing (the 30x30 routes change lanes
                                    # on their last road, from about 1777)
GEN1_LC_STEPS = 100                 # timed gen-1 lane-change steps
AGREE_FAST_STEPS = 200              # gen-1 fast mode card vs CPU on 4x4
# the float32 / fast-branch modes of the gen-1 kernels on [gen1-fast] and
# (G5-G8) on [agree-gen1-lc-fast]
GEN1_FAST_MODES = ("arrange@f32", "leader_scan@fast", "notify_cross@f32",
                   "cross_pass@f32", "blocker_cycles@fast",
                   "update_location@fast", "spawn_slots@f32",
                   "admit_heads@f32")
GEN1_LC_F32 = ("hist_window@f32", "lc_probe@f32", "lc_plan@f32",
               "lc_commit@f32", "shadow_insert@f32")
FAST_BRANCH = ("leader_scan", "blocker_cycles", "update_location")
AGREE_RING_ENGINE_STEPS = 200       # ring Engine vs gen-1 fast, card, 4x4
RING_ENGINE_WARMUP = 300            # the ring Engine on 30x30 at one env
RING_ENGINE_STEPS = 100
GETTER_EVERY = 5                    # get_lane_vehicle_count every 5th step
AGREE_GEN1B_STEPS = 40             # batched gen-1 fast, card vs CPU, 4x4
AGREE_GEN1B_BATCH = 4
AGREE_GEN1_ENV_STEPS = 60           # CityFlowVecEnv B=1 card vs CPU, 4x4_rl
GEN1B_WARMUP = 300                  # one env of the 30x30 gen-1 fast step
GEN1B_STEPS = 40                    # timed batched gen-1 steps at BATCH
GEN1_DQN_BATCH = 16                 # gen-1 learner (rl/dqn.train) envs
GEN1_DQN_ITERS = 4
AGREE_GEN1_LCB_STEPS = 60           # batched lane change + DURATION, 2x2_lc
AGREE_GEN1_LCB_AT = (80, 95, 110, 125)  # the Engine steps (past the first
                                    # shadows, about step 70) stacked into
                                    # the B = 4 batch
AGREE_GEN1_LCB_POOL = 2048          # its pool (the batch does not grow)
GEN1_LCB_STEPS = 40                 # timed batched steps of 30x30_lc at
                                    # BATCH from [gen1-lc]'s step-1960 state
# the RL kernels of the batched gen-1 step
GEN1_RL_KERNELS = ("lane_counts", "phase_scores", "phase_scores@phases")
MAIN_KERNELS = ("gather_rows", "cross_caps", "car_follow", "ring_commit",
                "notify_winners", "ring_exits", "ring_admit", "route_rows",
                "front_leaders", "ring_pack", "ring_pack@entrant",
                "ring_pack@candidate", "ring_pack@approach",
                "cross_caps@approach", "car_follow@ring",
                "car_follow@ring-link")
# K1's launches a ring step: the avail rows, the end-lane and the
# start-lane bundles (the foe exchange is read in place by K2)
K1_PER_RING_STEP = 3
# the kernel wrappers core/ring.py calls by name
RING_CALLS = ("gather_rows", "cross_caps", "car_follow", "ring_commit",
              "notify_winners", "ring_exits", "ring_admit", "route_rows",
              "ring_exits_pairs", "ring_exits_finish", "front_leaders",
              "front_leaders_lc", "pack_forward", "pack_entrants",
              "pack_candidates", "pack_approach", "tpl_params")
LC_KERNELS = ("lc_signal", "lc_receive", "lc_insert", "lc_partner")
LC_MODES = ("lc_partner@gather", "car_follow@lc", "ring_commit@lc",
            "ring_exits@pairs",
            "ring_exits@finish", "ring_admit@lc", "route_rows@lc",
            "front_leaders@ctx", "gap_refresh")
AGREE_MIXED_STEPS = 100             # card-vs-CPU steps on the mixed fixture
TPL_MODES = ("tpl_params", "car_follow@tpl", "cross_caps@tpl",
             "notify_winners@tpl", "ring_admit@tpl")
TPL_LC_MODES = ("lc_signal@tpl", "lc_receive@tpl", "car_follow@tpl+lc",
                "gap_refresh@tpl")
RL_KERNELS = ("lane_stats", "phase_pressure")
# PR 12's times of the rows T1 and K4 were redesigned from (PERF.md;
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
PR12_MS = {"ring_commit": 4.7289, "ring_commit@link": 1.3791,
           "ring_commit@lc": 9.1619, "tpl_params": 1.2430}
REPLACES = {
    "gather_rows": "cityflow_tpu/core/ring.py:243 (_typed_mm), :300-341 "
                   "(exchanges), :881-927 (foe_perm)",
    "gather_rows@avail": "cityflow_tpu/core/ring.py:748-753 (_typed_mm "
                         "E_rl: the phases' available road links)",
    "gather_rows@et": "cityflow_tpu/core/ring.py:762-777 (_typed_mm E_end: "
                      "the end-lane tail bundle)",
    "gather_rows@st": "cityflow_tpu/core/ring.py:758-760, :779-787 "
                      "(_typed_mm E_start: the start-lane head bundle)",
    "gather_rows@in_src": "cityflow_tpu/core/ring.py:300-341 (_fwd_ex, "
                          "the forward exchange)",
    "cross_caps": "cityflow_tpu/core/ring.py:936 (cross_caps)",
    "car_follow": "cityflow_tpu/core/ring.py:998 (isr_speed), :1042 "
                  "(min_chain)",
    "ring_commit": "cityflow_tpu/core/ring.py:1744-1907 (commit_l)",
    "ring_commit@link": "cityflow_tpu/core/ring.py:1644-1742 "
                        "(shift_out/append_k)",
    "lc_signal": "cityflow_tpu/core/ring_lc.py:192-311 (lc_phase: "
                 "neighbour rings, makeSignal, gaps; _perm :52)",
    "lc_receive": "cityflow_tpu/core/ring_lc.py:313-367 (lc_phase: "
                  "receiveSignal, yieldSpeed)",
    "lc_insert": "cityflow_tpu/core/ring_lc.py:369-531 (lc_phase: winners, "
                 "shadow inserts)",
    "lc_partner": "cityflow_tpu/core/ring_lc.py:534-567 (partner_fetch: "
                  "the uid match, kept for the step's later calls)",
    "lc_partner@gather": "cityflow_tpu/core/ring_lc.py:534-567 "
                         "(partner_fetch in the commit's pair rounds, "
                         "ring.py:1484-1529: the fetch at the match)",
    "car_follow@lc": "cityflow_tpu/core/ring.py:1042-1092 (min_chain under "
                     "lane_change: v_yield, raw)",
    "ring_commit@lc": "cityflow_tpu/core/ring.py:1815-1857 (commit_l under "
                      "lane_change: the rank-preserving delete)",
    "lane_stats": "cityflow_tpu/core/ring_observe.py:24-27 "
                  "(lane_waiting_ring)",
    "lane_stats@obs": "cityflow_tpu/core/ring_observe.py:115-130 "
                      "(observations_ring: waiting, in-flight sums)",
    "lane_stats@hist": "cityflow_tpu/core/ring.py:210-236 (_update_history)",
    "phase_pressure": "cityflow_tpu/core/ring_observe.py:35-65 "
                      "(phase_pressures), :106-112 (max_pressure_phases_ring)",
    "phase_pressure@features": "cityflow_tpu/core/ring_observe.py:68-103 "
                               "(phase_features)",
    "arrange": "cityflow_tpu/core/step.py:48-115 (arrangement: the 3-key "
               "lax.sort :64, leaders, first/last, link tables)",
    "leader_scan": "cityflow_tpu/core/step.py:242-322 (leader_scan, exact "
                   "branch)",
    "notify_cross": "cityflow_tpu/core/step.py:467-594 (notify_cross: "
                    "winner chain, one-hot einsum :557-558, foe permutation "
                    ":586-588)",
    "cross_pass": "cityflow_tpu/core/step.py:682-751 (get_action's cross "
                  "loop, Cross::canPass)",
    "hist_window": "cityflow_tpu/core/step.py:970-999 (update_history)",
    "lc_probe": "cityflow_tpu/core/lanechange.py:42-96 (_probe_neighbors: "
                "the 3V lax.sort :62, cummax / cummin fills)",
    "lc_plan": "cityflow_tpu/core/lanechange.py:108-189 (plan_lane_change: "
               "makeSignal, target, gaps; _estimate_gap :99-105)",
    "lc_plan@receive": "cityflow_tpu/core/lanechange.py:191-206 (recv_for, "
                       "two scatter-max passes)",
    "lc_plan@decide": "cityflow_tpu/core/lanechange.py:208-226 (lc_recv, "
                      "gap validity, do_change)",
    "lc_plan@yield": "cityflow_tpu/core/lanechange.py:294-318 (yield_speed)",
    "lc_commit": "cityflow_tpu/core/step.py:807-826 (get_action's "
                 "lane-change tail)",
    "lc_commit@commit": "cityflow_tpu/core/step.py:909-942 (lc_commit)",
    "tpl_params": "cityflow_tpu/core/ring.py:270-297 (_PP, the template "
                  "one-hot einsum)",
    "blocker_cycles": "cityflow_tpu/core/step.py:597-615 (blocker_cycles, "
                      "exact: log2(V) pointer-doubling gathers)",
    "blocker_cycles@fast": "cityflow_tpu/core/step.py:597-615, cap :609 "
                           "(blocker_cycles, fast mode)",
    "update_location": "cityflow_tpu/core/step.py:830-881 (update_location: "
                       "nonzero + fori_loop ordered sum :848-854, argsort "
                       ":863)",
    "update_location@fast": "cityflow_tpu/core/step.py:855-857 "
                            "(update_location's fast unordered sum), :863",
    "leader_scan@fast": "cityflow_tpu/core/step.py:262-286, :311-314 "
                        "(leader_scan fast branch: cand_pack, one gather "
                        "per hop)",
    "arrange@f32": "cityflow_tpu/core/step.py:48-115 (arrangement, float32)",
    "notify_cross@f32": "cityflow_tpu/core/step.py:467-594 (notify_cross, "
                        "float32)",
    "cross_pass@f32": "cityflow_tpu/core/step.py:682-751 (get_action cross "
                      "loop, float32)",
    "hist_window@f32": "cityflow_tpu/core/step.py:970-999 (update_history, "
                       "float32)",
    "lc_probe@f32": "cityflow_tpu/core/lanechange.py:42-96 "
                    "(_probe_neighbors, float32)",
    "lc_plan@f32": "cityflow_tpu/core/lanechange.py:108-189, 191-226, "
                   "294-318 (plan_lane_change, yield_speed, float32)",
    "lc_commit@f32": "cityflow_tpu/core/step.py:807-826, 909-942 "
                     "(lane-change tail, lc_commit, float32)",
    "car_follow@tpl": "cityflow_tpu/core/ring.py:998-1092 (isr_speed, "
                      "min_chain with pp / lead_pp)",
    "car_follow@tpl+lc": "cityflow_tpu/core/ring.py:1042-1092 (min_chain "
                         "with pp / lead_pp under lane_change: v_yield, "
                         "raw)",
    "cross_caps@tpl": "cityflow_tpu/core/ring.py:936-996 (cross_caps with "
                      "pp)",
    "lc_signal@tpl": "cityflow_tpu/core/ring_lc.py:172-311 (lc_phase under "
                     "templates: len_s, lead_len, foll_neg, olt_len)",
    "lc_receive@tpl": "cityflow_tpu/core/ring_lc.py:313-361 (best_sneg, "
                      "neg_s)",
    "arrange@batch": "cityflow_tpu/core/step.py:48-115 (arrangement under "
                     "vmap: parallel/batch.py:48)",
    "leader_scan@batch": "cityflow_tpu/core/step.py:242-322 (leader_scan "
                         "under vmap, fast branch)",
    "notify_cross@batch": "cityflow_tpu/core/step.py:467-594 (notify_cross "
                          "under vmap)",
    "cross_pass@batch": "cityflow_tpu/core/step.py:682-751 (get_action's "
                        "cross loop under vmap)",
    "blocker_cycles@batch": "cityflow_tpu/core/step.py:597-615 "
                            "(blocker_cycles under vmap, fast mode)",
    "update_location@batch": "cityflow_tpu/core/step.py:830-881 "
                             "(update_location under vmap, fast sum)",
    "spawn_slots": "cityflow_tpu/core/step.py:329-396 (spawn_vehicles: "
                   "dynamic_slice, nonzero(size=MS), ~40 drop scatters)",
    "spawn_slots@f32": "cityflow_tpu/core/step.py:329-396 (spawn_vehicles, "
                       "float32)",
    "spawn_slots@batch": "cityflow_tpu/core/step.py:329-396 "
                         "(spawn_vehicles under vmap, float32; the state "
                         "donated as parallel/batch.py:92 donates it: in "
                         "place)",
    "admit_heads": "cityflow_tpu/core/step.py:398-443 (admit_waiting up to "
                   "the leader scan: scatter-min heads, lane pack)",
    "admit_heads@f32": "cityflow_tpu/core/step.py:398-443 (admit_waiting up "
                       "to the leader scan, float32)",
    "admit_heads@batch": "cityflow_tpu/core/step.py:398-443 (admit_waiting "
                         "up to the leader scan under vmap, float32)",
    "lane_counts": "cityflow_tpu/core/observe.py:14-35, :60-67 (lane and "
                   "waiting counts, _avg_travel_time)",
    "lane_counts@drivables": "cityflow_tpu/core/observe.py:30-35 "
                             "(drivable_vehicle_count)",
    "phase_scores": "cityflow_tpu/core/observe.py:38-45 "
                    "(intersection_pressure)",
    "phase_scores@phases": "cityflow_tpu/rl/policies.py:15-54 "
                           "(phase_pressures, max_pressure_phases)",
    "phase_scores@features": "cityflow_tpu/rl/dqn.py:60-85, :143-150 "
                             "(build_intersection_obs features, reward)",
    "phase_scores@features:gen1-dqn": "cityflow_tpu/rl/dqn.py:60-85, "
                                      ":143-150 (build_intersection_obs "
                                      "features, reward; the learner's B)",
    "shadow_insert": "cityflow_tpu/core/lanechange.py:228-291 (the shadow "
                     "insert: nonzero(size=MS) x2, ~40 drop scatters)",
    "shadow_insert@f32": "cityflow_tpu/core/lanechange.py:228-291 (the "
                         "shadow insert, float32)",
}
# the batched lane-change rows ([gen1-lc-batch], float32): the same
# regions under vmap (parallel/batch.py:48)
GEN1_LCB_ROWS = ("hist_window", "lc_probe", "lc_plan", "lc_plan@receive",
                 "lc_plan@decide", "lc_plan@yield", "lc_commit",
                 "lc_commit@commit", "shadow_insert", "cross_pass",
                 "notify_cross", "spawn_slots", "arrange")
REPLACES.update({f"{n}@lcbatch": REPLACES[n] + " under vmap "
                 "(parallel/batch.py:48), float32" for n in GEN1_LCB_ROWS})
# the ring step's regions (R1-R4), a row per ring path that runs them
RING_REPLACES = {
    "notify_winners": "cityflow_tpu/core/ring.py:789-864 (notify winners), "
                      ":866-879 (blocker doubling)",
    "ring_exits": "cityflow_tpu/core/ring.py:1462-1483, :1530-1566 (exits, "
                  "removals, leave prefixes), :1908-1929 (blocker commit, "
                  "lights)",
    "ring_admit": "cityflow_tpu/core/ring.py:489-643 (spawn + admission)",
    "route_rows": "cityflow_tpu/core/ring.py:1567-1642 (route compaction)"}
RING_PATH_NOTE = {"lc": " under lane_change", "mixed": " with templates",
                  "mixed-lc": " with templates under lane_change"}
REPLACES.update(RING_REPLACES)
REPLACES["lc_insert@mixed-lc"] = REPLACES["lc_insert"] \
    + " with templates (a shadow copies its template)"
REPLACES["lc_partner@mixed-lc"] = REPLACES["lc_partner"] + " with templates"
REPLACES["lc_partner@gather:mixed-lc"] = REPLACES["lc_partner@gather"] \
    + " with templates"
REPLACES.update({f"{n}@{p}": v + RING_PATH_NOTE[p]
                 for n, v in RING_REPLACES.items() for p in RING_PATH_NOTE})
for _p in ("", ":mixed-lc"):
    REPLACES[f"ring_exits@pairs{_p}"] = (
        "cityflow_tpu/core/ring.py:1484-1515 (the pair bookkeeping: aborts, "
        "lateral offset)" + ("" if not _p else " with templates"))
    REPLACES[f"ring_exits@finish{_p}"] = (
        "cityflow_tpu/core/ring.py:1515-1529, :1545-1550 (the pair "
        "bookkeeping: finish, promote, unlinks, aborted shadows' stats)"
        + ("" if not _p else " with templates"))


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


def time_cuda(fn, reps):
    """Mean device time of fn() in ms over `reps` launches (CUDA events,
    after one warm-up call). The device first spins for about 0.1 s, so
    the host has queued the launches before the first one starts: a
    kernel shorter than its launch overhead is timed on the device, not
    at the host's launch rate."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel checks at the 30x30 call-site shapes
# ---------------------------------------------------------------------------

def kernel_row(name, err, ms, plain_ms, nbytes, nops, lib_ms,
               flops=H100_F32_FLOPS):
    """One row of the kernel table; `name` is the kernel, or kernel@site
    for a second call site or a mode of it. The bound is the larger of the
    bytes over the memory rate and the operations over `flops` (the f32
    rate; the f64 rate for the gen-1 kernels)."""
    bound = max(nbytes / H100_BYTES_PER_S, nops / flops) * 1e3
    log(f"[kernels] {name}: max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} "
        f"library_ms={lib_ms}")
    return dict(
        name=name, route="cuda",
        source=f"cityflow_tpu_torch/csrc/{name.split('@')[0]}.cu",
        replaces=REPLACES[name], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if nbytes / H100_BYTES_PER_S
        >= nops / flops else "operations",
        library_ms=lib_ms)


def check_kernels(sim, B, reps):
    import numpy as np
    import torch
    from cityflow_tpu_torch.kernels import (
        car_follow, cross_caps, gather_rows, ring_commit)
    from cityflow_tpu_torch.core.ring import _Ctx

    cfg, net = sim.cfg, sim.tables
    dev = sim.device
    rng = np.random.default_rng(0)
    T = lambda a: torch.as_tensor(a, device=dev).contiguous()
    cx = _Ctx(net, cfg, dev)
    rows = []
    LKp, LNp, KC, SK, SL = cfg.LKp, cfg.LNp, cfg.KC, cfg.SK, cfg.SL
    IL, G, LPI, AP = cfg.IL, cfg.G, cfg.LPI, cfg.AP

    row = lambda *a: rows.append(kernel_row(*a))

    # ---- K1: the foe exchange's shape (9 channels of R1's fields; no
    #      ring path launches it there, K2 reads the foe in place), the
    #      forward exchange's (lane -> in-lane, 14 AP + 2 channels) and the
    #      three call sites of the ring step (avail rows, end-lane and
    #      start-lane bundles), each bitwise and beside index_select
    def k1_row(name, x, idx):
        got = gather_rows.gather_rows(x, idx, 0.0)
        want = gather_rows.gather_rows_plain(x, idx, 0.0)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            f"{name} mismatch"
        del got, want
        ms = time_cuda(lambda: gather_rows.gather_rows(x, idx, 0.0), reps)
        plain = time_cuda(lambda: gather_rows.gather_rows_plain(x, idx, 0.0),
                          reps)
        il = idx.clamp(min=0).long()
        lib = time_cuda(lambda: x.index_select(1, il), reps)
        C, _, Bx = x.shape
        nsrc = int(torch.unique(idx[idx >= 0]).numel())
        nbytes = 4 * (C * nsrc * Bx + C * idx.numel() * Bx + idx.numel())
        log(f"[kernels] {name}: x {tuple(x.shape)} -> "
            f"({C}, {idx.numel()}, {Bx})")
        row(name, 0.0, ms, plain, nbytes, 0, lib)

    fidx = net["foe_src"]
    k1_row("gather_rows", T(rng.standard_normal((9, KC * LKp, B))
                            .astype(np.float32)), fidx)
    k1_row("gather_rows@in_src", T(rng.standard_normal((14 * AP + 2, LNp, B))
                                   .astype(np.float32)),
           net["in_src"].reshape(-1))
    MAXRL = net["phase_rl_avail"].shape[1]
    k1_row("gather_rows@avail", T((rng.random((1, MAXRL * G, B)) < 0.5)
                                  .astype(np.float32)), net["rl_src"])
    k1_row("gather_rows@et", T(rng.standard_normal((6, LNp, B))
                               .astype(np.float32)), net["end_src"])
    k1_row("gather_rows@st", T(rng.standard_normal((7, IL * G, B))
                               .astype(np.float32)), net["start_src"])

    # ---- K2: link rows, R = SKC, the foe read in place from seeded
    #      notifier fields through foe_src
    R = min(cfg.SKC, SK)
    f32 = lambda *s, lo=0.0, hi=1.0: T(rng.uniform(lo, hi, s)
                                        .astype(np.float32))
    dls = f32(R, LKp, B, lo=-20.0, hi=80.0)
    speed = f32(R, LKp, B, lo=0.0, hi=17.0)
    ent = T(rng.integers(0, 300, (R, LKp, B)).astype(np.float32))
    ph = T(rng.integers(-3, 3, (R, LKp, B)).astype(np.float32))
    plo = T(rng.integers(0, 4, (R, LKp, B)).astype(np.float32))
    rel = T(rng.random((R, LKp, B)) < 0.7)
    NF = KC * LKp
    fields = torch.stack([
        T((rng.random((NF, B)) < 0.5).astype(np.float32))
        for _ in range(4)] + [
        T(rng.integers(0, 256, (NF, B)).astype(np.float32)),
        f32(NF, B, lo=-10.0, hi=60.0),
        T(rng.integers(0, 300, (NF, B)).astype(np.float32)),
        T(rng.integers(-3, 3, (NF, B)).astype(np.float32)),
        T(rng.integers(0, 4, (NF, B)).astype(np.float32))])
    args = (dls, speed, ent, ph, plo, rel, fields, fidx, cx.cc_tabs,
            cx.prm_cc)
    got = cross_caps.cross_caps(*args)
    want = cross_caps.cross_caps_plain(*args)
    err, nbit = _bitwise("cross_caps", got, want)
    log(f"[kernels] cross_caps: not_bitwise={nbit}")
    assert nbit == 0, "cross_caps mismatch"
    ms = time_cuda(lambda: cross_caps.cross_caps(*args), reps)
    plain = time_cuda(lambda: cross_caps.cross_caps_plain(*args), reps)
    row("cross_caps", err, ms, plain,
        *cross_caps_work(args, {}), None)
    del fields, got, want

    # ---- K3: link rows, mode 3 (isr + min_chain)
    shp = (SK, LPI, G, B)
    kin = dict(
        speed=f32(*shp, hi=17.0), dls=f32(*shp, hi=80.0),
        isr_lane_left=0.0, any_fail=T(rng.random(shp) < 0.3),
        ff_d=f32(*shp, hi=90.0), app=False,
        avail=T(rng.random((LPI, G, B)) < 0.5),
        can_enter=T(rng.random((LPI, G, B)) < 0.5),
        turn=net["lk_turn"].reshape(LPI, G, 1), gap=f32(*shp, lo=-5.0,
                                                        hi=100.0),
        lead_spd=f32(*shp, hi=17.0), has_lead=T(rng.random(shp) < 0.8),
        isr_rel=True, custom=f32(*shp, hi=17.0),
        has_custom=T(rng.random(shp) < 0.1), drv_maxspd=10000.0,
        invalid=False, lane_left=0.0)
    got = car_follow.car_follow(3, cx.prm_cf, shp, **kin)
    want = car_follow.car_follow_plain(3, cx.prm_cf, shp, **kin)
    err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
    nbit = sum(int((g_ != w_).sum()) for g_, w_ in zip(got, want))
    log(f"[kernels] car_follow: max_abs_err={err} not_bitwise={nbit}")
    assert err <= 1e-5, "car_follow mismatch"
    # lane rows, mode 2
    lshp = (SL, LNp, B)
    lin = dict(speed=f32(*lshp, hi=17.0), gap=f32(*lshp, lo=-5.0, hi=100.0),
               lead_spd=f32(*lshp, hi=17.0),
               has_lead=T(rng.random(lshp) < 0.8), v_isr=0.0, isr_rel=False,
               custom=f32(*lshp, hi=17.0),
               has_custom=T(rng.random(lshp) < 0.1),
               drv_maxspd=net["ln_maxspd"][:, None],
               invalid=T(rng.random(lshp) < 0.05),
               lane_left=f32(*lshp, lo=-2.0, hi=300.0))
    got = car_follow.car_follow(2, cx.prm_cf, lshp, **lin)
    want = car_follow.car_follow_plain(2, cx.prm_cf, lshp, **lin)
    err2 = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
    nbit2 = _bitwise("car_follow (lane rows)", got, want)[1]
    assert err2 <= 1e-5, "car_follow (lane rows) mismatch"
    got = car_follow.car_follow(2, cx.prm_cf, lshp, raw=True, **lin)
    want = car_follow.car_follow_plain(2, cx.prm_cf, lshp, raw=True, **lin)
    err2 = max(err2, float((got - want).abs().max()))
    nbit2 += _bitwise("car_follow (raw)", got, want)[1]
    assert err2 <= 1e-5, "car_follow (raw) mismatch"
    # approach rows, mode 1 (isr only)
    ashp = (AP, LPI, G, B)
    ain = dict(speed=f32(*ashp, hi=17.0), dls=f32(*ashp, lo=-30.0, hi=5.0),
               isr_lane_left=f32(*ashp, lo=-5.0, hi=80.0),
               any_fail=T(rng.random(ashp) < 0.3), ff_d=f32(*ashp, hi=90.0),
               app=True, avail=T(rng.random((LPI, G, B)) < 0.5),
               can_enter=T(rng.random((LPI, G, B)) < 0.5),
               turn=net["lk_turn"].reshape(LPI, G, 1))
    got = car_follow.car_follow(1, cx.prm_cf, ashp, **ain)
    want = car_follow.car_follow_plain(1, cx.prm_cf, ashp, **ain)
    assert torch.equal(got[1], want[1]), "car_follow (isr) red_stop mismatch"
    err2 = max(err2, float((got[0] - want[0]).abs().max()))
    nbit2 += _bitwise("car_follow (isr)", got, want)[1]
    assert err2 <= 1e-5, "car_follow (isr) mismatch"
    log(f"[kernels] car_follow lane rows, raw, isr: max_abs_err={err2} "
        f"not_bitwise={nbit2}")
    err = max(err, err2)
    ms = time_cuda(lambda: car_follow.car_follow(2, cx.prm_cf, lshp, **lin),
                   reps)
    plain = time_cuda(
        lambda: car_follow.car_follow_plain(2, cx.prm_cf, lshp, **lin), reps)
    row("car_follow", err, ms, plain, *k3_work((2, cx.prm_cf, lshp), lin),
        None)

    # ---- K4: lane ring (12 channels, A = KIN * XK candidates sorted) and
    #      link ring (entrants in order, the entry step as a per-env value)
    #      on seeded inputs, bitwise, each beside its PR 12 time
    seeded = seeded_commit_calls(sim, B, rng)
    for label in ("ring_commit", "ring_commit@link"):
        a, k, nbytes = seeded[label]
        got = ring_commit.ring_commit(*a, **k)
        want = ring_commit.ring_commit_plain(*a, **k)
        _, bad = _bitwise(label, got, want)
        log(f"[kernels] {label} (seeded): not_bitwise={bad}")
        assert bad == 0, f"{label} mismatch"
        del got, want
        ms = time_cuda(lambda: ring_commit.ring_commit(*a, **k), reps)
        plain = time_cuda(lambda: ring_commit.ring_commit_plain(*a, **k),
                          reps)
        log(f"[kernels] {label}: ms={ms:.4f} (PR 12: {PR12_MS[label]})")
        row(label, 0.0, ms, plain, nbytes, 0, None)
    a, k, _ = seeded["ring_commit@lc-seeded"]
    _, bad = _bitwise("ring_commit@lc-seeded",
                      ring_commit.ring_commit(*a, **k),
                      ring_commit.ring_commit_plain(*a, **k))
    log(f"[kernels] ring_commit@lc-seeded: {len(a[0])} channels, "
        f"not_bitwise={bad}")
    assert bad == 0, "ring_commit (seeded lane-change mode) mismatch"
    del seeded, a, k
    check_kernel_cases()
    return rows


def commit_bytes(chans, keep, app, valid_ch, nsel, extra):
    """K4's bytes: per channel a column reads its `keep` surviving slots
    and writes all S; of the candidates (A, PCH, N', B) it reads every
    valid flag, the sort key of the valid ones and the entrant channels of
    the ones it takes; plus `extra` (counts, masks)."""
    upd = chans[0][0]
    esz = sum(c[0].element_size() for c in chans)
    A, _, AC, B = app.shape
    nvalid = (app[:, valid_ch] > 0.5).sum(0)
    taken = int(nvalid.clamp(max=nsel).sum())
    n_app_ch = sum((c[3] >= 0) + (c[1] == "pri") for c in chans)
    return (esz * (keep + upd.numel()) + extra
            + 4 * (A * AC * B + int(nvalid.sum()) + n_app_ch * taken))


def seeded_commit_calls(sim, B, rng):
    """K4's seeded calls at the 30x30 shapes: {label: ((chans, x, base,
    app), kwargs, bytes)} for the lane commit ("ring_commit": 12
    channels, A = KIN * XK candidates stably sorted), the link commit
    ("ring_commit@link": 5 channels, the entrants in order, one channel
    of the per-env entry step), drawn in that order as before, and the
    lane-change delete mode
    ("ring_commit@lc-seeded": the lane commit's channels, 5 + 2 MAXLPR
    more, a delete mask over about 5% of the slots, XD = XK + LCD)."""
    import numpy as np
    import torch
    cfg, dev = sim.cfg, sim.device
    T = lambda a: torch.as_tensor(a, device=dev).contiguous()
    f32 = lambda *s, lo=0.0, hi=1.0: T(rng.uniform(lo, hi, s)
                                        .astype(np.float32))
    SL, SK, LNp, LKp, G, AP = cfg.SL, cfg.SK, cfg.LNp, cfg.LKp, cfg.G, \
        cfg.AP
    XK = cfg.XK
    A = cfg.KIN * min(XK, SK)
    n_l = T(rng.integers(0, SL + 1, (LNp, B)).astype(np.int32))
    x_l = torch.minimum(n_l, T(rng.integers(0, XK + 1, (LNp, B))
                               .astype(np.int32)))
    app = torch.stack([f32(14, cfg.OL * G, B, lo=0.0, hi=30.0)
                       for _ in range(A)])
    app[:, 13] = T((rng.random((A, cfg.OL * G, B)) < 0.3).astype(np.float32))
    app[:, 2:5] = app[:, 2:5].floor()
    app[:, 6:13] = app[:, 6:13].floor()
    iring = lambda lo, hi: T(rng.integers(lo, hi, (SL, LNp, B))
                             .astype(np.int32))
    chans = [(f32(SL, LNp, B, hi=300.0), "f32", 0.0, 0, 0),
             (f32(SL, LNp, B, hi=17.0), "f32", 0.0, 1, 0),
             (iring(0, 100), "i32", 0.0, 2, 0),
             (iring(0, 100), "i32", 0.0, 3, 0),
             (iring(0, 10), "i32", 0.0, 4, 0),
             (f32(SL, LNp, B, hi=300.0), "f32", 0.0, 5, 0),
             (iring(-2**31, 2**31 - 1), "pri", 0.0, 6, 7),
             (iring(-1, 10**6), "i32", -1.0, 8, 0),
             (iring(-1, 50000), "i32", -1.0, 9, 0),
             (iring(-1, 50000), "i32", -1.0, 10, 0),
             (T(rng.random((SL, LNp, B)) < 0.2), "bool", 0.0, 11, 0),
             (iring(-1, 50000), "i32", -1.0, 12, 0)]
    kw = dict(valid_ch=13, sort_ch=0, nsel=min(cfg.SA, A), XK=XK,
              app_I=cfg.I, app_G=G)
    out = {"ring_commit": (
        (chans, x_l, n_l - x_l, app), kw,
        commit_bytes(chans, int((SL - x_l).sum()), app, kw["valid_ch"],
                     kw["nsel"], 2 * LNp * B * 4))}
    n_k = T(rng.integers(0, SK + 1, (LKp, B)).astype(np.int32))
    x_k = torch.minimum(n_k, T(rng.integers(0, XK + 1, (LKp, B))
                               .astype(np.int32)))
    ent = f32(AP, 11, LKp, B, hi=30.0).floor()
    ent[:, 0] = T((rng.random((AP, LKp, B)) < 0.3).astype(np.float32))
    kring = lambda lo, hi: T(rng.integers(lo, hi, (SK, LKp, B))
                             .astype(np.int32))
    kch = [(f32(SK, LKp, B, hi=60.0), "f32", 0.0, 1, 0),
           (kring(0, 100), "i32", 0.0, 3, 0),
           (kring(-2**31, 2**31 - 1), "pri", 0.0, 7, 8),
           (kring(-1, 10**6), "i32", -1.0, 9, 0),
           (kring(0, 2**31 - 1), "i32", float(2**31 - 1), -1, 0)]
    kkw = dict(valid_ch=0, sort_ch=-1, nsel=AP, XK=XK,
               envval=T(np.full(B, 7.0, np.float32)))
    out["ring_commit@link"] = (
        (kch, x_k, n_k - x_k, ent), kkw,
        commit_bytes(kch, int((SK - x_k).sum()), ent, kkw["valid_ch"],
                     kkw["nsel"], 2 * LKp * B * 4 + B * 4))
    # the lane-change mode: the pair channels (offset, shadow, changing,
    # direction, gap, MAXLPR route rows and aux rows) take an entrant's
    # valid flag (13), its distance (0) or its previous lane (12)
    lch = [(f32(SL, LNp, B, lo=-1.0, hi=1.0), "f32", 0.0, 13, 0),
           (T(rng.random((SL, LNp, B)) < 0.05), "bool", 0.0, 13, 0),
           (T(rng.random((SL, LNp, B)) < 0.05), "bool", 0.0, 13, 0),
           (iring(-1, 2), "i32", 0.0, 13, 0),
           (f32(SL, LNp, B, hi=50.0), "f32", 0.0, 0, 0)] \
        + [(iring(-1, 50000), "i32", -1.0, 12, 0)
           for _ in range(2 * cfg.MAXLPR)]
    dmask = T(rng.random((SL, LNp, B)) < 0.05)
    XD = min(XK + cfg.LCD, SL)
    lkw = dict(kw, dmask=dmask, XD=XD)
    lbase = n_l - dmask.sum(0, dtype=torch.int32)
    out["ring_commit@lc-seeded"] = (
        (chans + lch, None, lbase, app), lkw,
        commit_bytes(chans + lch, int((~dmask).sum()), app, kw["valid_ch"],
                     kw["nsel"], dmask.numel() + LNp * B * 4))
    return out


def check_kernel_cases():
    """K4, T1, K3, K2, L2, G12, L3, L1, G4 and G15 against their plain
    versions on every seeded edge case of tools/kernel_cases.py (the cases
    the CPU tests hold the plain versions to against numpy walks), bit for
    bit but L2's yv
    (within 1e-5, as on its path; its not-bitwise count printed): K4's
    lane, link and lane-change commits at B = 1, 3, 128 and 130, S = 128,
    MAX_CH channels, MAX_A candidates, and at S = 300 and 900 (chunks of
    rows); T1 at TP = 1, 3 and 1024 on contiguous and misaligned index
    views; K3 in every mode and instantiation the ring paths launch, K2
    at R = 1 to 4 and KC = 1 to 20, both at B = 1, 3, 128 and 130 (K2
    also 33); L2 in both modes at S = 1, 40, 100 and 130 (rings longer
    than one table of its receivers); G12 in f64 and f32, V not a
    multiple of four and misaligned views; L3 (in place: kernel and plain
    each on its own fresh copy) at LCI 1, 2, 3, 4 and 8 with both overflow
    bits, and L1 on neighbour columns out of order, with NaN and -0.0
    distances, at S = 1, 40 and 200 (a narrower env tile), both with
    templates; G4 (f32 and f64, B = 1, 3, 128 and
    130, KC = 1 to 20: every branch of the decision, reach ties, NaN and
    -0.0) and G15 (in place:
    each on its own fresh copy; no changer, more changers than MS, too few
    free slots, MS = 1, several scan chunks, misaligned views), L4 (both
    modes: the match, then the gather at the kernel's match, of the same
    channels and of others; B = 1, 3, 40, 128 and 130, S = 1 to 800, C =
    1 to 4) and G3 (f32 and f64, B = 1, 3, 128 and 130, KC = 1 to 20,
    k_link = 1 to 240: blocks of 8 and 16 threads too, no candidate, ties,
    tails at the cross distance, NaN and -0.0, links past k_link; the
    candidates from sorted_idx / drv_off and the leaves), G1 (f32 and
    f64, B = 1, 3, 128 and 130: ties in -dis and list_seq, -0.0 against
    +0.0, NaN, a bucket past a rank block, exactly k_link and k_link + 1
    on a lanelink, empty drivables and envs, V off the tile), G7's yield
    mode (no receiver, every slot one, a sender leading its receiver, no
    target follower, negative caps, rows off a 16-byte word), G11 in both
    forms (copying; in place, kernel
    and plain each on its own fresh copy: full pools, fewer free slots
    than due rows, windows clamped at the table's end, nothing due, free
    slots past several scan tiles, MS = 1, V not a multiple of 16,
    misaligned views (in place only: the copying form refuses them); f32
    and f64, B = 1 to 130) and G5 in both forms
    (hist_t below, at and past the ring's length, empty lanes and envs,
    f32 and f64, B = 1 to 130, misaligned views)."""
    import torch
    from cityflow_tpu_torch.kernels import (
        admit_heads, arrange, car_follow, cross_caps, cross_pass,
        hist_window, lc_insert, lc_plan, lc_receive, lc_signal,
        notify_cross, phase_pressure, ring_commit, ring_exits,
        shadow_insert, spawn_slots, tpl_params)
    from cityflow_tpu_torch.tools import kernel_cases as kc
    n = 0
    for name, case in kc.follow_cases():
        a, k = kc.follow_args(case, "cuda")
        _, bad = _bitwise(f"car_follow[{name}]",
                          car_follow.car_follow(*a, **k),
                          car_follow.car_follow_plain(*a, **k))
        assert bad == 0, f"car_follow[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.caps_cases():
        a, k = kc.caps_args(case, "cuda")
        _, bad = _bitwise(f"cross_caps[{name}]",
                          cross_caps.cross_caps(*a, **k),
                          cross_caps.cross_caps_plain(*a, **k))
        assert bad == 0, f"cross_caps[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.commit_cases():
        a, k = kc.commit_args(case, "cuda")
        _, bad = _bitwise(f"ring_commit[{name}]",
                          ring_commit.ring_commit(*a, **k),
                          ring_commit.ring_commit_plain(*a, **k))
        assert bad == 0, f"ring_commit[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.tpl_cases():
        a = kc.tpl_args(case, "cuda")
        _, bad = _bitwise(f"tpl_params[{name}]", tpl_params.tpl_params(*a),
                          tpl_params.tpl_params_plain(*a))
        assert bad == 0, f"tpl_params[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.admit_cases():
        a = kc.admit_args(case, "cuda")
        _, bad = _bitwise(f"admit_heads[{name}]", admit_heads.admit_heads(*a),
                          admit_heads.admit_heads_plain(*a))
        assert bad == 0, f"admit_heads[{name}]: {bad} values differ"
        n += 1
    err, nbit = 0.0, 0
    for name, case in kc.receive_cases():
        a, k = kc.receive_args(case, "cuda")
        e, nb = _compare(f"lc_receive[{name}]", lc_receive.lc_receive(*a, **k),
                         lc_receive.lc_receive_plain(*a, **k), 1e-5)
        err, nbit = max(err, e), nbit + nb
        n += 1
    for name, case in kc.insert_cases():
        _, bad = _bitwise(
            f"lc_insert[{name}]",
            lc_insert.lc_insert(*kc.insert_args(case, "cuda")),
            lc_insert.lc_insert_plain(*kc.insert_args(case, "cuda")))
        assert bad == 0, f"lc_insert[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.signal_cases():
        a, k = kc.signal_args(case, "cuda")
        _, bad = _bitwise(f"lc_signal[{name}]", lc_signal.lc_signal(*a, **k),
                          lc_signal.lc_signal_plain(*a, **k))
        assert bad == 0, f"lc_signal[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.cross_cases():
        a = kc.cross_args(case, "cuda")
        _, bad = _bitwise(f"cross_pass[{name}]", cross_pass.cross_pass(*a),
                          cross_pass.cross_pass_plain(*a))
        assert bad == 0, f"cross_pass[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.shadow_cases():
        _, bad = _bitwise(
            f"shadow_insert[{name}]",
            shadow_insert.shadow_insert(*kc.shadow_args(case, "cuda")),
            shadow_insert.shadow_insert_plain(*kc.shadow_args(case, "cuda")))
        assert bad == 0, f"shadow_insert[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.partner_cases():
        check_partner_case(name, case)
        n += 1
    for name, case in kc.spawn_cases():
        for inplace in (name not in kc.SPAWN_COPY_CASES, True):
            _, bad = _bitwise(
                f"spawn_slots[{name}]",
                spawn_slots.spawn_slots(*kc.spawn_args(case, "cuda"),
                                        inplace=inplace),
                spawn_slots.spawn_slots_plain(*kc.spawn_args(case, "cuda"),
                                              inplace=inplace))
            assert bad == 0, f"spawn_slots[{name}]: {bad} values differ " \
                f"(inplace={inplace})"
        n += 1
    for name, case in kc.hist_cases():
        for inplace in (False, True):
            _, bad = _bitwise(
                f"hist_window[{name}]",
                hist_window.hist_window(*kc.hist_args(case, "cuda"),
                                        inplace=inplace),
                hist_window.hist_window_plain(*kc.hist_args(case, "cuda"),
                                              inplace=inplace))
            assert bad == 0, f"hist_window[{name}]: {bad} values differ " \
                f"(inplace={inplace})"
        n += 1
    for name, case in kc.notify_cases():
        a = kc.notify_args(case, "cuda")
        _, bad = _bitwise(f"notify_cross[{name}]",
                          notify_cross.notify_cross(*a),
                          notify_cross.notify_cross_plain(*a))
        assert bad == 0, f"notify_cross[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.arrange_cases():
        a = kc.arrange_args(case, "cuda")
        _, bad = _bitwise(f"arrange[{name}]", arrange.arrange(*a),
                          arrange.arrange_plain(*a))
        assert bad == 0, f"arrange[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.yield_cases():
        st, net = kc.yield_args(case, "cuda")
        _, bad = _bitwise(f"lc_plan@yield[{name}]",
                          lc_plan.lc_plan("yield", st, net, 1),
                          lc_plan.lc_plan_plain("yield", st, net, 1))
        assert bad == 0, f"lc_plan@yield[{name}]: {bad} values differ"
        n += 1
    for name, case in kc.pressure_cases():
        for features in (False, True):
            a = kc.pressure_args(case, "cuda")
            _, bad = _bitwise(
                f"phase_pressure[{name}]",
                phase_pressure.phase_pressure(*a, features=features),
                phase_pressure.phase_pressure_plain(*a, features=features))
            assert bad == 0, f"phase_pressure[{name}]: {bad} values " \
                f"differ (features={features})"
        n += 1
    trm = 0.0
    for name, case in kc.exits_cases():
        want = ring_exits.ring_exits_plain(*kc.exits_args(case, "cuda"))
        for wide in (False, True):
            a = kc.exits_args(case, "cuda")
            with exits_offsets(wide):
                got = ring_exits.ring_exits(*a)
            tag = f"{name}@64-bit" if wide else name
            assert got["dis_l"] is a[3]["new_dis_l"], \
                f"ring_exits[{tag}]: the clamp not in place"
            trm = max(trm, check_exits_case(tag, got, want))
        n += 1
    # a view of the new distances that is not contiguous is refused
    a = kc.exits_args(kc.exits_case(kc.EXITS_CASES[0]), "cuda")
    nd = a[3]["new_dis_l"]
    wide = torch.empty(nd.shape[:-1] + (2 * nd.shape[-1],), dtype=nd.dtype,
                       device=nd.device)
    a[3]["new_dis_l"] = wide[..., ::2]
    try:
        ring_exits.ring_exits(*a)
        raise AssertionError("ring_exits took a strided new_dis_l")
    except ValueError:
        pass
    torch.cuda.synchronize()
    cases = (kc.FOLLOW_CASES, kc.CAPS_CASES, kc.COMMIT_CASES, kc.TPL_CASES,
             kc.ADMIT_CASES, kc.RECEIVE_CASES, kc.INSERT_CASES,
             kc.SIGNAL_CASES, kc.CROSS_CASES, kc.SHADOW_CASES,
             kc.PARTNER_CASES, kc.NOTIFY_CASES, kc.ARRANGE_CASES,
             kc.YIELD_CASES, kc.SPAWN_CASES, kc.HIST_CASES,
             kc.PRESSURE_CASES, kc.EXITS_CASES)
    log(f"[kernels] K3 / K2 / K4 / T1 / G12 / L2 / L3 / L1 / G4 / G15 / L4 "
        f"/ G3 / G1 / G7 yield / G11 / G5 (both forms each) / O2 (both "
        f"modes) / R2 exits "
        f"(32- and 64-bit offsets) seeded edge cases: {n} of "
        f"{sum(map(len, cases))} equal (L2's yv max_abs_err={err} "
        f"not_bitwise={nbit}; R2's t_rm max_rel={trm}; the rest bitwise, "
        f"R2's NaN distances as NaN) "
        f"({'; '.join(', '.join(c) for c in cases)})")


@contextlib.contextmanager
def exits_offsets(wide):
    """With `wide`, R2's exits kernel takes 64-bit offsets everywhere
    (ring_exits.OFFSET_LIMIT 0): the instantiation that rings of 2^31
    elements or more take, held to the plain version on smaller ones."""
    from cityflow_tpu_torch.kernels import ring_exits
    lim = ring_exits.OFFSET_LIMIT
    if wide:
        ring_exits.OFFSET_LIMIT = 0
    try:
        yield
    finally:
        ring_exits.OFFSET_LIMIT = lim


def check_exits_case(name, got, want):
    """R2's exits stage on one seeded case against its plain version:
    every output equal bit for bit (a NaN new distance against any NaN:
    the clamp leaves a NaN as it is, torch.minimum may rewrite its
    payload), t_rm within 1e-6 relative; the clamp written in place.
    Returns t_rm's largest relative difference."""
    import torch
    assert set(got) == set(want), f"ring_exits[{name}]: output keys differ"
    rel = 0.0
    for key in sorted(want):
        if key == "t_rm":
            rel, _ = rel_close(f"ring_exits[{name}].t_rm", got[key],
                               want[key], 1e-6)
            continue
        g, w = got[key], want[key]
        assert g.shape == w.shape and g.dtype == w.dtype, \
            f"ring_exits[{name}].{key}: {g.shape} {g.dtype} vs {w.shape} " \
            f"{w.dtype}"
        same = (g.view(torch.int32) == w.view(torch.int32)) \
            | (g.isnan() & w.isnan()) if g.dtype == torch.float32 else g == w
        bad = int((~same).sum())
        assert bad == 0, f"ring_exits[{name}].{key}: {bad} values differ"
    return rel


def check_partner_case(name, case):
    """L4 on one seeded case, bit for bit against its plain version: the
    match mode (values, found, match), then the gather mode at the
    kernel's match, of the same channels and of the channels reversed
    (so each is read at rows the match found for it in no call)."""
    from cityflow_tpu_torch.kernels import lc_partner as l4
    from cityflow_tpu_torch.tools import kernel_cases as kc
    a = kc.partner_args(case, "cuda")
    got = l4.lc_partner(*a)
    _, bad = _bitwise(f"lc_partner[{name}]", got, l4.lc_partner_plain(*a))
    assert bad == 0, f"lc_partner[{name}]: {bad} values differ"
    match, chans, tabs = got[2], a[5], a[6]
    for ch in (chans, chans[::-1]):
        _, bad = _bitwise(f"lc_partner@gather[{name}]",
                          l4.lc_partner_gather(match, ch, tabs),
                          l4.lc_partner_gather_plain(match, ch, tabs))
        assert bad == 0, f"lc_partner@gather[{name}]: {bad} values differ"


# ---------------------------------------------------------------------------
# agreement: card (kernels) vs CPU (plain), B = 1
# ---------------------------------------------------------------------------

def vehicles(st):
    """{key: (drivable, dis, speed)}; the key is the uid, or (uid, shadow)
    with lane change, since a shadow shares its real's uid."""
    out = {}
    sh = None if st.l_sh is None else st.l_sh.cpu().numpy()
    for pre in ("l", "k"):
        n = getattr(st, f"n_{pre}").cpu().numpy()
        uid = getattr(st, f"{pre}_uid").cpu().numpy()
        dis = getattr(st, f"{pre}_dis").cpu().numpy()
        spd = getattr(st, f"{pre}_speed").cpu().numpy()
        for p in n.nonzero()[0]:
            for s in range(int(n[p])):
                key = int(uid[s, p])
                if sh is not None:
                    key = (key, pre == "l" and bool(sh[s, p]))
                out[key] = ((pre, int(p)), float(dis[s, p]),
                            float(spd[s, p]))
    return out


def rel_close(name, got, want, tol=1e-5):
    """|got - want| <= tol |want| everywhere (float sums); returns (max
    relative error, values not bitwise)."""
    g, w = got.double().cpu(), want.double().cpu()
    d = (g - w).abs()
    assert bool((d <= tol * w.abs()).all()), f"{name}: beyond {tol} relative"
    rel = float((d / w.abs().clamp_min(1e-30)).max()) if d.numel() else 0.0
    return rel, int((d > 0).sum())


@contextlib.contextmanager
def partner_checked():
    """While open, every L4 call on CUDA tensors (both modes) also runs its
    plain version on the same inputs, which it must equal bit for bit;
    yields the counts of calls checked per mode. The plain versions count
    no launch."""
    from cityflow_tpu_torch.core import ring_lc
    from cityflow_tpu_torch.kernels import lc_partner as l4
    names = ("lc_partner", "lc_partner_gather")
    orig = {n: getattr(ring_lc, n) for n in names}
    n_calls = {n: 0 for n in names}

    def checked(n):
        def fn(*a):
            got = orig[n](*a)
            if a[0].is_cuda:
                _, bad = _bitwise(n, got, getattr(l4, n + "_plain")(*a))
                assert bad == 0, f"{n}: {bad} values differ from the plain"
                n_calls[n] += 1
            return got
        return fn
    try:
        for n in names:
            setattr(ring_lc, n, checked(n))
        yield n_calls
    finally:
        for n in names:
            setattr(ring_lc, n, orig[n])


def check_agreement(net, steps, tag="agree", **kw):
    """B=1 on the card (kernels) against the plain port on the CPU; with
    lane change also the (changing, shadow) counts, and changes must
    happen; with the history window its counts equal and its speed sums
    within 1e-5 relative."""
    import torch
    from cityflow_tpu_torch import ring_sim
    gpu = ring_sim.build_sim(net, horizon=steps + 8, **kw)
    cpu = ring_sim.build_sim(net, horizon=steps + 8, device="cpu", **kw)
    lc = gpu.cfg.lane_change
    hist = gpu.cfg.track_history
    worst, changes, hist_rel, hist_nbit = 0.0, 0, 0.0, 0
    for i in range(1, steps + 1):
        ring_sim.step(gpu)
        ring_sim.step(cpu)
        if lc:
            changes += int(cpu.state.l_chg.sum())
        if i % 5 and i != steps:
            continue
        a, b = vehicles(cpu.state), vehicles(gpu.state)
        assert set(a) == set(b), f"step {i}: vehicle sets differ"
        for u in a:
            assert a[u][0] == b[u][0], f"step {i}: uid {u} drivable"
            worst = max(worst, abs(a[u][1] - b[u][1]),
                        abs(a[u][2] - b[u][2]))
        assert worst <= 2e-3, f"step {i}: worst drift {worst}"
        if lc:
            cnt = lambda st: (int(st.l_chg.sum()), int(st.l_sh.sum()))
            assert cnt(cpu.state) == cnt(gpu.state), \
                f"step {i}: (changing, shadow) {cnt(cpu.state)} vs " \
                f"{cnt(gpu.state)}"
        if hist:
            for k in ("h_num", "h_ring_num", "h_t"):
                assert torch.equal(getattr(gpu.state, k).cpu(),
                                   getattr(cpu.state, k)), f"step {i}: {k}"
            for k in ("h_ssum", "h_ring_ssum"):
                r, nb = rel_close(f"step {i}: {k}", getattr(gpu.state, k),
                                  getattr(cpu.state, k))
                hist_rel, hist_nbit = max(hist_rel, r), hist_nbit + nb
    assert int(cpu.state.finished_cnt) == int(gpu.state.finished_cnt)
    assert int(gpu.state.overflow) == 0
    msg = f"[{tag}] {steps} steps B=1: vehicles={len(a)} worst_drift={worst}"
    if lc:
        assert changes > 0, "no lane change happened"
        msg += f" changing_rows_summed={changes}"
    if hist:
        assert int(gpu.state.h_t) == steps * (1 + lc)
        assert float(cpu.state.h_ssum.sum()) > 0, "no speeds in the window"
        msg += (f" h_t={int(gpu.state.h_t)} speed_sums_max_rel={hist_rel} "
                f"speed_sums_not_bitwise={hist_nbit}")
    log(msg)


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def _patch_points():
    """(module, name) of every kernel wrapper the step calls by name."""
    from cityflow_tpu_torch.core import ring as ring_mod
    from cityflow_tpu_torch.core import ring_lc
    return [(ring_mod, n) for n in RING_CALLS] \
        + [(ring_lc, n) for n in LC_KERNELS + ("lc_partner_gather",
                                               "gap_refresh")]


@contextlib.contextmanager
def timed_calls(points):
    """Replace each (module, name) by a wrapper that records CUDA events
    around its calls; yields {name: [(start, end), ...]}. No garbage
    collection inside: a collection between an event and its launch
    leaves the device idle and books the pause to that call."""
    import torch
    orig = {n: getattr(m, n) for m, n in points}
    events = {n: [] for _, n in points}

    def timed(n):
        def fn(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = orig[n](*a, **k)
            e.record()
            events[n].append((s, e))
            return out
        return fn

    gc.collect()
    gc.disable()
    try:
        for m, n in points:
            setattr(m, n, timed(n))
        yield events
    finally:
        gc.enable()
        for m, n in points:
            setattr(m, n, orig[n])


def per_step_ms(events, nsteps):
    return {n: sum(s.elapsed_time(e) for s, e in ev) / nsteps
            for n, ev in events.items() if ev}


def kernel_shares(sim, state, nsteps):
    """Device time per kernel wrapper (CUDA events around each launch)
    and per phase over `nsteps` batched steps."""
    import torch
    from cityflow_tpu_torch.core import ring as ring_mod
    # one untimed step first (from a copy: the batched step writes its
    # state in place), so the window starts in the steady state of the
    # caching allocator
    state = ring_mod.ring_step_p2_batched(
        sim.tables, sim.cfg, *ring_mod.ring_step_p1_batched(
            sim.tables, sim.cfg, fresh(state), sim.q))
    torch.cuda.synchronize()
    phase_ms = {"p1": 0.0, "p2": 0.0}
    with timed_calls(_patch_points()) as events:
        for _ in range(nsteps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            state, mid = ring_mod.ring_step_p1_batched(sim.tables, sim.cfg,
                                                       state, sim.q)
            ev[1].record()
            state = ring_mod.ring_step_p2_batched(sim.tables, sim.cfg, state,
                                                  mid)
            ev[2].record()
            torch.cuda.synchronize()
            phase_ms["p1"] += ev[0].elapsed_time(ev[1]) / nsteps
            phase_ms["p2"] += ev[1].elapsed_time(ev[2]) / nsteps
    torch.cuda.synchronize()
    return per_step_ms(events, nsteps), phase_ms


def check_path(tag, sim, st, launches, expect):
    """Asserts on a driven path's final batched state and launch counts,
    then its p1/p2 split, kernel shares and peak memory."""
    import torch
    log(f"[{tag}] launches={launches}")
    assert int(st.overflow.max()) == 0, "overflow flags set"
    for k, v in st.leaves().items():
        assert torch.equal(v, v[..., :1].expand_as(v)), \
            f"env columns differ in {k}"
    for k in expect:
        assert launches[k] > 0, f"kernel {k} was not launched on {tag}"
    peak = torch.cuda.max_memory_allocated()
    per, phase = kernel_shares(sim, st, 3)
    tot = phase["p1"] + phase["p2"]
    log(f"[{tag}] p1_ms={phase['p1']:.3f} p2_ms={phase['p2']:.3f} "
        f"(CUDA events, 3 steps)")
    for n, v in per.items():
        log(f"[{tag}] kernel {n}: {v:.3f} ms/step ({100 * v / tot:.1f}% of "
            f"the step)")
    log(f"[{tag}] max_memory_allocated={peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    return dict(p1_ms=phase["p1"], p2_ms=phase["p2"], kernel_ms=per,
                peak_bytes=peak)


def run_path(tag, cfg_path, batch, warmup, steps, expect, lane_slots=40,
             after_warmup=None):
    """One path through tools/bench.run_ring_ladder (`steps` consecutive
    timed steps after the warm-up), with the launch counts set to 0 just
    before and read just after; the batch it ran at must be `batch` (the
    ladder halves it on out-of-memory; the warm-up runs one env and copies
    it into the batch). On a lane-change config the shadows of env 0 are
    summed over the timed steps on the device: the window must hold
    some; the first warm-up step with shadows is printed. lane_slots 0 is
    build_sim's default; `after_warmup()`, when given, runs after the last
    single-env warm-up step (before the batched steps)."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.tools import bench

    net = compile_scenario(cfg_path)
    lc = bool(net.host.config.get("laneChange", False))
    args = bench.parser().parse_args(
        ["--config", cfg_path, "--batch", str(batch), "--warmup",
         str(warmup), "--window", "0", "--steps", str(steps),
         "--lane-slots", str(lane_slots)])
    shadows, first, warm = [], [], [0]

    def count_shadows(s):
        if not shadows:
            shadows.append(torch.zeros((), dtype=torch.int64,
                                       device=s.l_sh.device))
        shadows[0] += s.l_sh[..., 0].sum()

    def first_shadow(s):
        warm[0] += 1
        if after_warmup is not None and warm[0] == warmup - 1:
            after_warmup()
        # on the device: the first step whose state holds a shadow
        if not first:
            first.append(torch.full((), -1, dtype=torch.int32,
                                    device=s.l_sh.device))
        first[0] = torch.where((first[0] < 0) & s.l_sh.any(), s.step[0],
                               first[0])

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    r, B = bench.run_ring_ladder(args, net, batch,
                                 on_step=count_shadows if lc else None,
                                 on_warmup=first_shadow
                                 if lc or after_warmup else None)
    launches = kernels.launch_counts()
    ms = r["seconds"] * 1e3 / r["steps"]
    c = r["sim"].cfg
    log(f"[{tag}] B={B} steps={r['steps']} warmup={warmup} "
        f"ms_per_batched_step={ms:.3f} "
        f"env_steps_per_s={B * r['steps'] / r['seconds']:.1f} "
        f"vehicles_per_env={r['vehicles']} overflow={r['overflow']} "
        f"first_step_s={r['first_step_s']:.2f} "
        f"wall_s={time.time() - t0:.1f} LNp={c.LNp} LKp={c.LKp} SL={c.SL} "
        f"SK={c.SK} KOUT={c.KOUT} MAXLPR={c.MAXLPR} XK={c.XK} LCI={c.LCI}")
    assert B == batch, f"the {tag} path ran at B={B}, not {batch}"
    assert r["vehicles"] > 0, "no vehicles"
    per_step = {k: v / r["steps_run"] for k, v in launches.items()}
    log(f"[{tag}] launches per step={per_step}")
    assert launches["gather_rows"] == K1_PER_RING_STEP * r["steps_run"], \
        f"K1 launched {per_step['gather_rows']} times a {tag} step, not " \
        f"{K1_PER_RING_STEP}"
    res = dict(B=B, steps=r["steps"], warmup=warmup, ms_per_step=ms,
               env_steps_per_s=B * r["steps"] / r["seconds"],
               vehicles=r["vehicles"], launches_per_step=per_step)
    if lc:
        res["shadow_rows_env0"] = int(shadows[0])
        res["first_shadow_step"] = int(first[0]) if first else -1
        log(f"[{tag}] shadow rows on env 0, summed over the timed steps: "
            f"{res['shadow_rows_env0']}; first warm-up step with a shadow: "
            f"{res['first_shadow_step']}")
        assert res["shadow_rows_env0"] > 0, "no shadows in the timed window"
    res.update(check_path(tag, r["sim"], r["state"], launches, expect))
    return launches, res, r["sim"], r["state"]


# ---------------------------------------------------------------------------
# K4 on every call of one more step of each ring path
# ---------------------------------------------------------------------------

def check_commit_calls(tag, sim, state, reps):
    """K4 against its plain version, bit for bit, on every call of one more
    batched step of a ring path's own state (the link and the lane
    commit; under lane change the lane commit's delete mode), each call
    timed beside its plain version and its bound (printed; the kernel
    table's K4 rows stay the seeded calls and [lc]'s delete mode)."""
    import torch
    from cityflow_tpu_torch.core import ring as ring_mod
    from cityflow_tpu_torch.kernels import ring_commit as rc
    keep = {id(v) for v in sim.tables.values()}
    clone = lambda x: x if not isinstance(x, torch.Tensor) \
        or id(x) in keep else x.clone()
    calls = []

    def rec(chans, *a, **k):
        calls.append(([(clone(c[0]),) + tuple(c[1:]) for c in chans],
                      [clone(v) for v in a],
                      {n: clone(v) for n, v in k.items()}))
        return rc.ring_commit(chans, *a, **k)

    orig = ring_mod.ring_commit
    ring_mod.ring_commit = rec
    try:
        st, mid = ring_mod.ring_step_p1_batched(sim.tables, sim.cfg,
                                                fresh(state), sim.q)
        ring_mod.ring_step_p2_batched(sim.tables, sim.cfg, st, mid)
        torch.cuda.synchronize()
    finally:
        ring_mod.ring_commit = orig
    del st, mid
    assert len(calls) == 2, f"[{tag}] {len(calls)} K4 calls a step"
    for (chans, a, k), site in zip(calls, ("link", "lane")):
        got = rc.ring_commit(chans, *a, **k)
        want = rc.ring_commit_plain(chans, *a, **k)
        _, bad = _bitwise(f"ring_commit@{site}:{tag}", got, want)
        assert bad == 0, f"[{tag}] K4 {site} commit: {bad} values differ"
        del got, want
        ms = time_cuda(lambda: rc.ring_commit(chans, *a, **k), reps)
        plain = time_cuda(lambda: rc.ring_commit_plain(chans, *a, **k),
                          reps)
        dmask = k.get("dmask")
        x, base, app = a
        S = chans[0][0].shape[0]
        keep_slots = int((~dmask).sum()) if dmask is not None \
            else int((S - x.clamp(0, S)).sum())
        extra = base.numel() * 4 + (dmask.numel() if dmask is not None
                                    else x.numel() * 4) \
            + (k["envval"].numel() * 4 if k.get("envval") is not None
               else 0)
        nbytes = commit_bytes(chans, keep_slots, app, k["valid_ch"],
                              k["nsel"], extra)
        mode = ", delete mode" if dmask is not None else ""
        log(f"[kernels] ring_commit {site} commit on the {tag} step "
            f"({len(chans)} channels{mode}): "
            f"bitwise, ms={ms:.4f} plain_ms={plain:.4f} "
            f"bound_ms={nbytes / H100_BYTES_PER_S * 1e3:.4f}")
    del calls


# ---------------------------------------------------------------------------
# lane-change kernels on the lc path's own inputs
# ---------------------------------------------------------------------------

# the leaves L4's match is made on; its gathers read them as they were
PARTNER_LEAVES = ("l_uid", "l_sh", "l_dir", "l_chg", "n_l")


def record_lc_calls(sim, state):
    """One more batched step of the lc path with the lane-change wrappers
    recording their arguments (cloned, tables by reference): every L1-L4
    call (L4 in both modes), both K3 calls with v_yield (lane rows and
    approach rows) and the K4 call with the delete mask; and, under
    "pair_leaves", copies of L4's leaves as the commit's pair rounds
    start and as they end."""
    import torch
    from cityflow_tpu_torch.core import ring as ring_mod
    keep_ids = {id(v) for v in sim.tables.values()}

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x if id(x) in keep_ids else x.clone()
        if x is sim.tables:
            return x
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x

    wanted = {
        "car_follow": lambda a, k: "v_yield" in k,
        "ring_commit": lambda a, k: k.get("dmask") is not None}
    every = LC_KERNELS + ("lc_partner_gather",)
    points = [(m, n) for m, n in _patch_points()
              if n in every or n in wanted]
    orig = {n: getattr(m, n) for m, n in points}
    calls = {}

    def rec(n):
        def fn(*a, **k):
            if n in every or wanted[n](a, k):
                calls.setdefault(n, []).append(clone((a, k)))
            return orig[n](*a, **k)
        return fn

    pairs = ring_mod._lc_pairs

    def pairs_rec(net, cfg, rs, *a):
        snap = lambda: {k: getattr(rs, k).clone() for k in PARTNER_LEAVES}
        calls.setdefault("pair_leaves", []).append(snap())
        out = pairs(net, cfg, rs, *a)
        calls["pair_leaves"].append(snap())
        return out

    try:
        for m, n in points:
            setattr(m, n, rec(n))
        ring_mod._lc_pairs = pairs_rec
        s, mid = ring_mod.ring_step_p1_batched(sim.tables, sim.cfg,
                                               fresh(state), sim.q)
        ring_mod.ring_step_p2_batched(sim.tables, sim.cfg, s, mid)
        torch.cuda.synchronize()
    finally:
        for m, n in points:
            setattr(m, n, orig[n])
        ring_mod._lc_pairs = pairs
    return calls


def check_partner_calls(tag, calls):
    """L4 on one recorded lane-change step: one match and two gathers; the
    leaves the match was made on unchanged as the pair rounds start and
    as they end; each gather given the match's own match."""
    import torch
    from cityflow_tpu_torch.kernels import lc_partner as l4
    assert len(calls["lc_partner"]) == 1, "L4: not one match a step"
    assert len(calls["lc_partner_gather"]) == 2, "L4: not two gathers"
    (a, _), = calls["lc_partner"]
    made_on = dict(zip(PARTNER_LEAVES, (a[0], a[1], a[2], a[4], a[3])))
    for snap in calls["pair_leaves"]:
        for k in PARTNER_LEAVES:
            assert torch.equal(snap[k], made_on[k]), \
                f"[{tag}] {k} changed between L4's match and its gathers"
    match = l4.lc_partner_plain(*a)[2]
    for g, _ in calls["lc_partner_gather"]:
        assert torch.equal(g[0], match), f"[{tag}] a gather's match differs"
    log(f"[{tag}] L4: one match and two gathers on one step; l_uid, l_sh, "
        f"l_dir, l_chg and n_l equal to the match's as the pair rounds "
        f"start and end; each gather at the match's match")


def _flat(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _compare(name, got, want, tol):
    """(max |err|, values not bitwise); asserts equal shapes and dtypes,
    and all values within `tol` (exact for ints and bools)."""
    import torch
    err, nbit = 0.0, 0
    for g, w in zip(_flat(got), _flat(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            f"{name}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}"
        same = (g == w) | (torch.isnan(g) & torch.isnan(w)) \
            if g.dtype.is_floating_point else g == w
        nbit += int((~same).sum())
        if g.dtype.is_floating_point:
            d = (g.double() - w.double()).abs().nan_to_num(0.0)
            err = max(err, float(d.max()) if d.numel() else 0.0)
        else:
            assert bool(same.all()), f"{name}: int / bool mismatch"
    assert err <= tol, f"{name}: max |err| {err} > {tol}"
    return err, nbit


def check_lc_kernels(sim, state, reps):
    """L1-L4 and the K3 / K4 lane-change modes on the lc path's own
    inputs, against their plain versions, every recorded call; timed on
    the first recorded call of each (K3's at the lane rows). L3 writes its
    state in place: kernel and plain each run on a fresh copy of the
    recorded call, and each timed call on its own."""
    import torch
    from cityflow_tpu_torch.kernels import (
        car_follow, lc_insert, lc_partner, lc_receive, lc_signal,
        ring_commit)
    mods = {"lc_signal": lc_signal, "lc_receive": lc_receive,
            "lc_insert": lc_insert, "lc_partner": lc_partner,
            "lc_partner_gather": lc_partner,
            "car_follow": car_follow, "ring_commit": ring_commit}
    tol = {"lc_receive": 1e-5, "car_follow": 1e-5}
    calls = record_lc_calls(sim, state)
    check_partner_calls("lc", calls)
    rows = []
    for n, mod in mods.items():
        assert calls.get(n), f"{n}: no lane-change call recorded"
        kern, plain = getattr(mod, n), getattr(mod, n + "_plain")
        err, nbit = 0.0, 0
        for a, k in calls[n]:
            e, nb = _compare(n, lc_call(kern, n, a, k),
                             lc_call(plain, n, a, k), tol.get(n, 0.0))
            err, nbit = max(err, e), nbit + nb
        label = PARTNER_LABEL.get(n, n if n in LC_KERNELS else n + "@lc")
        log(f"[kernels] {label}: {len(calls[n])} calls checked, "
            f"max_abs_err={err} not_bitwise={nbit}")
        if n == "lc_signal":
            log_signal_branches("lc", calls[n])
        a, k = next(c for c in calls[n]
                    if n != "car_follow" or len(c[0][2]) == 3)
        if n == "lc_insert":
            ms, plain_ms = time_insert(kern, plain, a, reps)
        else:
            ms = time_cuda(lambda: kern(*a, **k), reps)
            plain_ms = time_cuda(lambda: plain(*a, **k), reps)
        nbytes, nops = lc_work(n, a, k)
        if label in PR12_MS:
            log(f"[kernels] {label}: ms={ms:.4f} (PR 12: {PR12_MS[label]})")
        row = kernel_row(label, err, ms, plain_ms, nbytes, nops, None)
        if n == "lc_partner":
            row["launches_of"] = ("lc", ["lc_partner"], ["lc_partner@gather"])
        rows.append(row)
    log_partner_step("lc", calls, reps)
    return rows


# L4's row names: the match mode under the kernel's, the gather mode's
PARTNER_LABEL = {"lc_partner_gather": "lc_partner@gather"}


def log_partner_step(tag, calls, reps):
    """L4's device time a step: each of the step's calls (the match and
    both gathers) timed, summed, beside the bound of each."""
    from cityflow_tpu_torch.kernels import lc_partner as l4
    tot, bound = 0.0, 0.0
    for n in ("lc_partner", "lc_partner_gather"):
        fn = getattr(l4, n)
        for a, k in calls[n]:
            tot += time_cuda(lambda: fn(*a, **k), reps)
            bound += lc_work(n, a, k)[0] / H100_BYTES_PER_S * 1e3
    log(f"[{tag}] L4 a step (one match, two gathers): {tot:.4f} ms, bound "
        f"{bound:.4f} ms (the earlier three searches: 2.572 ms a [lc] "
        f"step, PERF.md row 15g)")


def insert_copy(a):
    """L3's recorded arguments with what it writes in place copied: the
    lane leaves, yv and n_l."""
    ch, do_change, dirc, yv, n_l, tabs, LCI = a
    return ({k: v.clone() for k, v in ch.items()}, do_change, dirc,
            yv.clone(), n_l.clone(), tabs, LCI)


def lc_call(fn, n, a, k):
    """One call of a lane-change wrapper or its plain version; L3 on a
    fresh copy of its recorded arguments (its outputs are that copy's
    leaves)."""
    return fn(*insert_copy(a), **k) if n == "lc_insert" else fn(*a, **k)


def time_insert(kern, plain, a, reps, lci=None):
    """(kernel ms, plain ms) of L3 on `a`, each timed call on its own fresh
    copy (the copies untimed); with `lci`, at that shadow-insert cap; a
    None function is not timed."""
    c = a[-1] if lci is None else lci
    setup = lambda: insert_copy(a)
    return tuple(None if f is None else time_cuda_fresh(
        setup, lambda x: f(*x[:-1], c), reps) for f in (kern, plain))


def log_signal_branches(path, calls):
    """How many (lane, side, env) neighbour columns L1's calls read by its
    linear count (their occupied dis not non-increasing), of all it
    reads."""
    from cityflow_tpu_torch.kernels.lc_signal import unsorted_reads
    reads = linear = 0
    for a, _ in calls:
        r, lin = unsorted_reads(a[0], a[2], a[12])
        reads, linear = reads + r, linear + lin
    log(f"[kernels] lc_signal on the {path} step: {linear} of {reads} "
        f"(lane, side, env) neighbour column reads took the linear count "
        f"(occupied dis not non-increasing), {reads - linear} the binary "
        f"search")


def insert_work(a):
    """Bytes L3's in-place call must move, as this call's data reads them:
    the occupied do_change of every column that is some lane's neighbour,
    the dirc of its do_change rows and the dis of its candidates, n_l and
    the tables, the winners' values (read once from their source rows),
    each target column's occupied dis where it takes an insert, the
    shifted tail of those columns in every channel (read once, written
    once: rows from the first insert rank to the last slot), the started
    rows' sh, chg and dir, the new n_l and the overflow bits."""
    import torch
    from cityflow_tpu_torch.kernels.lc_insert import (channel_spec,
                                                      insert_plan)
    ch, do_change, dirc, yv, n_l, tabs, LCI = a
    S, N, B = do_change.shape
    dev = do_change.device
    width = {"f32": 4, "i32": 4, "bool": 1}
    row = sum(width[kind] for _, kind, _ in
              channel_spec(ch["rnrow"].shape[0], "tpl" in ch))
    inner, outer = tabs["inner_src"], tabs["outer_src"]
    is_in = torch.zeros(N, dtype=torch.bool, device=dev)     # an inner
    is_out = torch.zeros(N, dtype=torch.bool, device=dev)    # an outer
    is_in[inner[inner >= 0].long()] = True
    is_out[outer[outer >= 0].long()] = True
    occ = torch.arange(S, device=dev)[:, None, None] < n_l[None]
    nb = (is_in | is_out)[None, :, None]
    cand = do_change & (((dirc > 0) & is_in[None, :, None])
                        | ((dirc < 0) & is_out[None, :, None]))
    accepted, pos, exs, _ = insert_plan(ch["dis"], do_change, dirc, n_l,
                                        tabs, LCI)
    k = sum(ex.to(torch.int64) for ex in exs)                # (N, B)
    has = k > 0
    tail = int(torch.where(has, S - pos[0], 0).sum())
    n_ins = int(k.sum())
    started = sum(int((c >= 0).sum()) for c in accepted)
    return (int((occ & nb).sum()) + 4 * int((do_change & nb).sum())
            + 4 * int(cand.sum()) + 4 * N * B + 12 * N + row * n_ins
            + 4 * int((occ & has[None]).sum()) + row * (2 * tail - n_ins)
            + 6 * started + 4 * int(has.sum()) + N * B)


def lc_work(n, a, k):
    """Bytes (each input read once, each output written once) and
    operations of one lane-change kernel call, from its arguments."""
    import torch
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    if n == "lc_signal":
        (dis, speed, n_l, sh, chg, l_dir, l_gap, l_last, rnrow, olt_dis,
         olt_ex, now, tabs, _) = a
        S, N, B = dis.shape
        M = rnrow.shape[0]
        occ = torch.arange(S, device=dis.device)[:, None, None] < n_l[None]
        # a signal can start only on occupied rows that are neither shadows
        # nor changing: only there are the stale gap and the last-road flag
        # read, and, off the last road, the neighbour lanes' route rows;
        # the direction only on changing rows
        start = occ & ~sh & ~chg
        lo = tabs["ln_llocal"]
        nrows = sum(((lo + d >= 0) & (lo + d < M)).to(torch.int64)
                    for d in (1, -1))
        route = int(((start & ~l_last).sum((0, 2)) * nrows).sum())
        ins = (nb(dis, speed, n_l, sh, chg, olt_dis, olt_ex, now) + 16 * N
               + int(start.sum()) * (4 + 1) + int((occ & chg).sum()) * 4
               + 4 * route)
        # plan, hsig, gval (bool), dirc, tl_slot (i32), ygap (f32)
        outs = S * N * B * (3 + 4 + 4 + 4)
        # a rank count over both neighbour columns' occupied slots
        nops = 2 * int(n_l.sum()) * S
        return ins + outs, nops
    if n == "lc_receive":
        plan, hsig, chg, n_l, tabs = a[0], a[4], a[9], a[8], a[10]
        S, N, B = plan.shape
        occ = torch.arange(S, device=plan.device)[:, None, None] < n_l[None]
        # an occupied row's plan, chg and hsig; a plan row's dirc, tl_slot
        # and pri (it is a sender; plan rows are occupied); the pri of the
        # other rows holding a signal (a receiver's own, against the kept
        # sender's); gval where a plan row holds a signal and does not
        # change; at each yield (yv != 100, the plain version's) the
        # sender's speed and ygap and the receiver's speed, and in the
        # template mode both template indices; n_l, the neighbour tables;
        # yv and do_change in full
        from cityflow_tpu_torch.kernels.lc_receive import lc_receive_plain
        yields = int((lc_receive_plain(*a, **k)[0] != 100).sum())
        ins = (4 * N * B + 8 * N + int(occ.sum()) * 3 + int(plan.sum()) * 12
               + int((occ & hsig & ~plan).sum()) * 4
               + int((plan & hsig & ~chg).sum())
               + yields * (12 + 8 * (k.get("tpl") is not None)))
        # each plan row of a neighbour column is offered to its two
        # receivers in the column that reads it
        senders = plan.sum(0)                                   # (N, B)
        offers = 0
        for q in (tabs["inner_src"], tabs["outer_src"]):
            has = (q >= 0)[:, None]
            offers += int(torch.where(has, senders[q.clamp(min=0).long()],
                                      0).sum())
        return ins + S * N * B * (4 + 1), 2 * offers
    if n == "lc_insert":
        return insert_work(a), 0
    if n == "lc_partner":
        # the match: every row's uid, sh, dir and chg, n_l, the tables; the
        # channels at the rows with a match; C values, found and the match
        # out
        uid, sh, l_dir, n_l, chg, chans, tabs = a
        S, N, B = uid.shape
        C = len(chans)
        ins = nb(uid, sh, l_dir, n_l, chg) + 8 * N
        from cityflow_tpu_torch.kernels.lc_partner import lc_partner_plain
        hits = int((lc_partner_plain(*a)[2] >= 0).sum())
        return ins + 4 * C * hits + S * N * B * (4 * C + 1 + 2), 0
    if n == "lc_partner_gather":
        # the gather: the match, the tables, the channels at the rows with
        # a match, C values out
        match, chans, tabs = a
        C = len(chans)
        hits = int((match >= 0).sum())
        return (nb(match) + 8 * match.shape[1] + 4 * C * hits
                + match.numel() * 4 * C), 0
    if n == "car_follow":
        return k3_work(a, k)
    if n == "ring_commit":
        chans, _, base, app = a[:4]
        dmask = k["dmask"]
        S, N, B = dmask.shape
        keep = int((~dmask).sum())
        return commit_bytes(chans, keep, app, k["valid_ch"], k["nsel"],
                            dmask.numel() + base.numel() * 4), 0
    raise KeyError(n)


# ---------------------------------------------------------------------------
# non-uniform vehicle templates: T1 and the template modes
# ---------------------------------------------------------------------------

def record_tpl_calls(sim, state, lc):
    """One more batched step of a template path with the wrappers
    recording their arguments (cloned, tables by reference): every T1
    call, and every call in the template mode of K2, K3 and, with lane
    change, L1 and L2; with lane change also every L3 call, which carries
    the tpl channel, and every L4 call in both modes (K4's calls:
    check_commit_calls)."""
    import torch
    from cityflow_tpu_torch.core import ring as ring_mod
    from cityflow_tpu_torch.core import ring_lc
    keep = {id(v) for v in sim.tables.values()}

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x if id(x) in keep else x.clone()
        if x is sim.tables:
            return x
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x

    every = ["tpl_params"] + (["lc_insert", "lc_partner", "lc_partner_gather"]
                              if lc else [])
    names = every + ["cross_caps", "car_follow"] \
        + (["lc_signal", "lc_receive"] if lc else [])
    points = [(m, n) for m, n in _patch_points() if n in names]
    orig = {(m, n): getattr(m, n) for m, n in points}
    calls = {}

    def rec(m, n):
        def fn(*a, **k):
            if n in every or k.get("tpl") is not None:
                calls.setdefault(n, []).append(clone((a, k)))
            return orig[(m, n)](*a, **k)
        return fn

    try:
        for m, n in points:
            setattr(m, n, rec(m, n))
        st, mid = ring_mod.ring_step_p1_batched(sim.tables, sim.cfg,
                                                fresh(state), sim.q)
        ring_mod.ring_step_p2_batched(sim.tables, sim.cfg, st, mid)
        torch.cuda.synchronize()
    finally:
        for (m, n), f in orig.items():
            setattr(m, n, f)
    return calls


def tpl_work(n, a, k):
    """Bytes and operations of one call in a template mode (or of T1),
    from its arguments: the mode's work plus its template indices and
    table."""
    import torch
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    if n == "tpl_params":
        tpl, table, cols = a
        return nb(tpl, table) + 4 * len(cols) * tpl.numel(), 0
    if n == "cross_caps":
        return cross_caps_work(a, k)
    if n == "car_follow":
        return k3_work(a, k)
    if n == "lc_signal":
        nbytes, nops = lc_work("lc_signal", a, k)
        return nbytes + nb(k["tpl"], k["olt_len"]), nops
    if n in ("lc_receive", "lc_insert", "lc_partner", "lc_partner_gather"):
        return lc_work(n, a, k)
    raise KeyError(n)


@contextlib.contextmanager
def insert_demand():
    """The most shadow inserts that any lane asks for in one step: the
    winners per target lane before L3's cap (senders whose target is the
    lane, from its inner and outer side), as L3's inputs hold them, over
    every L3 call while the context is open and its "stop" has not been
    called, kept on the device. Yields a dict whose "stop" ends the
    probing (run_path calls it after the warm-up, so that the timed
    window runs without it: the window is held to the cap by its
    overflow == 0 check, as a lane with more senders than LCI sets
    OV_REMOVE) and whose "peak" is set on exit. Each column's senders are
    counted by direction, then read at each lane's neighbours."""
    import torch
    from cityflow_tpu_torch.core import ring_lc
    from cityflow_tpu_torch.kernels._nbr import nbcol
    orig = ring_lc.lc_insert
    peak = []

    def fn(ch, do_change, dirc, yv, n_l, tabs, LCI):
        n = 0
        for side, up in (("inner_src", True), ("outer_src", False)):
            want = (dirc > 0) if up else (dirc < 0)
            n = n + nbcol((do_change & want).sum(0, dtype=torch.int32),
                          tabs[side])
        m = n.max()
        if peak:
            peak[0] = torch.maximum(peak[0], m)
        else:
            peak.append(m)
        return orig(ch, do_change, dirc, yv, n_l, tabs, LCI)
    def stop():
        ring_lc.lc_insert = orig
    out = {"stop": stop}
    ring_lc.lc_insert = fn
    try:
        yield out
    finally:
        ring_lc.lc_insert = orig
        out["peak"] = int(peak[0]) if peak else 0


def check_tpl_kernels(sim, state, reps, lc, lci=None):
    """T1 and the template modes against their plain versions on every
    recorded call of one more step of a template path (T1, K2, L1 and L3
    exact; K3 and L2 within 1e-5, their not-bitwise counts printed; L3,
    which writes its state in place, kernel and plain each on a fresh copy
    of the call). Rows: without lane change T1, K2@tpl and K3@tpl; with it
    L1@tpl, L2@tpl, K3@tpl+lc, lc_insert@mixed-lc, and L4's two modes
    (lc_partner@mixed-lc, lc_partner@gather:mixed-lc; bitwise, and its
    time a step printed). Each is timed on its largest call (K3 at the
    lane rows, with v_yield on the lane-change path; L3 on a fresh copy
    each call; L4 on the step's first call of each mode), T1 beside the
    library gather table[:, cols][tpl]. With `lci` (the measured insert
    demand) L3 is also timed at that cap and at its maximum, 8."""
    import torch
    from cityflow_tpu_torch import kernels
    calls = record_tpl_calls(sim, state, lc)
    tol = {"car_follow": 1e-5, "lc_receive": 1e-5}
    partner = ("lc_partner", "lc_partner_gather")
    checked = ("tpl_params", "cross_caps", "car_follow") \
        + (("lc_signal", "lc_receive", "lc_insert") + partner
           if lc else ())
    timed = ("lc_signal", "lc_receive", "car_follow", "lc_insert") \
        + partner if lc else ("tpl_params", "cross_caps", "car_follow")
    rows = []
    for n in checked:
        assert calls.get(n), f"{n}: no template-path call recorded"
        mod = kernels.MODULES["lc_partner" if n in partner else n]
        kern, plain = getattr(mod, n), getattr(mod, n + "_plain")
        err, nbit = 0.0, 0
        for a, k in calls[n]:
            e, nb_ = _compare(n, lc_call(kern, n, a, k),
                              lc_call(plain, n, a, k), tol.get(n, 0.0))
            err, nbit = max(err, e), nbit + nb_
        label = {"tpl_params": n, "lc_insert": "lc_insert@mixed-lc",
                 "lc_partner": "lc_partner@mixed-lc",
                 "lc_partner_gather": "lc_partner@gather:mixed-lc"}.get(
            n, n + "@tpl")
        yld = sum("v_yield" in k for _, k in calls[n])
        log(f"[kernels] {label} on the {'mixed-lc' if lc else 'mixed'} "
            f"step: {len(calls[n])} calls checked ({yld} with v_yield), "
            f"max_abs_err={err} not_bitwise={nbit}")
        if n == "lc_signal":
            log_signal_branches("mixed-lc", calls[n])
        if n not in timed:
            continue
        if n == "car_follow":
            assert not lc or yld, "car_follow: no template-mode v_yield call"
            a, k = next(c for c in calls[n] if len(c[0][2]) == 3
                        and ("v_yield" in c[1]) == lc)
            label += "+lc" if lc else ""
        elif n in ("lc_insert", "lc_partner", "lc_partner_gather"):
            a, k = calls[n][0]            # the step's first
        else:
            a, k = max(calls[n], key=lambda c: c[0][0].numel())
        if n == "lc_insert":
            ms, plain_ms = time_insert(kern, plain, a, reps)
        else:
            ms = time_cuda(lambda: kern(*a, **k), reps)
            plain_ms = time_cuda(lambda: plain(*a, **k), reps)
        lib = None
        if n == "tpl_params":
            tpl, table, cols = a
            tc, ti = table[:, list(cols)], tpl.long()
            lib = time_cuda(lambda: tc[ti], reps)
            log(f"[kernels] tpl_params timed at {tuple(tpl.shape)} x "
                f"{len(cols)} columns: ms={ms:.4f} (PR 12: "
                f"{PR12_MS['tpl_params']}) library_ms={lib:.4f}")
        nbytes, nops = tpl_work(n, a, k)
        row = kernel_row(label, err, ms, plain_ms, nbytes, nops, lib)
        if n == "lc_insert":
            row["launches_of"] = ("mixed-lc", ["lc_insert"], [])
        elif n in partner:
            row["launches_of"] = ("mixed-lc", ["lc_partner@gather"], []) \
                if n != "lc_partner" else \
                ("mixed-lc", ["lc_partner"], ["lc_partner@gather"])
        rows.append(row)
    if lc:
        log_partner_step("mixed-lc", calls, reps)
    if lci is not None:
        from cityflow_tpu_torch.kernels.lc_insert import MAX_LCI, lc_insert
        a, _ = calls["lc_insert"][0]
        at = {c: time_insert(lc_insert, None, a, reps, c)[0]
              for c in sorted({max(lci, 1), sim.cfg.LCI, MAX_LCI})}
        log(f"[mixed-lc] L3 lc_insert on one [mixed-lc] step's state, by "
            f"shadow-insert cap: " + ", ".join(
                f"LCI {c}: {v:.4f} ms" for c, v in at.items())
            + f" (the peak demand is {lci}, build_sim's cap "
            f"{sim.cfg.LCI})")
    return rows


# ---------------------------------------------------------------------------
# the ring step's regions R1-R4 on each ring path's own state
# ---------------------------------------------------------------------------

# the R wrappers the ring step calls by name (R2 in three stages)
RING_WRAPPERS = ("notify_winners", "ring_admit", "ring_exits",
                 "ring_exits_pairs", "ring_exits_finish", "route_rows")


def fresh(state):
    """A copy of a batched state (ring or gen-1): the batched entries
    write theirs in place (R3's admission; G11, G5 and G15 on the gen-1
    step), so a phase that steps again from a state it keeps steps from a
    copy."""
    return state.map(lambda x: x.clone())


def admit_copy(rs):
    """rs with the leaves R3 writes copied (the rest shared)."""
    from cityflow_tpu_torch.kernels.ring_admit import ADMIT_FIELDS
    return rs.replace_fields(**{f: getattr(rs, f).clone()
                                for f in ADMIT_FIELDS
                                if getattr(rs, f) is not None})


def exits_copy(mid):
    """mid with the new distances R2's exits stage clamps in place
    copied (the rest shared)."""
    return dict(mid, new_dis_l=mid["new_dis_l"].clone())


def record_ring_calls(sim, state):
    """One more batched step from a copy of `state` with the R1-R4 wrappers
    recording their arguments: R3's state and R2's new distances as they
    were before the call (what the call writes in place copied), every
    other argument by reference (nothing in the step writes them after
    the call)."""
    import torch
    from cityflow_tpu_torch.core import ring as ring_mod
    orig = {n: getattr(ring_mod, n) for n in RING_WRAPPERS}
    calls = {n: [] for n in RING_WRAPPERS}

    def rec(n):
        def fn(*a, **k):
            kept = a[:2] + (admit_copy(a[2]),) + a[3:] \
                if n == "ring_admit" else a
            if n == "ring_exits":
                kept = a[:3] + (exits_copy(a[3]),)
            calls[n].append((kept, k))
            return orig[n](*a, **k)
        return fn

    try:
        for n in RING_WRAPPERS:
            setattr(ring_mod, n, rec(n))
        st, mid = ring_mod.ring_step_p1_batched(sim.tables, sim.cfg,
                                                fresh(state), sim.q)
        ring_mod.ring_step_p2_batched(sim.tables, sim.cfg, st, mid)
        torch.cuda.synchronize()
    finally:
        for n, f in orig.items():
            setattr(ring_mod, n, f)
    return calls


def _ring_call(fn, n, a, k):
    """One call of an R wrapper or its plain version; R3 on a fresh copy of
    its recorded state, returning the OV bits and the leaves it wrote; R2's
    exits stage on a fresh copy of its recorded new distances (its dis_l
    is that copy, clamped)."""
    if n == "ring_exits":
        return fn(*a[:3], exits_copy(a[3]), **k)
    if n != "ring_admit":
        return fn(*a, **k)
    rs = admit_copy(a[2])
    from cityflow_tpu_torch.kernels.ring_admit import ADMIT_FIELDS
    ov = fn(*a[:2], rs, *a[3:], **k)
    return [ov] + [getattr(rs, f) for f in ADMIT_FIELDS
                   if getattr(rs, f) is not None]


def _ring_compare(n, got, want):
    """(max |err|, not bitwise): every value bitwise, except R2's t_rm
    within 1e-6 relative."""
    if isinstance(want, dict):
        err, nbit = 0.0, 0
        for key in sorted(want):
            if key == "t_rm":
                _, nb = rel_close(f"{n}.t_rm", got[key], want[key], 1e-6)
                err, nbit = max(err, float(
                    (got[key] - want[key]).abs().max())), nbit + nb
            else:
                e, nb = _compare(f"{n}.{key}", got[key], want[key], 0.0)
                err, nbit = max(err, e), nbit + nb
        assert set(got) == set(want), f"{n}: output keys differ"
        return err, nbit
    return _compare(n, got, want, 0.0)


def time_cuda_fresh(setup, fn, reps):
    """Mean device time of fn(setup()) over `reps` calls, each on a fresh
    setup() (untimed) and behind a ~0.05 s device spin, so that the
    events bracket the call alone."""
    import torch
    fn(setup())
    total = 0.0
    for _ in range(reps):
        arg = setup()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        s.record()
        fn(arg)
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def ring_work(n, a, k, out):
    """Bytes each R call must move (each input read once, each output
    written once; ring slots only where occupied, R3's slots only where
    admitted, R4's route rows only for the exits taken) and its
    operations, from its arguments and outputs."""
    import torch
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts
                         if t is not None)
    cfg, net = a[0], a[1]
    if n == "notify_winners":
        n_k, blk, et, st, avail = a[6:11]
        occ = int(n_k.sum())
        tpl = k.get("k_tpl") is not None
        nbytes = (nb(out, n_k, blk, et, st, avail, net["lk_d"],
                     net["lk_len"], net["lk_turn"])
                  + occ * 4 * (4 + tpl))
        # per (cross, link, env): the count over the occupied slots and
        # the winner's formulas (can_yield, reach_steps: ~60 flops)
        nops = out[0].numel() * 60 + cfg.KC * occ * 2
        return nbytes, nops
    if n == "ring_admit":
        rs, q = a[2], a[3]
        EL, B = rs.el_cursor.shape
        slot = sum(getattr(rs, f).element_size() for f in (
            "l_dis", "l_speed", "l_flow", "l_route", "l_rpos", "l_nxt",
            "l_nxt3", "l_prev", "l_enter", "l_pri", "l_uid", "l_last",
            "l_custom", "l_hascustom", "l_off", "l_sh", "l_chg", "l_dir",
            "l_gap", "l_yv", "l_tpl") if getattr(rs, f) is not None)
        if rs.l_rnrow is not None:
            slot += 2 * cfg.MAXLPR * 4
        admitted = int((out[2] - rs.el_cursor).sum())  # cursor moved
        per_entry = 4 * (3 + len(q))                   # cursor, n_l, tail
        if cfg.lane_change:                            # best, end lane
            per_entry += 1 + 4 + 4 + 4
        return EL * B * per_entry + admitted * (slot + 4), 0
    if n == "ring_exits":
        return exits_work(a, out)[0], 0
    if n == "ring_exits_pairs":
        rs = a[2]
        return (nb(rs.n_l, rs.l_sh, rs.l_last, rs.l_chg, rs.l_dir, rs.l_off,
                   *a[3:7]) + nb(*out.values())), 0
    if n == "ring_exits_finish":
        rs = a[2]
        return (nb(rs.n_l, rs.l_sh, rs.l_chg, *a[3:10])
                + int(out["n_rm"].sum() - a[10].sum()) * 4
                + nb(*out.values())), 0
    if n == "route_rows":
        ef = a[2]
        exits = int(ef.sum())
        return (nb(ef, *out) + exits * 4 * (2 + out[0].shape[0])), 0
    raise KeyError(n)


def exits_work(a, out):
    """R2's exits stage: (bytes the in-place call moves as this data reads
    them, the copying count). The first: n_l and n_k; each occupied lane
    slot's new distance, and last where it is past the lane's end (or the
    length is NaN), nxt where such a slot is not last, the clamp written
    where it applies; sh where a slot leaves (lane change); the removed
    vehicles' enter times; each occupied link slot's distance, k_fail up
    to the front-most failure and its foe; the approach rows walked while
    the blocker is negative (ap_fail, ap_red where it fails, ap_ffo where
    both hold); the lights; every output but the new distances. The
    copying count (the earlier kernel's): the whole new-distance ring
    read and dis_l written, each occupied lane slot's nxt, last and sh,
    the link blocker inputs of every occupied slot and the whole approach
    rows. `a` holds the new distances as they were before the call."""
    import torch
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts
                         if t is not None)
    cfg, net, rs, mid = a
    nd = mid["new_dis_l"]
    SL, LNp, B = nd.shape
    dev = nd.device
    occ = torch.arange(SL, device=dev)[:, None, None] < rs.n_l[None]
    ln = net["ln_len"][:, None]
    hot = occ & ~(nd <= ln) & ~nd.isnan()
    live = hot & ~rs.l_last
    inval = live & (rs.l_nxt < 0)
    XKl = out["exited"].shape[0]
    lv = out["leave"][:XKl]
    outs = nb(*(v for key, v in out.items() if key not in ("dis_l", "ov")))
    lane = (nb(rs.n_l, rs.step) + 4 * int(occ.sum()) + int(hot.sum())
            + 4 * int(live.sum()) + 4 * int(inval.sum())
            + (int(lv.sum()) if rs.l_sh is not None else 0)
            + 4 * int(out["n_rm"].sum()))
    SK, LKp = cfg.SK, cfg.LKp
    m = rs.n_k.clamp(0, SK)
    occk = torch.arange(SK, device=dev)[:, None, None] < rs.n_k[None]
    fail = mid["k_fail"].reshape(SK, LKp, B) & occk
    found = fail.any(0)
    first = fail.to(torch.int32).argmax(0)
    foe = mid["k_fffoe"].reshape(SK, LKp, B).gather(0, first[None])[0]
    v = torch.where(found, foe, -1)
    apf = mid["ap_fail"].reshape(-1, LKp, B)
    apr = mid["ap_red"].reshape(-1, LKp, B)
    apo = mid["ap_ffo"].reshape(-1, LKp, B)
    ap_bytes = 0
    for r in reversed(range(apf.shape[0])):
        walk = v < 0
        hit = walk & apf[r]
        take = hit & ~apr[r]
        ap_bytes += int(walk.sum()) + int(hit.sum()) + 4 * int(take.sum())
        v = torch.where(take, apo[r], v)
    link = (nb(rs.n_k) + 4 * int(occk.sum())
            + int(torch.where(found, first + 1, m).sum())
            + 4 * int(found.sum()) + ap_bytes)
    lights = 0 if cfg.rl_traffic_light else nb(
        rs.phase, rs.phase_remain, net["i_n_phases"], net["i_virtual"],
        net["i_phase_offset"])
    nbytes = lane + link + lights + outs + nb(out["ov"])
    occ_l, occ_k = int(rs.n_l.sum()), int(rs.n_k.sum())
    copying = (nb(nd, rs.n_l, rs.n_k, mid["ap_fail"], mid["ap_red"],
                  mid["ap_ffo"], rs.phase, rs.phase_remain)
               + occ_l * (4 + 1 + 1 + (rs.l_sh is not None))
               + int(out["n_rm"].sum()) * 4
               + occ_k * (4 + 1 + 4)
               + nb(*(v for key, v in out.items() if key != "ov")))
    return nbytes, copying


def check_ring_kernels(sim, state, reps, path):
    """R1-R4 against their plain versions on every call of one more step
    of a ring path's own state (bitwise; R2's t_rm within 1e-6 relative),
    each wrapper timed on its call (R3 on a fresh copy of its state every
    call, kernel and plain alike) beside its bound. Rows: <kernel> on
    [main], <kernel>@<path> on the others; R2's lane-change stages as
    ring_exits@pairs / @finish (and @pairs:<path> past [lc])."""
    import torch
    from cityflow_tpu_torch import kernels
    calls = record_ring_calls(sim, state)
    lc = sim.cfg.lane_change
    rows = []
    for n in RING_WRAPPERS:
        if n in ("ring_exits_pairs", "ring_exits_finish") and not lc:
            assert not calls[n], f"{n} called without lane change"
            continue
        assert len(calls[n]) == 1, f"{n}: {len(calls[n])} calls a step"
        base = "ring_exits" if n.startswith("ring_exits") else n
        mod = kernels.MODULES[base]
        kern, plain = getattr(mod, n), getattr(mod, n + "_plain")
        a, k = calls[n][0]
        got = _ring_call(kern, n, a, k)
        want = _ring_call(plain, n, a, k)
        torch.cuda.synchronize()
        err, nbit = _ring_compare(n, got, want)
        if n == "ring_exits":
            with exits_offsets(True):
                got64 = _ring_call(kern, n, a, k)
            err64, nbit64 = _ring_compare(f"{n}@64-bit", got64, want)
            del got64
            log(f"[kernels] ring_exits ({path}) with 64-bit offsets: "
                f"max_abs_err={err64} not_bitwise={nbit64}")
        nbytes, nops = ring_work(n, a, k, got)
        admitted = int((got[2] - a[2].el_cursor).sum()) \
            if n == "ring_admit" else 0
        del got, want
        if n in ("ring_exits_pairs", "ring_exits_finish"):
            label = f"ring_exits@{n.split('_')[-1]}" + (
                "" if path == "lc" else f":{path}")
        else:
            label = n if path == "main" else f"{n}@{path}"
        # the path's launch count of this stage (R2's first: the stages
        # less the two lane-change ones)
        of = {"ring_exits": (["ring_exits"], ["ring_exits@pairs",
                                              "ring_exits@finish"]),
              "ring_exits_pairs": (["ring_exits@pairs"], []),
              "ring_exits_finish": (["ring_exits@finish"], [])}.get(
                  n, ([n], []))
        log(f"[kernels] {label}: {len(calls[n])} call on the {path} step "
            f"checked, max_abs_err={err} not_bitwise={nbit}")
        if n == "ring_admit":
            setup = lambda: (a[:2] + (admit_copy(a[2]),) + a[3:])
            ms = time_cuda_fresh(setup, lambda x: kern(*x, **k), reps)
            plain_ms = time_cuda_fresh(setup, lambda x: plain(*x, **k), reps)
            log(f"[kernels] {label}: admitted {admitted} of "
                f"{a[2].el_cursor.numel()} entry lanes x envs")
        elif n == "ring_exits":
            # in place: each call on a fresh copy of the new distances
            setup = lambda: a[:3] + (exits_copy(a[3]),)
            ms = time_cuda_fresh(setup, lambda x: kern(*x, **k), reps)
            plain_ms = time_cuda_fresh(setup, lambda x: plain(*x, **k), reps)
            with exits_offsets(True):
                ms64 = time_cuda_fresh(setup, lambda x: kern(*x, **k), reps)
            got = _ring_call(kern, n, a, k)
            inplace, copying = exits_work(a, got)
            del got
            log(f"[kernels] {label}: bound_ms (in place, as this data reads "
                f"it)={inplace / H100_BYTES_PER_S * 1e3:.4f} copying "
                f"count={copying / H100_BYTES_PER_S * 1e3:.4f}; ms with "
                f"64-bit offsets={ms64:.4f}")
        else:
            ms = time_cuda(lambda: kern(*a, **k), reps)
            plain_ms = time_cuda(lambda: plain(*a, **k), reps)
        row = kernel_row(label, err, ms, plain_ms, nbytes, nops, None)
        row["source"] = f"cityflow_tpu_torch/csrc/{base}.cu"
        row["launches_of"] = (path,) + of
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the ring step's front leaders, gap refresh, channel packs and K3's
# ring-leader mode (R5-R7) on each ring path's own state
# ---------------------------------------------------------------------------

# (module of core/ that calls it, kernel module, wrapper) of each call
FRONT_CALLS = (("ring", "front_leaders", "front_leaders"),
               ("ring", "front_leaders", "front_leaders_lc"),
               ("ring_lc", "gap_refresh", "gap_refresh"),
               ("ring", "ring_pack", "pack_forward"),
               ("ring", "ring_pack", "pack_entrants"),
               ("ring", "ring_pack", "pack_candidates"),
               ("ring", "ring_pack", "pack_approach"),
               ("ring", "car_follow", "car_follow"),
               ("ring", "cross_caps", "cross_caps"))
# the row of each (wrapper, K3 ring kind) and its launch counters
# (counted, less)
FRONT_ROWS = {
    ("front_leaders", None): ("front_leaders", ["front_leaders"],
                              ["front_leaders@ctx"]),
    ("front_leaders_lc", None): ("front_leaders@ctx", ["front_leaders@ctx"],
                                 []),
    ("gap_refresh", None): ("gap_refresh", ["gap_refresh"], []),
    ("pack_forward", None): ("ring_pack", ["ring_pack"],
                             ["ring_pack@entrant", "ring_pack@candidate",
                              "ring_pack@approach"]),
    ("pack_entrants", None): ("ring_pack@entrant", ["ring_pack@entrant"],
                              []),
    ("pack_candidates", None): ("ring_pack@candidate",
                                ["ring_pack@candidate"], []),
    ("pack_approach", None): ("ring_pack@approach", ["ring_pack@approach"],
                              []),
    # K2's two call sites, each row with its own site's launches
    ("cross_caps", "link"): ("cross_caps@link", ["cross_caps"],
                             ["cross_caps@approach"]),
    ("cross_caps", "approach"): ("cross_caps@approach",
                                 ["cross_caps@approach"], []),
    ("car_follow", "lane"): ("car_follow@ring", ["car_follow@ring"],
                             ["car_follow@ring-link"]),
    ("car_follow", "link"): ("car_follow@ring-link",
                             ["car_follow@ring-link"], [])}
FRONT_REPLACES = {
    "front_leaders": "cityflow_tpu/core/ring.py:1151-1300 (approach rows: "
                     "the KOUT min over the out-link ring tails, the "
                     "per-front leaders, v_isr / isr_rel back from the link "
                     "domain)",
    "front_leaders@ctx": "cityflow_tpu/core/ring.py:344-448 (lc_front_ctx: "
                         "the KOUT min, the out-link tails, the next link's "
                         "end-lane tail)",
    "gap_refresh": "cityflow_tpu/core/ring_lc.py:99-158 (refresh_gaps)",
    "ring_pack": "cityflow_tpu/core/ring.py:300-341 (_shifted_exchange / "
                 "_fwd_ex), :686-729 (the forward exchange's channel pack)",
    "ring_pack@entrant": "cityflow_tpu/core/ring.py:1644-1690 (the link "
                         "entrants' pack, to_link)",
    "ring_pack@candidate": "cityflow_tpu/core/ring.py:1744-1837 (the lane "
                           "candidates' pack, E_app)",
    "ring_pack@approach": "cityflow_tpu/core/ring.py:1154-1168, :1206-1231 "
                          "(the approach rows' to_link pack, their _PP)",
    "cross_caps@link": "cityflow_tpu/core/ring.py:881-927 (the foe "
                       "exchange, read in place), :936-996 (cross_caps on "
                       "the link rows)",
    "cross_caps@approach": "cityflow_tpu/core/ring.py:881-927 (the foe "
                           "exchange, read in place), :936-996 (cross_caps "
                           "on the approach rows)",
    "car_follow@ring": "cityflow_tpu/core/ring.py:1301-1386 (the lane "
                       "domain's shifted leader views, gaps, invalid, the "
                       "fronts' override)",
    "car_follow@ring-link": "cityflow_tpu/core/ring.py:1094-1150 (the link "
                            "rows' shifted leader views, the end-lane tail "
                            "at slot 0)"}


def front_label(base, path):
    """A row's name: the base on [main], base@<path> on another path,
    base:<path> where the base already names a mode; the lane-change-only
    rows carry [lc] bare."""
    if path == "main":
        return base
    if base in ("gap_refresh",):
        return f"{base}@{path}"
    if base == "front_leaders@ctx":
        return base if path == "lc" else f"{base}:{path}"
    return f"{base}:{path}" if "@" in base else f"{base}@{path}"


REPLACES.update({front_label(b, p): v + ("" if p == "main" else
                                         RING_PATH_NOTE[p])
                 for b, v in FRONT_REPLACES.items()
                 for p in ("main",) + tuple(RING_PATH_NOTE)})


def record_front_calls(sim, state):
    """One more batched step from a copy of `state` with the R5-R7
    wrappers, K3 and K2 recording their arguments (K3 only in its
    ring-leader mode): the calls before R3's admission keep a copy of the
    leaves R3 writes in place, the others their arguments by reference."""
    import torch
    from cityflow_tpu_torch.core import ring as ring_mod
    from cityflow_tpu_torch.core import ring_lc
    mods = {"ring": ring_mod, "ring_lc": ring_lc}
    calls = {w: [] for _, _, w in FRONT_CALLS}
    calls["car_follow@approach"] = []          # K3's approach-row calls
    orig = {}

    def rec(w, fn):
        def call(*a, **k):
            if w == "car_follow" and k.get("ring") is None:
                if a[0] in (1, 2) and len(a[2]) == 4 \
                        and a[2][0] == sim.cfg.AP:
                    calls["car_follow@approach"].append((a, k))
                return fn(*a, **k)
            kept = a[:2] + (admit_copy(a[2]),) + a[3:] \
                if w in ("front_leaders_lc", "gap_refresh") else a
            calls[w].append((kept, k))
            return fn(*a, **k)
        return call

    try:
        for m, _, w in FRONT_CALLS:
            orig[(m, w)] = getattr(mods[m], w)
            setattr(mods[m], w, rec(w, orig[(m, w)]))
        st, mid = ring_mod.ring_step_p1_batched(sim.tables, sim.cfg,
                                                fresh(state), sim.q)
        ring_mod.ring_step_p2_batched(sim.tables, sim.cfg, st, mid)
        torch.cuda.synchronize()
    finally:
        for (m, w), f in orig.items():
            setattr(mods[m], w, f)
    return calls


def _bitwise(name, got, want):
    """(max |err|, values not bitwise): ints and bools equal, floats equal
    bit for bit (+0.0 and -0.0 apart)."""
    import torch
    err, nbit = 0.0, 0
    for g, w in zip(_flat(got), _flat(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            f"{name}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}"
        if g.dtype == torch.float32:
            nbit += int((g.view(torch.int32) != w.view(torch.int32)).sum())
            d = (g.double() - w.double()).abs().nan_to_num(0.0)
            err = max(err, float(d.max()) if d.numel() else 0.0)
        else:
            nbit += int((g != w).sum())
    return err, nbit


def _mark(acc, x, mask):
    """Mark in `acc` the elements of tensor `x` (which broadcasts to the
    call's shape, that of `mask`) that the True elements of `mask` read.
    acc: {(data pointer, elements, element size): flat bool mask}, so a
    tensor passed as two inputs counts once. A Python value reads
    nothing."""
    import torch
    if not torch.is_tensor(x):
        return
    xs = (1,) * (mask.dim() - x.dim()) + tuple(x.shape)
    m = mask
    for d in range(mask.dim()):
        if xs[d] == 1 and m.shape[d] != 1:
            m = m.any(dim=d, keepdim=True)
    m = torch.broadcast_to(m, xs).reshape(-1)
    key = (x.data_ptr(), x.numel(), x.element_size())
    acc[key] = m if key not in acc else acc[key] | m


def _marked_bytes(acc):
    return sum(int(m.sum()) * key[2] for key, m in acc.items())


def k3_work(a, k):
    """K3's bytes and operations on this call's data. Each input value is
    counted once, and only where the function reads it: every element's
    speed, flags, drv_maxspd and template index; the isr inputs avail,
    can_enter and turn where app, isr_lane_left where red, ff_d and dls
    where any_fail; v_isr where isr_rel; gap, lead_spd and lead_tpl where
    has_lead; custom where has_custom; lane_left where invalid. In the
    ring-leader mode: the ring's distances, speeds, templates and counts
    in full, nxt / last at occupied slots, the lane length where a slot is
    invalid (lane rows) or slot 0 has an end-lane tail (link rows), the
    end-lane bundle's flag in full and its distance, speed and template
    where the tail exists, and the approach rows' flag at the front slots
    of lanes with an in-lane, their speed (and distance) where it holds.
    Each output written once. Operations: ~80 float operations an
    element."""
    import torch
    from cityflow_tpu_torch.kernels.car_follow import INPUTS, S0_EX
    mode, shape = a[0], tuple(a[2])
    raw, r = k.get("raw", False), k.get("ring")
    inp = {n: v for n, v in k.items() if n in INPUTS}
    dev = inp["speed"].device
    elems = 1
    for d in shape:
        elems *= d
    acc = {}

    def full(x):
        return torch.broadcast_to(torch.as_tensor(x, device=dev).bool(),
                                  shape)

    def need(x, m=True):
        _mark(acc, x, full(m))

    for n in ("speed", "any_fail", "app", "isr_rel", "has_custom",
              "drv_maxspd", "invalid", "has_lead", "v_yield"):
        need(inp.get(n))
    need(k.get("tpl"))
    nbytes = 0
    if k.get("table") is not None:
        nbytes += k["table"].numel() * 4
    if mode & 1:
        app = full(inp["app"])
        for n in ("avail", "can_enter", "turn"):
            need(inp[n], app)
        red = app & ~(full(inp["avail"]) & full(inp["can_enter"]))
        need(inp["isr_lane_left"], red)
        need(inp["ff_d"], inp["any_fail"])
        need(inp["dls"], inp["any_fail"])
    elif "v_isr" in inp:
        need(inp["v_isr"], inp["isr_rel"])
    if mode & 2:
        need(inp.get("custom"), inp["has_custom"])
        if r is None:
            has = full(inp["has_lead"])
            need(inp["gap"], has)
            need(inp["lead_spd"], has)
            need(k.get("lead_tpl"), has)
            need(inp["lane_left"], inp["invalid"])
        else:
            S, N, B = r.dis.shape
            ring = lambda x: None if x is None else x.reshape(shape)
            for x in (r.dis, r.speed, r.tpl):
                need(ring(x))
            nbytes += r.n.numel() * 4
            occ = torch.arange(S, device=dev)[:, None, None] < r.n[None]
            if r.kind == "lane":
                need(ring(r.nxt), occ.reshape(shape))
                need(ring(r.last), occ.reshape(shape))
                inv = occ & (r.nxt < 0) & ~r.last
                nbytes += 4 * int(inv.any(-1).any(0).sum())   # len_row
                nbytes += r.in_inv.numel() * 4
                AP, B_ = r.ap_rel.shape[0], r.ap_rel.shape[-1]
                rel = r.ap_rel.reshape(AP, -1, B_)
                front = torch.zeros_like(rel)
                lanes = r.in_inv[r.in_inv >= 0].long()
                front[:min(AP, S), lanes] = True
                _mark(acc, rel, front)
                for x in (r.ap_v, None if raw else r.ap_d):
                    if x is not None:
                        _mark(acc, x.reshape(rel.shape), front & rel)
            else:
                need(inp["lane_left"], inp["invalid"])
                ex = r.s0[S0_EX] > 0.5
                nex = int(ex.sum())
                nbytes += 4 * (ex.numel() + nex * (2 + (r.tpl is not None)))
                nbytes += 4 * int(ex.any(-1).sum())            # len_row
    nbytes += _marked_bytes(acc)
    if mode == 1:
        outs = 4 + 1
    elif raw:
        outs = 4
    else:
        outs = 8 + (4 if r is not None else 0)
    return nbytes + elems * outs, elems * 80


def cross_caps_work(a, k):
    """K2's bytes and operations on this call's data (the wrapper's
    arguments). Each value is counted once, and only where the function
    reads it: every row's relevant flag and its three outputs; a relevant
    row's distance, speed, priority halves, enter time (where `ent` is a
    tensor) and template index; the link type and turn flag of links with
    a relevant row, and their crosses' distance and valid flag; a cross's
    foe_src where some row considers it (valid, ahead of it, relevant),
    its t2 where the foe's yield flag decides, its foelpi where it fails;
    and of the foe's 9 channels in R1's fields, each where the decision
    tree reads it (exists where a row considers the cross, yield where
    the row would yield, ...), once per (channel, fields row, env).
    Operations: ~60 an (row, considered cross)."""
    import torch
    from cityflow_tpu_torch.core.step import can_yield, reach_steps
    from cityflow_tpu_torch.kernels.cross_caps import TPL_COLS
    from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain
    dls, speed, ent, ph, plo, rel, fields, foe_src, tb, prm = a[:10]
    tpl, table = k.get("tpl"), k.get("table")
    R, LK, B = dls.shape
    KC = tb["d"].shape[0]
    dev = dls.device
    src = foe_src.reshape(KC, LK).long()
    has_foe = (src >= 0)[..., None]
    foe = {}

    def fo(c):              # channel c of each cross's foe, (KC, LK, B)
        if c not in foe:
            foe[c] = torch.where(has_foe, fields[c][src.clamp_min(0)], 0.0)
        return foe[c]

    f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    maxneg, yld, ln, turnspd, maxspd, upa, dt = (f(v) for v in prm)
    if tpl is not None:
        tp = tpl_params_plain(tpl, table, TPL_COLS)
    d = tb["d"][..., None]
    t1 = tb["t1"][None, :, None]
    t2 = tb["t2"][..., None]
    turn = tb["turn"][None, :, None]
    need = [torch.zeros((KC, LK, B), dtype=torch.bool, device=dev)
            for _ in range(9)]
    cons_any = torch.zeros((KC, LK), dtype=torch.bool, device=dev)
    t2_any = torch.zeros_like(cons_any)
    fail_any = torch.zeros_like(cons_any)
    n_cons = 0
    one = torch.ones((), dtype=torch.int32, device=dev)
    for r in range(R):
        p = (maxneg, yld, ln, turnspd, maxspd, upa) if tpl is None \
            else tuple(x[r][None] for x in tp)
        target = torch.where(turn, p[3], p[4])
        cons = tb["cvalid"][..., None] & (d >= dls[r][None]) & rel[r][None]
        n_cons += int(cons.sum())
        cons_any |= cons.any(-1)
        cf = cons & has_foe
        need[0] |= cf
        d1 = d - dls[r][None]
        yields = cf & (fo(0) > 0.5) & can_yield(speed[r][None], p[0], p[1],
                                                p[2], d1)
        need[1] |= yields
        fy = fo(1) > 0.5
        t2_any |= (yields & fy).any(-1)
        tree = yields & fy & ~(t1 > t2)
        need[5] |= tree
        fpos = fo(5) > 0
        need[2] |= tree & ~fpos
        need[4] |= tree & fpos
        eq = tree & fpos & (t1 == t2)
        need[6] |= eq
        need[7] |= eq
        need[8] |= eq & (ph[r][None] == fo(7))
        # the decision before the cycle flag (the plain version's tree)
        sr = torch.clamp_max(reach_steps(speed[r][None], d1, target, p[5],
                                         dt), 255)
        fr = fo(4)
        e_r = ent[r][None] if torch.is_tensor(ent) else f(ent)
        pri_win = (ph[r][None] > fo(7)) | ((ph[r][None] == fo(7))
                                           & (plo[r][None] > fo(8)))
        same = torch.where(
            fr > sr, -one, torch.where(
                fr < sr, one, torch.where(
                    e_r == fo(6),
                    torch.where(d1 == fo(5),
                                torch.where(pri_win, -one, one),
                                torch.where(d1 < fo(5), -one, one)),
                    torch.where(e_r < fo(6), -one, one))))
        cleared = torch.where(fo(2) > 0.5, -one, one)
        y = torch.where(
            ~fy, one, torch.where(
                t1 > t2, -one, torch.where(
                    ~fpos, cleared,
                    torch.where(t1 < t2, torch.where(fr > sr, -one, one),
                                same))))
        y1 = yields & (y == 1)
        need[3] |= y1
        fail_any |= (y1 & ~(fo(3) > 0.5)).any(-1)
    valid = src >= 0
    chans = 0
    for c in range(9):
        hit = torch.zeros((fields.shape[1], B), dtype=torch.int32,
                          device=dev)
        hit.index_add_(0, src[valid], need[c][valid].to(torch.int32))
        chans += int((hit > 0).sum())
    n = R * LK * B
    n_rel = int(rel.sum())
    row_in = 4 * (4 + torch.is_tensor(ent) + (tpl is not None))
    cols = rel.any(0).any(-1)
    nbytes = (n * (1 + 1 + 4 + 4)             # rel in; any_fail ff_d ff_foe
              + n_rel * row_in
              + (0 if table is None else table.numel() * 4)
              + int(cols.sum()) * (4 + 1 + KC * (4 + 1))  # t1 turn, d cvalid
              + 4 * (int(cons_any.sum()) + int(t2_any.sum())
                     + int(fail_any.sum()))   # foe_src, t2, foelpi
              + 4 * chans)
    return nbytes, n_cons * 60


def front_work(w, a, k, out):
    """Bytes each R5-R7 call must move (each input read once, only the
    slots and channels it reads, each output written once)."""
    import torch
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts
                         if t is not None)
    cfg, net = a[0], a[1]
    tpl = not cfg.uniform
    outs = nb(*_flat(out))
    AP, IL, G = cfg.AP, cfg.IL, cfg.G
    if w in ("front_leaders", "pack_entrants", "pack_approach"):
        from cityflow_tpu_torch.core.numerics import xla_f32_to_i32
        from cityflow_tpu_torch.kernels._ring_idx import (
            from_link_idx, lpi_of, to_link_idx)
        inl = a[3] if w == "front_leaders" else a[2]
        B = inl.shape[-1]
        plane = IL * G * B * 4                   # one inl channel plane
        nxt = xla_f32_to_i32(inl[2 * AP:3 * AP]).reshape(AP, IL, G, B)
    if w == "front_leaders":
        rs, inl, et, v_isr_ap, isr_rel_ap = a[2:7]
        full = int((rs.n_k > 0).sum())          # link ring tails read
        # each slot reads its next link's isr row where it has one, slot
        # 0 that link's end-lane tail too
        hops = [int((from_link_idx(cfg, lpi_of(cfg, nxt[s])) >= 0).sum())
                for s in range(AP)]
        # inl: distance and next link of every front slot, the speed,
        # occupancy (and template) of slots 0..AP-2 as leaders, the length
        planes = 2 * AP + (2 + tpl) * (AP - 1) + 1
        return (outs + nb(rs.n_k) + planes * plane
                + full * (8 + 4 * tpl) + 5 * sum(hops)
                + hops[0] * (12 + 4 * tpl + 4)), 0
    if w == "front_leaders_lc":
        rs = a[2]
        tails = int((rs.n_l > 0).sum()) * (4 + 4 * tpl) \
            + int((rs.n_k > 0).sum()) * (4 + 4 * tpl)
        return outs + nb(rs.n_l, rs.n_k, rs.l_nxt[0]) + tails, 0
    if w == "gap_refresh":
        from cityflow_tpu_torch.kernels.gap_refresh import _FX
        rs, fx = a[2], a[3]
        # a leader's template is read from slots 0..S-2, the front's own
        # at slot 0; of R5's context only the entries the kernel reads
        lead = lambda t: None if t is None else t[:-1]
        return (outs + nb(rs.l_dis, lead(rs.l_tpl), rs.k_dis,
                          lead(rs.k_tpl), rs.l_gap[0], rs.k_gap[0],
                          rs.l_nxt[0], net["ln_len"], net["lk_len"],
                          *(fx.get(n) for n in _FX))), 0
    if w == "pack_forward":
        rs = a[2]
        valid = int((net["in_src"] >= 0).sum())
        slot = sum(getattr(rs, f).element_size() for f in (
            "l_dis", "l_speed", "l_nxt", "l_nxt3", "l_route", "l_rpos",
            "l_flow", "l_pri", "l_uid", "l_enter", "l_custom",
            "l_hascustom", "l_gap", "l_yv", "l_tpl")
            if getattr(rs, f) is not None)
        B = rs.n_l.shape[-1]
        return outs + valid * B * (cfg.AP * slot + 4 + 8), 0
    # the in-lanes some link starts at (several links may share one)
    ss = net["start_src"]
    starts = int(torch.unique(ss[ss >= 0]).numel())
    if w == "pack_entrants":
        heads = sum(int((to_link_idx(cfg, net, lpi_of(cfg, nxt[s])) >= 0)
                        .sum()) for s in range(AP))
        moved = int((out[:, 0] > 0.5).sum())
        # each start in-lane's next links are read once; a front heading
        # into a link its occupancy and exit flag; an entrant its channels,
        # its in-lane length and its new distance and speed
        NE = out.shape[1]
        return (outs + starts * B * AP * 4 + heads * (4 + 1)
                + moved * 4 * (NE - 1 + 1)), 0
    if w == "pack_approach":
        st = a[3]
        heads = sum(int((to_link_idx(cfg, net, lpi_of(cfg, nxt[s])) >= 0)
                        .sum()) for s in range(AP))
        # each link reads its start index and its start in-lane's length,
        # each start in-lane its front next links once; a front heading
        # into a link its occupancy, in_src, distance, speed, priority
        # halves (and template); with templates the end-lane tail's four
        # channels
        return (outs + nb(net["start_src"], st[6]) + starts * B * AP * 4
                + heads * 4 * (6 + tpl) + tpl * 4 * cfg.LKp * B * 4), 0
    if w == "pack_candidates":
        rs, nd_k, ns_k, pays, exit_flags = a[2:7]
        XKe = exit_flags.shape[0]
        link = [getattr(rs, f)[:XKe] for f in (
            "k_flow", "k_route", "k_rpos", "k_enter", "k_pri", "k_uid",
            "k_gap", "k_tpl") if getattr(rs, f) is not None]
        return outs + nb(nd_k[:XKe], ns_k[:XKe], pays, exit_flags,
                         *link), 0
    raise KeyError(w)


def _call_kind(w, a, k):
    """K3's ring kind, K2's call site (the approach rows pass their one
    enter time as a float), None for the others."""
    if w == "car_follow":
        return k["ring"].kind
    if w == "cross_caps":
        return "link" if hasattr(a[2], "shape") else "approach"
    return None


def check_front_kernels(sim, state, reps, path):
    """R5 (both modes), R6, R7 (four modes), K3's ring-leader mode (lane
    and link rows) and K2 (link and approach rows, the foe read in place)
    against their plain versions on every call of one more step of a ring
    path's own state, bit for bit; each timed on its call beside its
    bound. Rows as front_label names them."""
    import torch
    from cityflow_tpu_torch import kernels
    calls = record_front_calls(sim, state)
    lc = sim.cfg.lane_change
    rows = []
    for _, mname, w in FRONT_CALLS:
        mod = kernels.MODULES[mname]
        kern, plain = getattr(mod, w), getattr(mod, w + "_plain")
        by_kind = {}
        for a, k in calls[w]:
            by_kind.setdefault(_call_kind(w, a, k), []).append((a, k))
        want_n = 0 if (w in ("front_leaders_lc", "gap_refresh") and not lc) \
            else 1
        kinds = {"car_follow": ("lane", "link"),
                 "cross_caps": ("link", "approach")}.get(w, (None,))
        for kind in kinds:
            got_calls = by_kind.get(kind, [])
            assert len(got_calls) == want_n, \
                f"{w} {kind}: {len(got_calls)} calls a step"
            if not want_n:
                continue
            a, k = got_calls[0]
            got = kern(*a, **k)
            want = plain(*a, **k)
            torch.cuda.synchronize()
            base, plus, minus = FRONT_ROWS[(w, kind)]
            label = front_label(base, path)
            err, nbit = _bitwise(label, got, want)
            log(f"[kernels] {label}: 1 call on the {path} step checked, "
                f"max_abs_err={err} not_bitwise={nbit}")
            assert nbit == 0, f"{label}: {nbit} values not bitwise"
            if w == "car_follow":
                nbytes, nops = k3_work(a, k)
            elif w == "cross_caps":
                nbytes, nops = cross_caps_work(a, k)
            else:
                nbytes, nops = front_work(w, a, k, got)
            del got, want
            ms = time_cuda(lambda: kern(*a, **k), reps)
            plain_ms = time_cuda(lambda: plain(*a, **k), reps)
            row = kernel_row(label, err, ms, plain_ms, nbytes, nops, None)
            row["launches_of"] = (path, plus, minus)
            rows.append(row)
    # K3's approach-row calls (the isr mode, then min_chain on the AP
    # rows): bit for bit, timed beside their bounds (printed)
    from cityflow_tpu_torch.kernels import car_follow as k3
    tot = dict(ms=0.0, plain=0.0, bound=0.0)
    for a, k in calls["car_follow@approach"]:
        err, nbit = _bitwise("car_follow@approach", k3.car_follow(*a, **k),
                             k3.car_follow_plain(*a, **k))
        assert nbit == 0, \
            f"car_follow@approach mode {a[0]}: {nbit} values not bitwise"
        nbytes, nops = k3_work(a, k)
        bound = max(nbytes / H100_BYTES_PER_S, nops / H100_F32_FLOPS) * 1e3
        ms = time_cuda(lambda: k3.car_follow(*a, **k), reps)
        plain_ms = time_cuda(lambda: k3.car_follow_plain(*a, **k), reps)
        tot["ms"] += ms
        tot["plain"] += plain_ms
        tot["bound"] += bound
        log(f"[kernels] car_follow approach rows, mode {a[0]}, on the "
            f"{path} step: max_abs_err={err} not_bitwise={nbit} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f}")
    assert len(calls["car_follow@approach"]) == 2, \
        f"K3: {len(calls['car_follow@approach'])} approach-row calls"
    log(f"[kernels] car_follow approach rows on the {path} step, both "
        f"calls: ms={tot['ms']:.4f} plain_ms={tot['plain']:.4f} "
        f"bound_ms={tot['bound']:.4f}")
    return rows


# ---------------------------------------------------------------------------
# the RL control path: RingVecEnv, O1 / O2, the DQN learner
# ---------------------------------------------------------------------------

def check_agreement_rl(cfg_path, steps):
    """The RL env at B=1 on the card against the plain port on the CPU,
    each under its own MaxPressure actions every MP_EVERY steps: equal
    actions at every decision, equal observations (avg_travel_time within
    1e-5 relative)."""
    import torch
    from cityflow_tpu_torch.rl.env import RingVecEnv
    gpu = RingVecEnv(cfg_path, batch=1, horizon=steps + 8)
    cpu = RingVecEnv(cfg_path, batch=1, horizon=steps + 8, device="cpu")
    gpu.reset()
    cpu.reset()
    ag = torch.zeros((1, gpu.num_intersections), dtype=torch.int32)
    ac = ag.clone()
    decisions, moved, att_rel = 0, 0, 0.0
    for t in range(steps):
        if t % MP_EVERY == 0 and t:
            ag, ac = gpu.max_pressure_actions(), cpu.max_pressure_actions()
            assert torch.equal(ag.cpu(), ac), f"step {t}: actions differ"
            decisions += 1
            moved += int((ac != 0).sum())
        og, rg = gpu.step(ag)
        oc, rc = cpu.step(ac)
        for k, v in oc.items():
            if k == "avg_travel_time":
                att_rel = max(att_rel, rel_close(k, og[k], v)[0])
            else:
                assert torch.equal(og[k].cpu(), v), f"step {t}: {k} differs"
        assert torch.equal(rg.cpu(), rc), f"step {t}: reward differs"
    assert moved > 0, "MaxPressure chose phase 0 everywhere"
    assert int(cpu.state.n_l.sum()) > 0 and float(rc.sum()) < 0, \
        "no waiting vehicles"
    log(f"[agree-rl] {steps} steps B=1: decisions={decisions} "
        f"nonzero_actions={moved} waiting={int(-float(rc.sum()))} "
        f"avg_travel_time_max_rel={att_rel}")


def rl_shares(env, nsteps):
    """Device time of O1 and O2 per step (CUDA events around each wrapper
    call) and of the whole step, over `nsteps` steps with the controller
    deciding every step. Each step starts behind a ~0.1 s device spin, so
    the events time the device, not the host's first launches."""
    import torch
    from cityflow_tpu_torch.core import ring_observe
    points = [(ring_observe, n)
              for n in ("lane_waiting", "lane_obs", "phase_pressure")]
    torch.cuda.synchronize()
    total = 0.0
    with timed_calls(points) as events:
        for _ in range(nsteps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(200_000_000)
            ev[0].record()
            env.step(env.max_pressure_actions())
            ev[1].record()
            torch.cuda.synchronize()
            total += ev[0].elapsed_time(ev[1]) / nsteps
    return per_step_ms(events, nsteps), total


def run_rl(cfg_path, batch, warmup, steps):
    """RingVecEnv at `batch` envs: `warmup` steps of one env under
    MaxPressure every MP_EVERY steps, copied into the batch, then `steps`
    timed steps of step() with max_pressure_actions() every MP_EVERY-th,
    with the launch counts set to 0 just before and read just after."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.core.ring import batch_ring_state
    from cityflow_tpu_torch.rl.env import RingVecEnv
    t0 = time.time()
    env = RingVecEnv(cfg_path, batch=1,
                     horizon=warmup + steps + 8 + 5 * DQN_ITERS + 16,
                     lane_slots=40)
    env.reset()
    acts = torch.zeros((1, env.num_intersections), dtype=torch.int32,
                       device=env.device)
    for t in range(warmup):
        if t % MP_EVERY == 0 and t:
            acts = env.max_pressure_actions()
        env.step(acts)
    env.state = batch_ring_state(env.state.map(lambda x: x[..., 0]), batch)
    env.batch = batch
    acts = acts.expand(batch, -1).contiguous()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    changed = torch.zeros((), dtype=torch.int64, device=env.device)
    kernels.reset_launches()
    t0 = time.time()
    for t in range(steps):
        if t % MP_EVERY == 0:
            acts = env.max_pressure_actions()
            # on the device: no host sync inside the timed window
            changed += (env.state.phase[:, 0] != acts[0]
                        .index_select(0, env._i_ring2orig)).sum()
        obs, reward = env.step(acts)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kernels.launch_counts()
    st = env.state
    changed = int(changed)
    ms = dt * 1e3 / steps
    veh = int(st.n_l[:, 0].sum() + st.n_k[:, 0].sum())
    log(f"[rl] B={batch} steps={steps} warmup={warmup} "
        f"ms_per_batched_step={ms:.3f} "
        f"env_steps_per_s={batch * steps / dt:.1f} vehicles_per_env={veh} "
        f"waiting_env0={int(-float(reward[0]))} "
        f"phase_changes_by_controller={changed} warmup_s={warm_s:.1f}")
    log(f"[rl] launches={launches}")
    assert int(st.overflow.max()) == 0, "overflow flags set"
    assert veh > 0, "no vehicles"
    for k, v in st.leaves().items():
        assert torch.equal(v, v[..., :1].expand_as(v)), \
            f"env columns differ in {k}"
    for k in MAIN_KERNELS + RL_KERNELS + ("lane_stats@obs",):
        assert launches[k] > 0, f"kernel {k} was not launched on rl"
    assert changed > 0, "the controller changed no phase in the window"
    peak = torch.cuda.max_memory_allocated()
    per, tot = rl_shares(env, 5)
    for n, v in per.items():
        log(f"[rl] {n}: {v:.3f} ms/step ({100 * v / tot:.1f}% of a "
            f"{tot:.3f} ms step with the controller every step; CUDA "
            f"events, 5 steps)")
    log(f"[rl] max_memory_allocated={peak} bytes ({peak / 2**30:.2f} GiB)")
    res = dict(B=batch, steps=steps, warmup=warmup, ms_per_step=ms,
               env_steps_per_s=batch * steps / dt, vehicles=veh,
               launches_per_step={k: v / steps for k, v in launches.items()},
               o_ms_per_step=per, step_ms_with_controller=tot,
               peak_bytes=peak)
    return launches, res, env


def check_rl_kernels(env, reps):
    """O1 in its three modes and O2 in its two against their plain
    versions on the rl path's own B=128 state; integer outputs exact, the
    float sums within 1e-5 relative; timed."""
    import torch
    from cityflow_tpu_torch.kernels import lane_stats as o1
    from cityflow_tpu_torch.kernels import phase_pressure as o2
    st, tabs, cfg = env.state, env.sim.tables, env.sim.cfg
    P, I = env._max_phases, cfg.I
    SL, N, B = st.l_speed.shape
    NK = st.n_k.shape[0]
    occ_l = int(st.n_l.clamp(max=SL).sum())
    occ_k = int(st.n_k.clamp(max=st.k_enter.shape[0]).sum())
    rows = []
    # waiting mode: the occupied speeds, the counts, the waiting counts
    args = (st.l_speed, st.n_l)
    assert torch.equal(o1.lane_waiting(*args), o1.lane_waiting_plain(*args))
    ms = time_cuda(lambda: o1.lane_waiting(*args), reps)
    plain = time_cuda(lambda: o1.lane_waiting_plain(*args), reps)
    rows.append(kernel_row("lane_stats", 0.0, ms, plain,
                           4 * occ_l + 8 * N * B, occ_l, None))
    # observation mode: + the enter times of occupied lane and link slots
    now = st.step.to(torch.float32) * tabs["ring_f32"][len(cfg.params)]
    args = (st.l_speed, st.n_l, st.l_enter, st.k_enter, st.n_k, now)
    got, want = o1.lane_obs(*args), o1.lane_obs_plain(*args)
    assert torch.equal(got[0], want[0]), "lane_stats@obs waiting differs"
    rel, nbit = rel_close("lane_stats@obs inflight", got[1], want[1])
    err = float((got[1] - want[1]).abs().max())
    log(f"[kernels] lane_stats@obs: inflight max_rel={rel} "
        f"not_bitwise={nbit} of {B}")
    ms = time_cuda(lambda: o1.lane_obs(*args), reps)
    plain = time_cuda(lambda: o1.lane_obs_plain(*args), reps)
    rows.append(kernel_row(
        "lane_stats@obs", err, ms, plain,
        8 * occ_l + 4 * occ_k + 8 * N * B + 4 * NK * B + 8 * B,
        2 * (occ_l + occ_k) + occ_l, None))
    # history mode on a filled window, every env at one h_t as on a path:
    # once before the window is full and once after, where each env's
    # ring row is read and written; timed at the second
    H = cfg.history_len + 1
    dev = st.l_speed.device
    gen = torch.Generator(device=dev).manual_seed(0)
    ring_num = torch.randint(0, SL + 1, (H, N, B), generator=gen,
                             device=dev).to(torch.float32)
    ring_ssum = torch.rand((H, N, B), generator=gen, device=dev) * 300.0
    h_num, h_ssum = ring_num.sum(0), ring_ssum.sum(0)
    rk = (ring_num.clone(), ring_ssum.clone())
    rp = (ring_num, ring_ssum)
    err, rel, nbit = 0.0, 0.0, 0
    for h in (5, H + 5):
        h_t = torch.full((B,), h, dtype=torch.int32, device=dev)
        args = lambda r: (st.l_speed, st.n_l, *r, h_num, h_ssum, h_t)
        got = o1.lane_history(*args(rk))
        want = o1.lane_history_plain(*args(rp))
        assert torch.equal(got[0], want[0]), "lane_stats@hist h_num differs"
        assert torch.equal(rk[0], rp[0]), "lane_stats@hist ring differs"
        for name, g_, w_ in (("h_ssum", got[1], want[1]),
                             ("h_ring_ssum", rk[1], rp[1])):
            r_, nb = rel_close(f"lane_stats@hist {name}", g_, w_)
            rel, nbit = max(rel, r_), nbit + nb
            err = max(err, float((g_ - w_).abs().max()))
    log(f"[kernels] lane_stats@hist: speed sums max_rel={rel} "
        f"not_bitwise={nbit}")
    ms = time_cuda(lambda: o1.lane_history(*args(rk)), reps)
    plain = time_cuda(lambda: o1.lane_history_plain(*args(rp)), reps)
    # occupied speeds, counts, h_t, the window sums in and out, the ring
    # row of each env read and written
    rows.append(kernel_row(
        "lane_stats@hist", err, ms, plain,
        4 * occ_l + 4 * N * B + 4 * B + 16 * N * B + 16 * N * B,
        occ_l + 4 * N * B, None))
    del ring_num, ring_ssum, rk, rp
    torch.cuda.empty_cache()
    # O2: the lanes it reads are the links' start and end lanes
    w = o1.lane_waiting(st.l_speed, st.n_l)
    ss = tabs["start_src"]
    lanes = torch.cat([tabs["in_src"].reshape(-1)[ss[ss >= 0].long()],
                       tabs["end_src"]])
    nlanes = int(torch.unique(lanes[lanes >= 0]).numel())
    G = tabs["g_n_phases"].shape[0]
    LPI = ss.shape[0] // G
    # the function needs the seven index tables once; the kernel reads
    # instead its lane tables (per intersection lane its id and the
    # counts of the phases it sums: cp, with features also cs and cup)
    # and g_n_phases. The bound takes the smaller of the two counts, the
    # other is logged beside it
    tab_bytes = sum(tabs[k].numel() * 4 for k in o2.TABLES)
    lanes_t = o2.lane_tables(tabs)[0]
    n_ent = int((lanes_t >= 0).sum())
    passes = -(-P // 16)
    for features, name in ((False, "phase_pressure"),
                           (True, "phase_pressure@features")):
        lane_bytes = lanes_t.numel() * 4 + G * 4 \
            + n_ent * passes * (66 if features else 32)
        a = (w, tabs, P, I, features)
        got, want = o2.phase_pressure(*a), o2.phase_pressure_plain(*a)
        for g_, w_ in zip(got, want):
            assert bitwise_equal(g_, w_), f"{name} differs"
        ms = time_cuda(lambda: o2.phase_pressure(*a), reps)
        plain = time_cuda(lambda: o2.phase_pressure_plain(*a), reps)
        outs = sum(t.numel() * t.element_size() for t in got)
        counts = {"the seven index tables": tab_bytes,
                  "the lane tables": lane_bytes}
        for what, nb in counts.items():
            ms_ = (4 * nlanes * B + nb + outs) / H100_BYTES_PER_S * 1e3
            log(f"[kernels] {name}: bound_ms with {what}={ms_:.4f}")
        rows.append(kernel_row(name, 0.0, ms, plain,
                               4 * nlanes * B + min(counts.values()) + outs,
                               2 * G * B * P * LPI, None))
    return rows


def run_dqn(env, iters):
    """make_ring_dqn_split_step from the rl path's state: `iters`
    iterations of 5 steps at eps 0.3, the launch counts set to 0 just
    before and read just after."""
    import math
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.rl import dqn, ring_dqn
    sim, P = env.sim, env._max_phases
    init_fn, train_iter = ring_dqn.make_ring_dqn_split_step(
        sim.tables, sim.cfg, P, sim_steps_per_action=5)
    gen = torch.Generator(device=env.device).manual_seed(0)
    params, opt = init_fn(gen, P)
    target = dqn.copy_params(params)
    st = env.state
    step0 = int(st.step[0])
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses, ms = [], []
    for _ in range(iters):
        t0 = time.time()
        params, opt, st, gen, m = train_iter(sim.tables, params, target, opt,
                                             st, sim.q, gen, 0.3)
        losses.append(m["loss"])
        torch.cuda.synchronize()
        ms.append((time.time() - t0) * 1e3)
    launches = kernels.launch_counts()
    losses = [float(x) for x in losses]
    # the first iteration also pays the learner's one-time set-up on the
    # card (the first matmuls, autograd, Adam's state)
    steady = sum(ms[1:]) / max(len(ms) - 1, 1)
    log(f"[dqn] B={st.n_l.shape[-1]} iters={iters} "
        f"ms_per_iteration={sum(ms) / iters:.3f} first_ms={ms[0]:.3f} "
        f"later_ms_mean={steady:.3f} ms={[round(x, 3) for x in ms]} "
        f"losses={losses} mean_reward={float(m['mean_reward'])} "
        f"launches={launches}")
    assert all(math.isfinite(x) for x in losses), "loss not finite"
    assert int(st.step[0]) == step0 + 5 * iters, "steps not advanced"
    assert int(st.overflow.max()) == 0, "overflow flags set"
    for k in ("phase_pressure@features", "lane_stats"):
        assert launches[k] > 0, f"kernel {k} was not launched on dqn"
    # O2 on the learner's own calls: one more iteration (from a copy)
    # with the calls recorded, each held bitwise to the plain version
    from cityflow_tpu_torch.core import ring_observe
    from cityflow_tpu_torch.kernels import phase_pressure as o2
    calls, orig = [], ring_observe.phase_pressure

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    ring_observe.phase_pressure = rec
    try:
        train_iter(sim.tables, params, target, opt, fresh(st), sim.q, gen,
                   0.3)
        torch.cuda.synchronize()
    finally:
        ring_observe.phase_pressure = orig
    assert calls, "[dqn] no O2 call recorded"
    for a, k in calls:
        for g_, w_ in zip(o2.phase_pressure(*a, **k),
                          o2.phase_pressure_plain(*a, **k)):
            assert bitwise_equal(g_, w_), "[dqn] O2 differs"
    a, k = calls[0]
    o2_ms = time_cuda(lambda: o2.phase_pressure(*a, **k), REPS)
    o2_plain = time_cuda(lambda: o2.phase_pressure_plain(*a, **k), REPS)
    log(f"[dqn] phase_pressure@features: {len(calls)} calls of one "
        f"iteration bitwise; on its first: ms={o2_ms:.4f} "
        f"plain_ms={o2_plain:.4f} (B={a[0].shape[-1]}, "
        f"features={k.get('features')})")
    return launches, dict(iters=iters, ms_per_iteration=sum(ms) / iters,
                          first_ms=ms[0], later_ms_mean=steady,
                          losses=losses, o2_ms=o2_ms, o2_plain_ms=o2_plain)


# ---------------------------------------------------------------------------
# the gen-1 exact Engine: goldens, card vs CPU, the 30x30 path, G1-G4
# ---------------------------------------------------------------------------

def golden_lines(name):
    """The reference's per-step records (tests/goldens/*.jsonl.gz); the
    oracle prints C++ inf / nan as they are."""
    import gzip
    with gzip.open(os.path.join(HERE, "tests", "goldens", name), "rt") as f:
        for line in f:
            yield json.loads(line.replace(":inf", ":Infinity")
                             .replace(":-inf", ":-Infinity")
                             .replace(":nan", ":NaN"))


def rl_phase_commands(step, inter_ids, n_phases=8, period=5):
    """The RL phase schedule the grid4x4_rl golden was dumped under: every
    `period` steps each real intersection gets an explicit phase."""
    if step % period:
        return []
    k = step // period
    return [(iid, (k * 7 + 3 * i) % n_phases)
            for i, iid in enumerate(inter_ids)]


def golden_mismatches(eng, gold, t):
    """Running vehicles' (drivable, distance, speed) against one golden
    record, exactly; returns the differences."""
    import numpy as np
    c = eng._fetch()
    host, L = eng.net.host, eng.cfg.num_lanes
    mine = {}
    for s in np.nonzero(c["running"])[0]:
        d = int(c["drv"][s])
        mine[eng._veh_id(int(c["uid"][s]))] = (
            host.lane_ids[d] if d < L else host.ll_ids[d - L],
            float(c["dis"][s]), float(c["speed"][s]))
    theirs = {v["id"]: (v["drv"], v["dis"], v["speed"])
              for v in gold["vehicles"]}
    if set(mine) != set(theirs):
        return [f"t={t}: vehicle sets differ "
                f"({sorted(set(mine) ^ set(theirs))[:5]})"]
    return [f"t={t} {k}: {mine[k]} != {theirs[k]}" for k in mine
            if mine[k] != theirs[k]]


def _gen1_golden_run(eng, golden, n, ids=None, atol_after=None,
                     exact_to=None):
    """Step `eng` n times against a golden's records; bitwise through
    step exact_to (all steps when None), then within atol_after with
    shadow twins left out. Returns the lane-change events of both
    (a drivable change within one road) in order."""
    gold = golden_lines(golden)
    next(gold)
    ev_g, ev_m, prev_g, prev_m = [], [], {}, {}
    L = eng.cfg.num_lanes
    host = eng.net.host

    def changes(prev, items, acc):
        for vid, drv in items:
            old = prev.get(vid)
            if old is not None and old != drv and "_TO_" not in old \
                    and "_TO_" not in drv \
                    and old.rsplit("_", 1)[0] == drv.rsplit("_", 1)[0]:
                acc.append(vid)
            prev[vid] = drv
    import numpy as np
    for t in range(n):
        if ids is not None:
            for iid, ph in rl_phase_commands(t, ids):
                eng.set_tl_phase(iid, ph)
        eng.next_step()
        g = next(gold)
        assert g["t"] == t + 1
        if exact_to is None or t + 1 <= exact_to:
            bad = golden_mismatches(eng, g, t + 1)
        else:
            bad = golden_near(eng, g, t + 1, atol_after)
        assert not bad, f"[golden-gen1] {golden}: " + "; ".join(bad[:5])
        c = eng._fetch()
        changes(prev_g, [(v["id"], v["drv"]) for v in g["vehicles"]], ev_g)
        changes(prev_m, [
            (eng._veh_id(int(c["uid"][s])),
             host.lane_ids[c["drv"][s]] if c["drv"][s] < L
             else host.ll_ids[c["drv"][s] - L])
            for s in np.nonzero(c["running"] & ~c["is_shadow"])[0]], ev_m)
    return ev_g, ev_m


def golden_near(eng, gold, t, atol):
    """Real vehicles' drivables equal, distance and speed within atol."""
    import numpy as np
    c = eng._fetch()
    host, L = eng.net.host, eng.cfg.num_lanes
    mine = {}
    for s in np.nonzero(c["running"] & ~c["is_shadow"])[0]:
        d = int(c["drv"][s])
        mine[eng._veh_id(int(c["uid"][s]))] = (
            host.lane_ids[d] if d < L else host.ll_ids[d - L],
            float(c["dis"][s]), float(c["speed"][s]))
    theirs = {v["id"]: (v["drv"], v["dis"], v["speed"])
              for v in gold["vehicles"]}
    if set(mine) != set(theirs):
        return [f"t={t}: vehicle sets differ"]
    return [f"t={t} {k}: {mine[k]} != {theirs[k]}" for k in mine
            if mine[k][0] != theirs[k][0]
            or abs(mine[k][1] - theirs[k][1]) > atol
            or abs(mine[k][2] - theirs[k][2]) > atol]


def check_golden_gen1():
    """The card Engine against the reference goldens: three trajectories
    at atol=0, the single lane changer (bitwise through step 150, within
    1e-6 with the same change events through 175), the DURATION router's
    lane history (sums equal, durations within 1e-9 relative) and the
    replay lines (positions within 1e-6, the rest equal)."""
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.tools.scenario import prepare
    fix = os.path.join(HERE, "tests", "fixtures")
    for config, golden, n, rl in GOLDEN_GEN1:
        t0 = time.time()
        eng = Engine(prepare(os.path.join(fix, config)), spawn_horizon=n + 8)
        ids = sorted(i.id for i in eng.net.host.net.intersections
                     if not i.virtual) if rl else None
        _gen1_golden_run(eng, golden, n, ids=ids)
        log(f"[golden-gen1] {config}: {n} steps bit-exact (atol=0) against "
            f"{golden}; vehicles={eng.get_vehicle_count()} "
            f"pool={eng.cfg.max_vehicles} growths={eng.growths} "
            f"wall_s={time.time() - t0:.1f}")
    t0 = time.time()
    eng = Engine(prepare(os.path.join(fix, "config_lc_single.json")))
    ev_g, ev_m = _gen1_golden_run(eng, "lc_single_180.jsonl.gz", 175,
                                  exact_to=150, atol_after=1e-6)
    assert ev_g and ev_m == ev_g, f"[golden-gen1] change events {ev_m} " \
        f"!= {ev_g}"
    log(f"[golden-gen1] config_lc_single.json: bit-exact through step 150, "
        f"within 1e-6 through 175, the same {len(ev_g)} change events "
        f"({ev_g}); wall_s={time.time() - t0:.1f}")
    check_history_golden()
    check_replay_golden()


def check_history_golden():
    """config_2x2.json under routerType DURATION against history_2x2_40:
    per road and step the window vehicle sum equal, the duration within
    1e-9 relative (or both -1 / inf)."""
    import gzip
    import math
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.tools.scenario import prepare
    t0 = time.time()
    eng = Engine(prepare(os.path.join(HERE, "tests", "fixtures",
                                      "config_2x2.json"),
                         name="config_2x2_duration", routerType="DURATION"))
    with gzip.open(os.path.join(HERE, "tests", "goldens",
                                "history_2x2_40.jsonl.gz"), "rt") as f:
        gold = [json.loads(line) for line in f]
    road_index = {r.id: r.index for r in eng.net.host.net.roads}
    worst = 0.0
    for rec in gold:
        eng.next_step()
        durs = eng._road_durations()
        nums, _ = eng._lane_history_np()
        for rid, ref_num, ref_dur in rec["roads"]:
            road = eng.net.host.net.roads[road_index[rid]]
            num = sum(int(nums[lane.index]) for lane in road.lanes)
            assert num == ref_num, f"[golden-gen1] history t={rec['t']} {rid}"
            d = durs[road.index]
            if ref_dur < 0 or math.isinf(ref_dur):
                assert d == ref_dur, f"[golden-gen1] duration {rid}: {d}"
            else:
                rel = abs(d - ref_dur) / max(abs(ref_dur), 1)
                assert rel <= 1e-9, f"[golden-gen1] duration {rid}: {rel}"
                worst = max(worst, rel)
    log(f"[golden-gen1] config_2x2.json DURATION: {len(gold)} steps of "
        f"history_2x2_40.jsonl.gz, window sums equal, durations within "
        f"{worst:.3e} relative; wall_s={time.time() - t0:.1f}")


def check_replay_golden():
    """The replay lines of config_2x2.json against replay_2x2_60: the
    same vehicles, positions and angles within 1e-6, the same lcDir,
    length, width and signal sections."""
    import gzip
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.tools.scenario import prepare
    t0 = time.time()
    cfg = prepare(os.path.join(HERE, "tests", "fixtures", "config_2x2.json"),
                  name="config_2x2_replay", saveReplay=True,
                  roadnetLogFile="replay_roadnet.json",
                  replayLogFile="replay.txt")
    eng = Engine(cfg)
    for _ in range(60):
        eng.next_step()
    eng.set_save_replay(False)
    with open(os.path.join(os.path.dirname(cfg), "replay.txt")) as f:
        mine = f.read().splitlines()
    with gzip.open(os.path.join(HERE, "tests", "goldens",
                                "replay_2x2_60.txt.gz"), "rt") as f:
        ref = f.read().splitlines()
    assert len(mine) == len(ref) == 60

    def parse(line):
        veh, road = line.split(";", 1)
        vs = {}
        for r in veh.split(","):
            if r.strip():
                x, y, ang, vid, lc, ln, w = r.split()
                vs[vid] = (float(x), float(y), float(ang), lc, ln, w)
        return vs, road
    worst = 0.0
    for t, (lm, lr) in enumerate(zip(mine, ref), 1):
        (vm, rm), (vr, rr) = parse(lm), parse(lr)
        assert set(vm) == set(vr) and rm == rr, f"[golden-gen1] replay t={t}"
        for vid in vr:
            d = max(abs(a - b) for a, b in zip(vm[vid][:3], vr[vid][:3]))
            assert d <= 1e-6 and vm[vid][3:] == vr[vid][3:], \
                f"[golden-gen1] replay t={t} {vid}"
            worst = max(worst, d)
    log(f"[golden-gen1] config_2x2.json replay: 60 lines match "
        f"replay_2x2_60.txt.gz (positions within {worst:.3e}); "
        f"wall_s={time.time() - t0:.1f}")


def bitwise_equal(a, b):
    """Equal bit for bit (floats compared as integers: -0.0 != +0.0)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        it = {torch.float64: torch.int64, torch.float32: torch.int32}
        a, b = a.view(it[a.dtype]), b.view(it[b.dtype])
    return bool(torch.equal(a, b))


def check_agreement_gen1(cfg_path, steps, tag="agree-gen1"):
    """The Engine on the card against the Engine on the CPU: every SimState
    leaf bitwise equal every 10 steps; the steps whose state holds a
    shadow are counted."""
    from cityflow_tpu_torch.engine import Engine
    t0 = time.time()
    gpu = Engine(cfg_path, spawn_horizon=steps + 8)
    cpu = Engine(cfg_path, spawn_horizon=steps + 8, device="cpu")
    shadow_steps = 0
    for i in range(1, steps + 1):
        gpu.next_step()
        cpu.next_step()
        shadow_steps += bool((cpu.state.is_shadow & cpu.state.running).any())
        if i % 10 and i != steps:
            continue
        g, c = gpu.state.leaves(), cpu.state.leaves()
        for k in g:
            assert bitwise_equal(g[k].cpu(), c[k]), \
                f"[{tag}] step {i}: {k} differs"
    assert gpu.get_vehicle_count() > 0
    log(f"[{tag}] {steps} steps: every SimState leaf bitwise equal, "
        f"vehicles={gpu.get_vehicle_count()} pool={gpu.cfg.max_vehicles} "
        f"growths={gpu.growths} steps_with_shadows={shadow_steps} "
        f"wall_s={time.time() - t0:.1f}")
    return shadow_steps


def _gen1_points(names):
    from cityflow_tpu_torch import kernels
    return [(kernels.MODULES[n], n) for n in names]


def gen1_shares(step, nsteps, names):
    """Device time of the G kernels per step (CUDA events around each
    wrapper call) and of whole steps, over `nsteps` calls of step()."""
    import torch
    torch.cuda.synchronize()
    total = 0.0
    with timed_calls(_gen1_points(names)) as events:
        for _ in range(nsteps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step()
            ev[1].record()
            torch.cuda.synchronize()
            total += ev[0].elapsed_time(ev[1]) / nsteps
    return per_step_ms(events, nsteps), total


def run_gen1(cfg_path, warmup, steps, tag="gen1", names=GEN1_KERNELS,
             exact=True, modes=()):
    """The gen-1 Engine on the card (exact, or fast mode: float32):
    `warmup` steps, then `steps` timed ones with the launch counts set to
    0 just before and read just after; every kernel in `names` and every
    mode in `modes` must have launched in them. Under lane change the
    first warm-up step with a shadow is printed and the timed steps must
    hold shadows (counted on the device). Returns the launches, the
    report, the Engine and its state after the warm-up."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.engine import Engine
    t0 = time.time()
    eng = Engine(cfg_path, exact=exact, backend="gen1",
                 spawn_horizon=warmup + steps + 16)
    lc = eng.lane_change
    setup_s = time.time() - t0
    t0 = time.time()
    first = None
    for i in range(warmup):
        eng.next_step()
        if lc and first is None and i % 10 == 9 and bool(
                (eng.state.is_shadow & eng.state.running).any()):
            first = i + 1
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    warm = eng.state    # the step writes no tensor of its input state
                        # (G15 writes the step's own, in place)
    torch.cuda.reset_peak_memory_stats()
    g0 = eng.growths
    shadows = torch.zeros((), dtype=torch.int64, device=eng.device)
    kernels.reset_launches()
    t0 = time.time()
    for _ in range(steps):
        eng.next_step()
        if lc:
            shadows += (eng.state.is_shadow & eng.state.running).sum()
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = eng.state
    run = st.running
    veh = int(run.sum())
    assert veh > 0, "no vehicles"
    assert bool(torch.isfinite(st.dis[run]).all()
                and torch.isfinite(st.speed[run]).all()), "state not finite"
    assert bool((st.dis[run] >= 0).all()), "negative distance"
    assert int(st.overflow) & ~eng._ov == 0
    for k in names + tuple(modes):
        assert launches[k] > 0, f"kernel {k} was not launched on {tag}"
    for k in ("spawn_slots@inplace", "hist_window@inplace"):
        assert launches[k] == 0, f"{k} on {tag}: the Engine keeps its state"
    per_step = {k: launches[k] / steps for k in launches
                if launches[k] and k.split("@")[0] in names}
    ms = dt * 1e3 / steps
    log(f"[{tag}] steps={steps} warmup={warmup} ms_per_step={ms:.3f} "
        f"steps_per_s={steps / dt:.1f} vehicles={veh} "
        f"waiting={int((st.active & ~run).sum())} "
        f"finished={int(st.finished_cnt)} pool={eng.cfg.max_vehicles} "
        f"growths={eng.growths} (in the window {eng.growths - g0}) "
        f"k_link={eng.cfg.k_link} setup_s={setup_s:.1f} "
        f"warmup_s={warm_s:.1f}")
    res = {}
    if lc:
        res = dict(shadow_rows_in_window=int(shadows),
                   first_shadow_step_by_10=first)
        log(f"[{tag}] shadows summed over the timed steps: {int(shadows)}; "
            f"first warm-up step with a shadow (checked every 10): {first}")
        assert int(shadows) > 0, f"no shadows in the {tag} window"
    log(f"[{tag}] launches per step={per_step}")
    per, tot = gen1_shares(eng.next_step, 5, names)
    for n, v in per.items():
        log(f"[{tag}] kernel {n}: {v:.4f} ms/step ({100 * v / tot:.2f}% of "
            f"a {tot:.3f} ms step; CUDA events, 5 steps)")
    prof = gen1_profile(eng.next_step, 3, ms, tag)
    log(f"[{tag}] max_memory_allocated={peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    return launches, dict(
        steps=steps, warmup=warmup, ms_per_step=ms, vehicles=veh,
        pool=eng.cfg.max_vehicles, growths=eng.growths,
        growths_in_window=eng.growths - g0, launches_per_step=per_step,
        kernel_ms_per_step=per, step_ms_events=tot, peak_bytes=peak,
        **res, **prof), eng, warm


def gen1_profile(step, nsteps, wall_ms, tag):
    """`nsteps` calls of step() under torch.profiler: the device's kernel
    time and
    kernel count per step, its busy share of the unprofiled `wall_ms`,
    and the operators that take the most device time."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(nsteps):
            step()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in ka if e.device_type == cuda]
    dev_t = lambda e: (getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0))
    dev_ms = sum(dev_t(e) for e in dev) / 1e3 / nsteps
    nker = sum(e.count for e in dev) / nsteps
    top = sorted(dev, key=dev_t, reverse=True)[:6]
    log(f"[{tag}] profiler, {nsteps} steps: device kernel time "
        f"{dev_ms:.3f} ms/step over {nker:.0f} kernels/step; device busy "
        f"{100 * dev_ms / wall_ms:.1f}% of the {wall_ms:.3f} ms unprofiled "
        f"step")
    for e in top:
        log(f"[{tag}]   {e.key[:60]}: {dev_t(e) / 1e3 / nsteps:.4f} ms/step, "
            f"{e.count / nsteps:.0f} per step")
    return dict(device_ms_per_step=dev_ms, kernels_per_step=nker,
                device_busy=dev_ms / wall_ms)


# the gen-1 kernels that write some of their arguments in place: G15
# always, G11 and G5 in their in-place form (the state donated)
GEN1_WRITERS = ("shadow_insert", "spawn_slots", "hist_window")


def gen1_written(n, a, k):
    """The tensors the call (a, k) of G kernel n writes in place (none for
    a call that writes no argument)."""
    if n == "shadow_insert":
        from cityflow_tpu_torch.kernels.shadow_insert import LEAVES
        return [getattr(a[1], f) for f in LEAVES + ("seq_counter",
                                                     "overflow")]
    if n == "spawn_slots" and k.get("inplace"):
        from cityflow_tpu_torch.kernels.spawn_slots import LEAVES
        return [getattr(a[0], f) for f in LEAVES + ("spawn_cursor",
                                                     "overflow")]
    if n == "hist_window" and k.get("inplace"):
        return list(a[3:7])
    return []


def record_gen1_calls(step, names):
    """One more call of step() with the wrappers of `names` recording
    their arguments as they were at the call. G15, and G11 and G5 where
    the state is donated, write some of their arguments in place: their
    arguments are recorded on a copy (fresh_args), and before each such
    call, every argument recorded earlier in the step that shares storage
    with a tensor it writes is replaced by a copy taken just before it
    writes (as_before), whether or not that kernel is among `names`. No
    other gen-1 kernel writes a tensor in place."""
    import torch
    from cityflow_tpu_torch import kernels
    mods = {n: kernels.MODULES[n] for n in tuple(names) + GEN1_WRITERS}
    orig = {n: getattr(m, n) for n, m in mods.items()}
    calls = {n: [] for n in names}

    def rec(n):
        def fn(*a, **k):
            written = gen1_written(n, a, k)
            if written:
                as_before(calls, written)
            if n in calls:
                calls[n].append((fresh_args(n, a, k), k))
            return orig[n](*a, **k)
        return fn
    try:
        for n, m in mods.items():
            setattr(m, n, rec(n))
        step()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        for n, m in mods.items():
            setattr(m, n, orig[n])
    return calls


def as_before(calls, written):
    """Replace, in the arguments recorded so far, every tensor that shares
    storage with a tensor of `written` (about to be written in place) by
    a copy (one copy per tensor, so arguments that were one tensor stay
    one)."""
    import dataclasses
    import torch
    ptrs = {t.untyped_storage().data_ptr() for t in written}
    memo = {}

    def fix(x):
        if isinstance(x, torch.Tensor):
            if x.untyped_storage().data_ptr() not in ptrs:
                return x
            if id(x) not in memo:
                memo[id(x)] = x.clone()
            return memo[id(x)]
        if isinstance(x, (tuple, list)):
            return type(x)(fix(y) for y in x)
        if isinstance(x, dict):
            return {key: fix(y) for key, y in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            new = {f.name: fix(getattr(x, f.name))
                   for f in dataclasses.fields(x)}
            if any(v is not getattr(x, f) for f, v in new.items()):
                return dataclasses.replace(x, **new)
        return x
    for n, cs in calls.items():
        calls[n] = [(fix(a), fix(k)) for a, k in cs]


def fresh_args(n, a, k):
    """The arguments of call (a, k) of G kernel n with what it writes in
    place copied (shadow_copy, spawn_copy, the G5 rings and sums), so that
    a call on the copy sees the state as the recorded call did; a call
    that writes no argument keeps its own."""
    if n == "shadow_insert":
        return shadow_copy(a)
    if n == "spawn_slots" and k.get("inplace"):
        return spawn_copy(a)
    if n == "hist_window" and k.get("inplace"):
        return a[:3] + tuple(t.clone() for t in a[3:7]) + a[7:]
    return a


def spawn_copy(a):
    """G11's arguments with the state's per-slot leaves, spawn_cursor and
    overflow (what its in-place form writes) copied."""
    from cityflow_tpu_torch.kernels.spawn_slots import LEAVES
    st = a[0]
    return (st.replace_fields(**{f: getattr(st, f).clone() for f in
                                 LEAVES + ("spawn_cursor", "overflow")}),
            ) + tuple(a[1:])


def shadow_copy(a):
    """G15's arguments with what it writes in place copied: st2's per-slot
    leaves, seq_counter and overflow (st shares the copies where it shared
    st2's tensors, and the target where it is st2's lc_target), so that a
    call on the copy sees the state as the recorded call did."""
    from cityflow_tpu_torch.kernels.shadow_insert import LEAVES
    st, st2, do_change, target, MS = a
    new = {f: getattr(st2, f).clone()
           for f in LEAVES + ("seq_counter", "overflow")}
    return (st.replace_fields(**{f: v for f, v in new.items()
                                 if getattr(st, f) is getattr(st2, f)}),
            st2.replace_fields(**new), do_change,
            new["lc_target"] if target is st2.lc_target else target, MS)


def _g4_pieces(a):
    """G4's arguments cut along the env axis into pieces whose (envs, V,
    KC) slabs hold at most 2^27 entries (the net tables shared)."""
    B, V = a[0].shape
    KC = a[9]["lnk_cross_d"].shape[1]
    n = max(1, min(B, 2 ** 27 // max(V * KC, 1)))
    for b0 in range(0, B, n):
        cut = lambda t: t[b0:b0 + n]
        yield tuple(cut(t) for t in a[:8]) + (
            {f: cut(v) for f, v in a[8].items()}, a[9])


def cross_plain_by_envs(*a):
    """cross_pass_plain piece by piece of envs (_g4_pieces; each env's
    result is its own), so that the (B, V, KC) slabs of the largest path
    fit the card beside its state."""
    import torch
    from cityflow_tpu_torch.kernels.cross_pass import cross_pass_plain
    outs = [cross_pass_plain(*p) for p in _g4_pieces(a)]
    return tuple(torch.cat(x) for x in zip(*outs))


def cross_funnel(a):
    """What G4's lazy decision reads on this call's data (csrc/
    cross_pass.cu's order), counted over each vehicle's crosses up to its
    first failure from the plain version's decision terms: `crosses`
    walked (cvalid read), `considered` (valid, cd >= dls), then how many
    of those passed on !self_yield and on !o_exists, read o_yield, passed
    on t1 > t2, needed reach_steps (the foe at dpos; o_cleared read
    otherwise), broke a reach tie (o_ent, then o_dist / o_pri) and read
    o_cyc; `fails`, `blockers` (o_idx read); and `bytes` / `ops`, the
    bound's count."""
    import torch
    from cityflow_tpu_torch.kernels.cross_pass import cross_pass_plain
    c = dict.fromkeys(("crosses", "considered", "no_self_yield", "no_foe",
                       "foe_yield_read", "t1_gt_t2", "reach", "cleared_read",
                       "tie", "tie_dist", "cyc_read", "fails", "blockers",
                       "valid"), 0)
    fs = a[1].element_size()
    nveh = nll = 0
    for piece in _g4_pieces(a):
        the_ll, blk_ok = piece[0], piece[7]
        KC = piece[9]["lnk_cross_d"].shape[1]
        (_, any_fail, _, _), m = cross_pass_plain(*piece, masks=True)
        cons, sy, ex, yl = (m["considered"], m["self_yield"], m["exists"],
                            m["foe_yield"])
        dec = cons & sy & ex                   # read o_yield
        typ = dec & yl & ~m["t1_gt_t2"]        # read o_dpos
        reach = typ & m["dpos"]
        tie = reach & m["reach_eq"] & m["t1_eq_t2"]
        # o_cyc is read where y is 1: the foe cannot yield, or y0 fails
        cyc = dec & (~yl | (typ & (m["y0"] != -1)))
        first = torch.where(any_fail, m["fail"].int().argmax(-1), KC - 1)
        walked = (torch.arange(KC, device=the_ll.device)
                  <= first[..., None]) & (the_ll >= 0)[..., None]
        w = lambda x: int((x & walked).sum())
        for key, x in (("crosses", walked), ("considered", cons),
                       ("no_self_yield", cons & ~sy),
                       ("no_foe", cons & sy & ~ex), ("foe_yield_read", dec),
                       ("t1_gt_t2", dec & yl & m["t1_gt_t2"]),
                       ("reach", reach), ("cleared_read", typ & ~m["dpos"]),
                       ("tie", tie), ("tie_dist", tie & m["ent_eq"]),
                       ("cyc_read", cyc), ("valid", m["valid"])):
            c[key] += w(x)
        c["fails"] += int(any_fail.sum())
        c["blockers"] += int((any_fail & blk_ok).sum())
        nveh += the_ll.numel()
        nll += int((the_ll >= 0).sum())
    # per vehicle its inputs (the_ll, dls, speed, seven params, next_turn)
    # and four outputs, its lanelink's type and turn flag; per cross
    # walked cvalid, cd where valid; per considered cross that yields
    # foe_pos and o_exists; then each term where the decision reads it
    # (foetype and o_dpos where the foe can yield, o_reach at dpos, the
    # two ent, then o_dist and the two pri on a tie); blk_ok at a failure,
    # o_idx at a blocking one
    typed = c["reach"] + c["cleared_read"]
    nbytes = (nveh * (4 + 9 * fs + 1) + nveh * (2 * fs + 5) + nll * 5
              + c["crosses"] + c["valid"] * fs
              + (c["considered"] - c["no_self_yield"]) * 5
              + c["foe_yield_read"] + (c["t1_gt_t2"] + typed) * 4
              + typed + c["cleared_read"] + c["reach"] * 4 + c["tie"] * 8
              + c["tie_dist"] * (fs + 8) + c["cyc_read"]
              + c["fails"] + c["blockers"] * 4)
    c["bytes"] = nbytes
    c["ops"] = c["considered"] * 8 + c["reach"] * 30 + nveh * 30
    return c


def shadow_work(a):
    """(bytes, operations) of one G15 call, in place: the change and
    active flags scanned, per pair its real's copied row, target and uid
    in and the shadow's whole row and the real's partner out, the env's
    seq_counter and overflow in and out (the out-of-place insert's count
    was every per-slot leaf read and written)."""
    import torch
    from cityflow_tpu_torch.kernels.shadow_insert import (
        K_COPY, LEAVES, leaf_kind)
    st, st2, do_change, target, MS = a
    B = do_change.shape[0]
    width = {f: getattr(st2, f)[0, 0].numel() * getattr(st2, f)
             .element_size() for f in LEAVES}
    npair = int(torch.minimum(do_change.sum(-1).clamp(max=MS),
                              (~st.active).sum(-1).clamp(max=MS)).sum())
    row_in = sum(w for f, w in width.items() if leaf_kind(f) == K_COPY) + 8
    return 2 * do_change.numel() + npair * (
        row_in + sum(width.values()) + 4) + B * 16, 2 * do_change.numel()


def notify_work(a, out):
    """Bytes and operations of one G3 call, as its data needs them: the
    net tables (the cross distances once for every env); per (lanelink,
    env) the end lane's rear slot and, where there is one, its prev_drv,
    and where that names the lanelink its dis and len; the start lane's
    front slot and, where there is one, its next drivable, and where that
    and ll_avail (read per lanelink) admit it its dis; the lanelink's two
    offsets in drv_off, its first min(k_link, count) slots in sorted_idx
    and their dis and len; per distinct notifier of a lanelink its other
    five terms (speed, maxNegAcc, yieldDistance, usualPosAcc, the target
    speed), cyc, ent and pri, and the end vehicle's where some cross has
    none; the ten outputs. Operations: two comparisons per kept candidate
    and cross, 60 per cross for the notifier's terms."""
    import torch
    net, arr, veh_next, ll_avail, leaves, L, K = a
    dis = leaves["dis"]
    fs = dis.element_size()
    LL, KC = net["lnk_cross_d"].shape
    B, V = veh_next.shape
    env = torch.arange(B, device=veh_next.device)[:, None]
    l_drv = L + torch.arange(LL, device=veh_next.device)
    last = arr["last_of"].index_select(-1, net["ll_end"])      # (B, LL)
    first = arr["first_of"].index_select(-1, net["ll_start"])
    at = lambda x, slot: x[env, slot.clamp(min=0).long()]
    e_ok = (last >= 0) & (at(leaves["prev_drv"], last) == l_drv)
    nxt = at(veh_next, first)
    s_ok = (first >= 0) & (nxt == l_drv) & ll_avail
    off = arr["drv_off"]
    n_link = torch.clamp(off[:, L + 1:L + LL + 1] - off[:, L:L + LL],
                         max=K)
    # distinct notifiers per (env, lanelink), and lanelinks with a cross
    # that has none
    idx = out["idx"].long()
    key = (env[..., None] * LL + torch.arange(LL, device=idx.device)[
        :, None]) * (V + 1) + idx + 1
    n_win = int(torch.unique(key[idx >= 0]).numel())
    n_none = int((idx < 0).any(-1).sum())
    tables = LL * (KC * fs + 4 + 4 + 1 + fs) + L * fs
    ins = (tables + B * LL * (4 + 4 + 1 + 8) + int((last >= 0).sum()) * 4
           + int(e_ok.sum()) * 2 * fs + int((first >= 0).sum()) * 4
           + int(s_ok.sum()) * fs + int(n_link.sum()) * (4 + 2 * fs)
           + n_win * (5 * fs + 9) + n_none * (5 * fs + 1))
    kept = int(e_ok.sum()) + int(s_ok.sum()) + int(n_link.sum())
    return ins + B * LL * KC * (5 + fs + 16), 2 * kept * KC \
        + 60 * B * LL * KC


def arrange_pack_count(a, out):
    """Bytes of one G1 call as the former count took them, with the
    attribute packs (10 floats and 2 ints a vehicle) and its dense
    lanelink tables: every table row written, the occupied rows' packs
    read, beside the recounted bound (logged, not used)."""
    import torch
    running, drv, dis, list_seq, D, L, k_link = a
    fs = dis.element_size()
    V = running.numel()
    nenv = V // running.shape[-1]
    nrun = int(running.sum())
    off = out["drv_off"]
    nt = int(torch.clamp(off[:, L + 1:] - off[:, L:-1], max=k_link).sum())
    per_row = 4 + 10 * fs + 2 * 4
    ins = V + nrun * (4 + fs + 4) + nt * (per_row - 4)
    outs = 8 * V + 8 * D * nenv + nenv * max(D - L, 1) * k_link * per_row \
        + nenv
    return ins + outs


def gen1_work(n, a, k, out):
    """Bytes (each input read once, each output written once, as this
    call's data needs them) and operations of one G kernel call; `n` is
    kernel or kernel@mode."""
    import torch
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    if n == "blocker_cycles":
        blocker = a[0]
        V = blocker.numel()
        # each slot's blocker in, its flag out (a walk re-reads the same
        # array); a compare per slot and two per blocked slot
        return V * 5, V + 2 * int((blocker >= 0).sum())
    if n == "update_location":
        (running, end, changed, buf_dis, buf_drv, enter_time, list_seq,
         ent, sorted_idx, lc_fin) = a[:10]
        V = running.numel()
        nenv = V // running.shape[-1]
        fs = buf_dis.element_size()
        removed = running & end
        trans = running & changed & ~removed
        nt, nr = int(trans.sum()), int(removed.sum())
        # each env's transfers are ranked among themselves
        nt2 = int((trans.reshape(nenv, -1).sum(-1).long() ** 2).sum())
        # flags in (and the lane-change flags, G1's order in exact mode),
        # per transfer its distance and drivable, per removal its entry
        # time; the removed flags and two ticket columns out, four scalars
        # per env
        ins = V * (3 + (4 if sorted_idx is not None else 0)
                   + (2 if lc_fin is not None else 0) + 8) \
            + nt * (fs + 4) + nr * fs + nenv * (3 * 4 + fs) + fs
        outs = V * (1 + 8) + nenv * (3 * 4 + fs)
        return ins + outs, nt2 * 3 + V * 4
    if n == "arrange":
        # the running flags, each running slot's drivable, distance and
        # ticket in; sorted_idx and leader over the slots, first_of,
        # last_of and drv_off over the drivables, the overflow flag out
        running, drv, dis, list_seq, D, L, k_link = a
        fs = dis.element_size()
        V = running.numel()
        nenv = V // running.shape[-1]
        env = torch.arange(nenv, device=drv.device).view(
            running.shape[:-1] + (1,)) if running.dim() > 1 else 0
        run = (drv + env * D)[running].long()
        nrun = int(run.numel())
        ins = V + nrun * (4 + fs + 4)
        outs = 8 * V + nenv * (8 * D + 4 * (D + 1)) + nenv
        # each vehicle compares itself with the others of its drivable
        ops = int((torch.bincount(run, minlength=D * nenv) ** 2).sum())
        return ins + outs, ops
    if n == "leader_scan":
        mask, dis, last_of = a[0], a[4], a[6]
        fs = dis.element_size()
        m = int(mask.sum())
        if k.get("fast"):
            # the table: per drivable its rear vehicle (lanes) or its
            # start lane's outs' rear vehicles (lanelinks), dis and len,
            # one (candidate, value) entry out; per scanning vehicle its
            # state and two params, then per hop a route entry, a table
            # entry and the drivable's length
            D = last_of.numel()
            return (D * (4 + 2 * fs) + D * (4 + fs)
                    + mask.numel() * (1 + 4 + fs) + m * (12 + 3 * fs)
                    + m * (8 + 2 * fs)), D * 6 + m * 20
        # per scanning vehicle: drv, route, pos, dis, two params, then at
        # least one hop (route entry, rear vehicle, its dis and len,
        # the drivable's length)
        return (mask.numel() * (1 + 4 + fs) + m * (12 + 3 * fs)
                + m * (8 + 3 * fs)), m * 20
    if n == "notify_cross":
        return notify_work(a, out)
    if n == "cross_pass":
        # what the lazy decision reads (cross_funnel), not every foe term
        # of every cross up to the first failure
        c = cross_funnel(a)
        return c["bytes"], c["ops"]
    if n == "hist_window":
        last_of, leader, speed, ring_num = a[:4]
        fs = speed.element_size()
        B, HL1, L = ring_num.shape
        # per env and lane its rear slot and the two sums in and out, the
        # new ring row out and, once the ring is full, the old row in; per
        # running lane vehicle its leader and speed; two adds per vehicle,
        # four per lane. The copying form also reads and writes both whole
        # rings (the wrapper's copies).
        nveh = int((lane_of(last_of, leader, L) < L).sum())
        nfull = int((a[7] >= HL1).sum())
        rings = 0 if k.get("inplace") else 4 * B * HL1 * L * fs
        return B * L * (4 + 6 * fs) + nfull * L * 2 * fs + rings \
            + nveh * (4 + fs), 2 * nveh + 4 * B * L
    if n == "lc_probe":
        running, drv, dis, last_of, leader, net, L = a
        B = dis.shape[0]
        V = dis.numel()
        # each side lane's walk visits the lane's vehicles (per env)
        on = running & (drv >= 0) & (drv < L)
        env = torch.arange(B, device=drv.device)[:, None] * (L + 1)
        cnt = torch.bincount((torch.where(on, drv, L) + env).reshape(-1)
                             .long(), minlength=B * (L + 1)).view(B, L + 1)
        visits = sum(int(((out[s + "_lane"] < L) * cnt.gather(
            1, out[s + "_lane"].clamp(0, L).long())).sum())
            for s in ("outer", "inner"))
        return (V * (1 + 4 + dis.element_size() + 4) + last_of.numel() * 4
                + L * 12 + V * 24), visits * 6 + V * 10
    if n == "shadow_insert":
        return shadow_work(a)
    if n == "spawn_slots":
        return spawn_work(a, k, out)
    if n == "admit_heads":
        (active, running, drv, uid, dis, params, leader, gap, list_seq,
         last_of, seq_counter, L) = a
        V = active.numel()
        fs = dis.element_size()
        nenv = V // active.shape[-1]
        nheads = int((out["head"] >= 0).sum())
        waiting = int((active & ~running).sum())
        admitted = int((out["running"] & ~running).sum())
        # per slot its flags, leader, ticket and gap in, running / leader /
        # gap / ticket / scan flag out; the waiting slots' lane and uid;
        # per lane its head out; per lane with a head its rear vehicle, that
        # vehicle's dis and len and the head's minGap; the admitted slots'
        # dis
        return V * (2 + 8 + fs) + V * (10 + fs) + waiting * 8 \
            + nenv * L * 4 + nheads * (4 + 3 * fs) + admitted * fs \
            + nenv * 4, 4 * V
    mode = n.split("@")[1] if "@" in n else None
    st = a[1]
    V = st.dis.numel()
    fs = st.dis.element_size()
    if n.startswith("lc_plan"):
        net = a[2]
        if mode == "signal":
            # per slot three flags, the cooldown time, drv, dis, gap, two
            # params, route and position, lc_target and G6's six
            # neighbours in; the eight signal fields out; the tables
            tabs = nb(*(net[t] for t in ("drv_len", "lane_out", "lane_local",
                                         "ll_end", "route_len",
                                         "route_next_ll"))) \
                + k["last_of"].numel() * 4
            return V * (3 + 4 + 8 + 4 + 24 + 5 * fs) + tabs \
                + V * (18 + 2 * fs), V * 60
        if mode == "receive":
            return V * (2 + 4 + 4 + 4) + V * 16, V * 6
        if mode == "decide":
            # the four receive fields, three flags, priority, drv, target,
            # tfollower, plan, speed, a param and the two gaps in; the
            # kept signal and the decision out
            return V * (37 + 4 * fs) + V * 5, V * 12
        return yield_work(st, fs)
    if n.startswith("lc_commit"):
        if mode == "tail":
            # every slot's running flag, offset and end flag in and its
            # four outputs out; a running slot's partner, flags, drivables,
            # new speed, direction and target (lane widths: L of them)
            L = a[6]
            nrun = int(st.running.sum())
            return V * (2 + fs) + nrun * (4 + 2 + 4 + 4 + fs + 4 + 4) \
                + L * fs + V * (3 + fs), V * 15
        # commit: thirteen per-slot fields in, ten out
        return V * (27 + fs) + V * (24 + fs), V * 10
    raise KeyError(n)


def yield_work(st, fs):
    """(bytes, operations) of one G7 yield call: each slot's lc_recv in
    and its cap out; per receiver its own speed and maxNegAcc and its
    sender's target leader, and where that is not the receiver the
    sender's speed, maxNegAcc, follower gap and target follower, and
    that follower's speed and maxNegAcc where there is one. The former
    count read each slot's speed and param too and each receiver's sender
    fields whatever the target leader: yield_pack_count."""
    import torch
    V = st.lc_recv.numel()
    recv = st.lc_recv >= 0
    src = st.lc_recv.clamp(min=0).long()
    tl = st.lc_tleader.gather(-1, src)
    me = torch.arange(st.lc_recv.shape[-1], device=src.device)
    cap = recv & (tl != me)
    tf = st.lc_tfollower.gather(-1, src)
    n_r, n_c = int(recv.sum()), int(cap.sum())
    n_f = int((cap & (tf >= 0)).sum())
    return V * (4 + fs) + n_r * (2 * fs + 4) + n_c * (3 * fs + 4) \
        + n_f * 2 * fs, n_c * 30


def yield_pack_count(st, fs):
    """Bytes of one G7 yield call as the former count took them (logged
    beside the recounted bound)."""
    V = st.lc_recv.numel()
    nrecv = int((st.lc_recv >= 0).sum())
    return V * (4 + 3 * fs) + nrecv * (8 + 5 * fs)


def spawn_work(a, k, out):
    """(bytes, operations) of one G11 call. In place: per env the free
    flags up to its MS-th free slot (all of them where it has fewer), the
    step column of its MS window rows, per due row its four other columns
    and flow parameters, per written row every per-slot leaf's row, the
    three per-env scalars in and two out; a compare per flag read. The
    copying form: every per-slot leaf read once and written once, the free
    flags read once more by the scan, each env's MS spawn rows and their
    flow parameters; a compare per slot."""
    import torch
    from cityflow_tpu_torch.kernels.spawn_slots import LEAVES
    st, tbl, flow_params, MS = a[0], a[1], a[2], a[4]
    nenv, V = st.active.shape
    fs = st.dis.element_size()
    NP = flow_params.shape[1]
    if not k.get("inplace"):
        state = sum(getattr(st, f).numel() * getattr(st, f).element_size()
                    for f in LEAVES)
        return 2 * state + st.active.numel() + nenv * MS * (
            5 * 4 + NP * fs) + nenv * 16, st.active.numel()
    c = torch.cumsum((~st.active).to(torch.int32), -1)
    flags = int(torch.clamp((c < MS).sum(-1) + 1, max=V).sum())
    due = int((out["spawn_cursor"] - st.spawn_cursor).sum())
    written = int((out["active"] & ~st.active).sum())
    row = sum(getattr(st, f)[0, 0].numel() * getattr(st, f).element_size()
              for f in LEAVES)
    return flags + nenv * MS * 4 + due * (4 * 4 + NP * fs) + written * row \
        + nenv * 20, flags


def _gen1_label(n, a):
    """A G kernel call's row name: the kernel, or kernel@mode for the
    modes of G7 and G8 after the first."""
    if n in ("lc_plan", "lc_commit"):
        first = {"lc_plan": "signal", "lc_commit": "tail"}[n]
        return n if a[0] == first else f"{n}@{a[0]}"
    return n


def _mode_label(n):
    """A gen-1 kernel's row on a fast-mode path: its fast branch, or its
    float32 mode."""
    return f"{n}@{'fast' if n in FAST_BRANCH else 'f32'}"


def _gen1_plain(n, mod):
    """G kernel n's plain version as the checks call it: G4's piece by
    piece of envs (cross_plain_by_envs: the same values in less memory)."""
    return cross_plain_by_envs if n == "cross_pass" \
        else getattr(mod, n + "_plain")


def _gen1_call(n, fn, a, k):
    """fn (kernel or plain version of G kernel n) on recorded call (a, k):
    a call that writes its arguments in place on a fresh copy of them."""
    return fn(*fresh_args(n, a, k), **k)


def _time_gen1(n, fn, a, k, reps):
    """time_cuda of fn on (a, k); a call that writes its arguments in
    place each time on a fresh copy (time_cuda_fresh, the copies
    untimed)."""
    if gen1_written(n, a, k):
        return time_cuda_fresh(lambda: fresh_args(n, a, k),
                               lambda x: fn(*x, **k), reps)
    return time_cuda(lambda: fn(*a, **k), reps)


def _gen1_bound(n, a, k, kern, label=None):
    """gen1_work of a recorded call (G4 and G15 count from their
    arguments; the others from the kernel's outputs too, each on a fresh
    copy where it writes in place). G1's and G7 yield's recounted bounds
    are logged beside the former counts of the same call, G3's with the
    bytes it reads from the leaves and G1's offsets."""
    out = None if n in ("cross_pass", "shadow_insert") \
        else _gen1_call(n, kern, a, k)
    nbytes, nops = gen1_work(
        f"{n}@{a[0]}" if n in ("lc_plan", "lc_commit") else n, a, k, out)
    tag = label or n
    if n == "arrange":
        log(f"[bound] {tag}: {nbytes} bytes "
            f"({nbytes / H100_BYTES_PER_S * 1e3:.4f} ms); the former "
            f"count, with the packs and lanelink tables, "
            f"{arrange_pack_count(a, out)}")
    elif n == "lc_plan" and a[0] == "yield":
        st = a[1]
        old = yield_pack_count(st, st.dis.element_size())
        ms = lambda x: f"{x / H100_BYTES_PER_S * 1e3:.4f}"
        log(f"[bound] {tag}: {nbytes} bytes ({ms(nbytes)} ms); the "
            f"former count {old} ({ms(old)} ms); receivers "
            f"{int((st.lc_recv >= 0).sum())} of {st.lc_recv.numel()}")
    elif n == "notify_cross":
        log(f"[bound] {tag}: {nbytes} bytes "
            f"({nbytes / H100_BYTES_PER_S * 1e3:.4f} ms) with its candidates "
            f"read through drv_off / sorted_idx and their terms from the "
            f"leaves")
    return nbytes, nops


def log_cross_funnel(tag, calls):
    """The funnel line of G4's calls on a path (cross_funnel, summed)."""
    tot = {}
    for a, _ in calls:
        for key, v in cross_funnel(a).items():
            tot[key] = tot.get(key, 0) + v
    log(f"[{tag}] cross_pass funnel over {len(calls)} calls: crosses "
        f"walked {tot['crosses']}, considered {tot['considered']}, passed "
        f"on !self_yield {tot['no_self_yield']}, on !o_exists "
        f"{tot['no_foe']}, on t1 > t2 {tot['t1_gt_t2']}, needed "
        f"reach_steps {tot['reach']} (o_cleared read {tot['cleared_read']}"
        f", reach ties {tot['tie']}, o_cyc read {tot['cyc_read']}), "
        f"failures {tot['fails']}, blockers {tot['blockers']}; bound "
        f"bytes {tot['bytes']}")
    return tot


def _check_call(n, kern, plain, a, k, rel_tol):
    """One recorded call of G kernel n: the kernel against its plain
    version (G15 each on its own fresh copy), every output bitwise, except
    float outputs within `rel_tol` relative where it is not None; returns
    the largest absolute difference."""
    if n == "notify_cross":
        # G1's offsets: non-decreasing, the last the env's running count
        off = a[1]["drv_off"]
        assert bool((off[:, 1:] >= off[:, :-1]).all()) and bool(
            (off[:, 0] == 0).all()), "notify_cross: drv_off not offsets"
    got = [t for t in _flat(_gen1_call(n, kern, a, k)) if t is not None]
    want = [t for t in _flat(_gen1_call(n, plain, a, k)) if t is not None]
    assert len(got) == len(want), f"{n}: outputs differ in number"
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if rel_tol is not None and g.dtype.is_floating_point:
            rel_close(f"{n}: output {i}", g, w, tol=rel_tol)
            err = max(err, float((g.double() - w.double()).abs().max())
                      if g.numel() else 0.0)
        else:
            assert bitwise_equal(g, w), f"{n}: output {i} not bitwise"
    return err


def check_gen1_kernels(eng, reps, names, fast=False, untimed=(), tag=None):
    """The kernels of `names` and `untimed` against their plain versions on
    every call of one more step of a gen-1 path, bitwise (fast mode: G10's
    unordered finish sum within 1e-6 relative); those
    of `names` timed on the first call of each kernel and mode (G2 on its
    last: the leader update over every leaderless vehicle). On a fast path one row per kernel,
    its float32 or fast mode, and G9 and G10 also in exact mode on the
    same inputs (G10 bitwise there, with G1's order of the step). G5
    beside the library's index_add_ of the same per-lane sums, G10 beside
    torch.sort(stable=True) + torch.sum, G12 beside
    scatter_reduce("amin")."""
    from cityflow_tpu_torch import kernels
    names = tuple(names) + tuple(untimed)
    calls = record_gen1_calls(eng.next_step, names)
    if "cross_pass" in names:
        log_cross_funnel(tag, calls["cross_pass"])
    rows = []
    for n in names:
        mod = kernels.MODULES[n]
        kern, plain = getattr(mod, n), _gen1_plain(n, mod)
        assert calls[n], f"{n}: no call recorded"
        rel_tol = 1e-6 if fast and n == "update_location" else None
        errs = [_check_call(n, kern, plain, a, k, rel_tol)
                for a, k in calls[n]]
        if fast and n == "blocker_cycles":
            for a, k in calls[n]:
                _check_call(n, kern, plain, (a[0], True, a[2]), k, None)
        if fast and n == "update_location":
            # exact mode on the same inputs: G1's order of this step's
            # first arrangement (the one the step hands to G10)
            (ga, gk), = calls["arrange"][:1]
            sidx = getattr(kernels.MODULES["arrange"], "arrange")(
                *ga, **gk)["sorted_idx"]
            for a, k in calls[n]:
                ax = list(a)
                ax[8], ax[19] = sidx, True
                _check_call(n, kern, plain, tuple(ax), k, None)
        both = (", in both modes" if fast and n in ("blocker_cycles",
                                                   "update_location")
                else "")
        log(f"[kernels] {n}: {len(calls[n])} calls equal to the plain "
            f"version ({'within 1e-6 relative' if rel_tol else 'bitwise'}"
            f"{both})")
        if n in untimed:
            continue
        timed = {}
        for a, k in (calls[n][-1:] if n == "leader_scan" else calls[n]):
            label = _mode_label(n) if fast else _gen1_label(n, a)
            timed.setdefault(label, (a, k))
        for label, (a, k) in timed.items():
            ms = _time_gen1(n, kern, a, k, reps)
            plain_ms = _time_gen1(n, plain, a, k, reps)
            lib = None
            if n == "hist_window":
                lib = index_add_ms(a, reps)
            elif n == "update_location":
                lib = sort_sum_ms(a, reps)
            elif n == "admit_heads":
                lib = heads_amin_ms(a, reps)
            nbytes, nops = _gen1_bound(n, a, k, kern, label)
            rows.append(kernel_row(
                label, max(errs), ms, plain_ms, nbytes, nops, lib,
                flops=H100_F32_FLOPS if fast else H100_F64_FLOPS))
    return rows


def sort_sum_ms(a, reps):
    """The library pair computing G10's transfer order and finish sum:
    torch.sort(stable=True) of -dis over the transfers and torch.sum of
    the counted travel times (the masks made outside the timing)."""
    import torch
    running, end, changed, buf_dis, enter_time = (a[i] for i in
                                                  (0, 1, 2, 3, 5))
    step, interval = a[11], a[16]
    removed = running & end
    trans = running & changed & ~removed
    key = torch.where(trans, -buf_dis, torch.inf)
    tt = torch.where(removed, (step.to(buf_dis.dtype) * interval)[..., None]
                     - enter_time, 0.0)
    return time_cuda(lambda: (torch.sort(key, dim=-1, stable=True),
                              torch.sum(tt, -1)), reps)


def lane_of(last_of, leader, L):
    """Each slot's lane from G1's lane chains, (B, V) from last_of (B, D)
    and leader (B, V) (L for the slots on none)."""
    import torch
    B, V = leader.shape
    lane = torch.full((B * V,), L, dtype=torch.long, device=leader.device)
    walk = last_of[:, :L]
    lanes = torch.arange(L, device=leader.device).expand(B, L)
    base = torch.arange(B, device=leader.device)[:, None] * V
    while bool((walk >= 0).any()):
        ok = walk >= 0
        lane[(walk + base)[ok].long()] = lanes[ok]
        walk = torch.where(ok, leader.gather(1, walk.clamp(0).long()), -1)
    return lane.view(B, V)


def index_add_ms(a, reps):
    """One library call computing G5's per-lane sums of every env:
    index_add_ of (1, speed) rows into (B * (L + 1), 2) by env and lane (L
    for the slots on no lane), the bins taken outside the timing."""
    import torch
    last_of, leader, speed, ring_num = a[:4]
    B, L = speed.shape[0], ring_num.shape[-1]
    lane = (lane_of(last_of, leader, L) + (L + 1) * torch.arange(
        B, device=speed.device)[:, None]).reshape(-1)
    vals = torch.stack([torch.ones_like(speed), speed], dim=-1).reshape(
        -1, 2)
    out = torch.zeros((B * (L + 1), 2), dtype=speed.dtype,
                      device=speed.device)
    return time_cuda(lambda: out.zero_().index_add_(0, lane, vals), reps)


# ---------------------------------------------------------------------------
# Engine(exact=False): gen-1 fast mode and the ring Engine
# ---------------------------------------------------------------------------

def engine_vehicles(eng):
    """{uid: (drivable, dis, speed)} of an Engine's running vehicles (a
    shadow's uid with bit 30 set), from either backend."""
    import numpy as np
    from cityflow_tpu_torch import ring_sim
    if eng._ring is not None:
        return ring_sim.fetch_vehicles(eng._ring.sim)
    st = eng.state
    run = st.running.cpu().numpy()
    uid, drv = st.uid.cpu().numpy(), st.drv.cpu().numpy()
    dis, spd = st.dis.cpu().numpy(), st.speed.cpu().numpy()
    return {int(uid[i]): (int(drv[i]), float(dis[i]), float(spd[i]))
            for i in np.nonzero(run)[0]}


def engine_finished(eng):
    if eng._ring is not None:
        return eng._ring.stats()[1]
    return int(eng.state.finished_cnt)


def check_agreement_fast(tag, a, b, steps):
    """Two fast-mode Engines stepped together (the card against the CPU,
    or the ring against gen-1): every 10 steps the same vehicles on the
    same drivables, |dis| and |speed| within 2e-3; the same finished
    count at the end. The launch counts are set to 0 first and returned
    as they stand after (the card Engine's). The steps whose state holds
    a shadow are counted."""
    from cityflow_tpu_torch import kernels
    t0 = time.time()
    kernels.reset_launches()
    worst, shadows = 0.0, 0
    for i in range(1, steps + 1):
        a.next_step()
        b.next_step()
        if i % 10 and i != steps:
            continue
        va, vb = engine_vehicles(a), engine_vehicles(b)
        assert set(va) == set(vb), f"[{tag}] step {i}: vehicle sets differ"
        for u in va:
            assert va[u][0] == vb[u][0], f"[{tag}] step {i}: uid {u} drivable"
            worst = max(worst, abs(va[u][1] - vb[u][1]),
                        abs(va[u][2] - vb[u][2]))
        assert worst <= 2e-3, f"[{tag}] step {i}: worst drift {worst}"
        shadows += any(u & (1 << 30) for u in va)
    launches = kernels.launch_counts()
    assert engine_finished(a) == engine_finished(b), f"[{tag}] finished"
    assert len(va) > 0
    log(f"[{tag}] {steps} steps: vehicles={len(va)} worst_drift={worst} "
        f"finished={engine_finished(a)} checks_with_shadows={shadows} "
        f"wall_s={time.time() - t0:.1f}")
    return launches, shadows


def run_ring_engine(cfg_path, warmup, steps, every):
    """Engine(exact=False) on the card, the ring at one env: `warmup`
    steps, then `steps` timed ones with get_lane_vehicle_count() every
    `every`th (a fetch of the whole host view), the launch counts set to
    0 just before and read just after (K1-K4 must have launched); the
    ms of one fetch, the ring growths, the device busy share."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.engine import Engine
    t0 = time.time()
    eng = Engine(cfg_path, exact=False, spawn_horizon=warmup + steps + 16)
    assert eng._ring is not None, "the ring was not selected"
    setup_s = time.time() - t0
    t0 = time.time()
    for _ in range(warmup):
        eng.next_step()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    g0 = eng._ring.growths
    kernels.reset_launches()
    counted = 0
    t0 = time.time()
    for i in range(steps):
        eng.next_step()
        if i % every == every - 1:
            counted += sum(eng.get_lane_vehicle_count().values())
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kernels.launch_counts()
    for k in MAIN_KERNELS:
        assert launches[k] > 0, f"kernel {k} was not launched on ring-engine"
    st = eng._ring.sim.state
    assert int(st.overflow) == eng._ring._known_ov
    veh = eng.get_vehicle_count()
    assert veh > 0 and counted > 0, "no vehicles"
    occ = torch.arange(st.l_dis.shape[0], device=st.l_dis.device)[:, None] \
        < st.n_l[None, :]
    assert bool(torch.isfinite(st.l_dis[occ]).all()), "state not finite"
    # one fetch of the host view (the getters' cache), on the host clock
    t1 = time.time()
    eng._ring.fetch()
    fetch_ms = (time.time() - t1) * 1e3
    # the step alone, without getters
    torch.cuda.synchronize()
    t1 = time.time()
    for _ in range(10):
        eng.next_step()
    torch.cuda.synchronize()
    step_ms = (time.time() - t1) * 1e2
    ms = dt * 1e3 / steps
    c = eng._ring.sim.cfg
    log(f"[ring-engine] steps={steps} warmup={warmup} ms_per_step={ms:.3f} "
        f"(get_lane_vehicle_count every {every}th) step_only_ms={step_ms:.3f}"
        f" fetch_ms={fetch_ms:.1f} vehicles={veh} growths={eng._ring.growths}"
        f" (in the window {eng._ring.growths - g0}) SL={c.SL} SK={c.SK} "
        f"setup_s={setup_s:.1f} warmup_s={warm_s:.1f}")
    log(f"[ring-engine] launches per step="
        f"{ {k: v / steps for k, v in launches.items() if v} }")
    prof = gen1_profile(eng.next_step, 3, step_ms, "ring-engine")
    return launches, dict(
        steps=steps, warmup=warmup, ms_per_step=ms, step_only_ms=step_ms,
        fetch_ms=fetch_ms, vehicles=veh, growths=eng._ring.growths,
        SL=c.SL, SK=c.SK, **prof)


# ---------------------------------------------------------------------------
# the batched gen-1 step (leading env axis) and its RL surface
# ---------------------------------------------------------------------------

def batch_vehicles(st, b):
    """{uid: (drivable, dis, speed)} of env b's running vehicles."""
    import numpy as np
    run = st.running[b].cpu().numpy()
    uid, drv = st.uid[b].cpu().numpy(), st.drv[b].cpu().numpy()
    dis, spd = st.dis[b].cpu().numpy(), st.speed[b].cpu().numpy()
    return {int(uid[i]): (int(drv[i]), float(dis[i]), float(spd[i]))
            for i in np.nonzero(run)[0]}


def envs_equal(st):
    """Every leaf of a batched state equal to env 0's, bit for bit."""
    for k, v in st.leaves().items():
        assert bitwise_equal(v, v[:1].expand_as(v).contiguous()), \
            f"env rows differ in {k}"


def check_agreement_gen1_batch(cfg_path, steps, batch):
    """parallel/batch.make_batched_step (fast mode, rl_actions) at `batch`
    envs, each with its own phases every step, on the card against the
    plain port on the CPU: every 10 steps in every env the same vehicles
    on the same drivables, |dis| and |speed| within 2e-3 ([agree-fast]'s
    yardstick), equal finished counts at the end; the launch counts of the
    card's run are returned."""
    import dataclasses
    import numpy as np
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.parallel.batch import (
        init_batch_state, make_batched_step)
    t0 = time.time()
    sides = []
    for dev in (None, "cpu"):
        e = Engine(cfg_path, exact=False, backend="gen1", device=dev,
                   spawn_horizon=steps + 8)
        cfg = dataclasses.replace(e.cfg, rl_traffic_light=True)
        sides.append([e, make_batched_step(e._net_dev, cfg, with_obs=False,
                                           rl_actions=True),
                      init_batch_state(cfg, e.state, batch)])
    n = np.maximum(sides[0][0].net.n_phases, 1)
    rng = np.random.default_rng(0)
    kernels.reset_launches()
    worst = 0.0
    for i in range(1, steps + 1):
        ph = torch.as_tensor((rng.integers(0, 1 << 20, (batch, n.size))
                              % n).astype(np.int32))
        for side in sides:
            e, step_b, st = side
            side[2] = step_b(st, e._spawn_dev, ph.to(e.device))[0]
        if i % 10 and i != steps:
            continue
        for b in range(batch):
            va, vb = (batch_vehicles(side[2], b) for side in sides)
            assert set(va) == set(vb), \
                f"[agree-gen1-batch] step {i} env {b}: vehicle sets differ"
            for u in va:
                assert va[u][0] == vb[u][0], \
                    f"[agree-gen1-batch] step {i} env {b}: uid {u} drivable"
                worst = max(worst, abs(va[u][1] - vb[u][1]),
                            abs(va[u][2] - vb[u][2]))
        assert worst <= 2e-3, f"[agree-gen1-batch] step {i}: drift {worst}"
    launches = kernels.launch_counts()
    g, c = sides[0][2], sides[1][2]
    assert torch.equal(g.finished_cnt.cpu(), c.finished_cnt), "finished"
    assert int(g.overflow.max()) == 0 and int(c.overflow.max()) == 0
    assert not torch.equal(c.dis[0], c.dis[1]), "the envs did not differ"
    for k in GEN1_KERNELS:
        assert launches[k] > 0, f"{k} idle on [agree-gen1-batch]"
    log(f"[agree-gen1-batch] {steps} steps B={batch}, per-env phases: "
        f"vehicles per env={[len(batch_vehicles(g, b)) for b in range(batch)]}"
        f" worst_drift={worst} finished={c.finished_cnt.tolist()} "
        f"wall_s={time.time() - t0:.1f}")
    return launches


def check_agreement_gen1_env(cfg_path, steps):
    """rl/env.CityFlowVecEnv at B=1 on the card against the plain port on
    the CPU, each under its own MaxPressure actions every MP_EVERY steps
    ([agree-rl]'s pattern): equal actions at every decision, equal counts,
    pressures, times and rewards, avg_travel_time within 1e-5 relative."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.rl.env import CityFlowVecEnv
    t0 = time.time()
    gpu = CityFlowVecEnv(cfg_path, batch=1, horizon=steps + 8)
    cpu = CityFlowVecEnv(cfg_path, batch=1, horizon=steps + 8, device="cpu")
    gpu.reset()
    cpu.reset()
    kernels.reset_launches()
    ag = torch.zeros((1, gpu.num_intersections), dtype=torch.int32)
    ac = ag.clone()
    decisions, moved, att_rel = 0, 0, 0.0
    for t in range(steps):
        if t % MP_EVERY == 0 and t:
            ag, ac = gpu.max_pressure_actions(), cpu.max_pressure_actions()
            assert torch.equal(ag.cpu(), ac), f"step {t}: actions differ"
            decisions += 1
            moved += int((ac != 0).sum())
        og, rg = gpu.step(ag)
        oc, rc = cpu.step(ac)
        for k, v in oc.items():
            if k == "avg_travel_time":
                att_rel = max(att_rel, rel_close(k, og[k], v)[0])
            else:
                assert torch.equal(og[k].cpu(), v), f"step {t}: {k} differs"
        assert torch.equal(rg.cpu(), rc), f"step {t}: reward differs"
    launches = kernels.launch_counts()
    assert moved > 0, "MaxPressure chose phase 0 everywhere"
    assert float(rc.sum()) < 0, "no waiting vehicles"
    for k in GEN1_KERNELS + GEN1_RL_KERNELS:
        assert launches[k] > 0, f"{k} idle on [agree-gen1-env]"
    log(f"[agree-gen1-env] {steps} steps B=1: decisions={decisions} "
        f"nonzero_actions={moved} vehicles={int(oc['vehicle_count'][0])} "
        f"waiting={int(-float(rc.sum()))} avg_travel_time_max_rel={att_rel} "
        f"wall_s={time.time() - t0:.1f}")


def _gen1_batch_report(tag, step, launches, steps, batch, dt, names):
    """The prints and numbers of a batched gen-1 window: ms per batched
    step, env-steps/s, each kernel's share (CUDA events, 3 more steps),
    the device busy share and kernels per step (profiler, 3 more steps),
    peak memory."""
    import torch
    ms = dt * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    per_launch = {k: v / steps for k, v in launches.items()
                  if v and k.split("@")[0] in names}
    log(f"[{tag}] launches per step={per_launch}")
    per, tot = gen1_shares(step, 3, names)
    for n, v in per.items():
        log(f"[{tag}] kernel {n}: {v:.4f} ms/step ({100 * v / tot:.2f}% of "
            f"a {tot:.3f} ms step; CUDA events, 3 steps)")
    prof = gen1_profile(step, 3, ms, tag)
    log(f"[{tag}] max_memory_allocated={peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    return dict(B=batch, steps=steps, ms_per_step=ms,
                env_steps_per_s=batch * steps / dt,
                launches_per_step=per_launch, kernel_ms_per_step=per,
                step_ms_events=tot, peak_bytes=peak, **prof)


def run_gen1_batch(cfg_path, batch, warmup, steps):
    """The batched gen-1 fast step on `cfg_path` at `batch` envs: one env
    (the Engine, which grows its pool on overflow) runs warmup + steps
    steps, so its pool is the smallest power of two with no overflow
    through the window; its state after `warmup` steps, in that pool, is
    copied into the batch, and `steps` batched steps of
    parallel/batch.make_batched_step are timed, the launch counts set to
    0 just before and read just after."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.core.state import pad_state
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.parallel.batch import (
        init_batch_state, make_batched_step)
    t0 = time.time()
    eng = Engine(cfg_path, exact=False, backend="gen1",
                 spawn_horizon=warmup + steps + 16)
    snap = None
    for i in range(warmup + steps):
        eng.next_step()
        if i + 1 == warmup:
            snap = eng.state
    cfg, net, spawn = eng.cfg, eng._net_dev, eng._spawn_dev
    assert not cfg.rl_traffic_light, "[gen1-batch] expects fixed-time lights"
    stb = init_batch_state(cfg, pad_state(snap, cfg.max_vehicles), batch)
    del snap, eng
    step_b = make_batched_step(net, cfg, with_obs=False)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    for _ in range(steps):
        stb = step_b(stb, spawn)[0]
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kernels.launch_counts()
    veh = int(stb.running[0].sum())
    log(f"[gen1-batch] B={batch} steps={steps} warmup={warmup} "
        f"ms_per_batched_step={dt * 1e3 / steps:.3f} "
        f"env_steps_per_s={batch * steps / dt:.1f} vehicles_per_env={veh} "
        f"waiting_per_env={int((stb.active[0] & ~stb.running[0]).sum())} "
        f"pool={cfg.max_vehicles} k_link={cfg.k_link} "
        f"overflow={int(stb.overflow.max())} warmup_s={warm_s:.1f}")
    assert int(stb.overflow.max()) == 0, "overflow flags set"
    assert veh > 0, "no vehicles"
    envs_equal(stb)
    for k in GEN1_KERNELS:
        assert launches[k] > 0, f"kernel {k} was not launched on gen1-batch"
    assert launches["spawn_slots@inplace"] == launches["spawn_slots"], \
        "[gen1-batch] a G11 call copied the pool (the state is donated)"
    holder = [stb]

    def one():
        holder[0] = step_b(holder[0], spawn)[0]
    res = _gen1_batch_report("gen1-batch", one, launches, steps, batch, dt,
                             GEN1_KERNELS)
    res.update(warmup=warmup, vehicles=veh, pool=cfg.max_vehicles)
    return launches, res, (net, cfg, spawn, holder)


def _batch_args_ok(n, a, k, batch):
    """The recorded call ran over the whole batch (env axis `batch`)."""
    if n == "notify_cross":
        t = a[2]
    elif n in ("spawn_slots", "shadow_insert"):
        t = a[0].active
    elif n in ("lc_plan", "lc_commit"):
        t = a[1].dis        # after the mode
    else:
        t = a[0]
    assert t.dim() == 2 and t.shape[0] == batch, \
        f"{n}: called with {tuple(t.shape)}, not ({batch}, V)"


def check_gen1_batch_kernels(ctx, reps, batch):
    """On every call of one more [gen1-batch] step: G1-G4, G9, G10, G11
    and G12 against their plain versions, bitwise (G10's fast finish sum
    within 1e-6 relative), each call asserted to cover all `batch` envs;
    then G13 in both modes and G14 in its three on that state (integer
    outputs and the pressures bitwise, the in-flight sum within 1e-5
    relative). Timed, with the library yardsticks: torch.sort + torch.sum
    for G10, one scatter_reduce("amin") for G12's heads, one index_add_
    for G13's counts."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.core import observe
    from cityflow_tpu_torch.core import step as step_mod
    net, cfg, spawn, holder = ctx

    def one():              # the path's own step: the state donated
        holder[0] = step_mod.step(net, cfg, holder[0], spawn, donate=True)
    calls = record_gen1_calls(one, GEN1_KERNELS)
    log_cross_funnel("gen1-batch", calls["cross_pass"])
    assert all(k.get("inplace") for _, k in calls["spawn_slots"]), \
        "[gen1-batch] G11 did not run in place"
    rows = []
    for n in GEN1_KERNELS:
        mod = kernels.MODULES[n]
        kern, plain = getattr(mod, n), _gen1_plain(n, mod)
        assert calls[n], f"{n}: no call recorded"
        rel_tol = 1e-6 if n == "update_location" else None
        errs = []
        for a, k in calls[n]:
            _batch_args_ok(n, a, k, batch)
            errs.append(_check_call(n, kern, plain, a, k, rel_tol))
        how = "within 1e-6 relative" if rel_tol else "bitwise"
        log(f"[kernels] {n}: {len(calls[n])} calls at B={batch} equal to the "
            f"plain version ({how})")
        a, k = calls[n][-1] if n == "leader_scan" else calls[n][0]
        ms = _time_gen1(n, kern, a, k, reps)
        plain_ms = _time_gen1(n, plain, a, k, reps)
        lib = None
        if n == "update_location":
            lib = sort_sum_ms(a, reps)
        elif n == "admit_heads":
            lib = heads_amin_ms(a, reps)
        label = f"{n}@batch"
        nbytes, nops = _gen1_bound(n, a, k, kern, label)
        rows.append(kernel_row(label, max(errs), ms, plain_ms, nbytes, nops,
                               lib))
    check_copy_form("gen1-batch", "spawn_slots", *calls["spawn_slots"][0],
                    reps)
    st = holder[0]
    L, D = cfg.num_lanes, cfg.num_drivables
    g13, g14 = kernels.MODULES["lane_counts"], kernels.MODULES["phase_scores"]
    for label, d in (("lane_counts@drivables", D), ("lane_counts", None)):
        a = (st.running, st.active, st.drv, st.speed, st.enter_time, st.step,
             net["interval"], L, d)
        got, want = g13.lane_counts(*a), g13.lane_counts_plain(*a)
        for key in got:
            if key == "inflight":
                rel, nbit = rel_close(f"{label} inflight", got[key],
                                      want[key])
                err = float((got[key] - want[key]).abs().max())
            elif got[key] is not None:
                assert torch.equal(got[key], want[key]), f"{label} {key}"
        log(f"[kernels] {label}: counts equal, inflight max_rel={rel} "
            f"not_bitwise={nbit} of {batch}")
        if d is not None:
            # drivable_vehicle_count: no path of the step calls it
            continue
        ms = time_cuda(lambda: g13.lane_counts(*a), reps)
        plain_ms = time_cuda(lambda: g13.lane_counts_plain(*a), reps)
        V = st.running.numel()
        fs = st.speed.element_size()
        outs = batch * (2 * L + (d or 0)) * 4 + batch * (8 + fs)
        rows.append(kernel_row(label, err, ms, plain_ms,
                               V * (2 + 4 + 2 * fs) + outs, 4 * V,
                               lane_index_add_ms(st, L, reps)))
    w = observe.lane_waiting_vehicle_count(cfg, st)
    P = int(net["n_phases"].max())
    LL = net["ll_start"].shape[0]
    tab = sum(net[t].numel() * net[t].element_size() for t in g14.TABLES)
    for mode, label in (("pressure", "phase_scores"),
                        ("phases", "phase_scores@phases"),
                        ("features", "phase_scores@features")):
        a = (w, net, P, mode)
        got, want = g14.phase_scores(*a), g14.phase_scores_plain(*a)
        for g_, w_ in zip(_flat(got), _flat(want)):
            assert bitwise_equal(g_, w_), f"{label} differs"
        ms = time_cuda(lambda: g14.phase_scores(*a), reps)
        plain_ms = time_cuda(lambda: g14.phase_scores_plain(*a), reps)
        outs = sum(t.numel() * t.element_size() for t in _flat(got))
        rows.append(kernel_row(label, 0.0, ms, plain_ms,
                               w.numel() * 4 + tab + outs,
                               batch * LL * (P if mode != "pressure" else 1),
                               None))
    return rows


def check_copy_form(tag, n, a, k, reps):
    """The copying form (inplace=False, the Engine's) of the recorded
    in-place call (a, k) of G11 or G5 on the same inputs: its outputs
    bitwise equal to the in-place form's, its kernel timed and its bound
    (the copying count) logged beside the path's in-place row. The path
    does not launch this form, so it has no row of the kernel table."""
    from cityflow_tpu_torch import kernels
    kern = getattr(kernels.MODULES[n], n)
    kc = dict(k, inplace=False)
    for i, (g, w) in enumerate(zip(_flat(_gen1_call(n, kern, a, kc)),
                                   _flat(_gen1_call(n, kern, a, k)))):
        assert bitwise_equal(g, w), f"{n}: the two forms differ ({i})"
    ms = _time_gen1(n, kern, a, kc, reps)
    nbytes, nops = _gen1_bound(n, a, kc, kern)
    bound = max(nbytes / H100_BYTES_PER_S, nops / H100_F32_FLOPS) * 1e3
    log(f"[kernels] {n} copying form on [{tag}]'s call (equal to the "
        f"in-place form bitwise; not launched on this path): ms={ms:.4f} "
        f"bound_ms={bound:.4f}")
    return ms


def heads_amin_ms(a, reps):
    """One library call computing G12's lane heads' first pass: the
    scatter_reduce("amin") of the waiting uids into (B, L + 1) by lane
    (the keys made outside the timing)."""
    import torch
    active, running, drv, uid = a[:4]
    L = a[11]
    waiting = active & ~running
    seq = torch.where(waiting, uid, 2**31 - 1)
    idx = torch.where(waiting, drv, L).long()
    out = torch.empty((uid.shape[0], L + 1), dtype=torch.int32,
                      device=uid.device)
    return time_cuda(lambda: out.fill_(2**31 - 1).scatter_reduce_(
        -1, idx, seq, "amin"), reps)


def lane_index_add_ms(st, L, reps):
    """One library call computing G13's lane counts: index_add_ of ones
    into the (B, L + 1) bins by each running vehicle's lane (L for the
    rest), the bins made outside the timing."""
    import torch
    B, V = st.running.shape
    on = st.running & (st.drv >= 0) & (st.drv < L)
    idx = (torch.where(on, st.drv, L).long()
           + (L + 1) * torch.arange(B, device=st.drv.device)[:, None])
    ones = torch.ones(B * V, dtype=torch.int32, device=st.drv.device)
    out = torch.zeros(B * (L + 1), dtype=torch.int32, device=st.drv.device)
    return time_cuda(lambda: out.zero_().index_add_(0, idx.reshape(-1),
                                                    ones), reps)


def run_gen1_env(cfg_path, batch, warmup, steps, pool):
    """rl/env.CityFlowVecEnv at `batch` envs with a pool of `pool` slots:
    `warmup` steps of one env under MaxPressure every MP_EVERY steps,
    copied into the batch, then `steps` timed steps of step() with
    max_pressure_actions() every MP_EVERY-th, the launch counts set to 0
    just before and read just after. Returns the launches, the report and
    the warm one-env state (a batch of one)."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.parallel.batch import init_batch_state
    from cityflow_tpu_torch.rl.env import CityFlowVecEnv
    t0 = time.time()
    env = CityFlowVecEnv(cfg_path, batch=1, max_vehicles=pool,
                         horizon=warmup + steps + 16)
    env.reset()
    acts = torch.zeros((1, env.num_intersections), dtype=torch.int32,
                       device=env.device)
    for t in range(warmup):
        if t % MP_EVERY == 0 and t:
            acts = env.max_pressure_actions()
        env.step(acts)
    assert int(env.state.overflow.max()) == 0, "overflow in the warm-up"
    warm = env.state
    env.state = init_batch_state(env.cfg, env.state.map(lambda x: x[0]),
                                 batch)
    env.batch = batch
    acts = acts.expand(batch, -1).contiguous()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    changed = torch.zeros((), dtype=torch.int64, device=env.device)
    kernels.reset_launches()
    t0 = time.time()
    for t in range(steps):
        if t % MP_EVERY == 0:
            acts = env.max_pressure_actions()
            # on the device: no host sync inside the timed window
            changed += (env.state.phase[0] != acts[0]).sum()
        obs, reward = env.step(acts)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kernels.launch_counts()
    st = env.state
    veh = int(obs["vehicle_count"][0])
    changed = int(changed)
    log(f"[gen1-env] B={batch} steps={steps} warmup={warmup} "
        f"ms_per_batched_step={dt * 1e3 / steps:.3f} "
        f"env_steps_per_s={batch * steps / dt:.1f} vehicles_per_env={veh} "
        f"waiting_env0={int(-float(reward[0]))} "
        f"phase_changes_by_controller={changed} pool={pool} "
        f"warmup_s={warm_s:.1f}")
    assert int(st.overflow.max()) == 0, "overflow flags set"
    assert veh > 0, "no vehicles"
    envs_equal(st)
    for k in GEN1_KERNELS + GEN1_RL_KERNELS:
        assert launches[k] > 0, f"kernel {k} was not launched on gen1-env"
    assert launches["spawn_slots@inplace"] == launches["spawn_slots"], \
        "[gen1-env] a G11 call copied the pool (the state is donated)"
    assert changed > 0, "the controller changed no phase in the window"

    def one():
        env.step(env.max_pressure_actions())
    # G4, G3 and G1 on every call of one more step, and G4's funnel
    rec = record_gen1_calls(one, ("cross_pass", "notify_cross", "arrange"))
    for n in ("cross_pass", "notify_cross", "arrange"):
        mod = kernels.MODULES[n]
        assert rec[n], f"{n}: no call recorded on [gen1-env]"
        for a, k in rec[n]:
            _batch_args_ok(n, a, k, batch)
            _check_call(n, getattr(mod, n), _gen1_plain(n, mod), a, k, None)
        log(f"[kernels] {n}: {len(rec[n])} calls of one more [gen1-env] "
            f"step at B={batch} equal to the plain version (bitwise)")
    calls = rec["cross_pass"]
    log_cross_funnel("gen1-env", calls)
    res = _gen1_batch_report("gen1-env", one, launches, steps, batch, dt,
                             GEN1_KERNELS + ("lane_counts", "phase_scores"))
    res.update(warmup=warmup, vehicles=veh, pool=pool,
               phase_changes=changed)
    return launches, res, warm


def run_gen1_dqn(cfg_path, batch, iters, warm, reps):
    """rl/dqn.train on `cfg_path` at `batch` envs for `iters` iterations
    (5 steps each) from the warm one-env state `warm` copied into the
    batch, the launch counts set to 0 just before and read just after;
    the ms of each iteration after the first (the first also pays train's
    set-up), and the mean of those after the second. Some iteration's
    reward must not be zero (vehicles wait). G14's features mode is held
    against its plain version on the last such call of the run, bitwise,
    and timed there: the row phase_scores@features:gen1-dqn, the path's
    own B."""
    import math
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.parallel.batch import init_batch_state
    from cityflow_tpu_torch.rl import dqn
    start = int(warm.step[0])
    state = init_batch_state(None, warm.map(lambda x: x[0]), batch)
    stamps, last = [], {}
    g14 = kernels.MODULES["phase_scores"]
    orig, feat = g14.phase_scores, []

    def g14_rec(*a, **k):
        if a[3] == "features":
            feat[:] = [a]
        return orig(*a, **k)

    def on_iter(i, metrics, state):
        torch.cuda.synchronize()
        stamps.append(time.time())
        last["state"] = state
    kernels.reset_launches()
    g14.phase_scores = g14_rec
    try:
        t0 = time.time()
        hist = dqn.train(cfg_path, iters=iters, on_iter=on_iter,
                         state=state)
        wall = time.time() - t0
    finally:
        g14.phase_scores = orig
    launches = kernels.launch_counts()
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    steady = sum(ms[1:]) / max(len(ms) - 1, 1)
    losses = [h["loss"] for h in hist]
    st = last["state"]
    rewards = [h["mean_reward"] for h in hist]
    log(f"[gen1-dqn] B={batch} iters={iters} from step {start} "
        f"pool={warm.active.shape[-1]} ms_per_iteration_after_the_"
        f"second={steady:.3f} ms_after_the_first={[round(x, 3) for x in ms]}"
        f" losses={losses} mean_rewards={rewards} "
        f"vehicles_env0={int(st.running[0].sum())} wall_s={wall:.1f}")
    assert all(math.isfinite(x) for x in losses), "loss not finite"
    assert any(r != 0.0 for r in rewards), "the reward is zero throughout"
    assert int(st.step[0]) == start + 5 * iters, "steps not advanced"
    assert int(st.overflow.max()) == 0, "overflow flags set"
    for k in GEN1_KERNELS + ("phase_scores@features",):
        assert launches[k] > 0, f"kernel {k} was not launched on gen1-dqn"
    assert launches["spawn_slots@inplace"] == launches["spawn_slots"], \
        "[gen1-dqn] a G11 call copied the pool (the state is donated)"
    # G1 and G3 on every call of one more iteration from the final state
    # (5 steps; recorded apart from the timed run)
    rec = record_gen1_calls(lambda: dqn.train(
        cfg_path, iters=1, state=fresh(st)), ("arrange", "notify_cross"))
    for n in ("arrange", "notify_cross"):
        mod = kernels.MODULES[n]
        assert rec[n], f"{n}: no call recorded on [gen1-dqn]"
        for ca, ck in rec[n]:
            _batch_args_ok(n, ca, ck, batch)
            _check_call(n, getattr(mod, n), _gen1_plain(n, mod), ca, ck,
                        None)
        log(f"[kernels] {n}: {len(rec[n])} calls of one more [gen1-dqn] "
            f"iteration at B={batch} equal to the plain version (bitwise)")
    del rec
    w, net, P, mode = a = feat[0]
    got, want = orig(*a), g14.phase_scores_plain(*a)
    for g_, w_ in zip(_flat(got), _flat(want)):
        assert bitwise_equal(g_, w_), "phase_scores@features:gen1-dqn"
    kms = time_cuda(lambda: orig(*a), reps)
    plain_ms = time_cuda(lambda: g14.phase_scores_plain(*a), reps)
    tab = sum(net[t].numel() * net[t].element_size() for t in g14.TABLES)
    outs = sum(t.numel() * t.element_size() for t in _flat(got))
    row = kernel_row("phase_scores@features:gen1-dqn", 0.0, kms, plain_ms,
                     w.numel() * 4 + tab + outs,
                     w.shape[0] * net["ll_start"].shape[0] * P, None)
    return launches, dict(B=batch, iters=iters, start_step=start,
                          pool=warm.active.shape[-1], ms_after_the_first=ms,
                          ms_per_iteration=steady, losses=losses,
                          mean_rewards=rewards), [row]


def lcb_warm_batch(cfg_path, exact, at, pool):
    """One Engine on `cfg_path` (lane change, DURATION) on the card, its
    states after each step of `at` (past the first shadows) in one pool of
    at least `pool` slots, stacked as a batch of len(at) envs whose states
    differ. Returns the Engine, the batch's config and the batch."""
    import dataclasses
    import torch
    from cityflow_tpu_torch.core.state import SIM_FIELDS, SimState, pad_state
    from cityflow_tpu_torch.engine import Engine
    eng = Engine(cfg_path, exact=exact, backend="gen1",
                 spawn_horizon=max(at) + AGREE_GEN1_LCB_STEPS + 16)
    snaps = []
    for t in range(1, max(at) + 1):
        eng.next_step()
        if t in at:
            snaps.append(eng.state)
    V = max([pool] + [x.active.shape[0] for x in snaps])
    snaps = [pad_state(x, V) for x in snaps]
    stb = SimState(**{k: torch.stack([getattr(x, k) for x in snaps])
                      .contiguous() for k in SIM_FIELDS})
    return eng, dataclasses.replace(eng.cfg, max_vehicles=V), stb


def check_agreement_gen1_lc_batch(cfg_path, steps, exact):
    """parallel/batch.make_batched_step with lane change and the DURATION
    history on a batch of AGREE_GEN1_LCB_AT's states (one Engine's, at
    four different steps past the first shadows, so that an env-offset
    fault that reads env 0 shows): `steps` batched steps on the card
    against the same batch on the CPU (plain versions) and against each
    env stepped alone on the card. Every 10 steps: batched against alone
    bitwise, every leaf; card against CPU bitwise in exact mode, in fast
    mode [agree-fast]'s yardstick (the same vehicles on the same
    drivables, |dis| and |speed| within 2e-3). The steps with shadows are
    counted (must be > 0); the card batch's launch counts returned."""
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.core import step as step_mod
    from cityflow_tpu_torch.core.state import SIM_FIELDS
    from cityflow_tpu_torch.parallel.batch import make_batched_step
    tag = "agree-gen1-lc-batch" + ("" if exact else "-fast")
    t0 = time.time()
    eng, cfg, stb = lcb_warm_batch(cfg_path, exact, AGREE_GEN1_LCB_AT,
                                   AGREE_GEN1_LCB_POOL)
    assert cfg.lane_change and cfg.track_history
    B = stb.step.shape[0]
    assert len(set(stb.step.tolist())) == B, "the envs are not distinct"
    cpu = lambda d: {k: v.cpu() if torch.is_tensor(v) else v
                     for k, v in d.items()}
    net, spawn = eng._net_dev, eng._spawn_dev
    net_c, spawn_c = cpu(net), cpu(spawn)
    step_g = make_batched_step(net, cfg, with_obs=False)
    step_c = make_batched_step(net_c, cfg, with_obs=False)
    g, c = stb, stb.map(lambda x: x.cpu())
    alone = [stb.map(lambda x, b=b: x[b:b + 1].clone())
             for b in range(B)]
    shadow_steps, worst = 0, 0.0
    kernels.reset_launches()
    for i in range(1, steps + 1):
        g = step_g(g, spawn)[0]
        c = step_c(c, spawn_c)[0]
        alone = [step_mod.step(net, cfg, x, spawn) for x in alone]
        shadow_steps += int((g.is_shadow & g.running).any(-1).sum())
        if i % 10 and i != steps:
            continue
        for b, x in enumerate(alone):
            for k in SIM_FIELDS:
                assert bitwise_equal(getattr(g, k)[b:b + 1], getattr(x, k)), \
                    f"[{tag}] step {i}: env {b} {k} differs from alone"
        if exact:
            for k in SIM_FIELDS:
                assert bitwise_equal(getattr(g, k).cpu(), getattr(c, k)), \
                    f"[{tag}] step {i}: {k} differs card vs CPU"
            continue
        for b in range(B):
            va, vb = batch_vehicles(g, b), batch_vehicles(c, b)
            assert set(va) == set(vb), \
                f"[{tag}] step {i} env {b}: vehicle sets differ"
            for u in va:
                assert va[u][0] == vb[u][0], \
                    f"[{tag}] step {i} env {b}: uid {u} drivable"
                worst = max(worst, abs(va[u][1] - vb[u][1]),
                            abs(va[u][2] - vb[u][2]))
        assert worst <= 2e-3, f"[{tag}] step {i}: drift {worst}"
    launches = kernels.launch_counts()
    assert shadow_steps > 0, f"[{tag}] no shadows"
    assert int(g.overflow.max()) == 0 and int(c.overflow.max()) == 0
    for k in GEN1_KERNELS + GEN1_LC_KERNELS:
        assert launches[k] > 0, f"{k} idle on [{tag}]"
    log(f"[{tag}] {steps} steps B={B} from steps "
        f"{[a for a in AGREE_GEN1_LCB_AT]} pool={cfg.max_vehicles}: "
        f"batched == alone bitwise, card vs CPU "
        f"{'bitwise' if exact else f'worst_drift={worst}'}; "
        f"vehicles per env={[len(batch_vehicles(g, b)) for b in range(B)]} "
        f"env-steps with shadows={shadow_steps} "
        f"wall_s={time.time() - t0:.1f}")
    return shadow_steps, launches


def run_gen1_lc_batch(ctx, batch, steps):
    """The batched gen-1 fast step with lane change and the DURATION
    history on config_30x30_lc.json at `batch` envs: [gen1-lc]'s state
    after its warm-up (float64, padded to the pool [gen1-lc] ended with,
    the smallest power of two with no overflow there) cast to float32
    through carry and copied into the batch (in place of warming a
    second, fast Engine), then `steps` timed batched steps, the launch
    counts set to 0 just before and read just after. Asserts overflow ==
    0, shadows in the window, vehicles, every env equal to env 0 bitwise
    and G1-G12, G5-G8 and G15 launched."""
    import dataclasses
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.carry import (
        net_tensors, sim_state_from_numpy, sim_state_to_numpy)
    from cityflow_tpu_torch.core.state import pad_state
    from cityflow_tpu_torch.parallel.batch import (
        init_batch_state, make_batched_step)
    host_net, spawn, cfg64, warm = ctx
    dev = spawn["step"].device
    cfg = dataclasses.replace(cfg64, exact=False)
    net = net_tensors(host_net, torch.float32, dev)
    one = sim_state_from_numpy(sim_state_to_numpy(
        pad_state(warm, cfg.max_vehicles)), dev, torch.float32)
    start = int(one.step)
    stb = init_batch_state(cfg, one, batch)
    del one
    step_b = make_batched_step(net, cfg, with_obs=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shadows = torch.zeros((), dtype=torch.int64, device=dev)
    kernels.reset_launches()
    t0 = time.time()
    for _ in range(steps):
        stb = step_b(stb, spawn)[0]
        shadows += (stb.is_shadow & stb.running).sum()
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kernels.launch_counts()
    veh = int(stb.running[0].sum())
    log(f"[gen1-lc-batch] B={batch} steps={steps} (engine steps "
        f"{start + 1}-{start + steps}) ms_per_batched_step="
        f"{dt * 1e3 / steps:.3f} env_steps_per_s={batch * steps / dt:.1f} "
        f"vehicles_per_env={veh} shadow_rows_in_window={int(shadows)} "
        f"pool={cfg.max_vehicles} overflow={int(stb.overflow.max())} "
        f"ring={tuple(stb.hist_ring_num.shape)}")
    assert int(stb.overflow.max()) == 0, "overflow flags set"
    assert int(shadows) > 0, "no shadows in the [gen1-lc-batch] window"
    assert veh > 0, "no vehicles"
    envs_equal(stb)
    log(f"[gen1-lc-batch] overflow == 0, shadows in the window, every env "
        f"equal to env 0 bitwise after step {start + steps}")
    for k in GEN1_KERNELS + GEN1_LC_KERNELS:
        assert launches[k] > 0, f"kernel {k} was not launched on " \
            "gen1-lc-batch"
    for k in ("spawn_slots", "hist_window"):
        assert launches[k + "@inplace"] == launches[k], \
            f"[gen1-lc-batch] a {k} call copied (the state is donated)"
    holder = [stb]
    del stb

    def one_step():
        holder[0] = step_b(holder[0], spawn)[0]
    res = _gen1_batch_report("gen1-lc-batch", one_step, launches, steps,
                             batch, dt, GEN1_KERNELS + GEN1_LC_KERNELS)
    res.update(start_step=start, vehicles=veh, pool=cfg.max_vehicles,
               shadow_rows_in_window=int(shadows))
    return launches, res, (net, cfg, spawn, holder)


def check_gen1_lcb_kernels(ctx, reps, batch):
    """On every call of one more [gen1-lc-batch] step (the path's own: the
    state donated): G5-G8 (every mode of G7 and G8), G11, G15, G4, G3 and
    G1 against their plain versions, each call asserted to span the `batch`
    envs, bitwise (G11, G5 and G15 write in place: kernel and plain
    version each on a fresh copy of what they write); G4's funnel
    printed. Timed on the first call of each kernel and mode (rows
    <name>@lcbatch; G5, G11 and G15 each call on a fresh copy), G5 beside
    index_add_; G3, G4, G11 and G15 have no one library call that
    computes their function. G11's and G5's copying forms are checked and
    timed on the same calls (check_copy_form)."""
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.core import step as step_mod
    net, cfg, spawn, holder = ctx

    def one():              # the path's own step: the state donated
        holder[0] = step_mod.step(net, cfg, holder[0], spawn, donate=True)
    names = GEN1_LC_KERNELS + ("spawn_slots", "cross_pass", "notify_cross",
                               "arrange")
    calls = record_gen1_calls(one, names)
    del holder[:]
    log_cross_funnel("gen1-lc-batch", calls["cross_pass"])
    for n in ("spawn_slots", "hist_window"):
        assert all(k.get("inplace") for _, k in calls[n]), \
            f"[gen1-lc-batch] {n} did not run in place"
    rows = []
    for n in names:
        mod = kernels.MODULES[n]
        kern, plain = getattr(mod, n), _gen1_plain(n, mod)
        assert calls[n], f"{n}: no call recorded"
        errs = []
        for a, k in calls[n]:
            _batch_args_ok(n, a, k, batch)
            errs.append(_check_call(n, kern, plain, a, k, None))
        log(f"[kernels] {n}: {len(calls[n])} calls at B={batch} equal to the "
            f"plain version (bitwise)")
        timed = {}
        for a, k in calls[n]:
            timed.setdefault(_gen1_label(n, a), (a, k))
        for label, (a, k) in timed.items():
            ms = _time_gen1(n, kern, a, k, reps)
            plain_ms = _time_gen1(n, plain, a, k, reps)
            lib = index_add_ms(a, reps) if n == "hist_window" else None
            nbytes, nops = _gen1_bound(n, a, k, kern, label + "@lcbatch")
            rows.append(kernel_row(label + "@lcbatch", max(errs), ms,
                                   plain_ms, nbytes, nops, lib))
    for n in ("spawn_slots", "hist_window"):
        check_copy_form("gen1-lc-batch", n, *calls[n][0], reps)
    g1 = kernels.MODULES["arrange"]
    per_call = [round(time_cuda(lambda: g1.arrange(*a, **k), reps), 4)
                for a, k in calls["arrange"]]
    log(f"[gen1-lc-batch] arrange: {len(per_call)} calls a step, ms "
        f"{per_call}, sum {sum(per_call):.4f}")
    return rows


def main():
    t_start = time.time()

    def mark(tag):
        # where the script's wall time goes (it must stay well inside the
        # 1200 s a run is given)
        log(f"[time] {tag} from {time.time() - t_start:.1f} s")
    if not os.path.isdir(os.path.join(HERE, "cityflow_tpu_torch")):
        print("chip_smoke: the cityflow_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(smi)
    from cityflow_tpu_torch.kernels import _lib
    t0 = time.time()
    L = _lib.lib()
    log(f"[build] kernels built in {time.time() - t0:.1f} s "
        f"(nvcc {_lib.build_seconds})")
    ptxas = L._name + ".ptxas.txt"
    if os.path.exists(ptxas):
        with open(ptxas) as f:
            for line in f:
                if "entry function" in line or "registers" in line \
                        or "spill" in line:
                    log(f"[build] {line.strip()}")

    t0 = time.time()
    from cityflow_tpu_torch.tools.scenario import mixed_templates, prepare
    cfg_path = prepare(os.path.join(HERE, "benchmarks", "config_30x30.json"))
    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.compiler.net import compile_scenario
    net = compile_scenario(cfg_path)
    sim = ring_sim.build_sim(net, horizon=16, sl=40)
    c = sim.cfg
    log(f"[scenario] 30x30 in {time.time() - t0:.1f} s: I={c.I} G={c.G} "
        f"LPI={c.LPI} KC={c.KC} IL={c.IL} OL={c.OL} LNp={c.LNp} "
        f"LKp={c.LKp} SL={c.SL} SK={c.SK} AP={c.AP} XK={c.XK}")

    mark("kernels")
    rows = check_kernels(sim, BATCH, REPS)
    del sim
    torch.cuda.empty_cache()
    mark("agree")
    check_agreement(net, AGREE_STEPS, sl=40)
    mark("main")
    main_launches, res, mn_sim, mn_state = run_path(
        "main", cfg_path, BATCH, WARMUP, STEPS, MAIN_KERNELS)
    log(f"[main] {json.dumps(res)}")
    check_commit_calls("main", mn_sim, mn_state, REPS)
    rows += check_ring_kernels(mn_sim, mn_state, REPS, "main")
    rows += check_front_kernels(mn_sim, mn_state, REPS, "main")
    del mn_sim, mn_state
    torch.cuda.empty_cache()

    mark("agree-lc, lc")
    # the fixture's `dir` names the machine it was written on: stage it;
    # L4 at one env (the ring Engine's step) against its plain version
    with partner_checked() as l4_calls:
        check_agreement(compile_scenario(prepare(os.path.join(
            HERE, "tests", "fixtures", "config_1x1s_lc.json"))),
            AGREE_LC_STEPS, tag="agree-lc", sl=12, sk=6, skc=99)
    log(f"[agree-lc] L4 at B=1 bitwise against its plain version: "
        f"{l4_calls}")
    assert all(l4_calls.values()), "[agree-lc] an L4 mode was not called"
    lc_cfg = prepare(os.path.join(HERE, "benchmarks", "config_30x30_lc.json"))
    lc_launches, lc_res, lc_sim, lc_state = run_path(
        "lc", lc_cfg, BATCH, LC_WARMUP, STEPS,
        MAIN_KERNELS + LC_KERNELS + LC_MODES)
    log(f"[lc] {json.dumps(lc_res)}")
    check_commit_calls("lc", lc_sim, lc_state, REPS)
    rows += check_lc_kernels(lc_sim, lc_state, REPS)
    rows += check_ring_kernels(lc_sim, lc_state, REPS, "lc")
    rows += check_front_kernels(lc_sim, lc_state, REPS, "lc")
    del lc_sim, lc_state
    torch.cuda.empty_cache()

    mark("agree-mixed, mixed, mixed-lc")
    # non-uniform vehicle templates: the three vehicles of the mixed
    # fixture over the 30x30 flows, with and without lane change
    fix = os.path.join(HERE, "tests", "fixtures")
    templates = mixed_templates(os.path.join(fix, "flow_2x2_mixed.json"))
    check_agreement(compile_scenario(prepare(os.path.join(
        fix, "config_2x2_mixed.json"))), AGREE_MIXED_STEPS,
        tag="agree-mixed", skc=99)
    mixed_cfg = prepare(os.path.join(HERE, "benchmarks", "config_30x30.json"),
                        name="config_30x30_mixed", templates=templates)
    mixed_launches, mixed_res, m_sim, m_state = run_path(
        "mixed", mixed_cfg, BATCH, WARMUP, STEPS, MAIN_KERNELS + TPL_MODES,
        lane_slots=0)
    log(f"[mixed] {json.dumps(mixed_res)}")
    check_commit_calls("mixed", m_sim, m_state, REPS)
    rows += check_tpl_kernels(m_sim, m_state, REPS, lc=False)
    rows += check_ring_kernels(m_sim, m_state, REPS, "mixed")
    rows += check_front_kernels(m_sim, m_state, REPS, "mixed")
    del m_sim, m_state
    torch.cuda.empty_cache()
    with partner_checked() as l4_calls:
        check_agreement(compile_scenario(prepare(os.path.join(
            fix, "config_1x1s_mixed_lc.json"))), AGREE_LC_STEPS,
            tag="agree-mixed-lc", sl=12, sk=6, skc=99)
    log(f"[agree-mixed-lc] L4 at B=1 bitwise against its plain version: "
        f"{l4_calls}")
    assert all(l4_calls.values()), "[agree-mixed-lc] an L4 mode not called"
    mlc_cfg = prepare(os.path.join(HERE, "benchmarks",
                                   "config_30x30_lc.json"),
                      name="config_30x30_lc_mixed", templates=templates)
    with insert_demand() as demand:
        mlc_launches, mlc_res, ml_sim, ml_state = run_path(
            "mixed-lc", mlc_cfg, BATCH, LC_WARMUP, STEPS,
            MAIN_KERNELS + LC_KERNELS + LC_MODES + TPL_MODES + TPL_LC_MODES,
            lane_slots=0, after_warmup=demand["stop"])
    mlc_res["insert_demand_peak"] = demand["peak"]
    log(f"[mixed-lc] the most shadow inserts one lane asked for in one "
        f"warm-up step: {demand['peak']} (cap LCI {ml_sim.cfg.LCI}; the "
        f"window is held to it by overflow == 0)")
    assert demand["peak"] <= ml_sim.cfg.LCI, "insert demand above the cap"
    log(f"[mixed-lc] {json.dumps(mlc_res)}")
    check_commit_calls("mixed-lc", ml_sim, ml_state, REPS)
    rows += check_tpl_kernels(ml_sim, ml_state, REPS, lc=True,
                              lci=demand["peak"])
    rows += check_ring_kernels(ml_sim, ml_state, REPS, "mixed-lc")
    rows += check_front_kernels(ml_sim, ml_state, REPS, "mixed-lc")
    del ml_sim, ml_state
    torch.cuda.empty_cache()

    mark("agree-rl, rl, dqn")
    # the RL control path (fixtures staged like the lane-change one)
    check_agreement_rl(prepare(os.path.join(fix, "config_4x4_rl.json")),
                       AGREE_RL_STEPS)
    from cityflow_tpu_torch import kernels
    kernels.reset_launches()
    check_agreement(compile_scenario(prepare(
        os.path.join(fix, "config_2x2.json"), name="config_2x2_duration",
        routerType="DURATION")), AGREE_HIST_STEPS, tag="agree-hist")
    hist_launches = kernels.launch_counts()
    log(f"[agree-hist] launches={hist_launches}")
    assert hist_launches["lane_stats@hist"] > 0, "O1 history mode idle"
    rl_launches, rl_res, env = run_rl(cfg_path, BATCH, RL_WARMUP, STEPS)
    log(f"[rl] {json.dumps(rl_res)}")
    check_commit_calls("rl", env.sim, env.state, REPS)
    rows += check_rl_kernels(env, REPS)
    dqn_launches, dqn_res = run_dqn(env, DQN_ITERS)
    log(f"[dqn] {json.dumps(dqn_res)}")
    del env
    torch.cuda.empty_cache()

    mark("golden-gen1, gen1")
    # the gen-1 exact Engine (G9 and G10 on its path too)
    kernels.reset_launches()
    check_golden_gen1()
    golden_launches = kernels.launch_counts()
    for k in GEN1_KERNELS + GEN1_LC_KERNELS:
        assert golden_launches[k] > 0, f"{k} idle on [golden-gen1]"
    assert golden_launches["update_location@fast"] == 0
    check_agreement_gen1(cfg_path, AGREE_GEN1_STEPS)
    gen1_launches, gen1_res, eng, _ = run_gen1(cfg_path, GEN1_WARMUP,
                                            GEN1_STEPS)
    log(f"[gen1] {json.dumps(gen1_res)}")
    rows += check_gen1_kernels(eng, REPS, GEN1_KERNELS, tag="gen1")
    del eng
    torch.cuda.empty_cache()
    mark("gen1-lc")
    # gen-1 lane change under the DURATION router
    shadow_steps = check_agreement_gen1(
        prepare(os.path.join(fix, "config_2x2_lc.json"),
                name="config_2x2_lc_duration", routerType="DURATION"),
        AGREE_GEN1_LC_STEPS, tag="agree-gen1-lc")
    assert shadow_steps > 0, "[agree-gen1-lc] no shadows"
    glc_cfg = prepare(os.path.join(HERE, "benchmarks",
                                   "config_30x30_lc.json"),
                      name="config_30x30_lc_duration",
                      routerType="DURATION")
    glc_launches, glc_res, eng, glc_warm = run_gen1(
        glc_cfg, GEN1_LC_WARMUP, GEN1_LC_STEPS, tag="gen1-lc",
        names=GEN1_KERNELS + GEN1_LC_KERNELS)
    log(f"[gen1-lc] {json.dumps(glc_res)}")
    rows += check_gen1_kernels(eng, REPS, GEN1_LC_KERNELS,
                               untimed=("spawn_slots", "admit_heads",
                                        "cross_pass", "notify_cross",
                                        "arrange"),
                               tag="gen1-lc")
    # what [gen1-lc-batch] starts from: the warm state, the pool, tables
    glc_ctx = (eng.net, eng._spawn_dev, eng.cfg, glc_warm)
    del eng, glc_warm
    torch.cuda.empty_cache()

    mark("gen1-fast")
    # Engine(exact=False): gen-1 fast mode (float32) ...
    from cityflow_tpu_torch.engine import Engine
    fast = dict(exact=False, backend="gen1")
    four = prepare(os.path.join(fix, "config_4x4.json"))
    check_agreement_fast(
        "agree-fast", Engine(four, spawn_horizon=AGREE_FAST_STEPS + 8, **fast),
        Engine(four, spawn_horizon=AGREE_FAST_STEPS + 8, device="cpu",
               **fast), AGREE_FAST_STEPS)
    fast_launches, fast_res, eng, _ = run_gen1(
        cfg_path, GEN1_WARMUP, GEN1_STEPS, tag="gen1-fast", exact=False,
        modes=GEN1_FAST_MODES)
    log(f"[gen1-fast] {json.dumps(fast_res)}")
    rows += check_gen1_kernels(eng, REPS, GEN1_KERNELS, fast=True,
                               tag="gen1-fast")
    del eng
    torch.cuda.empty_cache()
    lcd = prepare(os.path.join(fix, "config_2x2_lc.json"),
                  name="config_2x2_lc_duration", routerType="DURATION")
    card = Engine(lcd, spawn_horizon=AGREE_GEN1_LC_STEPS + 16, **fast)
    lcf_launches, shadows = check_agreement_fast(
        "agree-gen1-lc-fast", card,
        Engine(lcd, spawn_horizon=AGREE_GEN1_LC_STEPS + 16, device="cpu",
               **fast), AGREE_GEN1_LC_STEPS)
    assert shadows > 0, "[agree-gen1-lc-fast] no shadows"
    for k in GEN1_LC_F32:
        assert lcf_launches[k] > 0, f"{k} idle on [agree-gen1-lc-fast]"
    rows += check_gen1_kernels(card, REPS, GEN1_LC_KERNELS, fast=True)
    del card
    mark("ring-engine")
    # ... and the ring Engine
    ring_agree_launches, _ = check_agreement_fast(
        "agree-ring-engine",
        Engine(four, exact=False, spawn_horizon=AGREE_RING_ENGINE_STEPS + 8),
        Engine(four, spawn_horizon=AGREE_RING_ENGINE_STEPS + 8, **fast),
        AGREE_RING_ENGINE_STEPS)
    for k in MAIN_KERNELS + ("update_location@fast",):
        assert ring_agree_launches[k] > 0, f"{k} idle on [agree-ring-engine]"
    ring_launches, ring_res = run_ring_engine(
        cfg_path, RING_ENGINE_WARMUP, RING_ENGINE_STEPS, GETTER_EVERY)
    log(f"[ring-engine] {json.dumps(ring_res)}")
    gc.collect()
    torch.cuda.empty_cache()

    mark("gen1-batch, gen1-env, gen1-dqn")
    # the batched gen-1 step (a leading env axis) and its RL surface
    check_agreement_gen1_batch(four, AGREE_GEN1B_STEPS, AGREE_GEN1B_BATCH)
    check_agreement_gen1_env(prepare(os.path.join(fix, "config_4x4_rl.json")),
                             AGREE_GEN1_ENV_STEPS)
    gb_launches, gb_res, ctx = run_gen1_batch(cfg_path, BATCH, GEN1B_WARMUP,
                                              GEN1B_STEPS)
    log(f"[gen1-batch] {json.dumps(gb_res)}")
    rows += check_gen1_batch_kernels(ctx, REPS, BATCH)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    env_launches, env_res, warm = run_gen1_env(
        cfg_path, BATCH, GEN1B_WARMUP, GEN1B_STEPS, gb_res["pool"])
    log(f"[gen1-env] {json.dumps(env_res)}")
    gc.collect()
    torch.cuda.empty_cache()
    gdqn_launches, gdqn_res, gdqn_rows = run_gen1_dqn(
        cfg_path, GEN1_DQN_BATCH, GEN1_DQN_ITERS, warm, REPS)
    rows += gdqn_rows
    del warm
    log(f"[gen1-dqn] {json.dumps(gdqn_res)}")
    gc.collect()
    torch.cuda.empty_cache()

    mark("gen1-lc-batch")
    # batched gen-1 lane change and the DURATION history
    for exact in (True, False):
        check_agreement_gen1_lc_batch(lcd, AGREE_GEN1_LCB_STEPS, exact)
    lcb_batch = BATCH
    while True:
        try:
            glcb_launches, glcb_res, lcb_ctx = run_gen1_lc_batch(
                glc_ctx, lcb_batch, GEN1_LCB_STEPS)
            break
        except torch.cuda.OutOfMemoryError as e:
            why = str(e)[:160]
        # the state, the history rings and the step's temporaries at this
        # B do not fit the card: halve B and say so
        log(f"[gen1-lc-batch] out of device memory at B={lcb_batch} "
            f"({why}); halving B")
        assert lcb_batch > 1, "[gen1-lc-batch] does not fit at B=1"
        gc.collect()
        torch.cuda.empty_cache()
        lcb_batch //= 2
    glcb_res["batch_halved_from"] = BATCH if lcb_batch != BATCH else None
    log(f"[gen1-lc-batch] {json.dumps(glcb_res)}")
    del glc_ctx
    rows += check_gen1_lcb_kernels(lcb_ctx, REPS, lcb_batch)
    del lcb_ctx
    gc.collect()
    torch.cuda.empty_cache()
    # each row's launches come from the path that runs it
    path_of = {"lane_stats@hist": hist_launches,
               "phase_pressure@features": dqn_launches}
    ring_paths = {"main": main_launches, "lc": lc_launches,
                  "mixed": mixed_launches, "mixed-lc": mlc_launches}
    for r in rows:
        name = r["name"]
        if "launches_of" in r:
            path, plus, minus = r.pop("launches_of")
            r["launches"] = sum(ring_paths[path][k] for k in plus) \
                - sum(ring_paths[path][k] for k in minus)
        elif name.endswith("@lcbatch"):
            base = name[:-len("@lcbatch")]
            r["launches"] = glcb_launches[
                {"lc_plan": "lc_plan@signal",
                 "lc_commit": "lc_commit@tail"}.get(base, base)]
        elif name.endswith("@batch"):
            r["launches"] = gb_launches[name.split("@")[0]]
        elif name == "phase_scores":
            # the pressure mode: the calls in no other mode
            r["launches"] = (env_launches[name]
                             - env_launches["phase_scores@phases"]
                             - env_launches["phase_scores@features"])
        elif name in ("phase_scores@features",
                      "phase_scores@features:gen1-dqn"):
            r["launches"] = gdqn_launches["phase_scores@features"]
        elif name.split("@")[0] in ("lane_counts", "phase_scores"):
            r["launches"] = env_launches[name]
        elif name in TPL_MODES:
            r["launches"] = mixed_launches[name]
        elif name in TPL_LC_MODES:
            r["launches"] = mlc_launches[name]
        elif name in path_of:
            r["launches"] = path_of[name][name]
        elif name in GEN1_FAST_MODES:
            r["launches"] = fast_launches[name]
        elif name in GEN1_LC_F32:
            r["launches"] = lcf_launches[name]
        elif name in GEN1_KERNELS:
            r["launches"] = gen1_launches[name]
        elif name in ("lc_plan", "lc_commit"):
            # G7 / G8: one row per mode, the first mode's under the name
            r["launches"] = glc_launches[
                name + ("@signal" if name == "lc_plan" else "@tail")]
        elif name.split("@")[0] in GEN1_LC_KERNELS:
            r["launches"] = glc_launches[name]
        elif name.split("@")[0] in RL_KERNELS:
            r["launches"] = rl_launches[name]
        elif name in LC_KERNELS or name in LC_MODES:
            r["launches"] = lc_launches[name]
        else:
            r["launches"] = main_launches[name.split("@")[0]]
    log(f"[done] wall_s={time.time() - t_start:.1f}")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
