"""Hand-written CUDA kernels of the ring and gen-1 steps (sources in
csrc/), each with its wrapper, its plain PyTorch version and its launch
counter:

  K1 gather_rows     static one-hot exchanges as exact row gathers
  K2 cross_caps      Cross::canPass over each link's crosses, the foe
                     read in place from R1's fields
  K3 car_follow      isr_speed + min_chain, fused
  K4 ring_commit     shift-out + append of both rings, all channels
                     (lane-change mode: the rank-preserving delete)
  L1 lc_signal       lane-change signals, target leader / follower, gaps
  L2 lc_receive      signal arbitration, yield speed, change decision
  L3 lc_insert       shadow winners per lane and the rank-preserving inserts
  L4 lc_partner      real / shadow partner values by uid match (match
                     mode: the search, kept as a match; gather mode: other
                     channels at that match)
  O1 lane_stats      per-lane waiting counts, the lane-history window, the
                     time in flight (observations)
  O2 phase_pressure  MaxPressure pressures and actions, DQN phase features
  G1 arrange         gen-1 per-drivable order, leaders, drivable offsets
  G2 leader_scan     gen-1 leader scan past the drivable's end
  G3 notify_cross    gen-1 cross notifiers and their canPass terms
  G4 cross_pass      gen-1 cross loop of getAction (canPass, first fail)
  G5 hist_window     gen-1 DURATION lane history (Lane::updateHistory;
                     copying form or in place)
  G6 lc_probe        gen-1 lane change: neighbours on the side lanes
  G7 lc_plan         gen-1 lane change: signals, arbitration, gap validity,
                     yieldSpeed (modes signal / receive / decide / yield)
  G8 lc_commit       gen-1 lane change: getAction's offset tail, the
                     commit of finished and aborted changes (modes tail /
                     commit)
  G9 blocker_cycles  gen-1 deadlock test along the blocker chains
  G10 update_location  gen-1 finish statistics and transfer order
  G11 spawn_slots    gen-1 spawn: the due spawn rows into each env's first
                     free slots (copying form: every per-slot leaf
                     written anew; in-place form: the spawned rows only)
  G12 admit_heads    gen-1 handleWaiting: each lane's FIFO head, its
                     admission, its leader and gap behind the rear vehicle
  G13 lane_counts    gen-1 observations: per-lane counts and waiting, per-
                     drivable counts, the in-flight travel-time sum
  G14 phase_scores   gen-1 intersection pressure, MaxPressure phase
                     pressures and choice, the DQN's per-phase features
  G15 shadow_insert  gen-1 lane change: the shadows into each env's first
                     free slots, in place (the pairs' rows of every
                     per-slot leaf)
  T1 tpl_params      vehicle template index -> template parameters
  R1 notify_winners  ring step: each cross's notifier and its canPass
                     terms, the blocker-cycle flag (the foe exchange's
                     input)
  R2 ring_exits      ring step: crossings (the invalid clamp in place),
                     leave prefixes, removals and their sums, the
                     lane-change pair flags (stages pairs / finish), the
                     blocker commit, the lights
  R3 ring_admit      ring step: spawn and admission, in place
  R4 route_rows      ring step: the route rows of the link -> lane
                     transfers
  R5 front_leaders   ring step: the lane fronts' leaders from the link
                     rings' tails (approach mode: K3's approach inputs;
                     lane-change mode: lc_front_ctx)
  R6 gap_refresh     ring step, lane change: the stale-gap refresh of every
                     lane and link slot
  R7 ring_pack       ring step: the channel packs (forward exchange, link
                     entrants, lane candidates, the approach rows' to_link
                     pack) straight from the rings

R1, R3 and R4 count their template / lane-change calls apart as
<name>@tpl / <name>@lc, L4 its gather mode as lc_partner@gather, R2 its
two lane-change stages as ring_exits@pairs
and ring_exits@finish, R5 its lane-change mode as front_leaders@ctx, R6
its template calls as gap_refresh@tpl, R7 its modes as ring_pack@entrant,
ring_pack@candidate and ring_pack@approach (the rest are forward packs).
K3's ring-leader mode (the lane and link rows read their leaders from the
ring in place) counts apart as car_follow@ring, its link-row calls also
as car_follow@ring-link.
K2, K3, L1 and L2 have a template mode (non-uniform vehicle templates:
each row's parameters read from its template index and the table inside
the kernel), counted apart as <name>@tpl; K3's calls in both its template
and lane-change modes also as car_follow@tpl+lc. G7's and G8's modes are
counted apart as lc_plan@<mode> and lc_commit@<mode>. The gen-1 kernels
G1-G12 and G15 run in float64 (exact mode) or float32 (fast mode); the
float32 launches of G1-G8, G10-G12 and G15 are counted apart as
<name>@f32, and the fast branches of G2, G9 and G10 as <name>@fast.
Every G kernel takes B envs' slot pools at once (a leading env axis, the
env on the kernel's grid); one env is a batch of one. G13's calls with the per-drivable
counts count apart as lane_counts@drivables, G14's modes as
phase_scores@phases and phase_scores@features. G11's and G5's in-place
calls (the state donated by the batched entries) count apart as
spawn_slots@inplace and hist_window@inplace.

A wrapper runs the kernel on CUDA tensors and the plain version on CPU
tensors; the library is built at first use (kernels/_lib.py).
"""

from cityflow_tpu_torch.kernels import (
    admit_heads, arrange, blocker_cycles, car_follow, cross_caps, cross_pass,
    gather_rows, hist_window, lane_counts, lane_stats, lc_commit, lc_insert,
    lc_partner, lc_plan, lc_probe, lc_receive, lc_signal, leader_scan,
    front_leaders, gap_refresh, notify_cross, notify_winners,
    phase_pressure, phase_scores, ring_admit, ring_commit, ring_exits,
    ring_pack, route_rows, shadow_insert, spawn_slots, tpl_params,
    update_location)

MODULES = {"gather_rows": gather_rows, "cross_caps": cross_caps,
           "car_follow": car_follow, "ring_commit": ring_commit,
           "lc_signal": lc_signal, "lc_receive": lc_receive,
           "lc_insert": lc_insert, "lc_partner": lc_partner,
           "lane_stats": lane_stats, "phase_pressure": phase_pressure,
           "arrange": arrange, "leader_scan": leader_scan,
           "notify_cross": notify_cross, "cross_pass": cross_pass,
           "tpl_params": tpl_params, "hist_window": hist_window,
           "lc_probe": lc_probe, "lc_plan": lc_plan, "lc_commit": lc_commit,
           "blocker_cycles": blocker_cycles,
           "update_location": update_location, "spawn_slots": spawn_slots,
           "admit_heads": admit_heads, "lane_counts": lane_counts,
           "phase_scores": phase_scores, "shadow_insert": shadow_insert,
           "notify_winners": notify_winners, "ring_exits": ring_exits,
           "ring_admit": ring_admit, "route_rows": route_rows,
           "front_leaders": front_leaders, "gap_refresh": gap_refresh,
           "ring_pack": ring_pack}

# the gen-1 kernels with a float32 mode, and those with a fast branch
F32_KERNELS = ("arrange", "leader_scan", "notify_cross", "cross_pass",
               "hist_window", "lc_probe", "lc_plan", "lc_commit",
               "update_location", "spawn_slots", "admit_heads",
               "shadow_insert")
FAST_KERNELS = ("leader_scan", "blocker_cycles", "update_location")


# modes of a kernel counted apart as well (module, counter)
MODES = {"car_follow@lc": (car_follow, "launches_lc"),
         "ring_commit@lc": (ring_commit, "launches_lc"),
         "lc_partner@gather": (lc_partner, "launches_gather"),
         "lane_stats@hist": (lane_stats, "launches_hist"),
         "lane_stats@obs": (lane_stats, "launches_obs"),
         "phase_pressure@features": (phase_pressure, "launches_features"),
         "cross_caps@tpl": (cross_caps, "launches_tpl"),
         "cross_caps@approach": (cross_caps, "launches_app"),
         "car_follow@tpl": (car_follow, "launches_tpl"),
         "car_follow@tpl+lc": (car_follow, "launches_tpl_lc"),
         "lc_signal@tpl": (lc_signal, "launches_tpl"),
         "lc_receive@tpl": (lc_receive, "launches_tpl"),
         **{f"lc_plan@{m}": (lc_plan, f"launches_{m}") for m in lc_plan.MODES},
         **{f"lc_commit@{m}": (lc_commit, f"launches_{m}")
            for m in lc_commit.MODES},
         **{f"{n}@f32": (MODULES[n], "launches_f32") for n in F32_KERNELS},
         **{f"{n}@fast": (MODULES[n], "launches_fast")
            for n in FAST_KERNELS},
         "lane_counts@drivables": (lane_counts, "launches_drivables"),
         "phase_scores@phases": (phase_scores, "launches_phases"),
         "phase_scores@features": (phase_scores, "launches_features"),
         "spawn_slots@inplace": (spawn_slots, "launches_inplace"),
         "hist_window@inplace": (hist_window, "launches_inplace"),
         "notify_winners@tpl": (notify_winners, "launches_tpl"),
         "ring_exits@pairs": (ring_exits, "launches_pairs"),
         "ring_exits@finish": (ring_exits, "launches_finish"),
         "ring_admit@lc": (ring_admit, "launches_lc"),
         "ring_admit@tpl": (ring_admit, "launches_tpl"),
         "route_rows@lc": (route_rows, "launches_lc"),
         "front_leaders@ctx": (front_leaders, "launches_ctx"),
         "gap_refresh@tpl": (gap_refresh, "launches_tpl"),
         "ring_pack@entrant": (ring_pack, "launches_ent"),
         "ring_pack@candidate": (ring_pack, "launches_cand"),
         "ring_pack@approach": (ring_pack, "launches_app"),
         "car_follow@ring": (car_follow, "launches_ring"),
         "car_follow@ring-link": (car_follow, "launches_ring_link")}


def reset_launches():
    for m in MODULES.values():
        m.launches = 0
    for m, attr in MODES.values():
        setattr(m, attr, 0)


def launch_counts():
    """Launches per kernel since the last reset, and per counted mode
    (included in their kernel's count)."""
    out = {name: m.launches for name, m in MODULES.items()}
    out.update({name: getattr(m, attr) for name, (m, attr) in MODES.items()})
    return out
