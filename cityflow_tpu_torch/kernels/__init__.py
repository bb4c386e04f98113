"""Hand-written CUDA kernels of the ring and gen-1 steps (sources in
csrc/), each with its wrapper, its plain PyTorch version and its launch
counter:

  K1 gather_rows     one-hot exchanges as exact gathers
  K2 cross_caps      Cross::canPass over each link's crosses
  K3 car_follow      isr_speed + min_chain, fused
  K4 ring_commit     shift-out + append of both rings, all channels
                     (lane-change mode: the rank-preserving delete)
  L1 lc_signal       lane-change signals, target leader / follower, gaps
  L2 lc_receive      signal arbitration, yield speed, change decision
  L3 lc_insert       shadow winners per lane and the rank-preserving inserts
  L4 lc_partner      real / shadow partner values by uid match
  O1 lane_stats      per-lane waiting counts, the lane-history window, the
                     time in flight (observations)
  O2 phase_pressure  MaxPressure pressures and actions, DQN phase features
  G1 arrange         gen-1 per-drivable order, leaders, lanelink tables
  G2 leader_scan     gen-1 leader scan past the drivable's end
  G3 notify_cross    gen-1 cross notifiers and their canPass terms
  G4 cross_pass      gen-1 cross loop of getAction (canPass, first fail)
  G5 hist_window     gen-1 DURATION lane history (Lane::updateHistory)
  G6 lc_probe        gen-1 lane change: neighbours on the side lanes
  G7 lc_plan         gen-1 lane change: signals, arbitration, gap validity,
                     yieldSpeed (modes signal / receive / decide / yield)
  G8 lc_commit       gen-1 lane change: getAction's offset tail, the
                     commit of finished and aborted changes (modes tail /
                     commit)
  G9 blocker_cycles  gen-1 deadlock test along the blocker chains
  G10 update_location  gen-1 finish statistics and transfer order
  T1 tpl_params      vehicle template index -> template parameters

K2, K3, L1 and L2 have a template mode (non-uniform vehicle templates:
each row's parameters read from its template index and the table inside
the kernel), counted apart as <name>@tpl; K3's calls in both its template
and lane-change modes also as car_follow@tpl+lc. G7's and G8's modes are
counted apart as lc_plan@<mode> and lc_commit@<mode>. The gen-1 kernels
G1-G10 run in float64 (exact mode) or float32 (fast mode); the float32
launches of G1-G8 and G10 are counted apart as <name>@f32, and the fast
branches of G2, G9 and G10 as <name>@fast.

A wrapper runs the kernel on CUDA tensors and the plain version on CPU
tensors; the library is built at first use (kernels/_lib.py).
"""

from cityflow_tpu_torch.kernels import (
    arrange, blocker_cycles, car_follow, cross_caps, cross_pass, gather_rows,
    hist_window, lane_stats, lc_commit, lc_insert, lc_partner, lc_plan,
    lc_probe, lc_receive, lc_signal, leader_scan, notify_cross,
    phase_pressure, ring_commit, tpl_params, update_location)

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
           "update_location": update_location}

# the gen-1 kernels with a float32 mode, and those with a fast branch
F32_KERNELS = ("arrange", "leader_scan", "notify_cross", "cross_pass",
               "hist_window", "lc_probe", "lc_plan", "lc_commit",
               "update_location")
FAST_KERNELS = ("leader_scan", "blocker_cycles", "update_location")


# modes of a kernel counted apart as well (module, counter)
MODES = {"car_follow@lc": (car_follow, "launches_lc"),
         "ring_commit@lc": (ring_commit, "launches_lc"),
         "lane_stats@hist": (lane_stats, "launches_hist"),
         "lane_stats@obs": (lane_stats, "launches_obs"),
         "phase_pressure@features": (phase_pressure, "launches_features"),
         "cross_caps@tpl": (cross_caps, "launches_tpl"),
         "car_follow@tpl": (car_follow, "launches_tpl"),
         "car_follow@tpl+lc": (car_follow, "launches_tpl_lc"),
         "lc_signal@tpl": (lc_signal, "launches_tpl"),
         "lc_receive@tpl": (lc_receive, "launches_tpl"),
         **{f"lc_plan@{m}": (lc_plan, f"launches_{m}") for m in lc_plan.MODES},
         **{f"lc_commit@{m}": (lc_commit, f"launches_{m}")
            for m in lc_commit.MODES},
         **{f"{n}@f32": (MODULES[n], "launches_f32") for n in F32_KERNELS},
         **{f"{n}@fast": (MODULES[n], "launches_fast")
            for n in FAST_KERNELS}}


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
