"""Lane change of the gen-1 step: the reference's signal / shadow protocol
over the slot pool (the JAX package's core/lanechange.py).

Reference: src/vehicle/lanechange.{h,cpp} (SimpleLaneChange) and the
engine phases initSegments / planLaneChange / scheduleLaneChange
(engine.cpp:374-399, 792-820):

  makeSignal     pick the inner or outer lane by estimated gap, a 3 s
                 cooldown, not in the last 30 m of the lane
  send/receive   the target lane's leader and follower receive the signal;
                 a receiver keeps the highest-priority sender and yields
  schedule       a gap-valid changer inserts a shadow vehicle into the
                 target lane; real and shadow then move in lockstep while
                 the real's lateral offset grows; at (w_cur + w_tgt) / 2
                 the shadow takes over the identity (core/step.py)
  abort          a shadow that would leave its lane aborts the change

Same-step changers are arbitrated in slot order and shadow priorities are
2^30 + uid, as in the JAX package (the reference uses std::set pointer
order and mid-step RNG draws, which no other program can reproduce).

The neighbour probe is G6 lc_probe, the signals, arbitration and gap
validity G7 lc_plan (its yield mode is getAction's yieldSpeed), the shadow
insert G15 shadow_insert. Every function takes B envs' states ((B, V)
leaves, core/state.py), the env on each kernel's grid; one env is a batch
of one.
"""

from cityflow_tpu_torch.core.state import SimState, StepConfig
from cityflow_tpu_torch.core.step import _kernel


def probe_neighbors(net, cfg: StepConfig, st: SimState, arr):
    """The leader and follower on each running lane vehicle's inner and
    outer lane (G6), from the arrangement `arr` of the same state."""
    return _kernel("lc_probe")(st.running, st.drv, st.dis, arr["last_of"],
                               arr["leader"], net, cfg.num_lanes)


def plan_lane_change(net, cfg: StepConfig, st: SimState, arr):
    """planLaneChange + scheduleLaneChange: signals, arbitration, shadow
    inserts. Returns the new state. LaneChange::insertShadow
    (lanechange.cpp:71-102) puts each env's first max_spawn_per_step
    changers in slot order into its first free slots in slot order: a
    copy of the real on its target lane, linked to it both ways (G15); a
    changer without a free slot sets OV_SLOTS in its env's overflow."""
    L = cfg.num_lanes
    lc_plan = _kernel("lc_plan")
    nb = probe_neighbors(net, cfg, st, arr)
    sig = lc_plan("signal", st, net, L, nb=nb, last_of=arr["last_of"])
    rcv = lc_plan("receive", st, net, L, sig=sig)
    dec = lc_plan("decide", st, net, L, sig=sig, rcv=rcv)
    do_change = dec["do_change"]

    st2 = st.replace_fields(
        lc_has_signal=sig["has_signal"], lc_target=sig["target"],
        lc_dir=sig["direction"], lc_recv=dec["lc_recv"],
        lc_tleader=sig["tleader"], lc_tfollower=sig["tfollower"],
        lc_lgap=sig["lgap"], lc_fgap=sig["fgap"],
        lc_changing=st.lc_changing | do_change)
    return st2.replace_fields(**_kernel("shadow_insert")(
        st, st2, do_change, sig["target"], cfg.max_spawn_per_step))


def yield_speed(net, cfg: StepConfig, st: SimState):
    """SimpleLaneChange::yieldSpeed of each signal receiver
    (lanechange.cpp:186-206), 100 (no cap) for the others (G7)."""
    return _kernel("lc_plan")("yield", st, net, cfg.num_lanes)
