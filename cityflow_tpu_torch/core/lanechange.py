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
validity G7 lc_plan (its yield mode is getAction's yieldSpeed); the shadow
insert stays plain PyTorch, with an int-cumsum compaction in place of
nonzero(size=).
"""

import torch

from cityflow_tpu_torch.core.state import OV_SLOTS, SimState, StepConfig
from cityflow_tpu_torch.core.step import _first_true, _kernel, _scat_drop

SHADOW_BIT = 1 << 30      # shadow uid bit and priority offset


def probe_neighbors(net, cfg: StepConfig, st: SimState, arr):
    """The leader and follower on each running lane vehicle's inner and
    outer lane (G6), from the arrangement `arr` of the same state."""
    return _kernel("lc_probe")(st.running, st.drv, st.dis, arr["last_of"],
                               arr["leader"], net, cfg.num_lanes)


def plan_lane_change(net, cfg: StepConfig, st: SimState, arr):
    """planLaneChange + scheduleLaneChange: signals, arbitration, shadow
    inserts. Returns the new state."""
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
    return insert_shadows(cfg, st, st2, do_change, sig["target"])


def insert_shadows(cfg: StepConfig, st: SimState, st2: SimState, do_change,
                   target):
    """LaneChange::insertShadow (lanechange.cpp:71-102) for the first
    max_spawn_per_step changers in slot order, into the first free slots
    in slot order: a copy of the real on its target lane, linked to it
    both ways. A changer without a free slot sets OV_SLOTS."""
    V = st.dis.shape[0]
    MS = cfg.max_spawn_per_step
    changers = _first_true(do_change, MS)
    free = _first_true(~st.active, MS)
    ok = (changers >= 0) & (free >= 0)
    ov = torch.any((changers >= 0) & (free < 0))
    src = torch.where(ok, changers, V)
    dst = torch.where(ok, free, V)
    src_c = src.clamp(0, V - 1)

    def cp(a, val=None):
        return _scat_drop(a, dst, a.index_select(0, src_c) if val is None
                          else val)
    uid_src = st.uid.index_select(0, src_c)
    st2 = st2.replace_fields(
        active=cp(st2.active, True), running=cp(st2.running, True),
        dis=cp(st2.dis), speed=cp(st2.speed),
        drv=cp(st2.drv, target.index_select(0, src_c)),
        prev_drv=cp(st2.prev_drv), route=cp(st2.route),
        route_pos=cp(st2.route_pos), enter_time=cp(st2.enter_time),
        enter_ll_time=cp(st2.enter_ll_time),
        priority=cp(st2.priority, SHADOW_BIT + uid_src),
        # the shadow copies the real's controllerInfo (vehicle.cpp copy
        # constructor), the possibly stale gap that gates makeSignal too
        leader=cp(st2.leader, -1), gap=cp(st2.gap),
        blocker=cp(st2.blocker, -1), custom_speed=cp(st2.custom_speed, 0.0),
        has_custom=cp(st2.has_custom, False),
        list_seq=cp(st2.list_seq, st.seq_counter),
        uid=cp(st2.uid, uid_src | SHADOW_BIT),
        params=_scat_drop(st2.params, dst, st.params.index_select(0, src_c)),
        partner=cp(st2.partner, src), is_shadow=cp(st2.is_shadow, True),
        offset=cp(st2.offset, 0.0), lc_changing=cp(st2.lc_changing, False),
        lc_finished=cp(st2.lc_finished, False),
        lc_last_t=cp(st2.lc_last_t), lc_target=cp(st2.lc_target, -1),
        lc_has_signal=cp(st2.lc_has_signal, False), lc_dir=cp(st2.lc_dir, 0),
        lc_recv=cp(st2.lc_recv, -1), lc_tleader=cp(st2.lc_tleader, -1),
        lc_tfollower=cp(st2.lc_tfollower, -1),
        lc_lgap=cp(st2.lc_lgap, 0.0), lc_fgap=cp(st2.lc_fgap, 0.0),
        lc_last_dir=cp(st2.lc_last_dir, 0),
        seq_counter=st.seq_counter + 1,
        overflow=st2.overflow | torch.where(ov, OV_SLOTS, 0).to(torch.int32))
    # link real -> shadow
    return st2.replace_fields(partner=_scat_drop(st2.partner, src, dst))


def yield_speed(net, cfg: StepConfig, st: SimState):
    """SimpleLaneChange::yieldSpeed of each signal receiver
    (lanechange.cpp:186-206), 100 (no cap) for the others (G7)."""
    return _kernel("lc_plan")("yield", st, net, cfg.num_lanes)
