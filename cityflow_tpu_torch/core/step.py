"""The gen-1 step and the speed-model formulas it shares with the ring.

Formulas (vehicle.cpp), elementwise in the reference's operation order:
a Python float argument takes the dtype of the tensor beside it, as JAX's
weakly typed constants do, so the ring runs them in float32 and the gen-1
step in float64. They are the plain versions of what csrc/common.cuh and
csrc/gen1.cuh compute inside the kernels.

The gen-1 step (JAX package core/step.py): one Engine::nextStep
(engine.cpp:566-594) over the slot pool of `SimState`, phase by phase;
each phase is a Jacobi update, as the reference's double-buffered vehicle
writes make it. Exact mode (cfg.exact) runs in float64 with the
reference's sums in its order; fast mode in float32 with JAX's fast
branches: the leader scan's per-drivable candidate table, the deadlock
walk capped at 2^min(k_chase, 10) steps, the finish sum unordered.
Thirteen regions run as hand-written CUDA kernels on the card
(kernels/), each in both float types: G11 spawn_slots (the spawn), G12
admit_heads (the admission), G1 arrange (the per-drivable order), G2
leader_scan (and its fast branch), G3 notify_cross (the notifier of each
cross side), G4 cross_pass (Cross::canPass over a vehicle's crosses), G5
hist_window (the DURATION router's lane history), G9 blocker_cycles (the
deadlock test), G10 update_location (finish statistics, transfer order),
and for lane change (core/lanechange.py) G6 lc_probe, G7 lc_plan, G8
lc_commit and G15 shadow_insert.

Who owns the state: `step(..., donate=False)` writes none of its inputs,
so a step can be run again from the same state (the Engine's
capacity-growth retry does) and a snapshot may share the state's tensors:
G11 hands the step fresh per-slot leaves, G5 fresh rings, every other
phase returns new tensors, and G15 writes in place only what the step
made. With donate=True the step may write the state it is given, as the
JAX package's donated rollout does: G11 writes the spawned rows into the
state's own leaves and G5 each env's ring row and window sums into its
own rings, so no phase copies the pool or the rings. The batched entries
(parallel/batch.py, rl/env.CityFlowVecEnv, rl/dqn, tools/bench.py) donate
and drop the state they hand over; a caller that steps again from a kept
state passes a copy.

B envs at once: every function of the step takes a batch's state (a
leading env axis, core/state.py); one env is a batch of one, lifted at
the caller's boundary (`lift`, `squeeze`). Per-env sources are gathered
along each env's own axis (`egat`), the net and spawn tables are shared,
and every kernel takes the batch in one launch with the env on its grid,
lane change and the DURATION history included.

Float64 parity with the reference needs each float op rounded on its own
and every sum in the reference's order: no fused ops, no reordered
reductions (the finish-time sum runs as an explicit loop), and no division
by a Python float on the card (PyTorch's CUDA division by a CPU scalar
multiplies by its reciprocal), so the step interval is a 0-dim device
tensor (`net["interval"]`).
"""

import numpy as np
import torch

from cityflow_tpu_torch.core.numerics import jnp_take, xla_f32_to_i32
from cityflow_tpu_torch.core.state import (
    OV_HOPS, OV_LINK_TABLE, SimState, StepConfig)

EPS = 1e-8  # reference utility.h:15

# param columns (compiler/net.py)
P_SPEED, P_LEN, P_WIDTH, P_MAXPOSACC, P_MAXNEGACC, P_USUALPOSACC, \
    P_USUALNEGACC, P_MINGAP, P_MAXSPEED, P_HEADWAY, P_YIELD, P_TURNSPEED = \
    range(12)

def _t(x, like):
    return x if torch.is_tensor(x) else torch.tensor(
        x, dtype=like.dtype, device=like.device)


def _sqrt(x):
    """torch.sqrt, except float64 on the CPU, where PyTorch's vectorized
    sqrt (MKL) misses the correctly rounded result by one ulp on about 1
    in 140 inputs; numpy's is IEEE, like the card's and the reference's."""
    if x.dtype == torch.float64 and x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def no_collision_speed(vL, dL, vF, dF, gap, interval, target_gap):
    """reference vehicle.cpp:200-209."""
    c = vF * interval / 2 + target_gap - 0.5 * vL * vL / dL - gap
    a = 0.5 / _t(dF, c)
    b = 0.5 * _t(interval, c)
    disc = b * b - 4 * a * c
    v1 = 0.5 / a * (_sqrt(torch.clamp_min(disc, 0.0)) - b)
    v2 = 2 * vL - dL * interval + 2 * (gap - target_gap) / interval
    v = torch.minimum(v1, _t(v2, v1))
    return torch.where(b * b < 4 * a * c, -100.0, v)


def brake_distance_after_accel(speed, acc, dec, interval):
    """reference vehicle.cpp:302-306."""
    next_speed = speed + acc * interval
    return ((speed + next_speed) * interval / 2
            + (next_speed * next_speed / dec / 2))


def stop_before_speed(speed, usual_pos, usual_neg, distance, interval):
    """reference vehicle.cpp:240-250 (getStopBeforeSpeed)."""
    bda = brake_distance_after_accel(speed, usual_pos, usual_neg, interval)
    ti = 2 * distance / (speed + EPS) / interval
    # (int)takeInterval: C truncation; x86 cvttsd2si out of range -> INT_MIN
    ti_int = torch.where(torch.abs(ti) >= 2.0**31, -(2.0**31),
                         torch.trunc(ti))
    ge1 = speed - speed / ti_int
    lt1 = speed - speed / ti
    slow = torch.where(ti >= 1, ge1, lt1)
    return torch.where(bda < distance, speed + usual_pos * interval, slow)


def ref_min(a, b):
    """The reference's std::min(a, b), b < a ? b : a: a NaN in b leaves a
    (torch.minimum and the JAX step's jnp.minimum return the NaN). The
    isr_speed mins take the stop-before speed, which is 0 / 0 for a
    stopped vehicle with no distance left (vehicle.cpp getStopBeforeSpeed);
    elsewhere the two agree."""
    return torch.where(b < a, b, a)


def distance_until_speed(speed, target, acc, interval):
    """reference vehicle.cpp:275-282 (stage1speed adds acc/interval, as
    written there)."""
    s1 = torch.floor((target - speed) / acc / interval)
    v1 = speed + s1 * acc / interval
    d1 = (speed + v1) * (s1 * interval) / 2
    d = d1 + torch.where(v1 < target, (v1 + target) * interval / 2, 0.0)
    return torch.where(target <= speed, 0.0, d)


def reach_steps(speed, distance, target, acc, interval):
    """reference vehicle.cpp:252-268 (getReachSteps), returns int32 with
    XLA's saturating cast."""
    r_fast = torch.ceil(distance / torch.where(speed > 0, speed, 1.0))
    dts = distance_until_speed(speed, target, acc, interval)
    r_a = torch.ceil((_sqrt(torch.clamp_min(
        speed * speed + 2 * acc * distance, 0.0)) - speed) / acc / interval)
    r_b = (torch.ceil((target - speed) / acc / interval)
           + torch.ceil((distance - dts) / target / interval))
    r = torch.where(speed > target, r_fast,
                    torch.where(dts > distance, r_a, r_b))
    r = torch.where(distance <= 0, 0.0, r)
    return xla_f32_to_i32(r)


def can_yield(speed, max_neg, yield_dist, length, d):
    """reference vehicle.cpp:284-287."""
    min_brake = 0.5 * speed * speed / max_neg
    return (((d > 0) & (min_brake < d - yield_dist))
            | ((d < 0) & (d + length < 0)))


def leader_scan_bound(max_speed, usual_neg, interval):
    """How far ahead the leader scan looks past the drivable's end
    (reference vehicle.cpp, updateLeaderAndGap / getIntersectionRelatedSpeed:
    the brake distance at max speed plus two intervals of travel)."""
    return max_speed * max_speed / usual_neg / 2 + max_speed * interval * 2


# ---------------------------------------------------------------------------
# gen-1 helpers
# ---------------------------------------------------------------------------

def gat(a, i):
    """Safe gather a[clip(i)] along the first axis (jnp.take of a clipped
    index) of a table every env shares; the caller masks invalid entries
    (i < 0)."""
    n = a.shape[0]
    j = i.clamp(0, max(n - 1, 0))
    if j.dim() == 1:
        return a.index_select(0, j)
    return a.index_select(0, j.reshape(-1)).reshape(
        tuple(j.shape) + tuple(a.shape[1:]))


def egat(a, i):
    """gat along each env's own axis: a (B, N, ...) per env, i (B, ...)
    slot (or lane, drivable) indices local to their env. An index never
    reaches into another env."""
    B, N = a.shape[0], a.shape[1]
    rest = tuple(a.shape[2:])
    n = max(N, 1)
    # each env's first row in the flattened (B * N, ...) table
    base = torch.arange(0, B * n, n, device=i.device).view(
        (B,) + (1,) * (i.dim() - 1))
    j = i.clamp(0, max(N - 1, 0)) + base
    return a.reshape((B * N,) + rest).index_select(0, j.reshape(-1)).reshape(
        tuple(i.shape) + rest)


def _scat_drop(a, tgt, v):
    """a.at[tgt].set(v, mode="drop") along each env's slot axis, with
    tgt == the axis length meaning "drop": a new tensor one row longer
    takes the writes, the spare row is cut. tgt is (n,) for one env or
    (B, n) for B envs (a (B, N, ...)); v broadcasts to tgt's shape plus
    a's trailing dims."""
    nb = tgt.dim() - 1
    shape = tuple(a.shape)
    rest = shape[nb + 1:]
    v = torch.as_tensor(v, dtype=a.dtype, device=a.device)
    v = v.expand(tuple(tgt.shape) + rest)
    if nb:
        B, N = shape[0], shape[1]
        n = max(N, 1)
        base = torch.arange(0, B * n, n, dtype=tgt.dtype,
                            device=tgt.device)[:, None]
        tgt = torch.where(tgt < N, tgt + base, B * N).reshape(-1)
        a = a.reshape((B * N,) + rest)
        v = v.reshape((-1,) + rest)
    ext = torch.cat([a, a[:1]])
    return ext.index_copy_(0, tgt.long(), v.contiguous())[:-1].reshape(shape)


def _first_true(mask, n):
    """jnp.nonzero(mask, size=n, fill_value=-1)[0] along the last axis
    (each env's own) without a host sync: the positions of the first n
    true entries, in order, padded with -1."""
    c = torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32)
    dest = torch.where(mask & (c <= n), c - 1, n).long()
    src = torch.arange(mask.shape[-1], dtype=torch.int32,
                       device=mask.device).expand(mask.shape)
    out = torch.full(tuple(mask.shape[:-1]) + (n + 1,), -1,
                     dtype=torch.int32, device=mask.device)
    return out.scatter_(-1, dest, src)[..., :n].contiguous()


def sort_key(x):
    """The int key of lax.sort's order of a float tensor (int64 / int32):
    the float's bits made monotone, after JAX's canonicalization (-0.0 to
    +0.0 and every NaN to +NaN before its total-order compare), so the
    zeros tie and the NaNs tie after +inf."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
        k = torch.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b)
    else:
        b = x.view(torch.int32)
        k = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return torch.where(torch.isnan(x), torch.iinfo(k.dtype).max, k)


def chain_step(net, L, route, pos, cur):
    """One hop of Router::getNextDrivable (router.cpp:49-76): lane ->
    selected lanelink (host-precomputed table), lanelink -> its end lane
    (pos + 1). L: the number of lanes."""
    rnl = net["route_next_ll"]
    NR, RLEN, MAXLPR = rnl.shape
    is_lane = (cur >= 0) & (cur < L)
    lane_local = gat(net["lane_local"], cur)
    flat = ((route.clamp(0, NR - 1) * RLEN + pos.clamp(0, RLEN - 1))
            * MAXLPR + lane_local.clamp(0, MAXLPR - 1))
    nxt_from_lane = gat(rnl.reshape(-1), flat)
    nxt_from_ll = gat(net["ll_end"], cur - L)  # lane idx == drivable idx
    nxt = torch.where(is_lane, nxt_from_lane,
                      torch.where(cur >= L, nxt_from_ll, -1))
    npos = torch.where(cur >= L, pos + 1, pos)
    return nxt, npos


def on_last_road(net, cfg, route, pos):
    return pos >= gat(net["route_len"], route) - 1


def _tree(fn, x):
    if isinstance(x, SimState):
        return x.map(fn)
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, v) for v in x)
    return fn(x)


def lift(x):
    """One env's values (a SimState with (V,) leaves and 0-dim scalars, or
    a dict, tuple or tensor of them) as a batch of one: an env axis of 1
    in front of every tensor."""
    return _tree(lambda t: t[None] if torch.is_tensor(t) else t, x)


def squeeze(x):
    """Env 0 of a batch of one, the env axis taken off: lift's inverse."""
    return _tree(lambda t: t[0] if torch.is_tensor(t) else t, x)


def _kernel(name):
    """A G kernel's wrapper, looked up at call time (the kernel modules
    import the formulas above, so this module cannot import them first)."""
    from cityflow_tpu_torch import kernels
    return getattr(kernels.MODULES[name], name)


# ---------------------------------------------------------------------------
# arrangement and leader scan (G1, G2)
# ---------------------------------------------------------------------------

def arrangement(net, cfg: StepConfig, running, drv, dis, list_seq):
    """The reference's per-drivable std::list order (distance desc, ties
    by insertion order), with each vehicle's leader, each drivable's first
    and last vehicle and its first position in that order (G1 arrange).
    Keys: leader, first_of, last_of, sorted_idx, drv_off, overflow_link."""
    return _kernel("arrange")(running, drv, dis, list_seq, cfg.num_drivables,
                              cfg.num_lanes, cfg.k_link)


def leader_scan(net, cfg: StepConfig, st: SimState, arr, mask):
    """Vehicle::updateLeaderAndGap's scan over the next drivables for the
    vehicles in `mask` (G2; fast mode: its candidate-table branch).
    Returns (leader slot or -1, gap)."""
    return _kernel("leader_scan")(
        mask, st.drv, st.route, st.route_pos, st.dis, st.params,
        arr["last_of"], net, cfg.num_lanes, cfg.k_scan, fast=not cfg.exact)


# ---------------------------------------------------------------------------
# step phases
# ---------------------------------------------------------------------------

def spawn_vehicles(net, cfg: StepConfig, st: SimState, spawn_tbl,
                   donate=False):
    """Activate this step's host-precomputed spawn rows into free slots
    (reference: Flow::nextStep + Engine::planRoute valid path,
    flow.cpp:6-22, engine.cpp:450-470), G11: per env the first
    max_spawn_per_step free slots in slot order take the rows; in place
    where the state is donated, else into new leaves."""
    return st.replace_fields(**_kernel("spawn_slots")(
        st, spawn_tbl, net["flow_params"], net["interval"],
        cfg.max_spawn_per_step, inplace=donate))


def admit_waiting(net, cfg: StepConfig, st: SimState, arr_prev):
    """Engine::handleWaiting (engine.cpp:502-516): per lane, admit the FIFO
    head of the waiting buffer if Lane::available (roadnet.cpp:428-436);
    G12 finds the heads and admits them, a head with no tail to follow
    scans for its leader."""
    h = _kernel("admit_heads")(
        st.active, st.running, st.drv, st.uid, st.dis, st.params, st.leader,
        st.gap, st.list_seq, arr_prev["last_of"], st.seq_counter,
        cfg.num_lanes)
    st = st.replace_fields(running=h["running"], leader=h["leader"],
                           gap=h["gap"], list_seq=h["list_seq"],
                           seq_counter=st.seq_counter + 1)
    # tail == null -> full scan (engine.cpp:512 -> vehicle.cpp:161-196)
    need_scan = h["need_scan"]
    arr_now = arrangement(net, cfg, st.running, st.drv, st.dis, st.list_seq)
    sl, sg = leader_scan(net, cfg, st, arr_now, need_scan)
    st = st.replace_fields(
        leader=torch.where(need_scan, sl, st.leader),
        # a scan miss keeps the stale gap (vehicle.cpp:162-196)
        gap=torch.where(need_scan & (sl >= 0), sg, st.gap))
    return st, arr_now


def lanelink_available(net, cfg, st):
    """LaneLink::isAvailable (roadnet.h:429-431,472) via the current phase
    mask: (..., LL) bool."""
    inter = net["ll_inter"]
    row = gat(net["phase_offset"], inter) + st.phase.index_select(
        -1, inter.clamp(0, max(st.phase.shape[-1] - 1, 0)))
    mrl = net["phase_rl_avail"].shape[1]
    flat = row * mrl + net["ll_rl_local"]
    return jnp_take(net["phase_rl_avail"].reshape(-1), flat)


def notify_cross(net, cfg: StepConfig, st: SimState, arr, veh_next, ll_avail,
                 cyc):
    """Engine::threadNotifyCross (engine.cpp:317-372): for each (link,
    cross slot) the notifier and its Cross::canPass terms (G3), on the own
    side in link-major (..., LL, KC) layout; the foe side is read through
    net["lnk_cross_foe_pos"] (`foe_view` gives JAX's foe dict). G3 reads
    each lanelink's vehicles through `arr` (G1's sorted_idx and drv_off)
    and their attributes from the state's leaves; `cyc` is G9's
    blocker-cycle flag of the same state."""
    leaves = dict(dis=st.dis, speed=st.speed, params=st.params, cyc=cyc,
                  prev_drv=st.prev_drv, enter_ll_time=st.enter_ll_time,
                  priority=st.priority)
    return _kernel("notify_cross")(
        net, arr, veh_next, ll_avail, leaves, cfg.num_lanes, cfg.k_link)


def foe_view(net, own):
    """The own-side notifier tables permuted to the foe side: the JAX
    package's notify_cross result (foe_exists ... foe_idx); each env's
    tables (..., LL, KC) permuted on their own."""
    pos = net["lnk_cross_foe_pos"].reshape(-1)
    out = {}
    for k, v in own.items():
        lead = tuple(v.shape[:-2])
        out["foe_" + k] = v.reshape(lead + (-1,)).index_select(
            -1, pos).reshape(v.shape)
    return out


def blocker_cycles(cfg: StepConfig, blocker):
    """Deadlock detection along the committed blocker chain (Cross::canPass,
    roadnet.cpp:662-674), G9: the blocker graph is functional, so "a cycle
    is reachable from v" == "the walk from v is still alive after >= V
    steps"; fast mode caps the walk at 2^min(k_chase, 10) steps."""
    return _kernel("blocker_cycles")(blocker, cfg.exact, cfg.k_chase)


def get_action(net, cfg: StepConfig, st: SimState, arr, veh_next, ll_avail,
               own):
    """Engine::vehicleControl + Vehicle::getNextSpeed for all running
    vehicles (engine.cpp:188-251, vehicle.cpp:308-376); the cross loop
    (vehicle.cpp:357-374, Cross::canPass) is G4."""
    f = st.dis.dtype
    dt = net["interval"]
    p = st.params
    L = cfg.num_lanes
    m = st.running
    speed = st.speed
    max_speed = p[..., P_MAXSPEED]
    veh_len = p[..., P_LEN]
    zero = torch.zeros((), dtype=f, device=speed.device)
    one = torch.ones((), dtype=f, device=speed.device)

    # --- car following (vehicle.cpp:212-238) ---
    leader = st.leader
    has_leader = leader >= 0
    lp = egat(p, leader)
    vL = egat(speed, leader)
    v_hard = no_collision_speed(vL, lp[..., P_MAXNEGACC], speed,
                                p[..., P_MAXNEGACC], st.gap, dt, zero)
    assume_decel = torch.where(speed > vL, speed - vL, zero)
    v_soft = no_collision_speed(vL, lp[..., P_USUALNEGACC], speed,
                                p[..., P_USUALNEGACC], st.gap, dt,
                                p[..., P_MINGAP])
    v_headway = ((st.gap + (vL + assume_decel / 2) * dt - speed * dt / 2)
                 / (p[..., P_HEADWAY] + dt / 2))
    v_follow_plain = torch.minimum(torch.minimum(v_hard, v_soft), v_headway)
    v_follow_custom = torch.minimum(st.custom_speed, v_hard)
    v_cf_leader = torch.where(st.has_custom, v_follow_custom, v_follow_plain)
    v_cf_no_leader = torch.where(st.has_custom, st.custom_speed, max_speed)
    v_cf = torch.where(has_leader, v_cf_leader, v_cf_no_leader)

    # --- intersection-related (vehicle.cpp:289-300,337-376) ---
    is_ll = st.drv >= L
    is_lane = ~is_ll & (st.drv >= 0)
    next_is_ll = veh_next >= L
    lane_left = gat(net["drv_len"], st.drv) - st.dis
    approach = (max_speed * max_speed / p[..., P_USUALNEGACC] / 2
                + max_speed * dt * 2)
    isr_related = is_ll | (is_lane & next_is_ll & (lane_left <= approach))

    # red-light / blocked-entry branch
    end_lane = gat(net["ll_end"], veh_next - L)
    tail2 = egat(arr["last_of"], end_lane)
    t2a = egat(torch.stack([st.dis, veh_len, st.speed], dim=-1), tail2)
    can_enter = ((tail2 < 0)
                 | (t2a[..., 0] > t2a[..., 1] + veh_len)
                 | (t2a[..., 2] >= 2))
    next_avail = egat(ll_avail, veh_next - L)
    red = next_is_ll & (~next_avail | ~can_enter)
    min_brake = 0.5 * speed * speed / p[..., P_MAXNEGACC]
    red_stop = red & ~(min_brake > lane_left)
    v_red = ref_min(max_speed, stop_before_speed(
        speed, p[..., P_USUALPOSACC], p[..., P_USUALNEGACC], lane_left, dt))

    # the cross loop over the relevant lanelink's crosses (G4): the turn
    # cap, the first failing cross, its stop speed and the new blocker
    next_turn = gat(net["ll_is_turn"], veh_next - L) & next_is_ll
    the_ll = torch.where(next_is_ll, veh_next - L,
                         torch.where(is_ll, st.drv - L, -1))
    dls = torch.where(is_lane, -lane_left, st.dis)
    blk_ok = m & isr_related & ~red_stop
    v_isr, _any_fail, _ff_d, new_blocker = _kernel("cross_pass")(
        the_ll, dls, speed, p, st.enter_ll_time, st.priority, next_turn,
        blk_ok, own, net)

    # the red branch returns early: skips the turn cap and the cross loop
    # (vehicle.cpp:343-352)
    v_isr_final = torch.where(red_stop, v_red, v_isr)

    # --- the getNextSpeed min-chain (vehicle.cpp:308-335) ---
    v = torch.minimum(max_speed, speed + p[..., P_MAXPOSACC] * dt)
    v = torch.minimum(v, gat(net["drv_max_speed"], st.drv))
    v = torch.minimum(v, v_cf)
    v = torch.where(isr_related, torch.minimum(v, v_isr_final), v)
    if cfg.lane_change:
        # laneChange->yieldSpeed (lanechange.cpp:186-206), G7; 100: no cap
        from cityflow_tpu_torch.core.lanechange import yield_speed
        v = torch.minimum(v, yield_speed(net, cfg, st))
    # (without laneChange no signal is received: yieldSpeed == 100)
    # invalid-lane stop (vehicle.cpp:325-328)
    invalid = (veh_next < 0) & ~on_last_road(net, cfg, st.route, st.route_pos)
    v_inv = no_collision_speed(zero, one, speed, p[..., P_MAXNEGACC],
                               lane_left, dt, p[..., P_MINGAP])
    v = torch.where(invalid, torch.minimum(v, v_inv), v)
    v = torch.maximum(v, speed - p[..., P_MAXNEGACC] * dt)
    if cfg.lane_change:
        # a real and its shadow move in lockstep: the min of both next
        # speeds (engine.cpp:195-205), symmetric, so set on both
        v = torch.where((st.partner >= 0) & m,
                        torch.minimum(v, egat(v, st.partner)), v)

    # --- kinematics (engine.cpp:212-221) ---
    neg = v < 0
    delta_dis = torch.where(neg, 0.5 * speed * speed / p[..., P_MAXNEGACC],
                            (speed + v) * dt / 2)
    new_speed = torch.where(neg, zero, v)

    # --- setDeltaDistance hop walk (vehicle.cpp:49-68) ---
    d = st.dis + delta_dis
    cur = st.drv
    pos = st.route_pos
    end = torch.zeros_like(m)
    for _ in range(cfg.k_hop):
        cur_len = gat(net["drv_len"], cur)
        go = m & (cur >= 0) & (d > cur_len)
        nd, npos = chain_step(net, L, st.route, pos, cur)
        end = end | (go & (nd < 0))
        d = torch.where(go, d - cur_len, d)
        cur = torch.where(go, nd, cur)
        pos = torch.where(go, npos, pos)
    # per env (B,)
    ov_hop = torch.any(m & (cur >= 0) & (d > gat(net["drv_len"], cur)),
                       dim=-1)
    changed = m & (cur != st.drv)
    buf = dict(dis=torch.where(m, d, st.dis),
               speed=torch.where(m, new_speed, st.speed),
               drv=cur, route_pos=pos, changed=changed,
               end=end, blocker=new_blocker)
    if cfg.lane_change:
        # a shadow about to leave its lane aborts (engine.cpp:223-226; an
        # abort wins over a same-step finish); a changing real's lateral
        # offset grows and it finishes at (w_cur + w_tgt) / 2
        # (engine.cpp:228-243); both end this step (G8 tail)
        t = _kernel("lc_commit")("tail", st, cur, buf["speed"], end, net, L)
        buf.update(offset=t["offset"], finish=t["finish"],
                   abort=t["abort"], end=t["end"])
    return buf, ov_hop


def update_location(net, cfg: StepConfig, st: SimState, arr, buf):
    """Engine::threadUpdateLocation + the main-stage push (engine.cpp:282-315,
    477-494), G10: removals (finish stats; exact mode in drivable-list
    order, one add at a time, as the single-thread reference accumulates,
    engine.cpp:296-303) and transfers (pushBuffer sorted by new distance
    desc, engine.cpp:480, with enterLaneLinkTime, :484-491). A finished
    lane change removes the real by an identity swap: not a finished trip
    (engine.cpp:299-303 hasFinished guard)."""
    lc = cfg.lane_change
    out = _kernel("update_location")(
        st.running, buf["end"], buf["changed"], buf["dis"], buf["drv"],
        st.enter_time, st.list_seq, st.enter_ll_time,
        arr["sorted_idx"] if cfg.exact else None,
        st.lc_finished if lc else None, buf["finish"] if lc else None,
        st.step, st.seq_counter, st.finished_cnt, st.cum_travel,
        st.overflow, net["interval"], cfg.max_remove, cfg.num_lanes,
        cfg.exact)
    removed = out.pop("removed")
    return st.replace_fields(**out), removed


def commit(net, cfg: StepConfig, st: SimState, buf, removed):
    """Vehicle::update (vehicle.cpp:107-143) for survivors; removed slots
    are freed (engine.cpp:296-310)."""
    m = st.running & ~removed
    changed = buf["changed"] & m
    st = st.replace_fields(
        dis=torch.where(m, buf["dis"], st.dis),
        speed=torch.where(m, buf["speed"], st.speed),
        prev_drv=torch.where(changed, st.drv, st.prev_drv),
        drv=torch.where(changed, buf["drv"],
                        torch.where(removed, -1, st.drv)),
        route_pos=torch.where(changed, buf["route_pos"], st.route_pos),
        blocker=torch.where(m, buf["blocker"], -1),
        has_custom=torch.zeros_like(st.has_custom),
        active=st.active & ~removed,
        running=m,
    )
    # clear blockers pointing at vehicles removed this step
    # (engine.cpp:419-421)
    bl_removed = egat(removed, st.blocker) & (st.blocker >= 0)
    st = st.replace_fields(blocker=torch.where(bl_removed, -1, st.blocker))
    if cfg.lane_change:
        st = lc_commit(cfg, st, buf, removed)
    return st


def lc_commit(cfg: StepConfig, st: SimState, buf, removed):
    """The lane-change epilogue of Vehicle::update, finishChanging and
    abortChanging (lanechange.cpp:115-148, vehicle.cpp:378-381, 412-416):
    promotion, unlinking, the offset reset and clearSignal (G8 commit)."""
    return st.replace_fields(**_kernel("lc_commit")(
        "commit", st, removed, buf["finish"], buf["offset"]))


def update_leader_and_gap(net, cfg: StepConfig, st: SimState, donate=False):
    """Engine::threadUpdateLeaderAndGap (engine.cpp:429-442), then
    Lane::updateHistory under the DURATION router (on every call, as the
    reference: twice a step with lane change; in place where the state is
    donated)."""
    arr = arrangement(net, cfg, st.running, st.drv, st.dis, st.list_seq)
    in_leader = arr["leader"]
    has_in = in_leader >= 0
    ila = egat(torch.stack([st.dis, st.params[..., P_LEN]], dim=-1),
               in_leader)
    gap_in = ila[..., 0] - ila[..., 1] - st.dis
    need_scan = st.running & ~has_in
    sl, sg = leader_scan(net, cfg, st, arr, need_scan)
    leader = torch.where(st.running, torch.where(has_in, in_leader, sl), -1)
    # a scan that finds no leader leaves the gap as it was
    # (vehicle.cpp:162-196 returns without writing)
    gap = torch.where(st.running,
                      torch.where(has_in, gap_in,
                                  torch.where(sl >= 0, sg, st.gap)), st.gap)
    st = st.replace_fields(leader=leader, gap=gap, last_of_drv=arr["last_of"])
    if cfg.track_history:
        st = update_history(cfg, st, arr, donate)
    return st, arr


def update_history(cfg: StepConfig, st: SimState, arr, donate=False):
    """Lane::updateHistory (roadnet.cpp:900-915): this call's per-lane
    (vehicle count, speed sum) into the ring of history_len + 1 rows and
    the window sums behind RouterType::DURATION road costs
    (roadnet.cpp:719-734), G5; `arr` is this state's arrangement. Each env
    writes its own ring row (its own hist_t): into its own rings and sums
    where the state is donated, else into new ones."""
    n, s, ring_n, ring_s = _kernel("hist_window")(
        arr["last_of"], arr["leader"], st.speed, st.hist_ring_num,
        st.hist_ring_ssum, st.hist_num, st.hist_ssum, st.hist_t,
        inplace=donate)
    return st.replace_fields(hist_num=n, hist_ssum=s, hist_ring_num=ring_n,
                             hist_ring_ssum=ring_s, hist_t=st.hist_t + 1)


def pass_time(net, cfg: StepConfig, st: SimState):
    """TrafficLight::passTime (trafficlight.cpp:29-37), fixed-time mode."""
    n = net["n_phases"]
    has = (n > 0) & ~net["inter_virtual"]
    remain = torch.where(has, st.phase_remain - net["interval"],
                         st.phase_remain)
    phase = st.phase
    for _ in range(cfg.k_phase):
        go = has & (remain <= 0)
        nxt = torch.where(go, (phase + 1) % n.clamp_min(1), phase)
        t = gat(net["phase_time"], net["phase_offset"] + nxt)
        remain = torch.where(go, remain + t, remain)
        phase = nxt
    return st.replace_fields(phase=phase, phase_remain=remain)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def step_part1(net, cfg: StepConfig, st: SimState, spawn_tbl,
               donate=False):
    """Flow::nextStep + planRoute, handleWaiting, and with lane change
    initSegments + planLaneChange + scheduleLaneChange (engine.cpp:571-575)
    followed by a full leader / gap update, since the shadows changed the
    lists (engine.cpp:574). donate: as `step`."""
    st = spawn_vehicles(net, cfg, st, spawn_tbl, donate)
    # handleWaiting reads the end-of-previous-step lane tails
    st, arr = admit_waiting(net, cfg, st, dict(last_of=st.last_of_drv))
    if cfg.lane_change:
        from cityflow_tpu_torch.core.lanechange import plan_lane_change
        st = plan_lane_change(net, cfg, st, arr)
        st, arr = update_leader_and_gap(net, cfg, st, donate=donate)
    return st, arr


def step_part2a(net, cfg: StepConfig, st: SimState, arr):
    """notifyCross: the phase masks, each vehicle's next drivable, the
    blocker cycles (G9) and G3's own-side notifier tables."""
    ll_avail = lanelink_available(net, cfg, st)
    veh_next, _ = chain_step(net, cfg.num_lanes, st.route, st.route_pos,
                             st.drv)
    cyc = blocker_cycles(cfg, st.blocker)
    own = notify_cross(net, cfg, st, arr, veh_next, ll_avail, cyc)
    return ll_avail, veh_next, own


def step_part2b(net, cfg: StepConfig, st: SimState, arr, ll_avail, veh_next,
                own):
    """getAction."""
    return get_action(net, cfg, st, arr, veh_next, ll_avail, own)


def step_part2(net, cfg: StepConfig, st: SimState, arr):
    """notifyCross + getAction."""
    return step_part2b(net, cfg, st, arr, *step_part2a(net, cfg, st, arr))


def step_part3(net, cfg: StepConfig, st: SimState, arr, buf, ov_hop,
               donate=False):
    """updateLocation, updateAction, updateLeaderAndGap, the lights.
    donate: as `step` (part 3 writes only the history rings)."""
    st, removed = update_location(net, cfg, st, arr, buf)
    st = commit(net, cfg, st, buf, removed)
    st, _arr2 = update_leader_and_gap(net, cfg, st, donate=donate)
    if not cfg.rl_traffic_light:
        st = pass_time(net, cfg, st)
    ov = (torch.where(ov_hop, OV_HOPS, 0)
          | torch.where(arr["overflow_link"], OV_LINK_TABLE, 0))
    return st.replace_fields(step=st.step + 1,
                             overflow=st.overflow | ov.to(torch.int32))


def step(net, cfg: StepConfig, st: SimState, spawn_tbl, donate=False):
    """One Engine::nextStep (engine.cpp:566-594) of B envs at once ((B, V)
    leaves, the net and spawn tables shared; one env is B = 1, `lift`):
    each kernel launched once over all envs, through the four parts the
    JAX package splits the step into for very large nets (part 1, 2a,
    2b, 3). donate=False: no tensor of `st` is written (the Engine);
    donate=True: `st` is the caller's no longer, and its leaves and rings
    are written in place (the batched entries); its leaves must then not
    overlap in memory."""
    st, arr = step_part1(net, cfg, st, spawn_tbl, donate)
    buf, ov_hop = step_part2(net, cfg, st, arr)
    return step_part3(net, cfg, st, arr, buf, ov_hop, donate)


step_split = step
