"""Host-side spawn schedule precomputation.

The reference's spawn path is fully deterministic given (seed, step horizon):
flow spawn TIMES depend only on flow intervals (flow.cpp:6-22), and all RNG
draws happen on the main thread in a fixed order (SURVEY.md section 2.4):

  per engine step:
    for each flow (flow order):                       engine.cpp:567-568
      per spawned vehicle:
        priority = rnd()   [rejection vs live pool]   vehicle.cpp:45
        threadIndex = rnd() % threadNum               engine.cpp:606
    planRoute main stage (ROAD order, buffer order):  engine.cpp:453-457
      per valid vehicle: firstLane = rnd() % numCandidates  router.cpp:99

So the whole spawn stream — priorities, first lanes, waiting-buffer order —
can be replayed on the host with a bit-exact mt19937 and shipped to the device
as a static table. Rejection re-draws require knowing the live-priority set;
collisions are 2^-32-probability events, so we assert they never occur
against the set of all draws (a superset of the live pool).

Invalid-route flows spawn their first batch of vehicles (consuming 2 draws
each), which are then discarded in planRoute and the flow disabled
(engine.cpp:458-461) — replicated here; such rows are not emitted.

`SpawnGenerator` is incremental so the RNG stream semantics of
Engine::reset(resetRnd=false) (stream continues) and setRandomSeed (reseed
mid-run; flow timing state is unaffected) are preserved.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

from cityflow_tpu_torch.rng import MT19937
from cityflow_tpu_torch.compiler.net import CompiledNet


@dataclass
class FlowRuntime:
    """Per-flow spawn timing state (Flow fields, flow.h:20-27).
    Evolution is RNG-independent."""
    now_time: np.ndarray
    current_time: np.ndarray
    cnt: np.ndarray
    alive: np.ndarray

    @staticmethod
    def fresh(net: CompiledNet) -> "FlowRuntime":
        flows = net.host.flows
        return FlowRuntime(
            now_time=np.array([f.interval for f in flows], np.float64),
            current_time=np.zeros(len(flows), np.float64),
            cnt=np.zeros(len(flows), np.int64),
            alive=np.ones(len(flows), bool))

    def copy(self):
        return FlowRuntime(self.now_time.copy(), self.current_time.copy(),
                           self.cnt.copy(), self.alive.copy())


class SpawnGenerator:
    """Incrementally generates the spawn-event table (uid = row index)."""

    def __init__(self, net: CompiledNet, seed: int, interval: float):
        self.net = net
        self.interval = interval
        self._base_seed = seed
        self.rng = MT19937(seed)
        self.drawn = set()
        self.priority_collisions = 0
        self.fs = FlowRuntime.fresh(net)
        self.next_step = 0            # first ungenerated step
        self.max_per_step = 1
        flows = net.host.flows
        self._lane_cands = [[l.index for l in f.first_lane_candidates]
                            for f in flows]
        self._first_road = [f.anchors[0].index if f.anchors else -1
                            for f in flows]
        self._routes_of = [f.route_id for f in flows]
        self._starts = [f.start_time for f in flows]
        self._ends = [f.end_time for f in flows]
        self._intervals = [f.interval for f in flows]
        self._cols = {k: [] for k in
                      ("step", "flow", "cnt", "priority", "first_drv", "route")}
        self._arrays = None
        # manually pushed vehicles (Engine::pushVehicle, engine.cpp:693-717):
        # each consumes priority+thread draws at push time and a first-lane
        # draw in the next planRoute, exactly like a flow spawn
        self.manuals = []        # (inject_step, road, flow_idx, route, cands, serial)
        self._set_origin(0)

    def _set_origin(self, step: int):
        """Record the earliest point the stream can be replayed from: the RNG
        state, flow timing state and already-emitted rows at `step`. Rows
        before a mid-run reseed / reset(resetRnd=false) come from a stream
        whose seed basis is gone, so replays (inject_manual, Archive restore)
        start here instead of from scratch."""
        self._origin = dict(
            step=step,
            rng=self.rng.get_state(),
            drawn=set(self.drawn),
            fs=self.fs.copy(),
            cols={k: list(v) for k, v in self._cols.items()},
            manuals=list(self.manuals))

    def _rewind_to_origin(self):
        o = self._origin
        self.rng.set_state(o["rng"])
        self.drawn = set(o["drawn"])
        self.fs = o["fs"].copy()
        self._cols = {k: list(v) for k, v in o["cols"].items()}
        self.next_step = o["step"]
        self._arrays = None

    # -- mt19937 draw helpers -------------------------------------------------
    def _draw_priority(self) -> int:
        # while (engine->checkPriority(priority = engine->rnd()));
        # vehicle.cpp:45. The reference redraws only when the priority
        # collides with a vehicle STILL IN THE POOL (removed vehicles free
        # theirs); the host replay pre-generates spawns and cannot know
        # removal times, so on a collision with an ever-drawn value we keep
        # the draw — the colliding vehicle has almost surely finished
        # (a live collision needs two of ~V active vehicles in 2^32, while
        # ever-drawn collisions appear after ~2^16 spawns). The count is
        # tracked so exact-mode users can detect the residual risk.
        p = self.rng()
        p_signed = p - 2**32 if p >= 2**31 else p
        if p_signed in self.drawn:
            self.priority_collisions += 1
        self.drawn.add(p_signed)
        return p_signed

    # -- generation -----------------------------------------------------------
    def extend(self, up_to_step: int):
        """Generate rows for steps [next_step, up_to_step)."""
        if up_to_step <= self.next_step:
            return
        fs = self.fs
        F = len(self.net.host.flows)
        cols = self._cols
        for step in range(self.next_step, up_to_step):
            staged = []   # (first_road, seq, flow, cnt, priority)
            seq = 0
            # manual pushes made before this step: ctor+thread draws at push
            # time, buffered FIRST in their road's planRoute queue
            n_man = 0
            for (mstep, road, fidx, rid, cands, serial) in self.manuals:
                if mstep != step:
                    continue
                pri = self._draw_priority()
                _thread = self.rng()
                staged.append((road, -1000 + n_man, ("manual", fidx, rid,
                                                     cands, serial), pri))
                n_man += 1
            for i in range(F):
                # Flow::nextStep (flow.cpp:6-22)
                if not fs.alive[i]:
                    continue
                if self._ends[i] != -1 and fs.current_time[i] > self._ends[i]:
                    continue  # reference returns before currentTime update
                if fs.current_time[i] >= self._starts[i]:
                    while fs.now_time[i] >= self._intervals[i]:
                        pri = self._draw_priority()
                        _thread = self.rng()  # engine.cpp:606 (value unused)
                        staged.append((self._first_road[i], seq,
                                       (i, int(fs.cnt[i])), pri))
                        seq += 1
                        fs.cnt[i] += 1
                        fs.now_time[i] -= self._intervals[i]
                    fs.now_time[i] += self.interval
                fs.current_time[i] += self.interval
            # planRoute main stage: ROAD order, then buffer order (engine.cpp:453)
            staged.sort(key=lambda t: (t[0], t[1]))
            emitted = 0
            for _road, _seq, spec, pri in staged:
                if isinstance(spec[0], str):    # manual push
                    _, fidx, rid, cands, serial = spec
                    if rid < 0 or not cands:
                        continue                # discarded; no flow disabling
                    lane = cands[self.rng() % len(cands)]
                    cols["step"].append(step)
                    cols["flow"].append(fidx)
                    cols["cnt"].append(serial)
                    cols["priority"].append(pri)
                    cols["first_drv"].append(lane)
                    cols["route"].append(rid)
                    emitted += 1
                    continue
                i, cnt_i = spec
                if self._routes_of[i] < 0:
                    fs.alive[i] = False   # engine.cpp:458-461, no lane draw
                    continue
                cands = self._lane_cands[i]
                lane = cands[self.rng() % len(cands)]
                cols["step"].append(step)
                cols["flow"].append(i)
                cols["cnt"].append(cnt_i)
                cols["priority"].append(pri)
                cols["first_drv"].append(lane)
                cols["route"].append(self._routes_of[i])
                emitted += 1
            self.max_per_step = max(self.max_per_step, emitted)
        self.next_step = up_to_step
        self._arrays = None

    # -- stream-semantics operations -------------------------------------------
    def reset_flows(self, reseed_to: int = None, current_step: int = 0):
        """Engine::reset: flows reset (flow.cpp reset), rows cleared; the RNG
        stream continues unless reseed_to is given (engine.cpp:744-760).

        The reference RNG at reset time has consumed draws only for steps
        [0, current_step); this generator pre-consumed up to `next_step`
        (the horizon). For the continuing-stream case, replay from the origin
        up to current_step to recover the true stream state."""
        if reseed_to is not None:
            self.rng = MT19937(reseed_to)
            self.drawn = set()
            self._base_seed = reseed_to
        else:
            self._rewind_to_origin()
            self.extend(current_step)     # rng now == reference state at reset
        self.fs = FlowRuntime.fresh(self.net)
        self.next_step = 0
        for c in self._cols.values():
            c.clear()
        self._arrays = None
        self.manuals = []
        self._set_origin(0)

    def reseed(self, seed: int, current_step: int):
        """Engine::setRandomSeed mid-run: future draws come from the new
        stream; flow timing state is unaffected. Rows already consumed
        (step < current_step) are kept; later rows are regenerated."""
        self.rng = MT19937(seed)
        self.drawn = set()
        keep = [k for k, s in enumerate(self._cols["step"]) if s < current_step]
        if len(keep) != len(self._cols["step"]):
            for name in self._cols:
                self._cols[name] = [self._cols[name][k] for k in keep]
        # rebuild rng-independent flow state at current_step
        fs = FlowRuntime.fresh(self.net)
        self.fs = fs
        F = len(self.net.host.flows)
        for step in range(current_step):
            for i in range(F):
                if not fs.alive[i]:
                    continue
                if self._ends[i] != -1 and fs.current_time[i] > self._ends[i]:
                    continue
                if fs.current_time[i] >= self._starts[i]:
                    while fs.now_time[i] >= self._intervals[i]:
                        if self._routes_of[i] < 0:
                            fs.alive[i] = False
                        fs.cnt[i] += 1
                        fs.now_time[i] -= self._intervals[i]
                    fs.now_time[i] += self.interval
                fs.current_time[i] += self.interval
        self.next_step = current_step
        self._arrays = None
        # the pre-reseed draw basis is gone: future replays start here
        self.manuals = [m for m in self.manuals if m[0] < current_step]
        self._set_origin(current_step)

    def inject_manual(self, step: int, road: int, flow_idx: int,
                      route_id: int, cand_lanes, serial: int):
        """Engine::pushVehicle between steps: rows from `step` onward are
        regenerated from the stream origin with the manual vehicle's draws
        interleaved (works after reset(resetRnd=false) and mid-run reseeds —
        the origin tracks the last non-replayable stream boundary)."""
        horizon = self.next_step
        self.manuals.append((step, road, flow_idx, route_id,
                             list(cand_lanes), serial))
        self._rewind_to_origin()
        self.extend(max(horizon, step + 2))

    # -- snapshot / restore (Archive, reference archive.cpp:161-165) -----------
    def snapshot_state(self) -> dict:
        """Everything needed to rebuild this generator in a FRESH engine:
        the replay origin (RNG state, flow timing, rows already emitted
        before the origin) plus the manual-push list and horizon. The
        serialized RNG matches the reference's mt19937 operator<< dump."""
        o = self._origin
        rng_o = MT19937.__new__(MT19937)
        rng_o.set_state(o["rng"])
        return dict(
            origin_step=o["step"],
            origin_rng=rng_o.serialize(),
            origin_drawn=[int(x) for x in o["drawn"]],
            origin_fs=dict(now_time=o["fs"].now_time.copy(),
                           current_time=o["fs"].current_time.copy(),
                           cnt=o["fs"].cnt.copy(),
                           alive=o["fs"].alive.copy()),
            origin_cols={k: list(v) for k, v in o["cols"].items()},
            manuals=[list(m[:4]) + [list(m[4]), m[5]] for m in self.manuals],
            next_step=self.next_step,
            max_per_step=self.max_per_step,
            base_seed=self._base_seed)

    def restore_state(self, snap: dict):
        rng = MT19937.deserialize(snap["origin_rng"])
        # np.array (not asarray): extend() mutates fs in place, and `snap` may
        # be a live Archive's dict that must survive repeated loads
        fs = FlowRuntime(
            now_time=np.array(snap["origin_fs"]["now_time"], np.float64),
            current_time=np.array(snap["origin_fs"]["current_time"], np.float64),
            cnt=np.array(snap["origin_fs"]["cnt"], np.int64),
            alive=np.array(snap["origin_fs"]["alive"], bool))
        self.rng = rng
        self.drawn = set(int(x) for x in snap["origin_drawn"])
        self.fs = fs
        self._cols = {k: list(v) for k, v in snap["origin_cols"].items()}
        self.next_step = int(snap["origin_step"])
        self.manuals = [(int(m[0]), int(m[1]), int(m[2]), int(m[3]),
                         list(m[4]), int(m[5])) for m in snap["manuals"]]
        self._base_seed = snap.get("base_seed", self._base_seed)
        self._arrays = None
        self._set_origin(int(snap["origin_step"]))
        self.max_per_step = int(snap.get("max_per_step", 1))
        self.extend(int(snap["next_step"]))

    # -- table access -----------------------------------------------------------
    def arrays(self):
        if self._arrays is None:
            c = self._cols
            self._arrays = dict(
                step=np.array(c["step"], np.int32),
                flow=np.array(c["flow"], np.int32),
                cnt=np.array(c["cnt"], np.int32),
                priority=np.array(c["priority"], np.int32),
                first_drv=np.array(c["first_drv"], np.int32),
                route=np.array(c["route"], np.int32))
        return self._arrays
