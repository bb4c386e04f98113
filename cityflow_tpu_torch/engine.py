"""`cityflow_tpu_torch.Engine`: the reference CityFlow Python API.

The JAX package's `cityflow_tpu.Engine`, on a CUDA card (device=None) or,
when asked, on the CPU: scenario compilation, the spawn table, capacity
growth, the getters (string ids, dict marshalling), lane change, the
DURATION router's lane history and reroutes, pushed vehicles, archives
and replay files. Three steps serve it:

- exact=True: the gen-1 step (core/step.py) in float64, the reference
  engine bit for bit (tests/goldens);
- exact=False, backend="gen1": the gen-1 step in float32 with its fast
  branches;
- exact=False, backend="auto" or "ring": the ring step at one env
  (ring_backend.RingShell), where the scenario fits the ring layout
  ("auto" falls back to gen-1 fast mode where it does not).

No state tensor the engine holds is written in place, here, in the shells
or in the steps: the engine calls the gen-1 step with donate=False (G11
spawn_slots and G5 hist_window make fresh leaves and rings, and G15
shadow_insert writes only those), because a snapshot shares the state's
tensors with the engine and the capacity-growth retry runs a step again
from the state it started from. The batched entries donate their state
instead (core/step.py).
"""

import copy
import math
import os
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional

import numpy as np
import torch

from cityflow_tpu_torch.carry import net_tensors
from cityflow_tpu_torch.compiler import flows as flows_mod
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.compiler.spawn import SpawnGenerator
from cityflow_tpu_torch.core import step as step_mod
from cityflow_tpu_torch.core.state import (
    OV_HOPS, OV_LINK_TABLE, OV_REMOVE, OV_SLOTS, SimState, StepConfig,
    init_state, pad_state)
from cityflow_tpu_torch.device import resolve_device
from cityflow_tpu_torch.parallel.batch import spawn_table

GROWTH_RETRIES = 8
FETCHED = ("active", "running", "dis", "speed", "drv", "prev_drv", "route",
           "route_pos", "enter_time", "priority", "leader", "gap",
           "list_seq", "uid", "is_shadow", "partner", "lc_last_dir",
           "offset")


class Archive:
    """In-memory snapshot (reference: src/engine/archive.{h,cpp}). The
    engine never writes a state tensor it holds in place, so a snapshot
    holds the state by reference."""

    def __init__(self, state: SimState, host_aux: dict):
        self.state = state
        self.host_aux = copy.deepcopy(host_aux)

    def dump(self, path: str):
        from cityflow_tpu_torch import serialize
        serialize.dump_archive(self, path)


class Engine:
    def __init__(self, config_file: str, thread_num: int = 1,
                 exact: bool = True, max_vehicles: int = 2048,
                 spawn_horizon: int = 4096, backend: str = "auto",
                 device=None):
        """device: None means the CUDA card (a RuntimeError without one);
        "cpu" runs every kernel's plain PyTorch version. backend: "auto"
        takes the ring when exact=False and the scenario fits its layout
        (grid nets), "gen1" the slot-pool step, "ring" the ring or a
        ValueError."""
        del thread_num  # results are threadNum-independent
        if backend not in ("auto", "gen1", "ring"):
            raise ValueError(f"unknown backend {backend!r}")
        if exact and backend == "ring":
            raise ValueError("backend='ring' requires exact=False")
        self.device = resolve_device(device)
        self._dtype = torch.float64 if exact else torch.float32
        self.net = compile_scenario(config_file)
        cfgj = self.net.host.config
        self.interval = float(cfgj["interval"])
        self.seed = int(cfgj["seed"])
        self.rl_traffic_light = bool(cfgj["rlTrafficLight"])
        self.lane_change = bool(cfgj.get("laneChange", False))
        self.save_replay_in_config = bool(cfgj.get("saveReplay", False))
        self.save_replay = self.save_replay_in_config
        # an extension key (the reference hardcodes RouterType::LENGTH,
        # router.h:42): "routerType": "LENGTH" | "DURATION"
        self.router_type = str(cfgj.get("routerType", "LENGTH")).upper()
        if self.router_type not in ("LENGTH", "DURATION"):
            raise ValueError(f"unknown routerType {self.router_type}")

        self._net_dev = net_tensors(self.net, self._dtype, self.device)
        self._spawn_horizon = spawn_horizon
        self._spawn = SpawnGenerator(self.net, self.seed, self.interval)
        self._spawn.extend(spawn_horizon)
        self._upload_spawn()

        self.cfg = StepConfig(
            interval=self.interval,
            num_lanes=self.net.num_lanes,
            num_drivables=self.net.num_lanes + self.net.num_links,
            max_vehicles=max_vehicles,
            max_spawn_per_step=self._spawn.max_per_step,
            k_out=max(self.net.host.ko, 1), k_cross=max(self.net.host.kc, 1),
            rl_traffic_light=self.rl_traffic_light,
            lane_change=self.lane_change, exact=bool(exact),
            track_history=self.router_type == "DURATION")
        self.growths = 0
        self._pushed_ids: Dict[int, str] = {}
        self._manually_pushed = 0
        self._route_ids = None
        self._ring = None
        if not exact and backend in ("auto", "ring"):
            from cityflow_tpu_torch.ring_backend import RingShell
            try:
                self._ring = RingShell(self)
            except ValueError:
                if backend == "ring":
                    raise
        self.state = None
        self._fetched_step = -1
        if self._ring is None:
            self._set_state(self._fresh_state())
        self._replay = None
        if self.save_replay:
            self._open_replay(cfgj.get("roadnetLogFile"),
                              cfgj.get("replayLogFile"))

    # ------------------------------------------------------------------
    # infrastructure
    # ------------------------------------------------------------------
    def _fresh_state(self) -> SimState:
        return init_state(self.cfg, self.net.num_inters, self.net.phase_time,
                          self.net.n_phases, self.net.phase_offset,
                          self.device)

    def _set_state(self, st: SimState):
        """Install a state and read its step and overflow once: the host
        keeps both, so stepping reads back one value per step."""
        self.state = st
        self._step, self._ov = int(st.step), int(st.overflow)
        self._fetched_step = -1

    def _upload_spawn(self):
        self._spawn_dev = spawn_table(self._spawn, self.device)

    def _grow(self, bits: int):
        cfg = self.cfg
        if bits & OV_SLOTS:
            cfg = dc_replace(cfg, max_vehicles=cfg.max_vehicles * 2)
        if bits & OV_LINK_TABLE:
            cfg = dc_replace(cfg, k_link=cfg.k_link * 2)
        if bits & OV_HOPS:
            cfg = dc_replace(cfg, k_hop=cfg.k_hop * 2)
        if bits & OV_REMOVE:
            cfg = dc_replace(cfg, max_remove=cfg.max_remove * 2)
        self.cfg = cfg
        self.growths += 1

    def _now_step(self) -> int:
        if self._ring is not None:
            return self._ring.now_step()
        return self._step

    def _step_once(self):
        if self._ring is not None:
            self._ring.step_once()
            return
        if self._step + 1 >= self._spawn.next_step:
            self._spawn.extend(self._spawn.next_step * 2)
            self._upload_spawn()
            if self._spawn.max_per_step > self.cfg.max_spawn_per_step:
                self.cfg = dc_replace(
                    self.cfg, max_spawn_per_step=self._spawn.max_per_step)
        prev = self.state
        for _ in range(GROWTH_RETRIES):
            # the step takes a batch: this env is a batch of one
            new = step_mod.squeeze(step_mod.step(
                self._net_dev, self.cfg, step_mod.lift(prev),
                self._spawn_dev, donate=False))
            ov_all = int(new.overflow)
            ov = ov_all & ~self._ov
            if ov == 0:
                self.state = new
                self._step += 1
                self._ov = ov_all
                return
            self._grow(ov)
            prev = pad_state(prev, self.cfg.max_vehicles)
        raise RuntimeError("simulation capacity growth failed")

    def _fetch(self) -> Dict[str, np.ndarray]:
        """The per-slot fields the getters read, as numpy arrays (one
        device-to-host copy per step at most; on the ring, its host view
        with one row per vehicle, ring_sim.fetch_full)."""
        key = (self._now_step(), self._manually_pushed)
        if self._ring is not None:
            if self._fetched_step != key:
                self._cache = self._ring.fetch()
                self._fetched_step = key
                self._id_map = None
            return self._cache
        if self._fetched_step != key:
            st = self.state
            self._cache = {n: getattr(st, n).cpu().numpy() for n in FETCHED}
            params = st.params.cpu().numpy()
            self._cache["len"] = params[:, 1]
            self._cache["width"] = params[:, 2]
            self._fetched_step = key
            self._id_map = None       # lazy per-fetch id -> slot index
        return self._cache

    def _veh_id(self, uid: int) -> str:
        if uid & (1 << 30):  # shadow twin (engine.cpp:814: id + "_shadow")
            return self._veh_id(uid & ~(1 << 30)) + "_shadow"
        if uid in self._pushed_ids:
            return self._pushed_ids[uid]
        t = self._spawn.arrays()
        return f"flow_{t['flow'][uid]}_{t['cnt'][uid]}"

    def _id_to_slot(self, vid: str) -> Optional[int]:
        """O(1) id lookup through a per-fetch id -> slot map (the
        reference keeps a std::map of the pool, engine.cpp:615-630)."""
        c = self._fetch()
        if self._id_map is None:
            self._id_map = {
                self._veh_id(int(c["uid"][slot])): int(slot)
                for slot in np.nonzero(c["active"])[0]}
        return self._id_map.get(vid)

    def _lane_order(self, c):
        """Front-to-back per-drivable vehicle order (distance desc,
        list_seq)."""
        run = np.nonzero(c["running"])[0]
        return run[np.lexsort((c["list_seq"][run], -c["dis"][run],
                               c["drv"][run]))]

    def _pool_order(self, c):
        slots = np.nonzero(c["running"] & ~c["is_shadow"])[0]
        return slots[np.argsort(c["priority"][slots], kind="stable")]

    # ------------------------------------------------------------------
    # control API (reference cityflow.cpp:12-46)
    # ------------------------------------------------------------------
    def next_step(self):
        self._step_once()
        if self.save_replay and self._replay is not None:
            self._write_replay_line()

    def reset(self, seed: bool = False):
        """reference Engine::reset (engine.cpp:744-760): flows and state
        reset; the mt19937 stream continues unless resetRnd."""
        cur = self._now_step()
        self._pushed_ids.clear()
        self._manually_pushed = 0
        self._spawn.reset_flows(reseed_to=self.seed if seed else None,
                                current_step=cur)
        self._spawn.extend(self._spawn_horizon)
        self._upload_spawn()
        if self._ring is not None:
            self._ring.reset()
            self._fetched_step = -1
        else:
            self._set_state(self._fresh_state())

    def set_random_seed(self, seed: int):
        """reference Engine::setRandomSeed: reseeds the stream mid-run."""
        self.seed = int(seed)
        cur = self._now_step()
        self._spawn.reseed(seed, cur)
        self._spawn.extend(max(self._spawn_horizon, cur * 2))
        self._upload_spawn()
        if self._ring is not None:
            self._ring.on_spawn_changed()
            self._fetched_step = -1

    def set_tl_phase(self, intersection_id: str, phase_id: int):
        """reference engine.cpp:719-725 (guarded by rlTrafficLight)."""
        if not self.rl_traffic_light:
            print("please set rlTrafficLight to true to enable traffic "
                  "light control")
            return
        idx = self.net.host.inter_index[intersection_id]
        if self._ring is not None:
            self._ring.set_tl_phase(idx, int(phase_id))
            return
        phase = self.state.phase.clone()
        phase[idx] = int(phase_id)
        self.state = self.state.replace_fields(phase=phase)

    def set_vehicle_speed(self, vid: str, speed: float):
        slot = self._id_to_slot(vid)
        if slot is None:
            raise RuntimeError(f"Vehicle '{vid}' not found")
        if self._ring is not None:
            c = self._fetch()
            self._ring.set_custom_speed(
                {k: c[k][slot] for k in ("kind", "pos", "slot")}, speed)
            self._fetched_step = -1
            return
        st = self.state
        custom = st.custom_speed.clone()
        custom[slot] = float(speed)
        has = st.has_custom.clone()
        has[slot] = True
        self.state = st.replace_fields(custom_speed=custom, has_custom=has)

    def _register_route(self, route) -> int:
        """Write a new road route into the route tables (they have
        headroom) and upload them; returns its id."""
        host = self.net.host
        key = tuple(r.index for r in route)
        if self._route_ids is None:
            self._route_ids = {tuple(r.index for r in rt): i
                               for i, rt in enumerate(host.routes)}
        if key in self._route_ids:
            return self._route_ids[key]
        rid = len(host.routes)
        net = self.net
        if rid >= net.route_len.shape[0] or \
                len(route) > net.route_roads.shape[1]:
            raise RuntimeError("route table headroom exhausted; recreate the "
                               "Engine with a larger scenario compile")
        net.route_len[rid] = len(route)
        L = net.num_lanes
        for k, road in enumerate(route):
            net.route_roads[rid, k] = road.index
            net.route_next_ll[rid, k, :] = -1
            for lane in road.lanes:
                nxt = flows_mod.next_lanelink_for(route, k, lane)
                if nxt is not None:
                    net.route_next_ll[rid, k, lane.lane_index] = L + nxt.index
        host.routes.append(route)
        self._route_ids[key] = rid
        for k in ("route_len", "route_roads", "route_next_ll"):
            self._net_dev[k] = torch.as_tensor(
                getattr(net, k), dtype=torch.int32, device=self.device)
        return rid

    def _lane_history_np(self):
        """(window vehicle count, window speed sum) per lane, from the
        backend that holds the window (on the ring: its h_* channels in
        ring lane order, read through meta.lane_pos)."""
        if self._ring is not None:
            st = self._ring.sim.state
            lp = self._ring.sim.meta.lane_pos
            return st.h_num.cpu().numpy()[lp], st.h_ssum.cpu().numpy()[lp]
        st = self.state
        return st.hist_num.cpu().numpy(), st.hist_ssum.cpu().numpy()

    def _road_durations(self) -> Dict[int, float]:
        """Road::getAverageDuration per road from the lane history
        (roadnet.cpp:719-734): the average speed weighted by the lanes'
        window counts; -1 where the window is empty."""
        out: Dict[int, float] = {}
        if not self.cfg.track_history:
            return out
        num, ssum = self._lane_history_np()
        for road in self.net.host.net.roads:
            n = 0.0
            s = 0.0
            for lane in road.lanes:
                n += float(num[lane.index])
                s += float(ssum[lane.index])
            if n <= 0:
                out[road.index] = -1.0     # getAverageSpeed -1: no history
            else:
                # an all-stopped window gives inf, the reference's double
                # division
                avg_speed = s / n
                out[road.index] = (
                    math.inf if avg_speed == 0
                    else flows_mod.road_average_length(road) / avg_speed)
        return out

    def _router_cost(self, max_speed: float):
        if self.router_type == "DURATION":
            return flows_mod.duration_cost_fn(self._road_durations(),
                                              max_speed)
        return flows_mod.length_cost

    def get_lane_history(self) -> Dict[str, tuple]:
        """Per lane (historyVehicleNum, historyAverageSpeed): the window
        behind DURATION routing (Lane::getHistoryVehicleNum /
        getHistoryAverageSpeed, roadnet.cpp:917-923)."""
        if not self.cfg.track_history:
            raise RuntimeError('lane history requires routerType "DURATION"')
        num, ssum = self._lane_history_np()
        ids = self.net.host.lane_ids
        return {ids[i]: (int(num[i]),
                         float(ssum[i] / num[i]) if num[i] else 0.0)
                for i in range(len(ids))}

    def set_vehicle_route(self, vid: str, anchors: List[str]) -> bool:
        """reference Engine::setRoute -> Router::setRoute
        (engine.cpp:852-866, router.cpp:245-264)."""
        host = self.net.host
        slot = self._id_to_slot(vid)
        if slot is None:
            return False
        drv = int(self._fetch()["drv"][slot])
        if drv < 0 or drv >= self.cfg.num_lanes:
            return False  # on a lanelink (router.cpp:246)
        try:
            anchor_roads = [host.net.road_map[a] for a in anchors]
        except KeyError:
            return False
        cur_road = host.net.lanes[drv].road
        if self._ring is not None:
            max_spd = float(self._ring.sim.meta.param_row[8])
        else:
            max_spd = float(self.state.params[slot, 8])
        route = flows_mod.update_shortest_path(
            host.net, [cur_road] + anchor_roads,
            cost=self._router_cost(max_spd))
        if route is None:
            return False
        rid = self._register_route(route)
        # onValidLane under the new route (router.cpp:254-257)
        if len(route) > 1 and self.net.route_next_ll[
                rid, 0, host.net.lanes[drv].lane_index] < 0:
            return False
        if self._ring is not None:
            c = self._fetch()
            ok = self._ring.set_route(
                {k: c[k][slot] for k in ("kind", "pos", "slot", "drv")}, rid)
            if ok:
                self._fetched_step = -1
            return ok
        st = self.state
        route_t, pos_t = st.route.clone(), st.route_pos.clone()
        route_t[slot] = rid
        pos_t[slot] = 0
        self.state = st.replace_fields(route=route_t, route_pos=pos_t)
        self._fetched_step = -1
        return True

    def push_vehicle(self, info: dict, roads: List[str]):
        """reference Engine::pushVehicle(info, roads) (engine.cpp:693-717):
        a vehicle with custom parameters and an anchor-road route, queued
        for the next step's planRoute; the RNG draws replay exactly."""
        host = self.net.host
        tpl = flows_mod.VehicleTemplate(
            speed=float(info.get("speed", 0.0)),
            len=float(info.get("length", 5.0)),
            width=float(info.get("width", 2.0)),
            maxPosAcc=float(info.get("maxPosAcc", 4.5)),
            maxNegAcc=float(info.get("maxNegAcc", 4.5)),
            usualPosAcc=float(info.get("usualPosAcc", 2.5)),
            usualNegAcc=float(info.get("usualNegAcc", 2.5)),
            minGap=float(info.get("minGap", 2.0)),
            maxSpeed=float(info.get("maxSpeed", 16.66667)),
            headwayTime=float(info.get("headwayTime", 1.0)))
        if self._ring is not None and \
                not self._ring.check_uniform_template(tpl.as_list()):
            raise ValueError(
                "the ring backend holds the scenario's vehicle templates "
                "only; push_vehicle with other parameters needs "
                "Engine(..., backend='gen1') (or exact=True)")
        anchor_roads = [host.net.road_map[r] for r in roads]
        route = flows_mod.update_shortest_path(
            host.net, anchor_roads, cost=self._router_cost(tpl.maxSpeed))
        rid = self._register_route(route) if route is not None else -1
        # a flow row of its own for the custom parameters
        net = self.net
        fid = len(host.flows) + len(self._pushed_ids)
        if fid >= net.flow_params.shape[0]:
            raise RuntimeError("flow table headroom exhausted")
        net.flow_params[fid] = tpl.as_list()
        self._net_dev["flow_params"] = torch.as_tensor(
            net.flow_params, device=self.device).to(self._dtype)
        serial = self._manually_pushed
        self._manually_pushed += 1
        cands = (flows_mod.first_lane_candidates(route)
                 if route is not None else [])
        self._spawn.inject_manual(self._now_step(), anchor_roads[0].index,
                                  fid, rid, [l.index for l in cands], serial)
        self._upload_spawn()
        if self._ring is not None:
            if rid >= 0:
                self._ring.refresh_route_tables(rid)
            self._ring.on_spawn_changed()
            self._fetched_step = -1
        if self._spawn.max_per_step > self.cfg.max_spawn_per_step:
            self.cfg = dc_replace(
                self.cfg, max_spawn_per_step=self._spawn.max_per_step)
        # name the row's uid
        t = self._spawn.arrays()
        hits = np.nonzero((t["flow"] == fid) & (t["cnt"] == serial))[0]
        if hits.size:
            self._pushed_ids[int(hits[0])] = f"manually_pushed_{serial}"

    # ------------------------------------------------------------------
    # query API
    # ------------------------------------------------------------------
    def get_current_time(self) -> float:
        return self._now_step() * self.interval

    def get_vehicle_count(self) -> int:
        return int(np.sum(self._fetch()["running"]))

    def get_vehicles(self, include_waiting: bool = False) -> List[str]:
        """Pool order = std::map<int priority> ascending
        (engine.cpp:780-790)."""
        c = self._fetch()
        mask = (c["active"] if include_waiting else c["running"]) \
            & ~c["is_shadow"]
        slots = np.nonzero(mask)[0]
        slots = slots[np.argsort(c["priority"][slots], kind="stable")]
        return [self._veh_id(int(c["uid"][s])) for s in slots]

    def get_lane_vehicle_count(self) -> Dict[str, int]:
        c = self._fetch()
        counts = np.bincount(c["drv"][c["running"]],
                             minlength=self.cfg.num_drivables)
        return {lid: int(counts[i])
                for i, lid in enumerate(self.net.host.lane_ids)}

    def get_lane_waiting_vehicle_count(self) -> Dict[str, int]:
        """speed < 0.1 -> waiting (engine.cpp:641)."""
        c = self._fetch()
        m = c["running"] & (c["speed"] < 0.1)
        counts = np.bincount(c["drv"][m], minlength=self.cfg.num_drivables)
        return {lid: int(counts[i])
                for i, lid in enumerate(self.net.host.lane_ids)}

    def get_lane_vehicles(self) -> Dict[str, List[str]]:
        c = self._fetch()
        ids = self.net.host.lane_ids
        ret = {lid: [] for lid in ids}
        L = self.cfg.num_lanes
        for slot in self._lane_order(c):
            d = c["drv"][slot]
            if d < L:
                ret[ids[d]].append(self._veh_id(int(c["uid"][slot])))
        return ret

    def get_vehicle_speed(self) -> Dict[str, float]:
        c = self._fetch()
        return {self._veh_id(int(c["uid"][s])): float(c["speed"][s])
                for s in self._pool_order(c)}

    def get_vehicle_distance(self) -> Dict[str, float]:
        c = self._fetch()
        return {self._veh_id(int(c["uid"][s])): float(c["dis"][s])
                for s in self._pool_order(c)}

    def get_leader(self, vid: str) -> str:
        c = self._fetch()
        slot = self._id_to_slot(vid)
        if slot is None:
            raise RuntimeError(f"Vehicle '{vid}' not found")
        # a shadow's leader query answers through its real twin
        # (engine.cpp:842-845)
        if self.lane_change and c["is_shadow"][slot] and \
                c["partner"][slot] >= 0:
            slot = int(c["partner"][slot])
        lead = c["leader"][slot]
        return self._veh_id(int(c["uid"][lead])) if lead >= 0 else ""

    def get_average_travel_time(self) -> float:
        """reference engine.cpp:682-691: finished cumulative + in-flight,
        summed over the pool in priority order (float64 order kept)."""
        c = self._fetch()
        if self._ring is not None:
            tt, n = self._ring.stats()
        else:
            tt = float(self.state.cum_travel)
            n = int(self.state.finished_cnt)
        now = self.get_current_time()
        slots = np.nonzero(c["active"])[0]
        slots = slots[np.argsort(c["priority"][slots], kind="stable")]
        for s in slots:
            tt += now - float(c["enter_time"][s])
            n += 1
        return 0.0 if n == 0 else tt / n

    def get_vehicle_info(self, vid: str) -> Dict[str, str]:
        """reference vehicle.cpp:435-457 (std::to_string -> '%f' 6dp)."""
        c = self._fetch()
        slot = self._id_to_slot(vid)
        if slot is None:
            raise RuntimeError(f"Vehicle '{vid}' not found")
        running = bool(c["running"][slot])
        info = {"running": str(int(running))}
        if not running:
            return info
        host = self.net.host
        L = self.cfg.num_lanes
        d = int(c["drv"][slot])
        info["distance"] = f"{float(c['dis'][slot]):.6f}"
        info["speed"] = f"{float(c['speed'][slot]):.6f}"
        info["drivable"] = host.lane_ids[d] if d < L else host.ll_ids[d - L]
        if d < L:
            road = host.net.lanes[d].road
            info["road"] = road.id
            info["intersection"] = road.end_intersection.id
        route = host.routes[int(c["route"][slot])]
        pos = int(c["route_pos"][slot])
        info["route"] = "".join(r.id + " " for r in route[pos:])
        return info

    # ------------------------------------------------------------------
    # replay / archive
    # ------------------------------------------------------------------
    def set_save_replay(self, open_: bool):
        if not self.save_replay_in_config:
            print("saveReplay is not set to true in config file!")
            return
        self.save_replay = open_

    def set_replay_file(self, path: str):
        if not self.save_replay_in_config:
            print("saveReplay is not set to true in config file!")
            return
        self._open_replay(None, path)

    def _phases_np(self) -> np.ndarray:
        """The current phase per intersection, in the original order
        (replay lines)."""
        if self._ring is not None:
            return self._ring.phases_np()
        return self.state.phase.cpu().numpy()

    def _open_replay(self, roadnet_log, replay_log):
        from cityflow_tpu_torch import replay
        base = self.net.host.dir
        if roadnet_log:
            replay.write_roadnet_log(self.net, os.path.join(base, roadnet_log))
        if self._replay is not None:
            self._replay.close()
        self._replay = open(os.path.join(base, replay_log), "w")

    def _write_replay_line(self):
        from cityflow_tpu_torch import replay
        self._replay.write(replay.step_line(self, self._fetch()) + "\n")
        self._replay.flush()

    def snapshot(self) -> Archive:
        """reference Archive(engine) (archive.cpp:9-37): the device state
        and the spawn / RNG stream state (on the ring also its step count
        and the overflow bits it has accepted)."""
        aux = dict(pushed=self._pushed_ids,
                   manually_pushed=self._manually_pushed,
                   spawn=self._spawn.snapshot_state())
        if self._ring is not None:
            aux["ring_step"] = self._ring.step_count
            aux["ring_ov"] = self._ring._known_ov
            return Archive(self._ring.sim.state, aux)
        return Archive(self.state, aux)

    def load(self, archive: Archive):
        if self._ring is not None:
            aux = archive.host_aux
            self._ring.load(archive.state,
                            aux.get("ring_step", int(archive.state.step)),
                            aux.get("ring_ov", 0))
            self._pushed_ids = copy.deepcopy(aux["pushed"])
            self._manually_pushed = aux["manually_pushed"]
            if "spawn" in aux:
                self._spawn.restore_state(aux["spawn"])
                self._spawn.extend(max(self._spawn.next_step,
                                       self._ring.step_count + 2))
                self._upload_spawn()
                self._ring.on_spawn_changed()
            self._fetched_step = -1
            return
        st = archive.state
        if st.active.shape[0] != self.cfg.max_vehicles:
            # the archive may come from an engine whose pool had grown
            self.cfg = dc_replace(self.cfg,
                                  max_vehicles=st.active.shape[0])
        self._set_state(st.map(lambda t: t.to(self.device)))
        self._pushed_ids = copy.deepcopy(archive.host_aux["pushed"])
        self._manually_pushed = archive.host_aux["manually_pushed"]
        if "spawn" in archive.host_aux:
            self._spawn.restore_state(archive.host_aux["spawn"])
            self._spawn.extend(max(self._spawn.next_step, self._step + 2))
            self._upload_spawn()
            if self._spawn.max_per_step > self.cfg.max_spawn_per_step:
                self.cfg = dc_replace(
                    self.cfg, max_spawn_per_step=self._spawn.max_per_step)

    def load_from_file(self, path: str):
        from cityflow_tpu_torch import serialize
        serialize.load_archive_into(self, path)
