"""The ring (gen-2) backend of the reference-API `Engine`.

`Engine(config, exact=False)` takes this shell when the compiled scenario
fits the ring layout (grid-like nets, compiler/ring_net.py
`RingMeta.supported`; non-uniform vehicle templates ride the per-slot
template channel). The getters read `ring_sim.fetch_full`, the host view
in the gen-1 cache's shape; the step is `ring_sim.step` (core/ring.py
ring_step) on one env. The JAX package's ring_backend.RingShell.

What differs from the gen-1 backend (the JAX package's documented
divergences, kept):
  * float32 only (exact mode stays on the gen-1 path);
  * `push_vehicle` takes a template the ring already holds (the uniform
    row, or a row of the tpl_params table); a new one needs
    backend="gen1" (`check_uniform_template`);
  * `get_leader` answers across the drivable boundary through the
    reference's forward walk (vehicle.cpp:157-196), rebuilt at fetch;
  * `set_vehicle_speed` holds for the next `next_step` only, the
    reference's buffered one-shot (vehicle.cpp:120-121).

Every mutation writes a new tensor (clone, then the index write), so an
`Engine.snapshot()` keeps the state it was taken of.
"""

import dataclasses
from typing import Dict

import numpy as np
import torch

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.core.ring import init_ring_state
from cityflow_tpu_torch.core.state import OV_SLOTS

GROWTH_RETRIES = 8
GROW_SL, GROW_SK = 8, 4      # slots a ring growth adds (lane, link)


def _set(t, index, value):
    """A copy of t with t[index] = value."""
    t = t.clone()
    t[index] = value
    return t


class RingShell:
    def __init__(self, engine, horizon: int = 1024):
        self.engine = engine
        self.horizon = max(horizon, 256)
        self.sim = ring_sim.build_sim(engine.net, horizon=self.horizon,
                                      device=engine.device)
        if engine.rl_traffic_light:
            self.sim.cfg = dataclasses.replace(self.sim.cfg,
                                               rl_traffic_light=True)
        # the Engine's spawn generator owns the RNG stream (reseeds,
        # pushes): the queues come from it, so both backends replay the
        # same spawn rows
        ring_sim.rebuild_queues(self.sim, engine._spawn, self.horizon)
        m = self.sim.meta
        inv = np.zeros(m.I, np.int64)
        inv[m.new2old_inter] = np.arange(m.I)
        self._orig2ring = inv            # original inter index -> ring
        self.step_count = 0
        self.growths = 0                 # ring growths (OV_SLOTS retries)
        self._known_ov = 0
        self._host_tables = None

    # -- stepping ------------------------------------------------------
    def step_once(self):
        """One step; a full ring (OV_SLOTS) grows the rings and runs the
        step again from the state it started from (the overflowing step
        dropped vehicles); other overflow bits are recorded and kept."""
        if self.step_count + 8 >= self.horizon:
            self.horizon *= 2
            self.engine._spawn.extend(self.horizon)
            self.engine._upload_spawn()
            ring_sim.rebuild_queues(self.sim, self.engine._spawn,
                                    self.horizon)
        for _ in range(GROWTH_RETRIES):
            prev = self.sim.state
            ov = int(ring_sim.step(self.sim).overflow)
            fresh = ov & ~self._known_ov
            if not fresh:
                self.step_count += 1
                return
            if fresh & OV_SLOTS:
                self.sim.state = prev
                ring_sim.grow_slots(self.sim, dsl=GROW_SL, dsk=GROW_SK)
                self.growths += 1
            else:
                self._known_ov = ov
                self.step_count += 1
                return
        raise RuntimeError("ring capacity growth failed")

    # -- views ---------------------------------------------------------
    def fetch(self) -> Dict[str, np.ndarray]:
        return ring_sim.fetch_full(self.sim, self.engine._spawn)

    def now_step(self) -> int:
        return self.step_count

    def stats(self):
        st = self.sim.state
        return float(st.cum_travel), int(st.finished_cnt)

    def phases_np(self) -> np.ndarray:
        return self.sim.state.phase.cpu().numpy()[self._orig2ring]

    # -- mutations -----------------------------------------------------
    def set_tl_phase(self, inter_index: int, phase_id: int):
        st = self.sim.state
        g = int(self._orig2ring[inter_index])
        self.sim.state = st.replace_fields(
            phase=_set(st.phase, g, int(phase_id)))

    def set_custom_speed(self, row: dict, speed: float, on: bool = True):
        st = self.sim.state
        at = (int(row["slot"]), int(row["pos"]))
        if row["kind"] == 0:
            self.sim.state = st.replace_fields(
                l_custom=_set(st.l_custom, at, float(speed)),
                l_hascustom=_set(st.l_hascustom, at, on))
        elif row["kind"] == 1:
            self.sim.state = st.replace_fields(
                k_custom=_set(st.k_custom, at, float(speed)),
                k_hascustom=_set(st.k_hascustom, at, on))
        else:
            raise RuntimeError("cannot set speed on a waiting vehicle")

    def refresh_route_tables(self, rid: int):
        """Route `rid`'s ring rows (route_next, route_aux, route_len) from
        the host net tables after Engine._register_route wrote them: the
        route section of compiler/ring_net.py build_ring for one row."""
        sim = self.sim
        m = sim.meta
        net = self.engine.net
        L = net.num_lanes
        LNp = sim.cfg.LNp
        rn = np.asarray(net.route_next_ll[rid])       # (RLEN, MAXLPR)
        ring_next = np.where(
            rn >= L,
            LNp + m.link_pos[np.clip(rn - L, 0, max(len(m.link_pos) - 1,
                                                    0))],
            -1).astype(np.int32)
        if self._host_tables is None:
            self._host_tables = {k: sim.tables[k].cpu().numpy()
                                 for k in ("lk_end_lane", "ln_llocal")}
        lk_end_lane = self._host_tables["lk_end_lane"]
        ln_llocal = self._host_tables["ln_llocal"]
        RLEN, MAXLPR = ring_next.shape
        rl = int(net.route_len[rid])
        aux = np.zeros((RLEN, MAXLPR), np.int32)
        for p2 in range(RLEN):
            last2 = p2 >= rl - 1
            for li in range(MAXLPR):
                nxt = ring_next[p2, li]
                nxt3 = -1
                if nxt >= 0:
                    el2 = lk_end_lane[nxt - LNp]
                    if el2 >= 0 and p2 + 1 < RLEN:
                        nxt3 = ring_next[p2 + 1, int(ln_llocal[el2])]
                aux[p2, li] = ((nxt3 + 2) << 1) | int(bool(last2))
        dev = sim.device
        tb = sim.tables
        tb["route_next"] = _set(tb["route_next"], rid,
                                torch.as_tensor(ring_next, device=dev))
        tb["route_aux"] = _set(tb["route_aux"], rid,
                               torch.as_tensor(aux, device=dev))
        tb["route_len"] = _set(tb["route_len"], rid, rl)

    def set_route(self, row: dict, rid: int) -> bool:
        """Router::setRoute on the ring state (router.cpp:245-264, as the
        gen-1 engine's set_vehicle_route)."""
        if row["kind"] != 0:
            return False                  # on a lanelink
        sim = self.sim
        self.refresh_route_tables(rid)
        net = self.engine.net
        at = (int(row["slot"]), int(row["pos"]))
        llocal = int(net.lane_local[int(row["drv"])])
        rnrow = sim.tables["route_next"][rid, 0].cpu().numpy()
        auxrow = sim.tables["route_aux"][rid, 0].cpu().numpy()
        rl = int(net.route_len[rid])
        if rl > 1 and rnrow[llocal] < 0:
            return False                  # onValidLane fails
        st = sim.state
        kw = dict(
            l_route=_set(st.l_route, at, rid),
            l_rpos=_set(st.l_rpos, at, 0),
            l_nxt=_set(st.l_nxt, at, int(rnrow[llocal])),
            l_nxt3=_set(st.l_nxt3, at, int((auxrow[llocal] >> 1) - 2)),
            l_last=_set(st.l_last, at, rl <= 1))
        if sim.cfg.lane_change:
            col = (slice(None),) + at
            kw["l_rnrow"] = _set(st.l_rnrow, col, torch.as_tensor(
                rnrow.astype(np.int32), device=sim.device))
            kw["l_auxrow"] = _set(st.l_auxrow, col, torch.as_tensor(
                auxrow.astype(np.int32), device=sim.device))
        sim.state = st.replace_fields(**kw)
        return True

    def on_spawn_changed(self):
        """A push or a reseed: the queues again from the shared generator
        (its deterministic prefix keeps the live cursors valid)."""
        ring_sim.rebuild_queues(self.sim, self.engine._spawn, self.horizon)

    def check_uniform_template(self, params_row) -> bool:
        """Whether the ring holds this template: the uniform row, or a row
        of the tpl_params table (a new one would need the tables rebuilt,
        so the Engine refuses it)."""
        row = np.asarray(params_row, np.float64)
        if self.sim.meta.uniform_params:
            return bool(np.allclose(row, np.asarray(
                self.sim.meta.param_row, np.float64)))
        tpp = self.sim.tables["tpl_params"].cpu().numpy().astype(np.float64)
        return bool(np.any(np.all(np.isclose(tpp, row[None]), axis=1)))

    def load(self, state, step, ov):
        """Install an archived ring state (its rings may have grown)."""
        st = state.map(lambda t: t.to(self.sim.device))
        sl, sk = st.l_dis.shape[0], st.k_dis.shape[0]
        if (sl, sk) != (self.sim.cfg.SL, self.sim.cfg.SK):
            self.sim.cfg = dataclasses.replace(self.sim.cfg, SL=sl, SK=sk)
        self.sim.state = st
        self.step_count = int(step)
        self._known_ov = int(ov)

    def reset(self):
        tb = {k: self.sim.tables[k].cpu().numpy()
              for k in ("i_n_phases", "i_phase_offset", "phase_time")}
        self.sim.state = init_ring_state(self.sim.cfg, tb,
                                         len(self.sim.meta.entry_lanes),
                                         self.sim.device)
        self.step_count = 0
        self._known_ov = 0
        self.on_spawn_changed()
