"""Scenario runner, the port of ``goworld_tpu/scenarios/runner.py``:
drive the port's World through a ScenarioSpec and prove it.

* **Oracle gates**: at small N, a checked tick asserts the interest-set
  contract. The device neighbor lists decoded into
  ``Entity.interested_in`` must equal the brute-force per-entity-radius
  oracle (:func:`goworld_tpu_torch.ops.aoi.neighbors_oracle`),
  ``interested_by`` must mirror it, and every attached client's mirror
  (kept from ``create_entity``/``destroy_entity`` client messages) must
  equal its owner's interest set.
* **Gauges**: the scenario's op_stats series (rebuilds, overflow, skin
  slack, enter/leave volume) aggregated over the run.

Host-side respawn churn (``spec.churn_rate``) destroys and recreates
that fraction of the population every tick through the World API.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from goworld_tpu_torch.scenarios.spec import ScenarioSpec, get_scenario

_INF = float("inf")


@dataclasses.dataclass
class ScenarioReport:
    name: str
    n: int
    ticks: int
    oracle_ticks_checked: int = 0
    mismatches: list = dataclasses.field(default_factory=list)
    # aggregated gauges (the bench headline-block numbers)
    rebuilds: int = 0
    over_k_rows_max: int = 0
    over_cap_cells_max: int = 0
    demand_max: int = 0
    skin_slack_min: float = _INF
    enter_events: int = 0
    leave_events: int = 0
    churned: int = 0

    @property
    def oracle_ok(self) -> bool:
        return self.oracle_ticks_checked > 0 and not self.mismatches

    def gauges(self) -> dict:
        return {
            "aoi_rebuild_total": self.rebuilds,
            "aoi_over_k_rows_max": self.over_k_rows_max,
            "aoi_over_cap_cells_max": self.over_cap_cells_max,
            "aoi_demand_max": self.demand_max,
            "aoi_skin_slack_min": (
                round(self.skin_slack_min, 3)
                if self.skin_slack_min is not _INF else None
            ),
            "aoi_enter_events": self.enter_events,
            "aoi_leave_events": self.leave_events,
            "churned_entities": self.churned,
        }


def build_world(
    spec: ScenarioSpec,
    *,
    n: int = 160,
    capacity: int | None = None,
    seed: int = 0,
    radius: float = 25.0,
    extent: float = 200.0,
    skin: float = 0.0,
    grid_kw: dict | None = None,
    cfg_kw: dict | None = None,
    client_frac: float = 0.0,
    world_kw: dict | None = None,
    device="cuda",
):
    """Build a single-space World under ``spec`` with ``n`` live movers
    on ``device`` (the card unless the caller asks for the CPU).

    Defaults size ``k``/``cell_cap``/``verlet_cap`` to the population so
    the sweep stays EXACT even fully converged (hotspot piles everyone
    into one cell) — the oracle gates require it; pass ``grid_kw`` to
    deliberately under-provision (the overflow regression tests do).
    Returns ``(world, entities, clients)`` where ``clients`` maps
    client_id -> its mirror set of entity ids, updated by
    :func:`drain_client_messages`.
    """
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.entity.entity import Entity, GameClient
    from goworld_tpu_torch.entity.manager import World
    from goworld_tpu_torch.entity.space import Space
    from goworld_tpu_torch.ops.aoi import GridSpec

    cap = capacity or max(64, int(n * 1.5))  # churn headroom
    gkw = dict(
        radius=radius, extent_x=extent, extent_z=extent,
        k=cap, cell_cap=cap, row_block=cap, skin=skin,
    )
    gkw.update(grid_kw or {})
    ckw = dict(
        capacity=cap,
        grid=GridSpec(**gkw),
        scenario=spec,
        enter_cap=4 * cap * min(cap, 64),
        leave_cap=4 * cap * min(cap, 64),
        sync_cap=4 * cap,
    )
    ckw.update(cfg_kw or {})
    cfg = WorldConfig(**ckw)
    w = World(cfg, n_spaces=1, seed=seed, device=device,
              **(world_kw or {}))

    class ScnSpace(Space):
        pass

    w.register_space("ScnSpace", ScnSpace)
    # one entity type per radius class (reference EntityTypeDesc
    # .aoiDistance; _type_aoi_radius maps inf -> aoi_distance 0)
    type_names = []
    for i, (r, _f) in enumerate(spec.radius_mix):
        tname = f"Scn{i}"
        w.register_entity(
            tname, type(tname, (Entity,), {}),
            aoi_distance=0.0 if r == _INF else float(r),
        )
        type_names.append(tname)
    w.create_nil_space()
    space = w.create_space("ScnSpace")

    from goworld_tpu_torch.scenarios.spec import _largest_remainder

    counts = _largest_remainder([f for _, f in spec.radius_mix], n)
    rng = np.random.default_rng(seed)
    kinds = rng.permutation(np.repeat(np.arange(len(counts)), counts))
    ents = []
    clients: dict = {}
    for i in range(n):
        e = w.create_entity(
            type_names[int(kinds[i])], space=space,
            pos=(float(rng.uniform(1.0, extent - 1.0)), 0.0,
                 float(rng.uniform(1.0, extent - 1.0))),
            moving=True,
        )
        if rng.uniform() < client_frac:
            cid = f"scn-c{i}"
            e.set_client(GameClient(1, cid, w))
            clients[cid] = set()
        ents.append(e)
    return w, ents, clients


def drain_client_messages(w, clients: dict) -> None:
    """Fold queued create/destroy client messages into per-client entity
    mirrors (what a real gate would maintain for each connection)."""
    for _gate, cid, msg in w.client_messages:
        mirror = clients.get(cid)
        if mirror is None:
            continue
        if msg.get("type") == "create_entity" \
                and not msg.get("is_player"):
            mirror.add(msg["eid"])
        elif msg.get("type") == "destroy_entity" \
                and not msg.get("is_player"):
            mirror.discard(msg["eid"])
    w.client_messages.clear()


def check_oracle(w, clients: dict | None = None,
                 check_mirrors: bool = True) -> list:
    """One full-contract check; returns a list of mismatch strings
    (empty = exact). Caller guarantees the sweep is provisioned exact
    (both overflow gauges zero) — asserted here so a silently degraded
    configuration can never 'pass'."""
    from goworld_tpu_torch.ops.aoi import neighbors_oracle

    bad: list = []
    if w.op_stats["aoi_over_k_rows"] or w.op_stats["aoi_over_cap_cells"]:
        bad.append(
            "sweep not exact this tick (over_k_rows="
            f"{w.op_stats['aoi_over_k_rows']}, over_cap_cells="
            f"{w.op_stats['aoi_over_cap_cells']}) — provision k/cell_cap"
        )
        return bad
    pos = w.state.pos[0].cpu().numpy()
    alive = w.state.alive[0].cpu().numpy()
    wr = w.state.aoi_radius[0].cpu().numpy()
    if w.cfg.grid.precision != "off":
        # precision=q16: interest is defined over the SNAPPED lattice
        # world (the exact positions the sweep ran on and sync records
        # carried) — the oracle evaluates the same domain, and
        # exactness there is the construction's guarantee
        from goworld_tpu_torch.ops.aoi import quantize_positions

        pos = quantize_positions(w.cfg.grid, torch.from_numpy(pos)).numpy()
    oracle = neighbors_oracle(pos, alive, w.cfg.grid.radius,
                              watch_radius=wr)
    owner = w._slot_owner[0]
    for slot, eid in owner.items():
        e = w.entities.get(eid)
        if e is None or e.destroyed or e.slot is None:
            continue
        want = {owner[j] for j in oracle[slot] if j in owner}
        if e.interested_in != want:
            bad.append(
                f"{eid}@{slot}: interested_in {sorted(e.interested_in)} "
                f"!= oracle {sorted(want)}"
            )
        for jid in e.interested_in:
            je = w.entities.get(jid)
            if je is None or eid not in je.interested_by:
                bad.append(f"{eid} watches {jid} but is not in its "
                           "interested_by")
    if clients and check_mirrors:
        drain_client_messages(w, clients)
        for e in list(w.entities.values()):
            if e.client is None or e.destroyed:
                continue
            mirror = clients.get(e.client.client_id)
            if mirror is None:
                continue
            if mirror != e.interested_in:
                bad.append(
                    f"client {e.client.client_id}: mirror "
                    f"{sorted(mirror)} != interest "
                    f"{sorted(e.interested_in)}"
                )
    return bad


def run_scenario(
    spec_or_name,
    *,
    n: int = 160,
    ticks: int = 30,
    seed: int = 0,
    oracle_every: int = 3,
    client_frac: float = 0.15,
    skin: float = 0.0,
    grid_kw: dict | None = None,
    cfg_kw: dict | None = None,
    world_kw: dict | None = None,
    raise_on_mismatch: bool = False,
    device="cuda",
) -> ScenarioReport:
    """Drive ``ticks`` World ticks under the scenario, churn per the
    spec, gate against the oracle every ``oracle_every`` ticks, and
    aggregate the scenario gauges."""
    spec = (get_scenario(spec_or_name)
            if isinstance(spec_or_name, str) else spec_or_name)
    w, ents, clients = build_world(
        spec, n=n, seed=seed, skin=skin, grid_kw=grid_kw,
        cfg_kw=cfg_kw, client_frac=client_frac, world_kw=world_kw,
        device=device,
    )
    space = next(iter(w.spaces.values()))
    rng = np.random.default_rng(seed + 1)
    rep = ScenarioReport(name=spec.name, n=n, ticks=ticks)
    churn_n = int(round(spec.churn_rate * n))
    extent = w.cfg.grid.extent_x
    live = [e for e in ents if not e.destroyed]
    for t in range(ticks):
        if churn_n and t > 0:
            # respawn churn through the real API: destroy + same-tick
            # recreate (slot quarantine holds the freed slot one tick)
            victims = rng.choice(len(live), churn_n, replace=False)
            for vi in sorted(victims, reverse=True):
                e = live.pop(vi)
                tname = e.type_name
                e.destroy()
                live.append(w.create_entity(
                    tname, space=space,
                    pos=(float(rng.uniform(1.0, extent - 1.0)), 0.0,
                         float(rng.uniform(1.0, extent - 1.0))),
                    moving=True,
                ))
                rep.churned += 1
        w.tick()
        st = w.op_stats
        rep.rebuilds += int(st.get("aoi_rebuild_last", 1))
        rep.over_k_rows_max = max(rep.over_k_rows_max,
                                  int(st["aoi_over_k_rows"]))
        rep.over_cap_cells_max = max(rep.over_cap_cells_max,
                                     int(st["aoi_over_cap_cells"]))
        rep.demand_max = max(rep.demand_max, int(st["aoi_demand_max"]))
        if "aoi_skin_slack" in st:
            rep.skin_slack_min = min(rep.skin_slack_min,
                                     float(st["aoi_skin_slack"]))
        rep.enter_events += int(st.get("aoi_enter_events", 0))
        rep.leave_events += int(st.get("aoi_leave_events", 0))
        if oracle_every and (t % oracle_every == oracle_every - 1):
            bad = check_oracle(w, clients)
            rep.oracle_ticks_checked += 1
            if bad:
                rep.mismatches.extend(f"tick {t}: {m}" for m in bad[:8])
                if raise_on_mismatch:
                    raise AssertionError(
                        f"scenario {spec.name} tick {t}: " + "; "
                        .join(bad[:4])
                    )
    return rep
