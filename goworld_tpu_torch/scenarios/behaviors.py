"""Per-entity scenario behaviors, the port of
``goworld_tpu/scenarios/behaviors.py``.

Every entity carries a behavior lane (``SpaceState.behavior_id``, an
index into the spec's mix). The JAX package steps the population
through one ``vmap(lax.switch)``, which computes every member over
every row and selects; the port does the same without the switch: each
member's velocity field is computed over all rows and each row takes
its own member's by ``torch.where``. Nothing branches on the host.

Each member returns ``(velocity f32[N, 3], teleport position f32[N, 3],
teleport bool[N])``; teleporting rows override their integrated
position before the sweep, so the Verlet skin's device gate sees the
jump on that tick. Each row draws from its own key
(``jax.random.split(key, n)``) as the vmapped members do, and every
float op takes the jitted reference's order
(:mod:`goworld_tpu_torch.ops.xla_order`), under flush-to-zero as XLA's
CPU runtime runs it: the members read flushed positions, velocities and
features, and flush each float result that can fall below 2^-126 (a
random walk's select keeps the carried velocity's bits, as XLA's does).

The phase schedule (hotspot attractor, shrink-zone radius, flock wind)
is a function of the tick counter on the device
(:func:`scenario_context`).
"""

from __future__ import annotations

import math

import torch

from goworld_tpu_torch.models.behavior_tree import (
    features_from_neighbors,
    unit_norm,
)
from goworld_tpu_torch.models.npc_policy import (
    build_obs_from_features,
    policy_accel,
)
from goworld_tpu_torch.models.random_walk import cos_sin
from goworld_tpu_torch.ops import prng
from goworld_tpu_torch.ops.xla_order import (
    as_f32,
    div32,
    fma32,
    ftz,
    mul32,
    mul_recip,
    rsqrt_x86,
)
from goworld_tpu_torch.scenarios.spec import ScenarioSpec

_TWO_PI = 2.0 * math.pi


def _bounds(cfg, bounds: tuple | None) -> tuple:
    """(origin_x, origin_z, extent_x, extent_z) the members steer
    within: the grid's, or the megaspace's world bounds."""
    if bounds is not None:
        return tuple(float(v) for v in bounds)
    g = cfg.grid
    return (float(g.origin_x), float(g.origin_z),
            float(g.extent_x), float(g.extent_z))


def _unit_xz(dx, dz, eps: float = 1e-6):
    norm = unit_norm(dx, dz, eps)
    return div32(dx, norm), div32(dz, norm)


def _vel3(vx, vz):
    return torch.stack([vx, torch.zeros_like(vx), vz], dim=-1)


def _phase_rate(period) -> float:
    """``2 pi / period`` as XLA folds ``2 pi * t / period``: the divide
    becomes a multiply by the float32 reciprocal, and the two constants
    multiply in float32 before ``t`` does."""
    return as_f32(as_f32(_TWO_PI) * mul_recip(1.0, float(period)))


def scenario_context(spec: ScenarioSpec, cfg, t: torch.Tensor,
                     bounds: tuple | None = None) -> dict:
    """Phase state for tick ``t`` (0-d int32 on the device): attractor
    position, shrink-zone radius and wind heading, as 0-d tensors."""
    ox, oz, ex_, ez_ = _bounds(cfg, bounds)
    tf = t.to(torch.float32)
    cx = ox + 0.5 * ex_
    cz = oz + 0.5 * ez_
    ph = tf * _phase_rate(spec.attractor_period)
    cos_ph, sin_ph = cos_sin(ph)
    ax = fma32(cos_ph, (0.5 - spec.attractor_margin) * ex_, cx)
    az = fma32(sin_ph, (0.5 - spec.attractor_margin) * ez_, cz)
    half = 0.5 * float(min(ex_, ez_))
    prog = torch.clamp_max(mul_recip(tf, float(spec.shrink_over)), 1.0)
    zone_r = fma32(prog, -(1.0 - spec.shrink_min_frac), 1.0) * half
    wph = tf * _phase_rate(spec.flock_wind_period)
    wind_c, wind_s = cos_sin(wph)
    return dict(attractor=(ax, az), zone_c=(cx, cz), zone_r=zone_r,
                wind=(wind_c, wind_s))


def _walk_vel(keys, vel, moving, speed: float, turn_prob: float):
    """Per-entity random walk (each row its own key): keep heading,
    draw a new one with ``turn_prob`` or when stopped. ``vel`` is the
    carried lane, unflushed: the select keeps its bits."""
    sub = prng.split(keys)
    turn = prng.uniform(sub[:, 0], ()) < turn_prob
    heading = prng.uniform(sub[:, 1], (), 0.0, _TWO_PI)
    cos_h, sin_h = cos_sin(heading)
    new_vel = _vel3(mul32(cos_h, speed), mul32(sin_h, speed))
    stopped = vel.abs().sum(dim=-1) < 1e-6
    pick = (turn | stopped) & moving
    return torch.where(pick[:, None], new_vel, vel)


def _member(name: str, spec: ScenarioSpec, cfg, ctx: dict, policy,
            bounds: tuple | None, summary: bool = False):
    """The velocity field of one mix member over all rows:
    ``fn(keys, ent) -> (vel, dest, teleport)``; ``summary`` when the
    features come from the summary lanes (the megaspace)."""
    speed = float(cfg.npc_speed)
    turn_prob = float(cfg.turn_prob)
    dt = float(cfg.dt)
    b_ox, b_oz, b_ex, b_ez = _bounds(cfg, bounds)
    lo_x, lo_z = b_ox + 1e-3, b_oz + 1e-3
    hi_x, hi_z = b_ox + b_ex - 1e-3, b_oz + b_ez - 1e-3

    def still(ent):
        return ent["pos_raw"], torch.zeros_like(ent["moving"])

    def masked(vel, ent):
        return torch.where(ent["moving"][:, None], vel, 0.0)

    if name == "random_walk":
        def run(keys, ent):
            return (_walk_vel(keys, ent["vel_raw"], ent["moving"], speed,
                              turn_prob), *still(ent))
        return run

    if name == "hotspot":
        def run(keys, ent):
            ax, az = ctx["attractor"]
            dx = ftz(ax - ent["pos"][:, 0])
            dz = ftz(az - ent["pos"][:, 2])
            dist = unit_norm(dx, dz, 1e-12)
            ux, uz = _unit_xz(dx, dz)
            # the radial step never overshoots the attractor
            eff = torch.minimum(torch.full_like(dist, as_f32(speed)),
                                mul_recip(dist, dt))
            if spec.hotspot_jitter > 0.0:
                jh = prng.uniform(keys, (), 0.0, _TWO_PI)
                jc, js = cos_sin(jh)
                jx = mul32(jc, spec.hotspot_jitter * speed)
                jz = mul32(js, spec.hotspot_jitter * speed)
                vx = fma32(ux, eff, jx)
                vz = fma32(uz, eff, jz)
            else:
                vx, vz = mul32(ux, eff), mul32(uz, eff)
            return masked(_vel3(vx, vz), ent), *still(ent)
        return run

    if name == "shrink":
        def run(keys, ent):
            cx, cz = ctx["zone_c"]
            dx = ftz(cx - ent["pos"][:, 0])
            dz = ftz(cz - ent["pos"][:, 2])
            outside = unit_norm(dx, dz, 1e-12) > ctx["zone_r"]
            # the reference fuses the norm's squares differently for
            # the two components
            ux = div32(dx, unit_norm(dx, dz, 1e-6))
            uz = div32(dz, unit_norm(dz, dx, 1e-6))
            inward = _vel3(mul32(ux, speed), mul32(uz, speed))
            wander = _walk_vel(keys, ent["vel_raw"], ent["moving"],
                               0.4 * speed, turn_prob)
            vel = torch.where(outside[:, None], inward, wander)
            return masked(vel, ent), *still(ent)
        return run

    if name == "flock":
        def run(keys, ent):
            wx, wz = ctx["wind"]
            cx, cz = _unit_xz(ent["mean_off"][:, 0], ent["mean_off"][:, 2])
            coh = spec.flock_coherence
            has_nbr = ent["nbr_cnt"] > 0
            dxv = ftz(wx + torch.where(has_nbr, mul32(cx, coh), 0.0))
            dzv = ftz(wz + torch.where(has_nbr, mul32(cz, coh), 0.0))
            ux, uz = _unit_xz(dxv, dzv)
            if summary:
                # the reference's z loop over the summary lane fuses the
                # mean offset's z square, not its x square, and builds
                # the whole z output from that norm
                mx, mz = ent["mean_off"][:, 0], ent["mean_off"][:, 2]
                n1 = unit_norm(mz, mx, 1e-6)
                dxv = ftz(wx + torch.where(has_nbr,
                                           mul32(div32(mx, n1), coh), 0.0))
                dzv = ftz(wz + torch.where(has_nbr,
                                           mul32(div32(mz, n1), coh), 0.0))
                uz = div32(dzv, unit_norm(dxv, dzv, 1e-6))
            s = spec.flock_speed_frac * speed
            return masked(_vel3(mul32(ux, s), mul32(uz, s)), ent), \
                *still(ent)
        return run

    if name == "teleport":
        def run(keys, ent):
            sub = prng.split(keys, 4)
            vel = _walk_vel(sub[:, 0], ent["vel_raw"], ent["moving"],
                            speed, turn_prob)
            tele = (prng.uniform(sub[:, 1], ()) < spec.teleport_prob) \
                & ent["moving"]
            nx = prng.uniform(sub[:, 2], (), lo_x, hi_x)
            nz = prng.uniform(sub[:, 3], (), lo_z, hi_z)
            dest = torch.stack([nx, ent["pos_raw"][:, 1], nz], dim=-1)
            # a teleporting entity keeps no momentum into the new cell
            vel = torch.where(tele[:, None], 0.0, vel)
            return vel, dest, tele
        return run

    if name == "btree":
        def run(keys, ent):
            def toward(off, sign, split: bool):
                # chase's norm fuses its squares per component (as
                # shrink's), separate's as the other members'
                dx, dz = off[:, 0], off[:, 2]
                ux = div32(dx, unit_norm(dx, dz, 1e-6))
                uz = div32(dz, unit_norm(dz, dx, 1e-6)) if split \
                    else div32(dz, unit_norm(dx, dz, 1e-6))
                return _vel3(mul32(ux, sign * speed),
                             mul32(uz, sign * speed))

            chase = ent["client_cnt"] > 0
            crowded = ent["nbr_cnt"] >= 12
            wander = _walk_vel(keys, ent["vel_raw"], ent["moving"], speed,
                               turn_prob)
            vel = torch.where(
                chase[:, None], toward(ent["client_off"], 1.0, True),
                torch.where(crowded[:, None],
                            toward(ent["mean_off"], -1.0, False), wander))
            return masked(vel, ent), *still(ent)
        return run

    if name == "mlp":
        if policy is None:
            raise ValueError(
                "scenario mix includes 'mlp' but no MLPPolicy was "
                "passed to the tick (spec.needs_policy)")

        # beside other members the reference's loop is unswitched on
        # their conditions, and the x component's accel * dt is hoisted
        # above the branch, away from its add (ROADMAP.md Queue C4)
        fuse_x = spec.behavior_names == ("mlp",)
        # beside other members the reference vmaps a switch, and its
        # dots become batched one-row matvecs (summed in k order)
        per_row = len(spec.behavior_names) > 1

        def run(keys, ent):
            obs = build_obs_from_features(
                ent["pos"], ent["vel"], ent["yaw"], ent["nbr_cnt"],
                ent["mean_off"], cfg.grid.k, (b_ex, b_ez))
            accel = policy_accel(policy, obs, per_row)
            return masked(capped_step(ent["vel"], accel, dt, speed, fuse_x),
                          ent), *still(ent)
        return run

    raise ValueError(f"no kernel for behavior {name!r}")


def capped_step(vel, accel, dt: float, speed: float, fuse_x: bool = True):
    """``vel + accel * dt``, its XZ speed capped at ``speed``, with the
    jitted reference's fused multiply-adds (on the x component only
    where ``fuse_x``; else its product is rounded before the add). XLA
    rewrites ``speed / sqrt(s)`` into ``speed * rsqrt(s)`` and computes
    the rsqrt from the CPU's table estimate (:func:`rsqrt_x86`). ``vel``
    and ``accel`` are flushed (:func:`ops.xla_order.ftz`), and so is
    each result (``s`` is at least 1e-12, so its rsqrt is normal)."""
    v = fma32(accel, dt, vel)
    if not fuse_x:
        v = torch.cat([ftz(vel[:, :1] + mul32(accel[:, :1], dt)),
                       v[:, 1:]], 1)
    s = fma32(v[:, 0], v[:, 0], mul32(v[:, 2], v[:, 2])) + 1e-12
    cap = mul32(rsqrt_x86(s), speed)
    return mul32(v, torch.clamp_max(cap, 1.0)[:, None])


def _neighbor_features(pos, has_client, nbr, nbr_cnt, want_client: bool):
    """Mean and nearest-client neighbor offsets from the previous tick's
    lists (the btree's feature build). Without a btree member the client
    lanes are zero, and the reference's sum is then its fusion's only
    output (:func:`ops.xla_order.sum_k`)."""
    f = features_from_neighbors(pos, has_client, nbr, nbr_cnt,
                                vectorized=not want_client)
    if not want_client:
        z = torch.zeros(pos.shape[0], dtype=torch.float32,
                        device=pos.device)
        return f.mean_off, z, torch.zeros_like(f.mean_off)
    return f.mean_off, f.client_cnt.to(torch.float32), f.client_off


def _per_row(ctx: dict, per: int) -> dict:
    """Each Space's phase values ``[S]`` repeated over its ``per`` rows."""
    def rows(v):
        if isinstance(v, tuple):
            return tuple(rows(x) for x in v)
        if not torch.is_tensor(v):
            return v
        return v[:, None].expand(-1, per).reshape(-1)
    return {k: rows(v) for k, v in ctx.items()}


def scenario_velocity(cfg, key, pos, yaw, state, policy,
                      bounds: tuple | None = None,
                      features: tuple | None = None):
    """The heterogeneous population's step: ``(vel f32[N, 3],
    teleport_pos f32[N, 3], teleport bool[N])`` for the tick.

    ``bounds`` = (origin_x, origin_z, extent_x, extent_z) overrides the
    grid extents for the phase schedule and the teleport targets;
    ``features`` = (mean_off f32[N, 3], client_cnt f32[N], client_off
    f32[N, 3]) replaces the neighbor-list gather. The megaspace passes
    both. With ``key [S, 2]`` the rows are S Spaces' rows in a row
    (``core/step.py`` ``flat_spaces``): each Space splits its own key
    into per-entity keys and reads its own tick's phase."""
    spec: ScenarioSpec = cfg.scenario
    if state.behavior_id is None:
        raise ValueError(
            "cfg.scenario is set but state.behavior_id is None: build "
            "the state with create_state(cfg)")
    n = pos.shape[0]
    dev = pos.device
    names = spec.behavior_names
    per = n // key.shape[0] if key.dim() == 2 else n
    ctx = scenario_context(spec, cfg, state.tick, bounds)
    if key.dim() == 2:
        ctx = _per_row(ctx, per)
    pos_d = ftz(pos)
    if features is not None:
        mean_off, client_cnt, client_off = features
    elif spec.needs_features:
        mean_off, client_cnt, client_off = _neighbor_features(
            pos_d, state.has_client, state.nbr, state.nbr_cnt,
            "btree" in names)
    else:
        mean_off = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        client_cnt = torch.zeros(n, dtype=torch.float32, device=dev)
        client_off = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    # the members' float ops read flushed lanes; selects keep the raw
    # bits of the carried position and velocity
    ent = dict(pos=pos_d, vel=ftz(state.vel), pos_raw=pos,
               vel_raw=state.vel, yaw=yaw, moving=state.npc_moving,
               mean_off=mean_off, nbr_cnt=state.nbr_cnt.to(torch.float32),
               client_cnt=client_cnt, client_off=client_off)
    keys = prng.split(key, per).reshape(n, 2)
    outs = [_member(b, spec, cfg, ctx, policy, bounds,
                    features is not None)(keys, ent) for b in names]
    vel, tele_pos, tele = outs[0]
    if len(outs) > 1:
        bid = torch.clamp(state.behavior_id, 0, len(outs) - 1)
        for i, (v, p, t) in enumerate(outs[1:], start=1):
            pick = bid == i
            vel = torch.where(pick[:, None], v, vel)
            tele_pos = torch.where(pick[:, None], p, tele_pos)
            tele = torch.where(pick, t, tele)
    alive = state.alive
    vel = torch.where(alive[:, None], vel, 0.0)
    tele = tele & alive & state.npc_moving
    return vel, tele_pos, tele

