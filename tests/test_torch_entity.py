"""The port's host-only entity modules against their JAX twins: the
same inputs through both packages give equal outputs.

* ``attrs``: sets, the delta journal, nested paths, list ops, type
  canonicalisation, silent loads and severed trees;
* ``registry``: attr flags, hot columns, RPC permission flags, type ids;
* ``timer``: the order of firings under a fake clock (repeating and
  one-shot timers, cancels, dump and restore), the post queue, crontab;
* ``ids``: the 16-character format, fixed ids and nil-space ids, and
  ``build_eid_index`` / ``probe_eid_index`` on the same ids.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from goworld_tpu.entity import attrs as jattrs
from goworld_tpu.entity import registry as jregistry
from goworld_tpu.entity import timer as jtimer
from goworld_tpu.utils import ids as jids
from goworld_tpu_torch.entity import attrs as tattrs
from goworld_tpu_torch.entity import registry as tregistry
from goworld_tpu_torch.entity import timer as ttimer
from goworld_tpu_torch.utils import ids as tids

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

PAIRS = {"jax": (jattrs, jregistry, jtimer, jids),
         "port": (tattrs, tregistry, ttimer, tids)}


def both(fn):
    """``fn(attrs, registry, timer, ids)`` on each package."""
    return {k: fn(*mods) for k, mods in PAIRS.items()}


def _attr_script(attrs, name):
    journal = []
    root = attrs.make_root(journal.append)
    if name == "set":
        root["hp"] = 10
        root["hp"] = 12.5
        root["name"] = "orc"
        root.set_default("name", "elf")
        root.setdefault("level", 3)
        del root["level"]
    elif name == "nested":
        root["bag"] = {"items": [1, 2], "meta": {"w": 1.5}}
        bag = root.get_map("bag")
        bag.get_map("meta")["w"] = 2
        bag.get_list("items")[0] = 9
        root.get_map("new")["k"] = "v"
    elif name == "list":
        lst = root.get_list("l")
        for v in (1, 2.0, "x", {"a": 1}):
            lst.append(v)
        lst.insert(1, [5, 6])
        popped = lst.pop(0)
        lst.pop()
        lst[1] = 7
        journal.append(("popped", popped))
        lst[0].append(8)
    elif name == "types":
        root["i"] = np.int32(4)
        root["f"] = np.float32(0.5)
        root["b"] = True
        root["n"] = None
        root["by"] = b"raw"
        root["t"] = (1, (2, 3))
        with pytest.raises(TypeError):
            root["bad"] = object()
        journal.append(tuple(type(root[k]).__name__
                             for k in ("i", "f", "b", "n", "by")))
    elif name == "load":
        attrs.load_into(root, {"a": 1, "b": {"c": [1, 2]}})
        root["a"] = 2
        attrs.sever_tree(root)
        root["a"] = 3  # severed: no journal
        journal.append(root.get_int("a"))
    elif name == "reparent":
        root["m"] = {"x": 1}
        with pytest.raises(ValueError):
            root["other"] = root["m"]
    return [tuple(d) if isinstance(d, tuple) else d for d in journal], \
        root.to_dict(), repr(root)


@pytest.mark.parametrize("name", ["set", "nested", "list", "types", "load",
                                  "reparent"])
def test_attrs_match_jax(name):
    got = both(lambda attrs, *_: _attr_script(attrs, name))
    assert got["port"] == got["jax"]
    assert got["port"][0] or name == "reparent"


def _register(registry):
    class Hero:
        ATTRS = {"hp": "allclients hot:0", "mp": "client hot:1",
                 "gold": "persistent", "name": "AllClients persistent",
                 "seen": ["client", "hot:2"]}

        def Attack(self, target): ...
        def Move_Client(self, x, y): ...
        def Chat_AllClients(self, *msg): ...
        def _private(self): ...
        def OnCreated(self): ...

    class Town:
        ATTRS = {}

    reg = registry.Registry()
    out = []
    for name, cls, kw in (("Hero", Hero, {}),
                          ("Town", Town, dict(is_space=True,
                                              use_aoi=False)),
                          ("Npc", Hero, dict(aoi_distance=30.0,
                                             persistent=True))):
        d = reg.register(name, cls, **kw)
        out.append((d.name, d.is_space, d.is_persistent, d.use_aoi,
                    d.aoi_distance, sorted(d.client_attrs),
                    sorted(d.all_client_attrs), sorted(d.persistent_attrs),
                    d.hot_attrs, d.hot_attr_by_col, d.type_id,
                    sorted((k, v.flags, v.n_args)
                           for k, v in d.rpc_descs.items()),
                    [d.audience_of(a) for a in ("hp", "mp", "gold", "x")]))
    with pytest.raises(ValueError):
        reg.register("Hero", Hero)
    with pytest.raises(ValueError):
        reg.register("Mega", Hero, megaspace=True)
    with pytest.raises(KeyError):
        reg.get("Nope")
    out.append((reg.type_id("Npc"), reg.name_of(1), "Hero" in reg))
    return out


def test_registry_matches_jax():
    got = both(lambda _a, registry, *_: _register(registry))
    assert got["port"] == got["jax"]
    assert got["port"][0][12] == ["all_clients", "client", None, None]


def _timer_script(timer):
    now = [100.0]
    fired = []
    q = timer.TimerQueue(lambda: now[0])
    a = q.add(0.5, lambda: fired.append("a"), interval=0.5)
    q.add(0.25, lambda: fired.append("b"))
    c = q.add(0.3, method="Heal", args=("e1", 5), interval=1.0)
    d = q.add(1.7, method="Die", args=("e1",))
    q.add(0.5, lambda: 1 / 0)  # a failing callback is logged, not raised

    def fire(t):
        fired.append(t.method or "cb") if t.method else t.cb()

    log = []
    for step in range(12):
        now[0] += 0.2
        log.append((step, q.tick(fire), len(q)))
        if step == 4:
            q.cancel(a)
            dumped = q.dump([c, d])
    restored = q.restore(dumped)
    now[0] += 2.0
    log.append(("after", q.tick(fire), len(restored)))
    post = timer.PostQueue()
    order = []
    post.post(lambda: order.append(1))
    post.post(lambda: (order.append(2), post.post(lambda: order.append(4))))
    post.post(lambda: order.append(3))
    ran = (post.tick(), list(order), post.tick(), list(order))
    cron = timer.Crontab()
    hits = []
    cron.register(-1, -1, -1, -1, -1, lambda: hits.append("any"))
    cron.register(-5, -1, -1, -1, -1, lambda: hits.append("every5"))
    cron.register(30, 10, -1, -1, -1, lambda: hits.append("10:30"))
    import time as _time
    base = _time.mktime((2026, 3, 2, 10, 29, 0, 0, 0, -1))
    counts = [cron.tick(base + 60 * m) for m in range(3)] + \
        [cron.tick(base + 60 * 2 + 5)]
    return fired, log, dumped, ran, counts, hits


def test_timers_match_jax():
    got = both(lambda _a, _r, timer, _i: _timer_script(timer))
    assert got["port"] == got["jax"]
    fired = got["port"][0]
    assert fired[:2] == ["b", "Heal"] and "Die" in fired


def _ids_script(ids, eids):
    fixed = [ids.gen_fixed_id(f"k{i}") for i in range(4)]
    nil = [ids.nil_space_id(g) for g in (1, 2, 30001)]
    arr = np.array(eids, "S16")
    hashed, keys, sorted_eids, order = ids.build_eid_index(arr)
    query = np.concatenate([arr[::-3], np.array([b"x" * 16, b""], "S16")])
    p, ok = ids.probe_eid_index(hashed, keys, sorted_eids, query)
    return (fixed, nil, hashed, keys.tobytes(), sorted_eids.tobytes(),
            order.tolist(), p.tolist(), ok.tolist(),
            ids.eid_hash64(arr).tobytes(),
            [ids.is_valid_entity_id(x) for x in fixed + ["bad", "A" * 16]])


def test_ids_match_jax():
    eids = [tids.gen_entity_id() for _ in range(500)]
    assert all(len(e) == tids.ENTITYID_LENGTH and tids.is_valid_entity_id(e)
               and jids.is_valid_entity_id(e) for e in eids)
    assert all(jids.is_valid_entity_id(jids.gen_entity_id())
               for _ in range(3))
    assert len(set(eids)) == len(eids)
    got = both(lambda _a, _r, _t, ids: _ids_script(ids, eids))
    assert got["port"] == got["jax"]
    assert all(got["port"][7][:-2]) and not any(got["port"][7][-2:])
