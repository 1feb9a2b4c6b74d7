"""``examples/multihost_demo`` through the port's ops CLI on the CPU: one
logical game run as two controller processes (``mesh_processes = 2``),
the CLI's counterpart of ``tests/test_cli.py``'s multihost cases.

A copy of the demo with its ports moved and a ``server_cpu.py`` entry
(its ``server_torch.py`` registrations, ``gw.run(device="cpu")``):

* ``start`` spawns ``game1c0`` and ``game1c1``; a strict bot logs in
  through the gate (the Login RPC reaches the leader, the mutation log
  replays it on both), its Avatar lands on rank 1's half of the world
  and rank 1's Monsters reach it and move in its mirror, with no message
  twice (the strict mirror counts a second create as an error);
  ``reload`` freezes the group through its leader and restarts both
  ranks with ``-restore``; a second bot plays the restored game; ``stop``
  ends it and ``status`` reports it stopped;
* with rank 1 killed, ``start`` and ``reload`` refuse the partial group,
  and one ``watchdog`` scan tears rank 0 down and restarts the whole
  group from the leader's periodic checkpoint, which a bot then plays.

Every wait has its own bound and every process is killed in ``finally``.
"""

from __future__ import annotations

import asyncio
import os
import signal

import torch

from goworld_tpu_torch import cli
from tests.test_torch_examples import (Bots, _copy_example, _kill_all,
                                       _login, _logs, _until)

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

RANKS = ("1c0", "1c1")


def _demo(dst: str) -> tuple[str, int]:
    """The demo's copy (``tests/test_torch_examples.py``'s, its own
    ``[deployment]`` section taking the CPU entry); (dir, gate port)."""
    dst, gate = _copy_example("multihost_demo", dst)
    ini = os.path.join(dst, "goworld_tpu.ini")
    with open(ini) as f:
        text = f.read()
    head = "[deployment]\nentry = server_cpu.py\n\n"
    assert text.startswith(head)
    text = text[len(head):].replace(
        "[deployment]\n", "[deployment]\nentry = server_cpu.py\n", 1)
    with open(ini, "w") as f:
        f.write(text)
    return dst, gate


def _log(dst: str, label: str) -> str:
    with open(os.path.join(dst, "run", f"game{label}.log"),
              errors="replace") as f:
        return f.read()


def _started_on_cpu(dst: str, restore: bool) -> None:
    for label in RANKS:
        assert f"game1 started (restore={restore}) on cpu" in _log(
            dst, label), _logs(dst)


async def _play(dst: str, gate: int, name: str) -> None:
    """A strict bot logs in; its Avatar stands on rank 1's half; a
    Monster there reaches its mirror and moves in it."""
    bots = Bots(gate)
    try:
        bot = await _login(bots, "Avatar", name, dst)
        assert bot.player.pos[0] >= 400.0      # rank 1's tiles: x >= 400

        def monsters():
            return {eid: tuple(m.pos) for eid, m in bot.entities.items()
                    if m.type_name == "Monster"}
        await _until(lambda: monsters(), "a Monster in the mirror", dst)
        first = monsters()
        await _until(lambda: any(first.get(eid, p) != p
                                 for eid, p in monsters().items()),
                     "a Monster's sync", dst)
        assert all(p[0] >= 400.0 - 60.0 for p in monsters().values())
        assert bots.errors() == [], bots.errors()
    finally:
        await bots.close()


def test_multihost_demo_start_login_reload_stop(tmp_path):
    dst, gate = _demo(str(tmp_path / "mh"))
    try:
        assert cli.main(["start", dst]) == 0, _logs(dst)
        _started_on_cpu(dst, restore=False)
        asyncio.run(_play(dst, gate, "ann"))
        assert cli.main(["reload", dst]) == 0, _logs(dst)
        assert os.path.exists(os.path.join(dst, "game1_freezed.dat"))
        _started_on_cpu(dst, restore=True)
        asyncio.run(_play(dst, gate, "bob"))
        assert "SPMD staging divergence" not in _logs(dst)
        assert cli.main(["stop", dst]) == 0, _logs(dst)
        assert cli.cmd_status(dst) == 1
    finally:
        _kill_all(dst)


def test_multihost_demo_watchdog_restores_the_group(tmp_path):
    dst, gate = _demo(str(tmp_path / "mh"))
    try:
        assert cli.main(["start", dst]) == 0, _logs(dst)
        ckpt = os.path.join(dst, "game1_checkpoint.dat")
        asyncio.run(_until(lambda: os.path.exists(ckpt),
                           "the leader's checkpoint", dst))
        pid = cli._read_pid(dst, "game", "1c1")
        os.kill(pid, signal.SIGKILL)
        asyncio.run(_until(lambda: not cli._alive(pid), "rank 1 dead",
                           dst))
        # a partial group is never healed in place
        assert cli.main(["start", dst]) == 1
        assert cli.main(["reload", dst]) == 1
        actions = cli.watch_once(dst)
        assert actions == [
            "game1: dead rank(s) ['1c1']; tearing down surviving ['1c0']",
            "game1: restarted from game1_checkpoint.dat"], \
            (actions, _logs(dst))
        assert all(cli._alive(cli._read_pid(dst, "game", lb))
                   for lb in RANKS)
        assert cli.watch_once(dst) == []
        asyncio.run(_play(dst, gate, "cat"))
        assert cli.main(["stop", dst]) == 0, _logs(dst)
    finally:
        _kill_all(dst)
