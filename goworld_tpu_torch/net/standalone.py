"""Standalone cluster harness: dispatcher(s) + gate(s) in one process.

The reference always deploys dispatcher/game/gate as separate OS processes
(``cmd/goworld`` start). For tests, examples and single-machine runs we also
support hosting the dispatcher and gate services on a background asyncio
thread inside the game process — real sockets, real wire protocol, one
process. This is the "single-host multi-process integration driven by a bot
swarm" fixture of the reference's test strategy (``SURVEY.md#4``) without
process management.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import Future
from typing import Coroutine

from goworld_tpu_torch.net.dispatcher import DispatcherService
from goworld_tpu_torch.net.gate import GateService
from goworld_tpu_torch.utils import log

logger = log.get("standalone")


class ClusterHarness:
    """Runs N dispatchers + M gates on ephemeral ports in a daemon thread."""

    def __init__(self, n_dispatchers: int = 1, n_gates: int = 1,
                 desired_games: int = 1, host: str = "127.0.0.1",
                 heartbeat_timeout: float = 0.0,
                 position_sync_interval_ms: int = 20,
                 with_ws: bool = False, with_kcp: bool = False,
                 compress: bool = False,
                 tls_dir: str | None = None,
                 gate_exit_on_dispatcher_loss: bool = False,
                 gate_kwargs: dict | None = None):
        self.host = host
        self.n_dispatchers = n_dispatchers
        self.n_gates = n_gates
        self.desired_games = desired_games
        self.heartbeat_timeout = heartbeat_timeout
        self.position_sync_interval_ms = position_sync_interval_ms
        self.with_ws = with_ws
        self.with_kcp = with_kcp
        self.gate_kcp_addrs: list[tuple[str, int]] = []
        # client-edge transport (reference goworld_actions.ini runs CI
        # with compression+encryption ON)
        self.compress = compress
        self.tls_dir = tls_dir  # directory for the self-signed pair
        # default False: the harness tears processes down in arbitrary
        # order; real deployments keep the gate default (True)
        self.gate_exit_on_dispatcher_loss = gate_exit_on_dispatcher_loss
        # extra GateService kwargs (admission-control knobs in the
        # overload tests: max_clients, rate_limit_pps, ...)
        self.gate_kwargs = gate_kwargs or {}
        self.dispatchers: list[DispatcherService] = []
        self.gates: list[GateService] = []
        self.dispatcher_addrs: list[tuple[str, int]] = []
        self.gate_addrs: list[tuple[str, int]] = []
        self.gate_ws_addrs: list[tuple[str, int]] = []
        self.loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._tasks: list = []

    # ------------------------------------------------------------------
    def start(self, timeout: float = 30.0) -> None:
        ready = threading.Event()

        def run() -> None:
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self._boot())
            ready.set()
            self.loop.run_forever()

        self._thread = threading.Thread(
            target=run, name="cluster-harness", daemon=True
        )
        self._thread.start()
        if not ready.wait(timeout):
            raise TimeoutError("cluster harness failed to start")

    async def _boot(self) -> None:
        for i in range(self.n_dispatchers):
            d = DispatcherService(
                i + 1, self.host, 0,
                desired_games=self.desired_games,
                desired_gates=self.n_gates,
            )
            self.dispatchers.append(d)
            self._tasks.append(asyncio.ensure_future(d.serve()))
            await d.started.wait()
            self.dispatcher_addrs.append((self.host, d.bound_port))
        for i in range(self.n_gates):
            ws_port = 0
            if self.with_ws:
                import socket

                with socket.socket() as s:
                    s.bind((self.host, 0))
                    ws_port = s.getsockname()[1]
            ssl_ctx = None
            if self.tls_dir is not None:
                import os

                from goworld_tpu_torch.net import transport

                cert = os.path.join(self.tls_dir, "gate_tls.crt")
                key = os.path.join(self.tls_dir, "gate_tls.key")
                transport.ensure_self_signed_cert(cert, key)
                ssl_ctx = transport.server_ssl_context(cert, key)
            g = GateService(
                i + 1, self.host, 0, list(self.dispatcher_addrs),
                ws_port=ws_port,
                kcp_port=-1 if self.with_kcp else 0,
                heartbeat_timeout=self.heartbeat_timeout,
                position_sync_interval_ms=self.position_sync_interval_ms,
                compress=self.compress,
                ssl_context=ssl_ctx,
                exit_on_dispatcher_loss=self.gate_exit_on_dispatcher_loss,
                **self.gate_kwargs,
            )
            self.gates.append(g)
            self._tasks.append(asyncio.ensure_future(g.serve()))
            await g.started.wait()
            self.gate_addrs.append((self.host, g.bound_port))
            if self.with_kcp:
                self.gate_kcp_addrs.append((self.host, g.bound_kcp_port))
            if ws_port:
                self.gate_ws_addrs.append((self.host, ws_port))

    def submit(self, coro: Coroutine) -> Future:
        """Run a coroutine (e.g. a bot) on the harness loop."""
        assert self.loop is not None
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self) -> None:
        from goworld_tpu_torch.net.loops import drain_and_close

        drain_and_close(self.loop, self._thread)
