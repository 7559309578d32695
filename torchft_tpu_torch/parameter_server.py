"""Prototype fault-tolerant parameter server on reconfigurable process
groups.

Counterpart of ``torchft_tpu/parameter_server.py:36-174``. No lighthouse
is involved: an HTTP handshake (``POST /new_session``) creates a
per-client *session*, each backed by a fresh two-member
``ProcessGroupHost`` (server rank 0, client rank 1) that meets through the
server's ``KvStoreServer`` under a session-unique prefix. The handler
thread runs the server's half of the session, so a live session costs one
thread and a failure stays inside its session: a dead client tears down
only its own process group. The session's setup (the configure) is bounded
by the server's ``timeout``: a client that handshakes and never configures
is aborted, not waited for.

Subclass it and implement ``forward()`` with the per-session protocol (for
example broadcast the parameters, then sum a gradient push)::

    class MyPS(ParameterServer):
        def forward(self, rank, pg):     # the server: rank 0
            pg.broadcast([params], root=0).get_future().wait()

    ps = MyPS(port=0)
    pg = ParameterServer.new_session(ps.address())   # a client: rank 1
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import urllib.request
import uuid
from abc import ABC, abstractmethod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.process_group import ProcessGroup, ProcessGroupHost
from torchft_tpu_torch.retry import RetryPolicy, retry_call

logger = logging.getLogger(__name__)

__all__ = ["ParameterServer"]


class ParameterServer(ABC):
    """Abstract fault-tolerant parameter server (module docstring)."""

    def __init__(self, port: int = 0, timeout: float = 60.0) -> None:
        self._timeout = timeout
        self._store = KvStoreServer("0.0.0.0:0")
        store_port = self._store.port
        self._sessions_lock = threading.Lock()
        self._sessions_live = 0
        ps = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, format: str, *args: object) -> None:  # noqa: A002
                logger.debug("ps http: " + format, *args)

            def do_POST(self) -> None:  # noqa: N802 - http.server API
                if self.path != "/new_session":
                    self.send_error(404)
                    return
                session_id = str(uuid.uuid4())
                store_addr = f"{socket.gethostname()}:{store_port}/session/{session_id}"
                body = json.dumps({"session_id": session_id, "store_addr": store_addr}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                self.wfile.flush()
                # this handler thread runs the session's server half
                pg = ProcessGroupHost(timeout=ps._timeout)
                # a hard deadline on the session's SETUP: a client that
                # handshakes and never configures would hold this thread for
                # as long as the rendezvous blocks. forward() is the user's
                # protocol and bounds itself through the process group, so
                # the watchdog is cancelled once configure returns
                watchdog = threading.Timer(ps._timeout, pg.abort)
                watchdog.daemon = True
                with ps._sessions_lock:
                    ps._sessions_live += 1
                try:
                    watchdog.start()
                    try:
                        pg.configure(store_addr, 0, 2, quorum_id=0)
                    finally:
                        watchdog.cancel()
                    ps.forward(0, pg)
                except Exception:  # noqa: BLE001 - one session's failure is its own
                    logger.exception("session %s failed", session_id)
                finally:
                    pg.shutdown()
                    with ps._sessions_lock:
                        ps._sessions_live -= 1

        self._server = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name="ps_http")
        self._thread.start()

    def address(self) -> str:
        return f"http://{socket.gethostname()}:{self._server.server_port}"

    def active_sessions(self) -> int:
        """Sessions holding a handler thread (in setup or ``forward()``)."""
        with self._sessions_lock:
            return self._sessions_live

    @classmethod
    def new_session(cls, address: str, timeout: float = 60.0,
                    retry_policy: Optional[RetryPolicy] = None) -> ProcessGroup:
        """Client side: open a session against a running server and return
        its configured two-member process group, the caller rank 1.

        The handshake retries under ``TORCHFT_RETRY_*`` (``retry_policy``
        overrides it): a connection refused while the server is still
        binding its port is a backoff, not a failure. ``timeout`` bounds the
        handshake's attempts together and then the configure."""
        policy = retry_policy if retry_policy is not None else RetryPolicy.from_env()

        def handshake(remaining: float) -> dict:
            with urllib.request.urlopen(
                urllib.request.Request(f"{address}/new_session", method="POST"),
                timeout=max(remaining, 0.05),
            ) as resp:
                return json.loads(resp.read().decode())

        info = retry_call(handshake, policy=policy, timeout=timeout,
                          retryable=(OSError, TimeoutError, ValueError),
                          # a refused or reset connect usually means the server
                          # (re)started: full jitter spreads the reconnects
                          full_jitter_on=(ConnectionError,))
        pg = ProcessGroupHost(timeout=timeout)
        pg.configure(info["store_addr"], 1, 2, quorum_id=0)
        return pg

    @abstractmethod
    def forward(self, rank: int, pg: ProcessGroup) -> None:
        """The per-session protocol, run with the session's process group
        configured; ``rank`` is 0 on the server's handler thread."""

    def shutdown(self) -> None:
        self._server.shutdown()
        # shutdown() only stops serve_forever: release the listening port
        self._server.server_close()
        self._store.shutdown()
