"""Shared stdlib HTTP-server plumbing (one definition, two servers).

The observability exposition server (``obs/http.py``) and the serving
front door / replica RPC servers (``serving/api/``) are all the same
shape: a ``ThreadingHTTPServer`` on a daemon thread, bound to an
ephemeral-capable ``(host, port)``, with JSON-bodied handlers that
silence the per-request stderr log. This module is that shape, factored
once:

- :class:`JsonHandler` — ``BaseHTTPRequestHandler`` with the ``_send``/
  ``_send_json`` helpers (Content-Length always set, so clients never
  wait on a dangling socket) and the silent ``log_message``.
- :class:`HttpDaemon` — owns a ``ThreadingHTTPServer`` + daemon serving
  thread with idempotent ``start()``/``stop()`` and ``port``/``url``
  properties that resolve port-0 ephemeral binds (the test idiom).

Subclasses add routes by overriding ``do_GET``/``do_POST``; servers add
state by passing attributes through :meth:`HttpDaemon.__init__`'s
``context`` dict (exposed on the HTTP server object, reachable from a
handler as ``self.server.context``) — handler classes stay stateless
per the ``http.server`` contract.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

__all__ = ["HttpDaemon", "JsonHandler"]


class JsonHandler(BaseHTTPRequestHandler):
    """Request-handler base: byte/JSON senders + silenced access log."""

    server_version = "fleetx/1"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        """One complete response: status, Content-Type/Length, body."""
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload) -> None:
        """JSON-encode ``payload`` and send it with ``code``."""
        self._send(code, json.dumps(payload).encode(),
                   "application/json; charset=utf-8")

    def _read_body(self) -> bytes:
        """The request body per its Content-Length (b"" when absent)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = 0
        return self.rfile.read(length) if length > 0 else b""

    def _read_json(self):
        """Parse the request body as JSON ({} for an empty body);
        malformed JSON raises ``ValueError`` for the caller's 400."""
        body = self._read_body()
        if not body:
            return {}
        try:
            return json.loads(body)
        except json.JSONDecodeError as e:
            raise ValueError(f"request body is not valid JSON: {e}")

    def log_message(self, format, *args):  # noqa: A002 — http.server API
        """Silence per-request stderr lines (scrapes/streams every few
        seconds would otherwise flood workload logs)."""


class HttpDaemon:
    """A ``ThreadingHTTPServer`` on a daemon thread: started once,
    stoppable, ephemeral-port friendly. ``context`` entries become
    attributes on the underlying server's ``context`` dict so handlers
    reach shared state via ``self.server.context[...]``."""

    def __init__(self, handler_cls, port: int = 0, host: str = "127.0.0.1",
                 context: Optional[Dict] = None, thread_name: str =
                 "fleetx-http"):
        self._server = ThreadingHTTPServer((host, port), handler_cls)
        self._server.daemon_threads = True
        self._server.context = dict(context or {})
        self._thread: Optional[threading.Thread] = None
        self._thread_name = thread_name
        self.host = host

    @property
    def server(self) -> ThreadingHTTPServer:
        """The underlying stdlib server (handlers see it as
        ``self.server``)."""
        return self._server

    @property
    def port(self) -> int:
        """Actual bound port (resolves port-0 ephemeral binds)."""
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        """Base URL of the (running or startable) server."""
        return f"http://{self.host}:{self.port}"

    def start(self) -> "HttpDaemon":
        """Serve on a daemon thread; returns self. Idempotent."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name=self._thread_name, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the listener down and join the serving thread."""
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
