"""Standalone Prometheus scrape endpoint.

The sidecar already serves ``GET /metrics`` on its API port; this tiny
asyncio server exposes the same registry on a *separate* port
(``launch.sidecar --metrics-port``) so operators can firewall the scrape
surface away from the request path — the usual fleet convention.

    srv = MetricsServer(observability, port=9090)
    await srv.start()
    ...
    await srv.stop()

Routes: ``GET /metrics`` (text exposition 0.0.4) and ``GET /`` (a
one-line pointer).  Anything else is 404.  Stdlib-only.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from repro_torch.serving.observability import Observability

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Minimal HTTP/1.1 close-after-response scrape server."""

    def __init__(self, obs: Observability, host: str = "127.0.0.1",
                 port: int = 0):
        self.obs = obs
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
            except asyncio.TimeoutError:
                return
            parts = line.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain headers
            while True:
                h = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if h in (b"\r\n", b"\n", b""):
                    break
            if path.split("?")[0] == "/metrics":
                body = self.obs.render_metrics().encode()
                status, ctype = "200 OK", CONTENT_TYPE
            elif path == "/":
                body = b"clairvoyant metrics: scrape /metrics\n"
                status, ctype = "200 OK", "text/plain; charset=utf-8"
            else:
                body = b"not found\n"
                status, ctype = "404 Not Found", "text/plain; charset=utf-8"
            writer.write((f"HTTP/1.1 {status}\r\n"
                          f"Content-Type: {ctype}\r\n"
                          f"Content-Length: {len(body)}\r\n"
                          f"Connection: close\r\n\r\n").encode())
            writer.write(body)
            await writer.drain()
        except (ConnectionError, asyncio.TimeoutError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass
