"""TCP output servers for RTCM3 / NovAtel-SBAS streams.

Equivalent of the reference's tcpsvrthread/tcpsvrstart/send (src/sdrout.c:
212-385): a listening socket accepts any number of clients; ``send``
broadcasts a message to all of them, dropping dead connections.
"""
from __future__ import annotations

import socket
import threading


class TcpServer:
    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        # port 0 = OS-assigned ephemeral port (tests under pytest-xdist
        # collide on fixed ports); expose the bound port either way
        self.port = self._srv.getsockname()[1]
        self._srv.listen()
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._clients.append(conn)

    @property
    def nclients(self) -> int:
        with self._lock:
            return len(self._clients)

    def send(self, data: bytes) -> None:
        """Broadcast to all connected clients (sdrout.c send loop)."""
        with self._lock:
            dead = []
            for c in self._clients:
                try:
                    c.sendall(data)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._clients.remove(c)
                try:
                    c.close()
                except OSError:
                    pass

    def close(self) -> None:
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()
