"""Closing a ``multiprocessing.connection.Listener`` that a thread blocks
in ``accept()`` on.

On Linux, closing a listening socket does not wake a thread blocked in
``accept()`` on it: the thread stays parked for the life of the process.
``shutdown(SHUT_RDWR)`` on the socket does (``accept`` fails with EINVAL),
so the accept loop sees its error, finds its owner closed, and returns;
then the thread is joined. Where ``shutdown`` does not wake it (under
gVisor, as on the H100 host the port runs on, an ``AF_UNIX`` listener
refuses it with ENOTCONN and the accept stays blocked), one dial does: the
accept returns it, the authentication handshake fails on the closed
dial, and the loop, its owner closed, returns. The reference closes its
listeners without either, and its accept threads outlive
``shutdown()``.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

JOIN_TIMEOUT_S = 5.0
DIAL_TIMEOUT_S = 1.0


def _wake(listener) -> None:
    """Dial ``listener`` once and hang up (a refused dial is fine: the
    accept was already woken)."""
    address = getattr(listener, "address", None)
    if address is None:
        return
    family = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    try:
        with socket.socket(family) as dial:
            dial.settimeout(DIAL_TIMEOUT_S)
            dial.connect(address)
    except OSError:
        pass


def close_listener(listener, thread: Optional[threading.Thread] = None,
                   timeout_s: float = JOIN_TIMEOUT_S) -> None:
    """Wake ``thread``'s blocked ``accept``, close ``listener``, and join
    ``thread`` (unless it is the caller). The owner marks itself closed
    first, so the woken accept loop returns."""
    sock = getattr(getattr(listener, "_listener", None), "_socket", None)
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass                  # already shut, or never listening
    joinable = thread is not None and thread is not threading.current_thread()
    if joinable and thread.is_alive():
        _wake(listener)
    try:
        listener.close()
    except OSError:
        pass
    if joinable:
        thread.join(timeout_s)
