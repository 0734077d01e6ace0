"""Closing a ``multiprocessing.connection.Listener`` that a thread blocks
in ``accept()`` on.

On Linux, closing a listening socket does not wake a thread blocked in
``accept()`` on it: the thread stays parked for the life of the process.
``shutdown(SHUT_RDWR)`` on the socket does (``accept`` fails with EINVAL),
so the accept loop sees its error, finds its owner closed, and returns;
then the thread is joined. The reference closes its listeners without
this, and its accept threads outlive ``shutdown()``.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

JOIN_TIMEOUT_S = 5.0


def close_listener(listener, thread: Optional[threading.Thread] = None,
                   timeout_s: float = JOIN_TIMEOUT_S) -> None:
    """Wake ``thread``'s blocked ``accept``, close ``listener``, and join
    ``thread`` (unless it is the caller)."""
    sock = getattr(getattr(listener, "_listener", None), "_socket", None)
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass                  # already shut, or never listening
    try:
        listener.close()
    except OSError:
        pass
    if thread is not None and thread is not threading.current_thread():
        thread.join(timeout_s)
