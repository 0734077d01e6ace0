"""Wire-protocol versioning for the intra-node worker handshake.

Role of the reference's ``_private/protocol.py``: every hello carries an
explicit protocol version, and a listener that sees another version (or
a malformed hello) rejects the dial with a clear error instead of
failing later on a shape mismatch. The port has only the intra-node
worker attach (a worker process dialing back to its pool); the
reference's proto3 envelopes serve its remote daemons and clients, which
are not ported, so the port's hello stays a versioned tuple.
"""

from __future__ import annotations

from typing import Optional, Tuple

PROTOCOL_VERSION = 3


def make_hello(*fields) -> tuple:
    """A versioned hello: ("hello", PROTOCOL_VERSION, *fields)."""
    return ("hello", PROTOCOL_VERSION) + fields


def split_hello(hello) -> Tuple[Optional[int], tuple]:
    """(version, fields) of a received hello; version None for a
    malformed sender."""
    if not (isinstance(hello, tuple) and len(hello) >= 2
            and hello[0] == "hello"):
        return None, ()
    if not isinstance(hello[1], int) or isinstance(hello[1], bool):
        return None, tuple(hello[1:])
    return hello[1], tuple(hello[2:])


def mismatch_error(listener: str, version: Optional[int]) -> tuple:
    """The rejection reply a listener sends before closing the dial."""
    got = "a malformed hello" if version is None \
        else f"protocol v{version}"
    return ("error",
            f"protocol version mismatch: {listener} speaks "
            f"v{PROTOCOL_VERSION}, peer sent {got}; run one "
            "ray_tpu_torch version in every process")
