"""Small networking helpers shared by the CLIs, the supervisor and the tests
(counterpart of `coskad_tpu/utils/net.py`)."""

from __future__ import annotations

import socket

# The exit code of a rank 0 whose coordinator port was taken by another
# process before it could bind it (EX_TEMPFAIL): a port collision, which the
# supervisor retries on a fresh port without spending its restart budget.
PORT_IN_USE_EXIT = 75


def free_port(host: str = "") -> int:
    """Bind port 0 and return the port the kernel chose. Another process may
    take it before the caller binds it: rank 0 then exits with
    PORT_IN_USE_EXIT, and the supervisor picks another."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
