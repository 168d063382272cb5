"""Seconds to move one table across a process pool's pipe: the analytic's
4096 x 16384 float32 training waveforms (256 MiB), as a registration
carries them to a worker, sent with ``multiprocessing``'s own
``Connection.send``/``recv`` and with the pool's framing
(``core.procpool._send_msg``/``_recv_msg``: the pickle in one message, the
array's bytes read into one preallocated block), in turns.  Prints one
JSON line: each way's seconds per transfer (the receiver's clock, from the
first byte to the unpickled array) and their medians.

Run from the repository root:  python3 tools/pipe_rate.py [--turns N]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.procpool import _recv_msg, _send_msg  # noqa: E402

SHAPE = (4096, 16384)


def _receiver(conn, turns: int) -> None:
    """Receive ``turns`` pairs (plain, framed) and send back the seconds
    each took once its first byte was there."""
    out = {"plain": [], "framed": []}
    for _ in range(turns):
        for way in ("plain", "framed"):
            conn.poll(None)
            t0 = time.perf_counter()
            msg = conn.recv() if way == "plain" else _recv_msg(conn)
            out[way].append(time.perf_counter() - t0)
            if msg[2].shape != SHAPE or float(msg[2][1, 2]) != 16386.0:
                raise RuntimeError(f"{way}: the table arrived changed")
            conn.send("ack")
    conn.send(out)
    conn.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    a = np.arange(SHAPE[0] * SHAPE[1], dtype=np.float32).reshape(SHAPE)
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=_receiver, args=(child, args.turns))
    proc.start()
    child.close()
    for _ in range(args.turns):
        conn.send(("register", 1, a))
        conn.recv()
        _send_msg(conn, ("register", 2, a))
        conn.recv()
    out = conn.recv()
    proc.join(timeout=60)
    print(json.dumps({"mib": a.nbytes / 2 ** 20, "turns": args.turns,
                      "plain_s": out["plain"], "framed_s": out["framed"],
                      "plain_s_median": statistics.median(out["plain"]),
                      "framed_s_median": statistics.median(out["framed"])}))
    return 0 if proc.exitcode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
