"""Minutes-long LIVE-path session: scanner CLI vs a paced rtl_tcp server.

VERDICT r4 #7: the rtl_tcp client is protocol-complete and loopback
unit-tested, but no sustained live run was on record.  This tool stands
up a simulated-remote rtl_tcp SERVER (the real wire protocol: 12-byte
header, 5-byte commands, cu8 payload) that streams synthesized PMR446
band traffic at the true real-time rate (1.024 Msps = 2.048 MB/s) with a
repeating traffic script — transmissions on different channels with
different CTCSS codes, squelch-closed gaps between them — then drives
the ACTUAL scanner CLI (apps/sdr_pmr446.py) against it for the requested
minutes with the live audio sink, and reports the session: events seen,
bytes served, sustained input rate, audio seconds written.

Zero egress means "remote" is 127.0.0.1; everything above the socket is
the deployment path (io/rtl_tcp.py reconnect/stall logic included).

    python tools/live_session.py [--minutes 3] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

RATE = 1_024_000
#: traffic script, looped: (channel | 0 for silence, ctcss code, seconds)
SCRIPT = [(5, 12, 6.0), (0, 0, 3.0), (9, 20, 5.0), (0, 0, 2.0),
          (2, 3, 4.0), (0, 0, 4.0)]


def _build_pool():
    """Pre-rendered cu8 byte segments for the traffic script."""
    import numpy as np
    from sdr_pmr446_tpu.io import synth
    pool = []
    rng = np.random.default_rng(7)
    for ch, code, secs in SCRIPT:
        n = int(secs * RATE)
        if ch == 0:
            iq = 2e-3 * (rng.standard_normal(n)
                         + 1j * rng.standard_normal(n))
        else:
            iq = 0.6 * synth.make_scanner_iq(n, channel=ch,
                                             ctcss_code=code, seed=ch)
        inter = np.empty(2 * len(iq), np.float32)
        inter[0::2] = np.real(iq)
        inter[1::2] = np.imag(iq)
        raw = np.clip(inter * 127.5 + 127.5, 0, 255).astype(np.uint8)
        pool.append(raw.tobytes())
    return pool


class PacedRtlTcpServer(threading.Thread):
    """rtl_tcp wire server pacing cu8 bytes at real time."""

    def __init__(self, pool, stop_evt):
        super().__init__(daemon=True)
        self.pool = pool
        self.stop_evt = stop_evt
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.bytes_served = 0
        self.commands = []

    def run(self):
        from sdr_pmr446_tpu.io.rtl_tcp import MAGIC
        conn, _ = self.sock.accept()
        conn.settimeout(2.0)
        conn.sendall(MAGIC + struct.pack(">II", 5, 29))   # R820T, 29 gains

        def _drain_cmds():
            conn_nb = conn
            buf = b""
            while not self.stop_evt.is_set():
                try:
                    chunk = conn_nb.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                while len(buf) >= 5:
                    op, arg = struct.unpack(">BI", buf[:5])
                    self.commands.append((op, arg))
                    buf = buf[5:]
        threading.Thread(target=_drain_cmds, daemon=True).start()

        chunk_bytes = 2 * RATE // 8                   # 125 ms of cu8
        t0 = time.perf_counter()
        buf = b""
        seg = 0
        try:
            while not self.stop_evt.is_set():
                while len(buf) < chunk_bytes:
                    buf += self.pool[seg]
                    seg = (seg + 1) % len(self.pool)
                part, buf = buf[:chunk_bytes], buf[chunk_bytes:]
                # real-time pacing: never run ahead of the wall clock
                target = t0 + (self.bytes_served + len(part)) / (2 * RATE)
                dt = target - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
                conn.sendall(part)
                self.bytes_served += len(part)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            self.sock.close()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--minutes", type=float, default=3.0)
    p.add_argument("--out", default=os.path.join(_REPO_ROOT, "chiprun_out",
                                                 "live_session"))
    p.add_argument("--platform", default="",
                   help="JAX_PLATFORMS for the CLI subprocess (default: "
                        "JAX's own choice; this parent process stays off "
                        "JAX, so the CLI is the one process on the card)")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)

    print("live_session: rendering traffic pool...", file=sys.stderr)
    pool = _build_pool()
    stop = threading.Event()
    srv = PacedRtlTcpServer(pool, stop)
    srv.start()
    print(f"live_session: rtl_tcp server on 127.0.0.1:{srv.port}, "
          f"{args.minutes:.1f} min at {RATE} S/s", file=sys.stderr)

    wav = os.path.join(args.out, "live.wav")
    env = dict(os.environ, PYTHONPATH=_REPO_ROOT)
    if args.platform:
        env["JAX_PLATFORMS"] = args.platform
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sdr_pmr446_tpu.apps.sdr_pmr446",
         "--input", f"rtl_tcp://127.0.0.1:{srv.port}",
         "--seconds", str(args.minutes * 60.0),
         "--subchunks-per-step", "5", "-p", "max",
         "--output", wav],
        env=env, cwd=_REPO_ROOT, capture_output=True, text=True,
        timeout=args.minutes * 60 + 600)
    wall = time.perf_counter() - t0
    stop.set()
    open(os.path.join(args.out, "events.log"), "w").write(proc.stderr)

    events = [ln for ln in proc.stderr.splitlines()
              if any(k in ln for k in ("Tuned", "Detuned", "Acquired",
                                       "Changed", "Lost"))]
    n_served = srv.bytes_served // 2
    report = {
        "minutes": args.minutes,
        "rc": proc.returncode,
        "samples_served": n_served,
        "sustained_Msps_wire": round(n_served / wall / 1e6, 4),
        "wall_s": round(wall, 1),
        "events": len(events),
        "tuned": sum("Tuned to" in e for e in events),
        "ctcss": sum("Acquired CTCSS" in e for e in events),
        "detuned": sum("Detuned" in e for e in events),
        "server_commands": srv.commands[:6],
        "wav_bytes": os.path.getsize(wav) if os.path.exists(wav) else 0,
    }
    print(json.dumps(report))
    for e in events[:12]:
        print("  " + e.split("] ")[-1], file=sys.stderr)
    return 0 if proc.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
