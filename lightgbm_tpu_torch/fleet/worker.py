"""Fleet worker process: one PredictServer on an SO_REUSEPORT socket.

Port of ``lightgbm_tpu/fleet/worker.py`` (host code, copied). The worker
starts CUDA and loads its model on its own device (``device_type`` in the
forwarded parameters picks the CPU).

Spawned by :class:`~.replica.WorkerReplica` as::

    python -m lightgbm_tpu_torch.fleet.worker <model_path> <port> [key=value ...]

Every worker binds the SAME ``<port>`` with ``SO_REUSEPORT``, so raw client
connections are spread across workers by the kernel's socket load balancing
— the classic CPU scale-out shape — while the pool keeps one private routed
connection per worker for least-outstanding routing and control commands.
Each worker is a full PredictServer speaking the newline protocol
(server.handle_line), so ``!publish`` / ``!canary`` / ``!stats`` all work
per-worker.

The worker prints exactly one line on stdout once it is serving::

    FLEET_WORKER_READY port=<port> ctl_port=<ctl> obs_port=<obs> pid=<pid>

``ctl_port`` is a second, per-worker listening socket for the pool's
routed connection: a connection to the shared data port is balanced by the
kernel and may land on ANY worker, which is fine for data traffic but
would misroute control fan-out (``!publish`` to worker 1 landing on
worker 0 double-publishes one and leaves the other stale).

``obs_port`` is an always-on ephemeral ObsServer (even when the config's
``obs_port`` is 0) so the pool's health prober has a ``/healthz`` to hit.
"""
from __future__ import annotations

import os
import socket
import sys
import threading


def _serve_conn(server, conn, stop: threading.Event) -> None:
    """One client connection: newline protocol until EOF or !quit."""
    from ..server import handle_line
    f = conn.makefile("rwb")
    try:
        while not stop.is_set():
            raw = f.readline()
            if not raw:
                return
            resp = handle_line(server,
                               raw.decode("utf-8", errors="replace"))
            if resp is None:
                stop.set()
                return
            f.write((resp + "\n").encode())
            f.flush()
    except (OSError, ValueError):
        pass
    finally:
        try:
            conn.close()
        except OSError:
            pass


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        print("usage: python -m lightgbm_tpu_torch.fleet.worker "
              "<model_path> <port> [key=value ...]", file=sys.stderr)
        return 2
    model_path, port = argv[0], int(argv[1])
    from ..config import Config, params_to_config
    conf = params_to_config(Config.str2map(argv[2:]))
    from ..server import PredictServer
    server = PredictServer(conf, model=model_path)
    # health endpoint for the pool prober: reuse the config-driven ObsServer
    # when one started, else force an ephemeral one
    obs_srv = server._obs_http
    own_obs = obs_srv is None
    if own_obs:
        from ..obs.http_server import ObsServer
        obs_srv = ObsServer(port=0).start()
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if hasattr(socket, "SO_REUSEPORT"):
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind(("127.0.0.1", port))
    sock.listen(128)
    sock.settimeout(0.5)
    # control socket on a unique ephemeral port: connections to the shared
    # SO_REUSEPORT data port are balanced by the KERNEL, so a "connection
    # to worker N" may land on any worker — fine for data traffic, fatal
    # for control fan-out (a !publish meant for worker 1 that lands on
    # worker 0 double-publishes one and leaves the other stale). The pool's
    # routed connection targets this per-worker port instead.
    ctl = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ctl.bind(("127.0.0.1", 0))
    ctl.listen(16)
    ctl.settimeout(0.5)

    # the ready line is the ONLY stdout the worker produces (logs go to
    # stderr): the pool parses it to learn the ports before first probe
    print(f"FLEET_WORKER_READY port={sock.getsockname()[1]} "
          f"ctl_port={ctl.getsockname()[1]} "
          f"obs_port={obs_srv.port} pid={os.getpid()}", flush=True)
    stop = threading.Event()

    def _accept_loop(s):
        while not stop.is_set():
            try:
                conn, _ = s.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=_serve_conn,
                             args=(server, conn, stop),
                             daemon=True).start()

    try:
        th = threading.Thread(target=_accept_loop, args=(ctl,), daemon=True)
        th.start()
        _accept_loop(sock)
    finally:
        sock.close()
        ctl.close()
        server.close()
        if own_obs:
            obs_srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
