"""The fleet-children test under load: F5's reproduction (ROADMAP.md,
queue 3).

Runs `tests/test_torch_fleet.py::TestOrchestratorFleetRuntime::
test_create_resize_delete_over_local_children` `--runs` times at once,
`--rounds` times over, beside `--spinners` busy processes and one process
opening `--churn` short TCP connections a second to a local listener,
each closed by the client first, so their ports sit in TIME_WAIT (the
connection churn of many tests at once under `pytest -n 6`). Prints one
line a round and a last JSON line with the passes; every process it
starts is stopped before it exits.

    python tests/torch_fleet_under_load.py [--repo DIR] [--rounds 2]
        [--runs 6] [--spinners 6] [--churn 200]

Not collected by pytest (no `test_` prefix): it takes minutes.
"""

import argparse
import json
import os
import subprocess
import sys
import time

TEST = ("tests/test_torch_fleet.py::TestOrchestratorFleetRuntime::"
        "test_create_resize_delete_over_local_children")

SPIN = "while True: pass"

CHURN = """
import socket, sys, threading, time
rate = float(sys.argv[1])
srv = socket.socket()
srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
srv.bind(("127.0.0.1", 0))
srv.listen(512)
port = srv.getsockname()[1]

def serve():
    while True:
        c, _ = srv.accept()
        try:
            c.recv(16)
        finally:
            c.close()

threading.Thread(target=serve, daemon=True).start()
t0, n = time.monotonic(), 0
while True:
    c = socket.socket()
    try:
        c.connect(("127.0.0.1", port))
    except OSError:
        pass
    c.close()
    n += 1
    lag = t0 + n / rate - time.monotonic()
    if lag > 0:
        time.sleep(lag)
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--repo", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--runs", type=int, default=6)
    p.add_argument("--spinners", type=int, default=6)
    p.add_argument("--churn", type=float, default=200.0)
    p.add_argument("--timeout", type=float, default=400.0)
    args = p.parse_args(argv)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    load = [subprocess.Popen([sys.executable, "-c", SPIN])
            for _ in range(args.spinners)]
    if args.churn > 0:
        load.append(subprocess.Popen([sys.executable, "-c", CHURN,
                                      str(args.churn)]))
    passes = []
    try:
        time.sleep(20)  # let the churn fill TIME_WAIT
        for r in range(args.rounds):
            runs = [subprocess.Popen(
                [sys.executable, "-m", "pytest", TEST, "-q",
                 "-p", "no:cacheprovider", "-p", "no:randomly"],
                cwd=args.repo, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
                for _ in range(args.runs)]
            ok = 0
            for proc in runs:
                try:
                    out, _ = proc.communicate(timeout=args.timeout)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, _ = proc.communicate()
                if proc.returncode == 0:
                    ok += 1
                else:
                    tail = [ln for ln in out.splitlines()
                            if ln.startswith("E ")][-2:]
                    print(f"  round {r + 1}: failed: {tail}", flush=True)
            passes.append(ok)
            print(f"round {r + 1}: {ok} passed of {args.runs}", flush=True)
    finally:
        for proc in load:
            proc.kill()
            proc.wait()
    print(json.dumps({"repo": args.repo, "runs": args.runs,
                      "spinners": args.spinners, "churn": args.churn,
                      "passes": passes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
