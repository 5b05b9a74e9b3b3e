"""Example: run the control-plane API with the local orchestrator.

POST tenants/sources/destinations/pipelines, then
POST /v1/pipelines/1/start to launch a `python -m etl_tpu_torch.replicator`
child. Serves until SIGTERM or SIGINT:

    python -m etl_tpu_torch.examples.control_plane [--port 8080]
        [--work-dir DIR]

The bearer key is $ETL_API_KEY, else a new random one (printed).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import secrets
import signal
import tempfile

from aiohttp import web

from ..api.app import ApiState, build_app
from ..api.crypto import ConfigCipher, EncryptionKey
from ..api.orchestrator import LocalOrchestrator


async def run(port: int = 8080, work: str | None = None,
              stop: asyncio.Event | None = None) -> dict:
    """Serve the API on 127.0.0.1:`port` until `stop` is set (SIGTERM or
    SIGINT when none is given). Returns the printed lines (`lines`), the
    port and the work directory."""
    lines: list[str] = []

    def say(text: str) -> None:
        print(text, flush=True)
        lines.append(text)

    work = work or tempfile.mkdtemp(prefix="etl-api-")
    api_key = os.environ.get("ETL_API_KEY") or secrets.token_urlsafe(24)
    state = ApiState(f"{work}/api.db", ConfigCipher(EncryptionKey.generate()),
                     LocalOrchestrator(work), api_key=api_key)
    if stop is None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
    runner = web.AppRunner(build_app(state))
    await runner.setup()
    try:
        await web.TCPSite(runner, "127.0.0.1", port).start()
        say(f"control plane on http://127.0.0.1:{port} (see /openapi.json)")
        say(f"Authorization: Bearer {api_key}")
        await stop.wait()
    finally:
        await runner.cleanup()
        await state.close()
    say("control plane stopped")
    return {"lines": lines, "port": port, "work": work}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="etl_tpu_torch.examples.control_plane")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--work-dir", default=None,
                   help="the API's database and the children's files (a "
                        "new temporary directory by default)")
    args = p.parse_args(argv)
    return asyncio.run(run(args.port, args.work_dir))


if __name__ == "__main__":
    main()
