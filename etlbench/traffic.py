"""The traffic generator's shared parts. A mix is a data file
(`traffic/<name>.json`); its `kind` names the module that drives it
(`kinds/<kind>.py`), its `destination` the destination the pipeline
writes into (`destinations/<name>.py`). A driver gives `setup()` (inputs
from the seed, the pipeline started, the warm-up: a warm-up that does not
finish in `WARMUP_S` fails the run), `mark()` (the work done so far),
`rate(a, b, seconds)` (the end-to-end rates), `close()`, `release()`,
`check(control)` (the numbers compared, and `detail`) and `readings()`
(what else the traced window's readers may read, or {}).
"""

from __future__ import annotations

import asyncio

from . import spec, system

#: how long delivery may trail the window's close before rows count lost
DRAIN_S = 60.0
#: how long the warm-up may take before the run fails
WARMUP_S = 300.0


class Running:
    """One started Pipeline, watched for failure."""

    def __init__(self, db, sink, settings: dict, pipeline_id: int,
                 device: str):
        self.pipe, self.store = system.pipeline(db, sink, settings,
                                                pipeline_id, device)
        self._watch = None

    async def start(self) -> None:
        await self.pipe.start()
        self._watch = asyncio.ensure_future(self.pipe.wait())

    def check(self) -> None:
        """Raise if the pipeline has stopped on its own."""
        if self._watch is not None and self._watch.done():
            self._watch.result()
            raise RuntimeError("the pipeline stopped")

    async def ready(self, table_ids: list) -> None:
        from etl_tpu_torch.models.table_state import TableStateType

        waits = [self.store.notify_on(t, TableStateType.READY)
                 for t in table_ids]
        done = asyncio.ensure_future(asyncio.gather(*waits))
        try:
            while not done.done():
                self.check()
                await asyncio.wait({done}, timeout=0.05)
            done.result()
        finally:
            done.cancel()
            # a cancelled wait leaves no exception unretrieved
            done.add_done_callback(lambda f: f.cancelled() or f.exception())

    async def stop(self) -> None:
        await self.pipe.shutdown()
        if self._watch is not None:
            await self._watch


def destination(mix: dict, span=None):
    """A fresh destination of the kind the mix names."""
    return spec.destination(mix["destination"]).make(span)


def driver(cell, seed: int, device: str, scale: float = 1.0, span=None):
    """The driver of the cell's mix; `scale` < 1 shrinks it for the CPU
    tests."""
    return spec.kind(cell.traffic["kind"]).Driver(cell, seed, device, scale,
                                                  span)


def suffix(cell) -> str:
    """The suffix of the per-layer metrics the cell's kind reports."""
    return spec.kind(cell.traffic["kind"]).SUFFIX
