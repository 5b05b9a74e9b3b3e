"""Device meshes for the row-sharded decode.

Port of the reference's `etl_tpu/parallel/mesh.py`. The reference lifts
its decode program onto a `jax.sharding.Mesh`: rows block-sharded over
the `sp` axis, the same program on every shard, no collective on the
forward path (its `ir-collective` contract holds that). The port keeps
JAX's single-controller model without JAX: one process drives every
shard. A `DecodeMesh` is a list of per-shard devices, and a device may
repeat — that is how one card holds 8 shards, as the reference's tests
force 8 virtual CPU devices. `DeviceDecoder(mesh=…)` (ops/engine.py)
packs a batch once, splits its rows into `mesh.size` contiguous blocks
and launches the existing kernels on each block, on the current stream
of its shard's device; nothing crosses from one block to another, so no
`torch.distributed` call is needed or made.

`decode_mesh()` over the devices that exist is None on a host with one
card (as the reference's is on one device): the decoder then runs on its
one device exactly as before.
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch


class DecodeMesh:
    """Devices laid out along named axes: `axis_names` (("sp",) or
    ("dp", "sp")), `devices` (a list of `torch.device`, nested one level
    for 2D), `shape` ({axis: size}) and `size` (the shard count). `flat`
    lists the devices in row-major order, shard s on `flat[s]`."""

    __slots__ = ("axis_names", "devices", "shape", "size", "flat")

    def __init__(self, devices: list, axis_names: tuple):
        if len(axis_names) == 1:
            flat = list(devices)
            dims = (len(flat),)
        elif len(axis_names) == 2:
            if not devices or any(len(row) != len(devices[0])
                                  for row in devices):
                raise ValueError("a 2D mesh needs rows of one length")
            flat = [d for row in devices for d in row]
            dims = (len(devices), len(devices[0]))
        else:
            raise ValueError(f"unsupported mesh axes {axis_names!r}")
        self.axis_names = tuple(axis_names)
        self.devices = devices
        self.flat = flat
        self.shape = dict(zip(self.axis_names, dims))
        self.size = len(flat)

    def __repr__(self) -> str:
        return f"DecodeMesh({self.shape}, {[str(d) for d in self.flat]})"


def _device(d) -> torch.device:
    return d if isinstance(d, torch.device) else torch.device(d)


def check_devices(devices: Sequence) -> list:
    """The devices as `torch.device`s; raises where one is not on this
    host (a CUDA index past `torch.cuda.device_count()`, or any CUDA
    device without CUDA) or is neither a CPU nor a CUDA device."""
    out = [_device(d) for d in devices]
    for d in out:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: no CUDA device is "
                                   f"available")
            index = 0 if d.index is None else d.index
            if index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"mesh device {d}: this host has "
                    f"{torch.cuda.device_count()} CUDA device(s)")
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh device {d}")
    return out


def _cards() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_cache_key(mesh: "DecodeMesh | None") -> "tuple | None":
    """Canonical, hashable fingerprint of a mesh for signature keys
    (program_store.record_observed): axis names, shape, and one
    (type, index) per shard. Two mesh objects over the same devices and
    axes fingerprint equal; meshes over different device lists — or a
    mesh and none — never do, so a mesh dispatch and a single-device
    dispatch of one layout never share a signature."""
    if mesh is None:
        return None
    return (mesh.axis_names, tuple(mesh.shape.values()),
            tuple((d.type, d.index) for d in mesh.flat))


def decode_mesh(devices: "Sequence | None" = None) -> "DecodeMesh | None":
    """1D row-sharding mesh ("sp",) for the production decoder
    (`DeviceDecoder(mesh=…)`): over every CUDA card, or over `devices`
    (repeats allowed: `[cuda:0] * 8` is 8 shards on one card); None
    under 2 shards."""
    devs = _cards() if devices is None else check_devices(devices)
    if len(devs) < 2:
        return None
    return DecodeMesh(devs, ("sp",))


def shard_mesh(n_shards: int = 8, device: str = "cuda") -> DecodeMesh:
    """An `n_shards` mesh over the devices at hand of one type: the CUDA
    cards taken round robin (8 shards on one card, one a card on 8), or
    the CPU repeated — the port's counterpart of the reference's forced
    8-device host mesh. Raises where the type has no device."""
    if n_shards < 2:
        raise ValueError("a mesh needs at least 2 shards")
    if torch.device(device).type == "cuda":
        cards = _cards()
        if not cards:
            raise RuntimeError("shard_mesh(device='cuda'): no CUDA device "
                               "is available")
        devs = [cards[s % len(cards)] for s in range(n_shards)]
    else:
        devs = check_devices([device] * n_shards)
    return DecodeMesh(devs, ("sp",))


_DEFAULT_MESH: "list | None" = None
# decoders are built on the event loop and on executor threads (the
# pipeline's prewarm); the lock keeps the lazy init single-flight so every
# caller shares one mesh object
_DEFAULT_MESH_LOCK = threading.Lock()


def default_decode_mesh() -> "DecodeMesh | None":
    """Cached `decode_mesh()` over the CUDA cards — what a CUDA
    `DeviceDecoder` uses with `mesh="auto"`. Thread-safe."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        with _DEFAULT_MESH_LOCK:
            if _DEFAULT_MESH is None:
                _DEFAULT_MESH = [decode_mesh()]
    return _DEFAULT_MESH[0]


def make_mesh(devices: "Sequence | None" = None,
              dp: "int | None" = None) -> DecodeMesh:
    """A 2D ("dp", "sp") mesh over the given devices (default: every
    CUDA card). `dp` defaults to the largest power-of-two split ≤ √n that
    divides n, so both axes are populated — the reference's rule."""
    devs = _cards() if devices is None else check_devices(devices)
    n = len(devs)
    if not n:
        raise ValueError("make_mesh: no devices")
    if dp is None:
        dp = 1
        while dp * 2 <= max(1, int(n**0.5)) and n % (dp * 2) == 0:
            dp *= 2
        if n % dp:
            dp = 1
    sp = n // dp
    if not sp:
        raise ValueError(f"make_mesh: dp={dp} exceeds {n} devices")
    rows = [devs[r * sp:(r + 1) * sp] for r in range(dp)]
    return DecodeMesh(rows, ("dp", "sp"))
