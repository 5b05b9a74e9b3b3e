"""Canonical-layout program store: every compiled object of the decode
path, one subsystem — layout canonicalization, disk persistence of the
built libraries, and startup prewarm.

Port of the reference's `etl_tpu/ops/program_store.py`. The reference
compiles one XLA executable per (row bucket, layout) and persists each;
the port's compiled objects are what it really builds:

- the shared libraries: the kernels (`csrc/decode_pack.cu`,
  `csrc/egress_render.cu`, built with nvcc) and the host packers and
  framer (`native/framer.c`, built with the C compiler), each one
  `Library`;
- the per-layout kernel descriptors (`decode_kernel._device_desc`): the
  kernel reads its layout from a runtime table, so a layout costs an
  upload, not a build.

Three layers:

1. **Canonicalization** (`canonical_plan`), the reference's meaning
   exactly: index erasure, a (kind, width, bit-width) sort and count
   padding to `_COUNT_BUCKETS` with all-NULL phantom slots, up to
   `MAX_SLOTS`. The engine packs unfiltered batches into their canonical
   layout, so tables whose dense columns are the same multiset share one
   descriptor and one word layout; column outputs index by schema
   position, so the decoded batch is byte-identical to the exact
   layout's. `$ETL_TPU_CANONICAL_LAYOUTS=0` switches it off.

2. **Disk persistence** (`acquire`/`try_load`/`save`). A library's entry
   lives under `<dir>/<version tag>/`: the tag hashes the format version,
   the source, the compiler flags, the compiler's `--version` output and,
   for a CUDA library, `torch.version.cuda` and the card's compute
   capability. The directory is `configure(dir)` (Pipeline.start passes
   `BatchConfig.program_cache_dir`), else `$ETL_TPU_PROGRAM_CACHE_DIR`,
   else `etl_tpu_torch/_build/`. An entry is a metadata file (format,
   key, sha256 of the library) and the library itself under a name that
   carries its digest, both written by tmp + rename: a file that may be
   mapped is never written into, and two builds of different bytes never
   share a path (glibc's dlopen hands back the handle it holds for a
   path it has loaded, without reading the file again). `try_load`
   checks the digest BEFORE dlopen, then binds; an entry that fails any
   step is deleted and counted an invalid miss, and the caller rebuilds —
   a corrupt cache degrades to a rebuild, never a crash.

3. **Prewarm** (`warm_host_programs` / `prewarm_pipeline`, called by
   Pipeline.start when a cache directory is configured): the libraries
   through `acquire`, then the stored schemas' canonical layouts deduped,
   each layout's descriptor uploaded and the pinned staging buffers of
   each row bucket allocated; the observed signatures of earlier
   lifetimes (`record_observed`) fold in. The port builds synchronously:
   `start()` awaits every build it needs, and no batch decodes on the
   oracle meanwhile (the reference compiles in the background and routes
   to its oracle until the program lands; a departure, ROADMAP.md).

Counters keep the reference's names: `etl_programs_compiled_total`
counts compiler runs, `etl_compile_cache_hits_total{layer=disk|memory}`,
`etl_compile_cache_misses_total{reason=absent|invalid}` and
`etl_compile_cache_load_seconds`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import hashlib
import json
import logging
import os
import pickle
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

log = logging.getLogger("etl_tpu_torch.ops.program_store")

# ---------------------------------------------------------------------------
# canonicalization
# ---------------------------------------------------------------------------

#: module switch for tests / emergency opt-out ($ETL_TPU_CANONICAL_LAYOUTS=0)
CANONICALIZE = os.environ.get("ETL_TPU_CANONICAL_LAYOUTS", "1") != "0"

#: per-(kind, width, bit-width) column-count ladder: ≤1.5× steps bound the
#: phantom-slot waste at 50% of a group's columns
_COUNT_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
                  256)

#: the C packers index at most 256 slots per row; a canonical layout that
#: would pad past this falls back to sort + index erasure only
MAX_SLOTS = 256


def pad_count(n: int) -> int:
    for b in _COUNT_BUCKETS:
        if n <= b:
            return b
    return n


@dataclasses.dataclass(frozen=True)
class CanonicalPlan:
    """How one exact spec tuple maps onto its canonical layout.

    specs:      canonical specs (positional col indices) — what the
                descriptor and the word layout are built from
    slot_of:    dense position j (engine `_dense` order) → canonical slot
    pack_dense: per canonical slot, the dense position whose staged
                column feeds it; phantom slots name their group's first
                real member as a pack DONOR (same kind and width, so the
                nibble packer's alphabet scan sees a byte subset of what
                the real slot already scanned) and are zeroed after the
                pack
    phantom_slots: slots that are padding (zero-length ⇒ all-NULL)
    identity:   True when slots == dense positions and nothing is padded
                (the pack path then skips the permutation; index erasure
                in `specs` still applies)
    """

    specs: tuple
    slot_of: tuple
    pack_dense: tuple
    phantom_slots: tuple
    identity: bool

    @property
    def n_slots(self) -> int:
        return len(self.specs)


_PLAN_CACHE: dict = {}
_PLAN_LOCK = threading.Lock()
#: distinct canonical layouts (spec tuples) seen this process — the
#: etl_decode_canonical_layouts gauge
_LAYOUTS_SEEN: set = set()


def _identity_plan(specs: tuple) -> CanonicalPlan:
    n = len(specs)
    pos = tuple(range(n))
    return CanonicalPlan(tuple((j, k, w, bw) for j, (_, k, w, bw)
                               in enumerate(specs)),
                         pos, pos, (), True)


def canonical_plan(specs: tuple) -> CanonicalPlan:
    """The canonical layout for one exact engine spec tuple
    ((col_index, kind, gather_width, bit_width), ...). Pure and cached —
    safe from any thread."""
    cached = _PLAN_CACHE.get(specs)
    if cached is not None:
        return cached
    n = len(specs)
    if not CANONICALIZE or n == 0:
        plan = _identity_plan(specs)
    else:
        triple = lambda j: (specs[j][1].name, specs[j][2], specs[j][3])
        order = sorted(range(n), key=lambda j: (*triple(j), j))
        groups: list = []  # [(kind, w, bw), [dense positions]]
        for j in order:
            t = triple(j)
            if groups and groups[-1][0] == t:
                groups[-1][1].append(j)
            else:
                groups.append([t, [j]])
        padded = sum(pad_count(len(members)) for _, members in groups)
        pad = padded <= MAX_SLOTS
        slot_of = [0] * n
        cspecs: list = []
        pack_dense: list = []
        phantom: list = []
        for (_, members) in groups:
            j0 = members[0]
            _, kind, w, bw = specs[j0]
            count = pad_count(len(members)) if pad else len(members)
            for i in range(count):
                slot = len(cspecs)
                cspecs.append((slot, kind, w, bw))
                if i < len(members):
                    slot_of[members[i]] = slot
                    pack_dense.append(members[i])
                else:
                    pack_dense.append(j0)  # donor: same (kind, w, bw)
                    phantom.append(slot)
        identity = not phantom and slot_of == list(range(n))
        plan = CanonicalPlan(tuple(cspecs), tuple(slot_of),
                             tuple(pack_dense), tuple(phantom), identity)
    with _PLAN_LOCK:
        _PLAN_CACHE[specs] = plan
        _LAYOUTS_SEEN.add(plan.specs)
        n_layouts = len(_LAYOUTS_SEEN)
    from ..telemetry.metrics import ETL_DECODE_CANONICAL_LAYOUTS, registry

    registry.gauge_set(ETL_DECODE_CANONICAL_LAYOUTS, n_layouts)
    return plan


# ---------------------------------------------------------------------------
# disk persistence
# ---------------------------------------------------------------------------

#: 2: the observed signature gained the mesh fingerprint (6 slots)
_CACHE_FORMAT_VERSION = 2
#: where the libraries live when no cache directory is configured
DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"
_DIR_LOCK = threading.Lock()
_CONFIGURED: list = [None]  # [str | None]; None = fall back to env


def configure(cache_dir: "str | None") -> None:
    """Set (or clear) the process-wide program cache directory.
    `Pipeline.start` calls this from `BatchConfig.program_cache_dir`;
    None restores the $ETL_TPU_PROGRAM_CACHE_DIR / default-directory
    behaviour."""
    with _DIR_LOCK:
        _CONFIGURED[0] = cache_dir


def active_dir() -> "str | None":
    """The configured cache directory, else $ETL_TPU_PROGRAM_CACHE_DIR,
    else None (the libraries then live in `DEFAULT_DIR`, and nothing is
    prewarmed or recorded)."""
    with _DIR_LOCK:
        configured = _CONFIGURED[0]
    if configured is not None:
        return configured
    return os.environ.get("ETL_TPU_PROGRAM_CACHE_DIR") or None


def store_dir() -> Path:
    """Where libraries are loaded from and saved to right now."""
    d = active_dir()
    return Path(d) if d else DEFAULT_DIR


def version_tag(*parts: str) -> str:
    """Subdirectory name under the cache dir: a hash of the format
    version and `parts`, everything that could make a stored object
    wrong. Stale populations are simply never read again."""
    raw = "|".join((f"v{_CACHE_FORMAT_VERSION}",) + tuple(parts))
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _stable_repr(obj) -> str:
    """Deterministic, process-independent rendering of a key (tuples,
    enums, primitives). Enum identity uses class+name, never the
    interpreter-dependent default repr."""
    if isinstance(obj, enum.Enum):
        return f"{type(obj).__name__}.{obj.name}"
    if isinstance(obj, tuple):
        return "(" + ",".join(_stable_repr(x) for x in obj) + ")"
    return repr(obj)


def fingerprint(key: tuple) -> str:
    return hashlib.sha256(_stable_repr(key).encode()).hexdigest()[:32]


_VERSION_OUTPUTS: dict = {}  # compiler path → its `--version` output


def compiler_version(compiler: str) -> str:
    """`<compiler> --version`, once per process and compiler."""
    with _DIR_LOCK:
        out = _VERSION_OUTPUTS.get(compiler)
    if out is None:
        res = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, timeout=60)
        out = res.stdout + res.stderr
        with _DIR_LOCK:
            _VERSION_OUTPUTS[compiler] = out
    return out


@dataclasses.dataclass(frozen=True)
class Library:
    """One compiled object of the port: `source` built with
    `[compiler(), *flags, "-o", out, source]` into a shared library, then
    loaded with ctypes and declared by `bind` (which raises when the
    library does not fit the source it claims). `cuda` libraries also
    key on `torch.version.cuda` and the card's compute capability."""

    name: str
    source: Path
    compiler: Callable[[], str]
    flags: tuple
    bind: Callable[[ctypes.CDLL], ctypes.CDLL]
    cuda: bool = False
    timeout_s: float = 900.0

    def key(self) -> tuple:
        return (self.name,)

    def tag(self) -> str:
        parts = [self.name,
                 hashlib.sha256(self.source.read_bytes()).hexdigest(),
                 " ".join(self.flags), compiler_version(self.compiler())]
        if self.cuda:
            import torch

            parts += [str(torch.version.cuda),
                      "sm_%d%d" % torch.cuda.get_device_capability()]
        return version_tag(*parts)


@dataclasses.dataclass(frozen=True)
class Acquired:
    """What `acquire` returns: the bound library, where it came from
    ("memory", "disk" or "build"), and for a build its seconds and the
    compiler's output."""

    lib: ctypes.CDLL
    source: str
    build_seconds: "float | None" = None
    build_log: str = ""


#: the memory layer: (store dir, tag, key) → the bound library. Keyed by
#: the directory too, so that a process that moves to another directory
#: loads (or builds and saves) its libraries there
_MEMORY: dict = {}
_MEM_LOCK = threading.Lock()
_KEY_LOCKS: dict = {}  # same keys → lock: one build a key in-process


def _entry_paths(key: tuple, tag: str, cache_dir: Path) -> tuple:
    d = cache_dir / tag
    return d, d / (fingerprint(key) + ".meta")


def save(key: tuple, tag: str, built: Path,
         cache_dir: "Path | None" = None) -> Path:
    """Move the freshly built library `built` (a file in the entry's
    directory) to its content-addressed name and write the entry's
    metadata, both atomically (tmp + rename). Returns the library's
    path."""
    d, meta = _entry_paths(key, tag, cache_dir or store_dir())
    digest = hashlib.sha256(built.read_bytes()).hexdigest()
    name = f"{fingerprint(key)}-{digest[:16]}.so"
    os.replace(built, d / name)
    tmp = d / f"{meta.name}.tmp.{os.getpid()}.{threading.get_ident()}"
    tmp.write_text(json.dumps({
        "format": _CACHE_FORMAT_VERSION, "key": _stable_repr(key),
        "sha256": digest, "file": name}))
    os.replace(tmp, meta)
    return d / name


def _unlink(path: Path) -> None:
    try:
        path.unlink()
    except OSError:
        pass


def try_load(key: tuple, tag: str, bind, record_absent: bool = True,
             cache_dir: "Path | None" = None):
    """Load and bind the stored library of `key` under `tag`, or None. A
    present-but-unusable entry (unreadable metadata, another key, a
    digest that does not match, a library dlopen or `bind` refuses) is
    DELETED and counted an invalid miss: the caller rebuilds cleanly.
    The digest is checked before dlopen, so a damaged file is never
    mapped. `record_absent=False` keeps a pre-probe's absent miss out of
    the counters."""
    from ..telemetry.metrics import (ETL_COMPILE_CACHE_HITS_TOTAL,
                                     ETL_COMPILE_CACHE_LOAD_SECONDS,
                                     ETL_COMPILE_CACHE_MISSES_TOTAL,
                                     registry)

    d, meta = _entry_paths(key, tag, cache_dir or store_dir())
    if not meta.exists():
        if record_absent:
            registry.counter_inc(ETL_COMPILE_CACHE_MISSES_TOTAL,
                                 labels={"reason": "absent"})
        return None
    t0 = time.perf_counter()
    try:
        data = json.loads(meta.read_bytes())
        if data.get("format") != _CACHE_FORMAT_VERSION \
                or data.get("key") != _stable_repr(key):
            raise ValueError("program cache entry does not match its key")
        digest = data["sha256"]
        name = data["file"]
        if name != f"{fingerprint(key)}-{digest[:16]}.so":
            raise ValueError("program cache entry names a foreign file")
        lib_path = d / name
        if hashlib.sha256(lib_path.read_bytes()).hexdigest() != digest:
            raise ValueError("library digest does not match its entry")
        lib = bind(ctypes.CDLL(str(lib_path)))
    except Exception:  # any damage: a counted invalid miss, then rebuild
        log.warning("corrupt/stale program cache entry %s; deleting and "
                    "rebuilding", meta, exc_info=True)
        _unlink(meta)
        for stale in d.glob(f"{fingerprint(key)}-*.so"):
            _unlink(stale)  # unlinking a mapped file is safe
        registry.counter_inc(ETL_COMPILE_CACHE_MISSES_TOTAL,
                             labels={"reason": "invalid"})
        return None
    registry.counter_inc(ETL_COMPILE_CACHE_HITS_TOTAL,
                         labels={"layer": "disk"})
    registry.histogram_observe(ETL_COMPILE_CACHE_LOAD_SECONDS,
                               time.perf_counter() - t0)
    return lib


def _build(lib: Library, tag: str) -> tuple:
    """Run the compiler into a temporary file of the entry's directory →
    (path, seconds, the compiler's output). Raises on failure."""
    from ..telemetry.metrics import ETL_PROGRAMS_COMPILED_TOTAL, registry

    d, _ = _entry_paths(lib.key(), tag, store_dir())
    d.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=d)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        registry.counter_inc(ETL_PROGRAMS_COMPILED_TOTAL)
        res = subprocess.run(
            [lib.compiler(), *lib.flags, "-o", tmp, str(lib.source)],
            capture_output=True, text=True, timeout=lib.timeout_s)
        if res.returncode != 0:
            raise RuntimeError(f"building {lib.source.name} failed "
                               f"({res.returncode}):\n{res.stderr}")
    except BaseException:
        _unlink(Path(tmp))
        raise
    return Path(tmp), time.perf_counter() - t0, res.stdout + res.stderr


def acquire(lib: Library) -> Acquired:
    """The bound library of `lib`: from memory (this process loaded it
    from the current store directory), else from disk, else built, saved
    and loaded. A build that fails, or a fresh build that does not bind,
    raises: there is no fallback."""
    from ..telemetry.metrics import ETL_COMPILE_CACHE_HITS_TOTAL, registry

    tag = lib.tag()
    mem = (str(store_dir()), tag, lib.key())
    with _MEM_LOCK:
        got = _MEMORY.get(mem)
        key_lock = _KEY_LOCKS.setdefault(mem, threading.Lock())
    if got is not None:
        registry.counter_inc(ETL_COMPILE_CACHE_HITS_TOTAL,
                             labels={"layer": "memory"})
        return Acquired(got, "memory")
    with key_lock:
        with _MEM_LOCK:
            got = _MEMORY.get(mem)
        if got is not None:
            registry.counter_inc(ETL_COMPILE_CACHE_HITS_TOTAL,
                                 labels={"layer": "memory"})
            return Acquired(got, "memory")
        got = try_load(lib.key(), tag, lib.bind)
        if got is not None:
            out = Acquired(got, "disk")
        else:
            built, seconds, text = _build(lib, tag)
            path = save(lib.key(), tag, built)
            out = Acquired(lib.bind(ctypes.CDLL(str(path))), "build",
                           seconds, text)
        with _MEM_LOCK:
            _MEMORY[mem] = out.lib
        return out


def export_entry(lib: Library, dest_dir: str) -> None:
    """Copy `lib`'s verified entry out of the current store into
    `dest_dir` (acquiring it first, so the entry exists): what a new
    process on a shared cache directory inherits. The copies are written
    by tmp + rename."""
    import shutil

    acquire(lib)
    tag = lib.tag()
    src_dir, meta = _entry_paths(lib.key(), tag, store_dir())
    if not meta.exists():  # deleted under the loaded library: build anew
        with _MEM_LOCK:
            _MEMORY.pop((str(store_dir()), tag, lib.key()), None)
        acquire(lib)
    dst_dir, dst_meta = _entry_paths(lib.key(), tag, Path(dest_dir))
    dst_dir.mkdir(parents=True, exist_ok=True)
    name = json.loads(meta.read_bytes())["file"]
    for src, dst in ((src_dir / name, dst_dir / name), (meta, dst_meta)):
        tmp = dst.with_name(f"{dst.name}.tmp.{os.getpid()}")
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)


def forget_memory() -> None:
    """Drop the memory layer (process-death semantics for the chaos
    restart scenarios and the tests): the next `acquire` reads disk."""
    with _MEM_LOCK:
        _MEMORY.clear()


# ---------------------------------------------------------------------------
# observed signatures
# ---------------------------------------------------------------------------
#
# SchemaStore enumeration prewarms the layouts the STORE knows about, with
# data-independent widths. The workload's actual layouts follow its data
# (the device route's gather and bit widths track field lengths), and
# fused-filter layouts are per table. Every dispatch records its key here
# (first sighting per process; one small atomic file per version tag), and
# `prewarm_pipeline` folds the recorded signatures into its enumeration —
# a restart uploads what the workload actually used. A key is (row
# capacity, canonical specs, nibble, mesh fingerprint (parallel/mesh.
# mesh_cache_key; None off the mesh), predicate fingerprint, route).

_OBSERVED_FILE = "observed_sigs.pkl"
_OBSERVED_LOCK = threading.Lock()
_OBSERVED_SEEN: set = set()
#: newest-last cap: a pathological signature churn (unbounded DDL
#: variety) ages out the oldest recordings instead of growing the file
_OBSERVED_MAX = 256
#: the modules whose code a recorded signature is a signature of
_SIGNATURE_SOURCES = ("ops/engine.py", "ops/bitpack.py", "ops/staging.py",
                      "ops/decode_kernel.py", "ops/predicate.py",
                      "csrc/decode_pack.cu")
_SIGNATURE_TAG: list = []  # lazy singleton


def _signature_tag() -> str:
    if not _SIGNATURE_TAG:
        base = Path(__file__).resolve().parent.parent
        h = hashlib.sha256()
        for name in _SIGNATURE_SOURCES:
            h.update(name.encode())
            h.update((base / name).read_bytes())
        _SIGNATURE_TAG.append(version_tag("observed", h.hexdigest()))
    return _SIGNATURE_TAG[0]


def _observed_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, _signature_tag(), _OBSERVED_FILE)


def load_observed() -> list:
    """The recorded observed signatures, oldest first. Corruption
    degrades to an empty list + file deletion — the same never-fatal
    stance as the library cache."""
    cache_dir = active_dir()
    if not cache_dir:
        return []
    path = _observed_path(cache_dir)
    if not os.path.exists(path):
        return []
    try:
        with open(path, "rb") as f:
            data = pickle.load(f)  # written by record_observed only
        if data.get("format") != _CACHE_FORMAT_VERSION:
            raise ValueError("observed-signature file format mismatch")
        return [k for k in data.get("keys", []) if isinstance(k, tuple)]
    except Exception:  # any damage: empty, and the file goes
        log.warning("corrupt observed-signature file %s; deleting",
                    path, exc_info=True)
        _unlink(Path(path))
        return []


def record_observed(key: tuple) -> None:
    """Persist one observed dispatch signature. Called by the engine's
    dispatch stage per batch: the disarmed cost is one set lookup; the
    first sighting per process pays a small read-merge-write of the
    signature file (atomic tmp+rename — best-effort across processes,
    last-writer-wins). No cache dir = no-op."""
    cache_dir = active_dir()
    if cache_dir is None:
        return
    with _OBSERVED_LOCK:
        if key in _OBSERVED_SEEN:
            return
        _OBSERVED_SEEN.add(key)
    try:
        path = _observed_path(cache_dir)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with _OBSERVED_LOCK:
            merged = [k for k in load_observed() if k != key] + [key]
            merged = merged[-_OBSERVED_MAX:]
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                pickle.dump({"format": _CACHE_FORMAT_VERSION,
                             "keys": merged}, f)
            os.replace(tmp, path)
    except OSError:
        log.warning("failed to record observed program signature "
                    "(prewarm coverage only; decode continues)",
                    exc_info=True)


def observed_layouts() -> dict:
    """{route: distinct canonical layouts} among the signatures this
    process dispatched (recorded with a cache dir configured): how many
    layouts the tables' batches took on each route."""
    with _OBSERVED_LOCK:
        keys = list(_OBSERVED_SEEN)
    out: dict = {}
    # a mesh dispatch's layout is its single-device twin's: one count
    for _, specs, _, _, _, route in keys:
        out.setdefault(route, set()).add(specs)
    return {route: len(s) for route, s in sorted(out.items())}


def warm_observed_signatures(device: str = "cuda") -> dict:
    """Upload the descriptor of every recorded device-route signature to
    `device` where it is a card (a host-route signature, and every
    signature on the CPU, runs a plain version, which has no
    descriptor). Synchronous — run on an executor."""
    import torch

    from . import decode_kernel

    keys = load_observed()
    dev = torch.device(device)
    if dev.type == "cuda":
        for _, specs, nibble, _, _, route in keys:
            if route == "device":
                decode_kernel._device_desc(specs, nibble, dev)
    return {"observed": len(keys), "observed_ready": len(keys)}


# ---------------------------------------------------------------------------
# prewarm
# ---------------------------------------------------------------------------

#: row-capacity buckets the pipeline prewarm warms per canonical layout:
#: the streaming seal cap's bucket plus the mid-size bucket CDC flushes
#: most often land in. Callers override per deployment
#: (BatchConfig.prewarm_row_buckets).
PREWARM_ROW_BUCKETS = (4096, 16384)


def _library_modules(device: str, egress: bool) -> list:
    """The modules whose libraries a decoder on `device` loads: the host
    packers and framer always; on a card the decode kernels, and the
    render kernel where the destination renders on the card."""
    import torch

    from .. import native

    mods = [native]
    if torch.device(device).type == "cuda":
        from . import decode_kernel, egress_kernel

        mods += [decode_kernel] + ([egress_kernel] if egress else [])
    return mods


def libraries(device: str = "cuda", egress: bool = False) -> list:
    """The `Library` of each module `_library_modules` names."""
    return [m.LIBRARY for m in _library_modules(device, egress)]


def warm_libraries(device: str = "cuda", egress: bool = False) -> dict:
    """`acquire` each of those libraries and install it as its module's
    loaded library. Returns {name: where it came from}."""
    return {m.LIBRARY.name: m.load_library().source
            for m in _library_modules(device, egress)}


def warm_host_programs(schemas, row_buckets=None, device: str = "cuda",
                       egress: bool = False) -> dict:
    """Warm what decoding `schemas` on `device` needs: the libraries
    (`warm_libraries`), then per canonical layout (deduped across schemas,
    data-independent widths) its descriptor uploaded and, on a card, the
    pinned staging buffers of each row bucket allocated. Synchronous — run
    it on an executor from async code. The port builds synchronously, so
    nothing is ever left `building` (the reference's `wait` switch has
    nothing to choose here). Returns {"layouts", "ready", "building"}."""
    import torch

    from . import decode_kernel
    from .engine import DeviceDecoder
    from .staging import ARENA_POOL

    warm_libraries(device, egress)
    dev = torch.device(device)
    buckets = tuple(row_buckets) if row_buckets else PREWARM_ROW_BUCKETS
    seen: set = set()
    ready = 0
    for schema in schemas:
        dec = DeviceDecoder(schema, device="cpu", device_min_rows=1 << 30,
                            telemetry=False)
        specs = dec._host_specs()
        if not specs:
            continue
        pspecs = canonical_plan(specs).specs
        widths = tuple(w for _, _, w, _ in pspecs)
        nibble = dec._can_nibble(widths)
        for bucket in buckets:
            key = (bucket, pspecs, nibble)
            if key in seen:
                continue
            seen.add(key)
            if dev.type == "cuda":
                decode_kernel._device_desc(pspecs, nibble, dev)
                lease = ARENA_POOL.lease()
                try:
                    lease.take((bucket, sum(widths) // (2 if nibble else 1)),
                               torch.uint8, pinned=True)
                    lease.take((bucket, len(pspecs)), torch.uint8,
                               pinned=True)
                finally:
                    lease.release()
            ready += 1
    return {"layouts": len(seen), "ready": ready, "building": 0}


def configure_pipeline(batch_config) -> None:
    """Install `batch_config.program_cache_dir` as the process's store.
    The store is PROCESS-global (the admission-capacity stance): the
    first pipeline to configure a dir fixes it; a co-resident pipeline
    asking for a different dir is a config conflict, kept out with a
    warning rather than silently re-routing the first pipeline's
    libraries."""
    wanted = batch_config.program_cache_dir
    if not wanted:
        return
    current = active_dir()
    if current and current != wanted:
        log.warning(
            "program cache dir already configured to %s for this process; "
            "ignoring %s (the store is process-global — the first pipeline "
            "to configure it wins)", current, wanted)
    else:
        configure(wanted)


async def prewarm_pipeline(store, batch_config, egress: bool = False
                           ) -> dict:
    """`Pipeline.start`'s program prewarm: enumerate the SchemaStore's
    table schemas and warm their libraries and canonical layouts before
    the apply loop sees traffic, on the default executor — never on the
    event loop. Runs iff `batch_config.prewarm_programs` (None: iff a
    cache dir is configured). A fresh pipeline (no stored schemas yet)
    still loads its libraries; a restarted one reaches its first durable
    batch without a build."""
    import asyncio

    configure_pipeline(batch_config)
    prewarm = batch_config.prewarm_programs
    if prewarm is None:
        prewarm = bool(batch_config.program_cache_dir)
    if not prewarm:
        return {}
    schemas = []
    try:
        for tid in await store.get_table_ids_with_schemas():
            s = await store.get_table_schema(tid)
            if s is not None:
                schemas.append(s)
    except Exception:  # the store's fault: warm the libraries alone
        log.warning("program prewarm: schema enumeration failed; layouts "
                    "warm at first use", exc_info=True)
        schemas = []
    loop = asyncio.get_running_loop()

    def _warm() -> dict:
        stats = warm_host_programs(schemas, batch_config.prewarm_row_buckets,
                                   device=batch_config.device, egress=egress)
        # fold in the OBSERVED signatures recorded by previous
        # incarnations: the layouts the workload's data actually took
        stats.update(warm_observed_signatures(batch_config.device))
        return stats

    stats = await loop.run_in_executor(None, _warm)
    log.info("program prewarm: %d schemas -> %s", len(schemas), stats)
    return stats


def reset_for_tests() -> None:
    """Clear the plan cache / layout gauge inputs and the observed-
    signature process guard (tests only; the libraries stay loaded)."""
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        _LAYOUTS_SEEN.clear()
    with _OBSERVED_LOCK:
        _OBSERVED_SEEN.clear()
