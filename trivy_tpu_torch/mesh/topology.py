"""Mesh discovery: one `get_mesh()` for the whole device path.

The port of `trivy_tpu/mesh/topology.py` over torch devices.  A mesh is a
1-D ``("data",)`` tuple of torch devices, its **lanes**: rows, tiles and
NFA groups split into equal contiguous shards along it, one per lane, and
constants are replicated once per distinct device.

Policy (the reference's, read for CUDA):

  * `TRIVY_TPU_MESH=8` / `=2x4` (or the `--mesh` flag, threaded in as
    `override`) builds a mesh over the first N local devices.  An ``NxM``
    spec names the physical slice shape but flattens to N*M: the partition
    plan (mesh/plan.py) is pure data parallelism.
  * Unset / ``auto``: a mesh is built only on a host with more than one
    CUDA card.  The CPU is never auto-meshed.
  * ``none`` / ``off`` / ``1`` / a one-card host: no mesh (None), and every
    consumer takes its unsharded path.

On the CPU the lanes stand for the reference tests' 8 virtual host devices
(`CPU_LANES`): an explicit spec of up to 8 builds a CPU mesh whose lanes
all run on the CPU, tagged ``cpu:0`` .. ``cpu:7`` as the reference's
virtual devices are.  A mesh built by hand may repeat a device: a split of
one card, ``Mesh(["cuda:0"] * 4)``, runs its shards in turn on that card
(the twin of the reference's hand-built `Mesh(np.asarray(devices))`).
Every lane has its own tag (`lane_tags`): ``cuda:k`` for a card that holds
one lane, ``cuda:k#i`` for lane i of a card that holds several, so the
occupancy ledger keeps one entry per lane.

Mesh construction is memoised per (platform, spec).  The module also owns
the per-lane OCCUPANCY ledger: the staging path records how many real rows
and bytes each lane received per batch.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Any, Iterable

import torch

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.device import resolve_device

DATA_AXIS = "data"
# Lanes an explicit CPU spec may ask for: tests/conftest.py's forced host
# device count, which the reference's CPU meshes are built over.
CPU_LANES = 8

_LOCK = lockcheck.make_lock("mesh.topology")
_MESH_CACHE: dict[str, Any] = {}  # owner: _LOCK ((platform, spec) key -> Mesh | None)
_ACTIVE_DEVICES = 1  # owner: _LOCK (lane count of the widest mesh built)
_OCCUPANCY: dict[str, dict[str, int]] = {}  # owner: _LOCK


def lane_tags(devices: Iterable[torch.device]) -> tuple[str, ...]:
    """One distinct tag per lane: ``cpu:i`` on the CPU, ``cuda:k`` for a
    card holding one lane, ``cuda:k#i`` for lane i of a card holding
    several."""
    devs = list(devices)
    seen = Counter(devs)
    tags = []
    for i, d in enumerate(devs):
        if d.type == "cpu":
            tags.append(f"cpu:{i}")
        elif seen[d] > 1:
            tags.append(f"{d}#{i}")
        else:
            tags.append(str(d))
    return tuple(tags)


class Mesh:
    """A 1-D ``("data",)`` mesh: `devices`, one torch device per lane, all
    of one type; a device may repeat."""

    def __init__(self, devices: Iterable):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a mesh's lanes must share one device type: {devs}")
        self.devices = devs
        self.axis_names = (DATA_AXIS,)
        self.tags = lane_tags(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def platform(self) -> str:
        return self.devices[0].type

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices, each once, in first-lane order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({list(self.tags)})"


def as_mesh(mesh) -> Mesh | None:
    """A `Mesh`, None, or a sequence of devices (-> `Mesh`); a one-lane mesh
    is no mesh."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        if isinstance(mesh, (str, torch.device)) or not hasattr(mesh, "__iter__"):
            raise TypeError(f"mesh must be a Mesh or a list of devices, "
                            f"got {type(mesh).__name__}")
        mesh = Mesh(mesh)
    return mesh if mesh.size > 1 else None


def engine_mesh(device: torch.device, mesh=None, auto: bool = True) -> Mesh | None:
    """The mesh an engine (or verifier) on `device` runs over.

    A `mesh` given (a `Mesh` or a device list; one lane means none) must
    start at `device`, else ValueError.  With no `mesh`, `auto` takes the
    process mesh (`get_mesh()` on `device`'s type) when its first lane is
    `device`; an engine placed on another card of a multi-card host runs
    unmeshed there.  `auto` False: no mesh."""
    if mesh is not None:
        m = as_mesh(mesh)
        if m is not None and m.devices[0] != device:
            raise ValueError(f"the mesh's first lane is {m.devices[0]}, "
                             f"the engine's device {device}")
        return m
    if not auto:
        return None
    m = get_mesh(device_type=device.type)
    return m if m is not None and m.devices[0] == device else None


def parse_spec(spec: str | None) -> int | None:
    """`TRIVY_TPU_MESH` grammar -> device count.

    ``""``/``auto`` -> None (discover), ``none``/``off``/``0`` -> 1
    (explicitly unmeshed), ``N`` -> N, ``NxM`` -> N*M.  Raises
    ValueError on anything else: a typo'd topology must not silently
    fall back to single-device.
    """
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if s in ("", "auto"):
        return None
    if s in ("none", "off", "0"):
        return 1
    try:
        dims = [int(p) for p in s.split("x")]
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}: want N, NxM, auto or none")
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"bad mesh spec {spec!r}: dims must be positive")
    n = 1
    for d in dims:
        n *= d
    return n


def platform() -> str:
    """The accelerator this process would mesh: "cuda" when a card is
    usable, else "cpu"."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def is_cuda() -> bool:
    return platform() == "cuda"


def get_mesh(override: str | None = None, device_type: str | None = None):
    """The process's scan mesh on `device_type` ("cuda" or "cpu", default
    `platform()`), or None for the single-device path.

    `override` (the `--mesh` flag) wins over `TRIVY_TPU_MESH`; both win
    over auto-discovery.  Asking for more lanes than the platform has
    (CUDA cards, or `CPU_LANES`) raises.
    """
    spec = override if override not in (None, "") else os.environ.get(
        "TRIVY_TPU_MESH", ""
    )
    want = parse_spec(spec)
    plat = device_type or platform()
    key = f"{plat}:{'auto' if want is None else want}"
    with _LOCK:
        if key in _MESH_CACHE:
            return _MESH_CACHE[key]
    if plat == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    elif plat == "cpu":
        have = CPU_LANES
        devices = [torch.device("cpu")] * have
    else:
        raise ValueError(f"unsupported mesh device type {plat!r}")
    if want is None:
        # Auto: only a host with several cards earns a mesh.
        want = have if plat == "cuda" else 1
    if want > have:
        raise ValueError(
            f"mesh spec {spec!r} wants {want} devices, backend has {have}"
        )
    mesh = Mesh(devices[:want]) if want > 1 else None
    with _LOCK:
        _MESH_CACHE[key] = mesh
        if mesh is not None:
            global _ACTIVE_DEVICES
            _ACTIVE_DEVICES = max(_ACTIVE_DEVICES, want)
    return mesh


def clear_cache() -> None:
    """Forget memoised meshes + occupancy (tests that flip TRIVY_TPU_MESH)."""
    global _ACTIVE_DEVICES
    with _LOCK:
        _MESH_CACHE.clear()
        _OCCUPANCY.clear()
        _ACTIVE_DEVICES = 1


def mesh_device_count(mesh) -> int:
    """Lanes in `mesh` (1 for None: the unmeshed path)."""
    return 1 if mesh is None else mesh.size


def distinct_device_count(mesh) -> int:
    """Distinct devices under `mesh` (1 for None): the links a mesh
    really has, what the verify gate prices."""
    return 1 if mesh is None else len(mesh.distinct_devices())


def mesh_devices(mesh) -> list:
    """The mesh's devices in lane order ([] for None)."""
    return [] if mesh is None else list(mesh.devices)


def device_tag(device) -> str:
    """"type:index" of a torch device ("cpu:0" for the CPU), the key shape
    obs/memwatch uses."""
    d = torch.device(device)
    return f"{d.type}:{d.index or 0}"


def capacity_hint() -> int:
    """Device-count multiplier for batch sizing, without touching CUDA.

    It reports the widest mesh actually built this process, else the
    explicit TRIVY_TPU_MESH spec (a pure string parse), else 1.
    """
    with _LOCK:
        if _ACTIVE_DEVICES > 1:
            return _ACTIVE_DEVICES
    try:
        want = parse_spec(os.environ.get("TRIVY_TPU_MESH", ""))
    except ValueError:
        return 1
    return want if want and want > 1 else 1


# -- per-lane occupancy ------------------------------------------------------


def record_occupancy(device: str, rows: int, nbytes: int) -> None:
    """Ledger one staged shard: `rows` real rows / `nbytes` on lane `device`."""
    with _LOCK:
        d = _OCCUPANCY.setdefault(
            device, {"rows": 0, "nbytes": 0, "batches": 0}
        )
        d["rows"] += int(rows)
        d["nbytes"] += int(nbytes)
        d["batches"] += 1


def reset_occupancy() -> None:
    """Zero the occupancy ledger only; memoised meshes survive."""
    with _LOCK:
        _OCCUPANCY.clear()


def occupancy_snapshot() -> dict[str, dict[str, int]]:
    """Cumulative per-lane staging occupancy since process start."""
    with _LOCK:
        return {dev: dict(d) for dev, d in _OCCUPANCY.items()}


def occupancy_efficiency() -> float:
    """Work-share balance across lanes: total_rows / (n * max_rows).

    1.0 = perfectly balanced shards; padding or skew pulls it down."""
    snap = occupancy_snapshot()
    if not snap:
        return 1.0
    rows = [d["rows"] for d in snap.values()]
    peak = max(rows)
    if peak <= 0:
        return 1.0
    return sum(rows) / (len(rows) * peak)


def describe(mesh=None, spec: str | None = None) -> dict:
    """JSON-able topology block (the reference's `GET /debug/mesh` body)."""
    if mesh is None and (spec or os.environ.get("TRIVY_TPU_MESH")):
        try:
            mesh = get_mesh(spec)
        except Exception:  # graftlint: swallow(a bad spec describes as unmeshed, as the reference's does)
            mesh = None
    n = mesh_device_count(mesh)
    body: dict[str, Any] = {
        "enabled": mesh is not None,
        "devices": n,
        "spec": spec or os.environ.get("TRIVY_TPU_MESH", ""),
        "axis_names": list(mesh.axis_names) if mesh is not None else [],
        "device_tags": list(mesh.tags) if mesh is not None else [],
    }
    if mesh is not None:
        body["platform"] = mesh.platform
    return body
