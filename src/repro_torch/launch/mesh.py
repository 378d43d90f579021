"""Production mesh axes, as the reference's ``launch/mesh.py``.

Mesh axes:
- ``pod``   (2)  — cross-pod data parallelism (gradient all-reduce,
                   optionally int8-compressed);
- ``data``  (16) — in-pod data parallel / FSDP axis;
- ``model`` (16) — tensor-parallel axis (heads / d_ff / experts' d_ff).

The port has no 256- or 512-card process group and does not pretend to
have one.  The planner (`core.planner.plan`) and the sharding rules
(`launch.sharding`) read only ``mesh.shape``, as the reference's
``mesh_stub`` docstring says, so a mesh here is that stand-in: an object
whose ``shape`` maps each axis to its size.  The dry run
(`launch.dryrun`) traces one global program on the ``meta`` device and
divides by these sizes.
"""

from __future__ import annotations

import types

# Axis name -> size per mesh flavour (the reference's, as they are).
PRODUCTION_MESH_AXES: dict[str, dict[str, int]] = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}


def mesh_stub(axes: dict):
    """Planner-facing mesh stand-in: ``mesh.shape`` is ``axes``."""
    return types.SimpleNamespace(shape=dict(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The stand-in of the production mesh (``single`` or ``multi``)."""
    return mesh_stub(PRODUCTION_MESH_AXES["multi" if multi_pod
                                          else "single"])


def make_smoke_mesh():
    """One device with the production axis names."""
    return mesh_stub({"data": 1, "model": 1})


def dp_axes(mesh) -> tuple:
    """Data-parallel axes present in the mesh (pod first)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def mesh_device_count(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n
