"""The training runtime, copied from the JAX package's ``repro.runtime``
(plain Python, no array library): checkpoint-scoped recovery with
failure injection (`fault`), elastic re-meshing (`elastic`) and
straggler mitigation (`straggler`)."""

from .elastic import degraded_mesh_shape, plan_elastic_restart  # noqa: F401
from .fault import FailureInjector, SimulatedFailure, run_with_recovery  # noqa: F401
from .straggler import StragglerMitigator  # noqa: F401
