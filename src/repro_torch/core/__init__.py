"""BandMap core, ported: the mapper (`bandmap.map_dfg`) and everything
on its path — scheduling with bandwidth allocation, the conflict graph,
the MIS engines (numpy `mis.PortfolioSBTS` and the GPU-resident
`mis_device.DeviceSBTS`), certificates and the validator — and the
seeded workload generator (`workloads`) that drives it at 16x16 scale.
"""

from .bandmap import MappingResult, compare_modes, map_dfg
from .bitset import BitsetGraph
from .cancel import CancelToken
from .certify import IICertificate, certify_ii_infeasible
from .cgra import CGRAConfig
from .conflict import ConflictGraph, Vertex, build_conflict_graph
from .dfg import DFG, Edge, Op, OpKind
from .kernels_cnkm import (EXTRA_KERNELS, PAPER_KERNELS,
                           all_paper_kernels, cnkm_name, make_cnkm)
from .mis import (GroupMoveConfig, greedy_mis, solve_mis,
                  solve_mis_portfolio)
from .mis_device import DeviceSBTS, load_state
from .options import (CertifyOptions, MapOptions, PortfolioOptions,
                      ScheduleOptions)
from .schedule import ScheduledDFG, mii, res_mii, schedule_dfg
from .tec import TEC
from .workloads import (COMAP_16X16_SPECS, TraceRequest, WorkloadSpec,
                        generate, make_loop_kernel, make_reduction,
                        make_request_trace, make_stencil,
                        make_tightly_coupled, permute_dfg,
                        scale_16x16_loop, serve_catalog, sweep_specs)

__all__ = [
    "MappingResult", "compare_modes", "map_dfg", "BitsetGraph",
    "CancelToken", "IICertificate", "certify_ii_infeasible",
    "CGRAConfig", "ConflictGraph", "Vertex", "build_conflict_graph",
    "DFG", "Edge", "Op", "OpKind", "EXTRA_KERNELS",
    "PAPER_KERNELS", "all_paper_kernels", "cnkm_name", "make_cnkm",
    "GroupMoveConfig", "greedy_mis", "solve_mis", "solve_mis_portfolio",
    "DeviceSBTS", "load_state",
    "MapOptions", "ScheduleOptions", "CertifyOptions",
    "PortfolioOptions",
    "ScheduledDFG", "mii", "res_mii", "schedule_dfg", "TEC",
    "COMAP_16X16_SPECS", "TraceRequest", "WorkloadSpec", "generate",
    "make_loop_kernel", "make_reduction", "make_request_trace",
    "make_stencil", "make_tightly_coupled", "permute_dfg",
    "scale_16x16_loop", "serve_catalog", "sweep_specs",
]
