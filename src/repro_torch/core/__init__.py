"""Heterogeneity-aware gradient coding — the paper's contribution.

Public API:
  registry:    GradientCode protocol + @register_scheme/get_scheme factory
  schemes:     the five built-in codes bound to the registry
  codec:       code + shape-stable slot plan + decode (runtime seam)
  allocation:  heterogeneity-aware partition allocation (Eq. 5/6)
  coding:      B-matrix construction — Alg. 1 + baselines
  groups:      group-based scheme (Alg. 2/3)
  decoding:    decode-vector solve + group fast path
  throughput:  EWMA c_i estimation / elastic re-encode trigger
  straggler:   straggler pattern models
  simulator:   heterogeneous-cluster timing model (Figs. 2/3/5)
  aggregator:  coded gradient aggregation (worker encode + master decode)
"""

from repro_torch.core.allocation import (
    Allocation,
    RemapResult,
    allocate,
    count_moved,
    remap_allocation,
    support_matrix,
)
from repro_torch.core.registry import (
    GradientCode,
    MembershipStats,
    get_scheme,
    register_scheme,
    scheme_class,
    scheme_names,
)
from repro_torch.core import schemes as _schemes  # noqa: F401 - registers built-ins
from repro_torch.core.codec import Codec
from repro_torch.core.coding import (
    CodingScheme,
    build_cyclic,
    build_fractional_repetition,
    build_heter_aware,
    build_naive,
    make_scheme,
    satisfies_condition1,
)
from repro_torch.core.decoding import (
    DecodableSetTracker,
    DecodeError,
    DecodeOutcome,
    Decoder,
    best_effort_decode_vector,
    earliest_decodable_stream,
    solve_decode_vector,
    worker_arrival_order,
)
from repro_torch.core.groups import (
    GroupSearchResult,
    build_group_based,
    find_all_groups,
    find_greedy_groups,
    prune_groups,
)
from repro_torch.core.simulator import (
    ArrivalEvent,
    ArrivalStream,
    ChurnSchedule,
    ClusterSim,
    FaultEvent,
    FaultSchedule,
    FaultyClusterSim,
    MembershipEvent,
    PartitionTimes,
    mask_workers,
    theoretical_optimal_time,
)
from repro_torch.core.straggler import (
    ComposedModel,
    FaultModel,
    FixedDelayStragglers,
    NoStragglers,
    StragglerProfile,
    TransientStragglers,
)
from repro_torch.core.throughput import ThroughputEstimator

# NOTE: the approximate families (bernoulli, partial_work) live in
# repro_torch.approx — a layer above core — and are pulled in lazily by the
# registry on first scheme lookup (registry._load_family_modules), so
# scheme_names() is complete everywhere without core importing upward.

__all__ = [
    "GradientCode",
    "MembershipStats",
    "get_scheme",
    "register_scheme",
    "scheme_class",
    "scheme_names",
    "Codec",
    "Allocation",
    "RemapResult",
    "allocate",
    "count_moved",
    "remap_allocation",
    "support_matrix",
    "CodingScheme",
    "build_cyclic",
    "build_fractional_repetition",
    "build_heter_aware",
    "build_naive",
    "build_group_based",
    "make_scheme",
    "satisfies_condition1",
    "DecodableSetTracker",
    "DecodeError",
    "DecodeOutcome",
    "Decoder",
    "best_effort_decode_vector",
    "earliest_decodable_stream",
    "solve_decode_vector",
    "worker_arrival_order",
    "GroupSearchResult",
    "find_all_groups",
    "find_greedy_groups",
    "prune_groups",
    "ArrivalEvent",
    "ArrivalStream",
    "ChurnSchedule",
    "ClusterSim",
    "FaultEvent",
    "FaultSchedule",
    "FaultyClusterSim",
    "MembershipEvent",
    "PartitionTimes",
    "mask_workers",
    "theoretical_optimal_time",
    "ComposedModel",
    "FaultModel",
    "FixedDelayStragglers",
    "NoStragglers",
    "StragglerProfile",
    "TransientStragglers",
    "ThroughputEstimator",
]
