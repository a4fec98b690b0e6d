"""Approximate & partial-work gradient coding (DESIGN.md §5).

The paper's schemes are *exact*: an iteration completes only when some
decodable set satisfies ``a·B = 1``, so a bad throughput estimate or
one-too-many stragglers stalls the whole step.  This subsystem relaxes
exactness along two axes:

- **approximate codes** (`bernoulli`): the code itself only guarantees
  decodability in expectation — stepping is best-effort by design (Johri et
  al.; Song & Choi, approximate gradient coding for heterogeneous nodes);
- **partial work** (`partial_work`): workers stream per-partition results,
  so at a deadline the master decodes from completed *prefixes* instead of
  all-or-nothing worker reports;

and a :class:`DeadlinePolicy` that steps at a deadline with whatever
arrived (modes: ``exact_first`` | ``bounded_residual`` | ``fixed_deadline``),
adapting the deadline from the EWMA throughput estimates.  The decode-layer
contract is :class:`~repro_torch.core.decoding.DecodeOutcome` — vector, ``exact``
flag, RMS residual ``‖a·B_eff − 1‖₂/√k`` — produced by every decode path
and consumed by every backend.
"""

from repro_torch.approx.deadline import DEADLINE_MODES, DeadlinePolicy, DeadlineTick, StepTick
from repro_torch.approx.schemes import BernoulliCode, PartialWorkCode, build_bernoulli
from repro_torch.core.decoding import DecodeOutcome, best_effort_decode_vector

__all__ = [
    "DEADLINE_MODES",
    "DeadlinePolicy",
    "StepTick",
    "DeadlineTick",
    "DecodeOutcome",
    "best_effort_decode_vector",
    "BernoulliCode",
    "PartialWorkCode",
    "build_bernoulli",
]
