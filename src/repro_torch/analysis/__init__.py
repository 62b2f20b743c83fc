"""Static analysis of the port (the reference's ``repro.analysis``): a
rule registry and one entry point (:func:`analyze`), the kernel tile lint
over the CUDA kernels' launch specs and sources
(:class:`KernelTileLint`), the round loop's host-sync guard
(:class:`HostSyncGuard`), the collective-placement rule over the
collectives a rank issued (:class:`CollectivePlacement`, with
:func:`control_traffic_allowance`), and the donation rule over one
call's storages (:class:`DonationAliasing`, with
:func:`donated_leaf_ranges` and :func:`trace_aliasing`).  ``python -m
repro_torch.launch.analyze`` runs them; nothing here launches a kernel."""
from repro_torch.analysis.collectives import (  # noqa: F401
    CollectivePlacement, classify_collectives, control_traffic_allowance,
    count_collectives,
)
from repro_torch.analysis.core import (  # noqa: F401
    RULE_REGISTRY, AnalysisError, Report, Rule, Target, Violation, analyze,
    register_rule,
)
from repro_torch.analysis.donation import (  # noqa: F401
    Aliasing, DonationAliasing, donated_leaf_ranges, trace_aliasing,
)
from repro_torch.analysis.hostsync import HostSyncGuard  # noqa: F401
from repro_torch.analysis.tiles import KernelTileLint  # noqa: F401
