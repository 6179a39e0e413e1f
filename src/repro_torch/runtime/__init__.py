"""Serving runtime: fault injection, straggler monitor, async gateway,
artifact zoo and the online-learning updater."""

from repro_torch.runtime import faults  # noqa: F401
from repro_torch.runtime.gateway import (BrownoutConfig, BrownoutController,  # noqa: F401
                                         Gateway, Response)
from repro_torch.runtime.preemption import RESUME_EXIT_CODE, PreemptionHandler  # noqa: F401
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.zoo import ArtifactZoo, TenantQuarantined  # noqa: F401
