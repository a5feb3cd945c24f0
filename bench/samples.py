"""The program's boundary samples: each dispatch boundary's dict in
``PoolObservability``'s time series (``t_mono``, ``handoff_s``, the
launch counters' ``<kernel>_<field>_inc``), read after the run from the
port's own record of its newest pools' series
(``repro_torch.serving.metrics.recent_timeseries``).

The port is not imported here: ``program.py`` loaded it for the run,
and this reads the module that is there.  A port without that record
gives no samples, and the readers that use them leave their metric
out."""
from __future__ import annotations

import sys
from typing import Dict, List

PORT_METRICS = "repro_torch.serving.metrics"


def boundary_samples(rec: Dict) -> List[Dict]:
    """Every sample the port still holds; a reader keeps those whose
    ``t_mono`` falls in its part of ``rec``'s window, which leaves out
    the samples of any other pool the process ran."""
    recent = getattr(sys.modules.get(PORT_METRICS), "recent_timeseries",
                     None)
    if recent is None:
        return []
    return [s for series in recent() for s in series.snapshot()]
