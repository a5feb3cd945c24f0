"""Serving: the Spartus datapath as an inference service (port of
``repro/serving``).

- `engine`         — batch-1 streaming engine (SpartusEngine), the parity
                     oracle, and the CBCSC/int8 pack
- `batched_engine` — continuous-batching multi-session engine
                     (step_batch / step_frames / step_chunk)
- `scheduler`      — SessionPool admission/eviction and the synchronous
                     serve_requests driver
- `telemetry`      — device-resident per-(layer, slot) sparsity counters
"""
from repro_torch.serving.batched_engine import (
    BatchedLayerState,
    BatchedSpartusEngine,
    PoolState,
)
from repro_torch.serving.engine import (
    EngineConfig,
    PackedLayer,
    PackedSpartusModel,
    SpartusEngine,
)
from repro_torch.serving.scheduler import (
    RequestResult,
    ServeStats,
    SessionPool,
    StreamRequest,
    serve_requests,
)
from repro_torch.serving.telemetry import (
    TelemetryState,
    init_telemetry,
    measured_sparsity,
    percentile_summary,
)
