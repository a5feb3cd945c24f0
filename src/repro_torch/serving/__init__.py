"""Serving: the Spartus datapath as an inference service (port of
``repro/serving``).

- `engine`         — batch-1 streaming engine (SpartusEngine), the parity
                     oracle, and the CBCSC/int8 pack
- `batched_engine` — continuous-batching multi-session engine
                     (step_batch / step_frames / step_chunk)
- `scheduler`      — SessionPool: admission, incremental streams, cancel,
                     partial logits, the non-blocking tick; the
                     synchronous serve_requests driver
- `async_server`   — AsyncSpartusServer: the asyncio streaming front-end
- `sharding`       — slot-dimension data parallelism: the pool's slabs
                     split into one block of slots per device
- `checkpoint`     — per-session snapshot/restore and pool checkpoints,
                     across capacities and shard counts
- `faults`         — typed errors, seeded fault injection, backoff
- `metrics`        — metrics registry, per-chunk time series, tracing
- `telemetry`      — device-resident per-(layer, slot) sparsity counters
"""
from repro_torch.serving.async_server import (
    AsyncSpartusServer,
    StreamClosed,
    StreamHandle,
)
from repro_torch.serving.batched_engine import (
    BatchedLayerState,
    BatchedSpartusEngine,
    PoolState,
)
from repro_torch.serving.checkpoint import (
    PoolCheckpoint,
    SessionSnapshot,
    engine_fingerprint,
    load_checkpoint,
    restore_into,
    save_pool,
    snapshot_pool,
    snapshot_session,
)
from repro_torch.serving.engine import (
    EngineConfig,
    PackedLayer,
    PackedSpartusModel,
    SpartusEngine,
)
from repro_torch.serving.faults import (
    AdmissionShed,
    Backoff,
    BadRequest,
    DriverRecovered,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    InjectedFault,
    ProtocolError,
    ServingError,
    SessionTimeout,
    error_payload,
)
from repro_torch.serving.metrics import (
    MetricsRegistry,
    PoolObservability,
    TimeSeries,
    Tracer,
)
from repro_torch.serving.scheduler import (
    PartialLogits,
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
