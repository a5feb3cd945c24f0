"""The system under test: the port (``src/repro_torch``), built from a
configuration file and its model family, and handed the benchmark's
weights.  The only module of the benchmark that imports the port."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path


SRC = Path(__file__).resolve().parent.parent / "src"


def import_port() -> None:
    src = str(SRC)
    if src not in sys.path:
        sys.path.insert(0, src)


def engine_config(cfg: dict):
    from repro_torch.core import QuantConfig
    from repro_torch.serving import EngineConfig

    return EngineConfig(
        theta=cfg["theta"], gamma=cfg["gamma"], m=cfg["m"],
        capacity_frac=cfg["capacity_frac"], spmv_path=cfg["spmv_path"],
        quant=QuantConfig() if cfg.get("quant") else None)


def model_config(cfg: dict, family):
    """The port's configuration of the model, as ``family`` (the
    configuration's module under ``bench/families/``) names it."""
    cls = getattr(importlib.import_module(family.PORT_MODULE),
                  family.PORT_CONFIG)
    return cls(**family.model_kwargs(cfg))


def pool_engine(params, cfg: dict, family, device):
    from repro_torch.serving import BatchedSpartusEngine

    return BatchedSpartusEngine(params, model_config(cfg, family),
                                engine_config(cfg), device=device)


def batch1_engine(params, cfg: dict, family, device):
    from repro_torch.serving import SpartusEngine

    return SpartusEngine(params, model_config(cfg, family),
                         engine_config(cfg), device=device)


def server(engine, spec: dict, tracer=None):
    """``AsyncSpartusServer`` as the mix states it; ``tracer`` turns on
    ``PoolObservability`` with the program's span sites recorded."""
    from repro_torch.serving import AsyncSpartusServer, PoolObservability

    obs = None if tracer is None else PoolObservability(tracer=tracer)
    return AsyncSpartusServer(
        engine, spec["capacity"], chunk_frames=spec["chunk_frames"],
        target_chunk_ms=spec["target_chunk_ms"],
        max_frames=spec["max_frames"], observability=obs)


def ops_module():
    from repro_torch.kernels import ops

    return ops


def pool_engine_class():
    from repro_torch.serving import BatchedSpartusEngine

    return BatchedSpartusEngine
