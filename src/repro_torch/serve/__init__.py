# Port of repro.serve: a loaded Program artifact as a service on the card.
#   batcher   deterministic micro-batcher (simulated clock, BatchPolicy
#             with bounded queues / shedding / deadlines, pow2 buckets,
#             bit-exact per-stage latency decomposition); copied logic
#   registry  N loaded Programs by name, per-model engine + policy
#   server    request streams -> per-model queues -> metrics dict on an
#             explicit shared / per-engine timeline
# sharded, async_server and replay wait for ROADMAP Queue A item 4.
from repro_torch.serve.batcher import (BatchPolicy, BatchRecord, DrainResult,
                                       MicroBatcher, SHED_DEADLINE,
                                       SHED_NONE, SHED_QUEUE_FULL,
                                       SHED_REASONS, ShedEvent,
                                       drain_together, latency_metrics,
                                       linear_service_model)
from repro_torch.serve.registry import ProgramRegistry
from repro_torch.serve.server import Request, Server

__all__ = [
    "BatchPolicy", "BatchRecord", "DrainResult", "MicroBatcher",
    "ProgramRegistry", "Request", "SHED_DEADLINE", "SHED_NONE",
    "SHED_QUEUE_FULL", "SHED_REASONS", "Server", "ShedEvent",
    "drain_together", "latency_metrics", "linear_service_model",
]
