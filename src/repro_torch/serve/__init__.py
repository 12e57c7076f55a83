# Port of repro.serve: a loaded Program artifact as a service on the card.
#   sharded      data parallelism over a mesh of devices (pad-and-mask
#                ragged batches; bit-exact vs the single-device engine;
#                shards on one device in turn, one thread per distinct one)
#   batcher      deterministic micro-batcher (simulated clock, BatchPolicy
#                with bounded queues / shedding / deadlines, pow2 buckets,
#                bit-exact per-stage latency decomposition); copied logic
#   registry     N loaded Programs by name, per-model engine + policy
#   server       request streams -> per-model queues -> metrics dict on an
#                explicit shared / per-engine timeline
#   async_server asyncio front-end: bounded queues, admission control,
#                backpressure as raised exceptions, real clock; the
#                engine runs in an executor thread with its device current
#   replay       arrival-trace soak harness (Poisson / bursty generators,
#                deterministic SLO assertions); copied logic
from repro_torch.serve.async_server import (AsyncServer, CompletedRequest,
                                            DeadlineMissError,
                                            QueueFullError, ShedError)
from repro_torch.serve.batcher import (BatchPolicy, BatchRecord, DrainResult,
                                       MicroBatcher, SHED_DEADLINE,
                                       SHED_NONE, SHED_QUEUE_FULL,
                                       SHED_REASONS, ShedEvent,
                                       drain_together, latency_metrics,
                                       linear_service_model)
from repro_torch.serve.registry import ProgramRegistry
from repro_torch.serve.replay import ArrivalTrace, SoakReport, replay
from repro_torch.serve.server import Request, Server
from repro_torch.serve.sharded import ShardedRunner, sharded_runner

__all__ = [
    "ArrivalTrace", "AsyncServer",
    "BatchPolicy", "BatchRecord", "CompletedRequest",
    "DeadlineMissError", "DrainResult", "MicroBatcher",
    "ProgramRegistry", "QueueFullError", "Request",
    "SHED_DEADLINE", "SHED_NONE", "SHED_QUEUE_FULL", "SHED_REASONS",
    "Server", "ShardedRunner", "ShedError", "ShedEvent", "SoakReport",
    "drain_together", "latency_metrics", "linear_service_model",
    "replay", "sharded_runner",
]
