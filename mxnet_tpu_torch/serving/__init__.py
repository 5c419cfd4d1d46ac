"""Serving (counterpart of ``mxnet_tpu/serving``): a throughput-oriented
model server over the :class:`~mxnet_tpu_torch.predict.Predictor` plus a
continuous-batching autoregressive tier.

* :mod:`~mxnet_tpu_torch.serving.batcher` — dynamic micro-batching with
  shape-bucket padding, deadlines and typed :class:`Overloaded`;
* :mod:`~mxnet_tpu_torch.serving.decode` — slot-based continuous batching
  for autoregressive LMs: one fixed-shape decode step, one packed host
  read per token, admission into free slots between steps;
* :mod:`~mxnet_tpu_torch.serving.kvblocks` — the paged KV bookkeeping
  (block allocator, per-slot tables, prefix cache with copy-on-write);
* :mod:`~mxnet_tpu_torch.serving.pool` — N routed replicas: weighted
  least-outstanding routing, tenant quotas, priority shedding, per-replica
  circuit breakers and session failover;
* :mod:`~mxnet_tpu_torch.serving.registry` — the versioned registry, with
  pointer-flip ``register`` swaps of decode pools;
* :mod:`~mxnet_tpu_torch.serving.controller` — the fleet control plane:
  SLO-driven autoscaling, placement over the CUDA devices, replacement
  of dead replicas under a restart budget, priority shedding at fleet
  capacity;
* :mod:`~mxnet_tpu_torch.serving.frontend` — the in-process handle and
  the stdlib HTTP endpoint (``/predict``, ``/generate``, ``/models``,
  ``/healthz``, ``/fleet``, ``/metrics``).

A controller attaches to a registry in its constructor; on the CPU::

    pool = lm_pool(cfg, params, n_replicas=2, devices=["cpu"], ...)
    reg = ModelRegistry(ctx=mx.cpu()); reg.register("lm", pool)
    ctl = FleetController(reg, fleet=DeviceFleet(["cpu"], per_device=3))
    ctl.start()   # or ctl.tick(now) to step it by hand
"""

from .batcher import (BATCH_SIZE_BUCKETS, LATENCY_BUCKETS, DeadlineExceeded,
                      DynamicBatcher, Future, InvalidRequest, Overloaded)
from .decode import (TTFT_BUCKETS, DecodeEngine, GenerateSession,
                     ReplicaKilled)
from .controller import (HOLD, SCALE_DOWN, SCALE_UP, SHED, UNSHED,
                         AutoscalePolicy, DeviceFleet, FleetController,
                         Observation)
from .frontend import ServingHandle, ServingHTTPServer
from .kvblocks import (BlockAllocator, KVBlockPool, KVBlocksExhausted,
                       PrefixCache)
from .pool import (QuotaExceeded, Replica, ReplicaPool,
                   RetryBudgetExhausted, lm_pool)
from .registry import (MANIFEST, ModelRegistry, ServedModel, UnknownModel,
                       save_model)

__all__ = ["DynamicBatcher", "Future", "Overloaded", "DeadlineExceeded",
           "InvalidRequest", "LATENCY_BUCKETS", "BATCH_SIZE_BUCKETS",
           "TTFT_BUCKETS", "DecodeEngine", "GenerateSession",
           "ReplicaKilled", "QuotaExceeded", "RetryBudgetExhausted",
           "Replica", "ReplicaPool", "lm_pool",
           "BlockAllocator", "PrefixCache", "KVBlockPool",
           "KVBlocksExhausted",
           "ModelRegistry", "ServedModel", "UnknownModel", "save_model",
           "MANIFEST", "ServingHandle", "ServingHTTPServer",
           "Observation", "AutoscalePolicy", "DeviceFleet",
           "FleetController", "HOLD", "SCALE_UP", "SCALE_DOWN", "SHED",
           "UNSHED"]
