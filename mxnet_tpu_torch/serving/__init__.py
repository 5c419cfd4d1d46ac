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
* :mod:`~mxnet_tpu_torch.serving.frontend` — the in-process handle and
  the stdlib HTTP endpoint (``/predict``, ``/generate``, ``/models``,
  ``/healthz``, ``/metrics``).

The JAX package's fleet controller (``serving/controller.py``) is not
ported yet.
"""

from .batcher import (BATCH_SIZE_BUCKETS, LATENCY_BUCKETS, DeadlineExceeded,
                      DynamicBatcher, Future, InvalidRequest, Overloaded)
from .decode import (TTFT_BUCKETS, DecodeEngine, GenerateSession,
                     ReplicaKilled)
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
           "MANIFEST", "ServingHandle", "ServingHTTPServer"]
