"""mxnet_tpu_torch — the PyTorch + CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper.  Import as ``import mxnet_tpu_torch as mx``.

Ported so far: the symbolic serving path (``mx.sym`` graphs, the
executor, ``Predictor`` and the serving registry/batcher, with flash
attention as a hand-written CUDA kernel, ``csrc/flash_attention.cu``),
training (``mx.mod.Module.fit`` with ``mx.io.NDArrayIter``, ``mx.init``,
``mx.optimizer``, ``mx.lr_scheduler``, ``mx.metric``, ``mx.callback`` and
``models.resnet``, with train-mode BatchNorm as hand-written CUDA kernels,
``csrc/batch_norm.cu``) and the fused-LSTM language model
(``mx.rnn.FusedRNNCell``, ``mx.rnn.BucketSentenceIter``,
``mx.mod.BucketingModule`` and ``models.lstm_lm``, with the LSTM sequence
forward and backward as hand-written CUDA kernels, ``csrc/lstm.cu``), and
checkpoints with resume (``model.save_checkpoint``/``load_checkpoint``,
``Module.load``, ``fit(checkpoint_prefix=, resume="auto",
checkpoint_every_n_batches=)``, ``mx.checkpoint``, ``mx.random``).
The package imports ``torch`` and never ``jax`` nor ``mxnet_tpu``.  Its
entry points run on ``cuda:0`` unless the caller passes ``ctx=mx.cpu()``
(``context=`` for the modules); without a card they raise.
"""

__version__ = "0.3.0"

from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus

from . import telemetry
from . import faults
from . import ops
from . import ndarray
from . import ndarray as nd
from . import attribute
from .attribute import AttrScope
from . import name
from . import symbol
from . import symbol as sym
from .symbol import Symbol, Variable
from . import executor
from .executor import Executor
from . import predict
from .predict import Predictor
from . import serving
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import metric
from . import callback
from . import io
from . import random
from . import model
from . import checkpoint
from . import module
from . import module as mod
from . import convert
from . import models
from . import rnn

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "telemetry", "faults", "ops", "nd", "ndarray", "sym", "symbol",
           "Symbol", "Variable", "AttrScope", "Executor",
           "Predictor", "predict", "serving", "initializer", "init",
           "lr_scheduler", "optimizer", "metric", "callback", "io", "random",
           "model", "checkpoint", "module", "mod", "convert", "models",
           "rnn"]
