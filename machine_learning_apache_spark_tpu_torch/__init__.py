"""PyTorch/CUDA port of ``machine_learning_apache_spark_tpu``.

The same system — the MT Transformer and its paged serving engine so far —
written in PyTorch, with the JAX package's Pallas TPU kernels rewritten as
hand-written CUDA kernels for Hopper (``csrc/``). Module paths follow the
JAX package's, so each module's counterpart is found by name. Entry points
(``inference.Translator``, ``serving.ServingEngine``,
``serving.paged_runtime.PagedDecodeRuntime``) run on the card unless the
caller passes ``device="cpu"``.

Importing the package imports torch and numpy only: no JAX, and nothing of
the JAX package. Kernels are built at first use, never at import.
"""

__version__ = "0.1.0"
