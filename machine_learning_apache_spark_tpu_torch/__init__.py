"""PyTorch/CUDA port of ``machine_learning_apache_spark_tpu``.

The same system — the MT Transformer with its serving engines and its
training recipe, the model zoo (MLP, TinyVGG CNN, LSTM classifier) with
its recipes and the MLlib L-BFGS baseline, and the distributed path
(``Session``, ``launcher.Distributor`` gangs over ``torch.distributed``,
data-parallel ``fit(mesh=)``, ``submit``) so far — written in PyTorch, with the JAX package's Pallas TPU kernels rewritten
as hand-written CUDA kernels for Hopper (``csrc/``). Module paths follow
the JAX package's, so each module's counterpart is found by name. Entry
points (``inference.Translator``, ``inference.Classifier``,
``serving.ServingEngine``, ``serving.paged_runtime.PagedDecodeRuntime``,
``recipes.{translation,mlp,cnn,lstm}.train_*``,
``mllib.MultilayerPerceptronClassifier.fit``) run on the card unless the
caller passes ``device="cpu"``; a gang's ranks run on the card unless
``Distributor(platform="cpu")``.

The package imports torch and numpy only: no JAX, and nothing of the JAX
package. Kernels are built at first use, never at import. ``Session``
loads on first use, so importing the package itself loads nothing (a
gang rank's heartbeat starts before torch does).
"""

__version__ = "0.1.0"

__all__ = ["Session"]


def __getattr__(name: str):
    if name == "Session":
        from machine_learning_apache_spark_tpu_torch.session import Session

        return Session
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
