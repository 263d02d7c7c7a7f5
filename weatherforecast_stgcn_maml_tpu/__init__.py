"""MAML-STGCN-LSTM weather forecasting framework in JAX.

A JAX/XLA implementation of the capabilities of the
Yalt8826/WeatherForecast_STGCN_MAML reference system (see SURVEY.md): ERA5
ingestion -> windowed spatio-temporal graph samples -> hybrid STGCN->LSTM
forecaster -> MAML meta-training over global climate regions -> per-region
adaptation -> held-out validation with per-variable MSE/MAE and plots.

Design stance (written for an accelerator, not a port):
  * the kNN grid graph becomes a dense normalized adjacency so graph
    convolution is a dense matmul,
  * the per-node LSTM loop of the reference (hybrid_model.py:94-102) becomes
    a `lax.scan` over time batched over nodes,
  * MAML is a *correct* grad-through-inner-SGD functional transform (the
    reference's deepcopy-based loop never propagates meta-gradients,
    train_hybrid_maml_v5.py:111-178) vmapped over region tasks,
  * scaling is a `jax.sharding.Mesh` + data-parallel meta batch.
"""

__version__ = "0.1.0"

from weatherforecast_stgcn_maml_tpu.config import (  # noqa: F401
    AdaptConfig,
    CompatConfig,
    DataConfig,
    MeshConfig,
    MetaConfig,
    ModelConfig,
)
