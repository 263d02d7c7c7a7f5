"""Utils: checkpoint roundtrip, loggers, eval metrics, plots."""

import json
import os

import numpy as np
import pytest

from weatherforecast_stgcn_maml_tpu.config import WEATHER_VARS
from weatherforecast_stgcn_maml_tpu.data.preprocess import NormStats
from weatherforecast_stgcn_maml_tpu.eval.metrics import forecast_table, variable_metrics
from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)
from weatherforecast_stgcn_maml_tpu.utils.metrics import CsvLogger, JsonlLogger
from weatherforecast_stgcn_maml_tpu.utils.profiling import Timer


def test_checkpoint_roundtrip(tmp_path):
    arrays = {
        "params": {"w": np.arange(6.0).reshape(2, 3), "b": np.zeros(3)},
        "nested": [np.ones(2), np.full((2, 2), 7.0)],
    }
    meta = {"epoch": 3, "stats": {"mean": [1.0, 2.0]}, "name": "x"}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, arrays, meta)
    assert checkpoint_exists(path)
    back, meta2 = load_checkpoint(path, like=arrays)
    np.testing.assert_array_equal(back["params"]["w"], arrays["params"]["w"])
    np.testing.assert_array_equal(back["nested"][1], arrays["nested"][1])
    assert meta2["epoch"] == 3
    assert meta2["stats"]["mean"] == [1.0, 2.0]


def test_checkpoint_overwrite(tmp_path):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"a": np.zeros(2)}, {"v": 1})
    save_checkpoint(path, {"a": np.ones(2)}, {"v": 2})
    back, meta = load_checkpoint(path)
    np.testing.assert_array_equal(back["a"], np.ones(2))
    assert meta["v"] == 2


def test_csv_logger(tmp_path):
    path = str(tmp_path / "log.csv")
    log = CsvLogger(path, ["epoch", "meta_loss", "learning_rate"])
    log.log(epoch=1, meta_loss=0.5, learning_rate=1e-3)
    log.log(epoch=2, meta_loss=0.4, learning_rate=9e-4)
    lines = open(path).read().strip().split("\n")
    assert lines[0] == "epoch,meta_loss,learning_rate"
    assert lines[1].startswith("1,0.5")
    # Appending to an existing file does not rewrite the header.
    CsvLogger(path, ["epoch", "meta_loss", "learning_rate"]).log(
        epoch=3, meta_loss=0.3, learning_rate=8e-4
    )
    assert len(open(path).read().strip().split("\n")) == 4


def test_jsonl_logger(tmp_path):
    path = str(tmp_path / "log.jsonl")
    log = JsonlLogger(path)
    log.log({"a": 1, "b": np.float32(2.5)})
    rec = json.loads(open(path).read())
    assert rec == {"a": 1, "b": 2.5}


def test_timer():
    t = Timer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    assert t.summary()["a"] >= 0


def test_variable_metrics_excludes_sp():
    stats = NormStats(mean=np.zeros(12, np.float32), std=np.ones(12, np.float32))
    pred = np.zeros((4, 12))
    true = np.zeros((4, 12))
    sp_idx = WEATHER_VARS.index("sp")
    true[:, sp_idx] = 100.0  # massive sp error must not pollute the average
    true[:, 0] = 1.0  # u10 error of 1 -> mse 1
    res = variable_metrics(pred, true, stats)
    assert res["sp"]["mse"] == 10000.0
    assert res["u10"]["mse"] == 1.0
    # average over 5 scored non-sp vars: (1 + 0 + 0 + 0 + 0) / 5
    assert np.isclose(res["average_mse"], 0.2)


def test_variable_metrics_denormalizes():
    stats = NormStats(
        mean=np.full(12, 10.0, np.float32), std=np.full(12, 2.0, np.float32)
    )
    pred = np.zeros((2, 12))
    true = np.ones((2, 12))  # denorm difference = std = 2 -> mse 4
    res = variable_metrics(pred, true, stats)
    assert np.isclose(res["u10"]["mse"], 4.0)
    assert np.isclose(res["u10"]["mae"], 2.0)


def test_forecast_table():
    times = np.array(["2025-01-01T00:00", "2025-01-01T01:00"], dtype="datetime64[ns]")
    table = forecast_table(times, np.array([280.0, 281.0]), np.array([279.0, 283.0]))
    assert "2025-01-01T00:00" in table
    assert "280.0" in table and "283.0" in table


def test_plots(tmp_path):
    from weatherforecast_stgcn_maml_tpu.eval.plots import (
        temperature_figure,
        variables_figure,
    )

    stats = NormStats(mean=np.zeros(12, np.float32), std=np.ones(12, np.float32))
    it = np.array(["2025-01-01T00:00", "2025-01-01T01:00"], dtype="datetime64[ns]")
    ft = np.array(["2025-01-01T02:00", "2025-01-01T03:00"], dtype="datetime64[ns]")
    p1 = temperature_figure(
        str(tmp_path / "t.png"), it, ft,
        np.array([280.0, 281.0]), np.array([282.0, 283.0]), np.array([281.5, 282.5]),
        "TestRegion",
    )
    p2 = variables_figure(
        str(tmp_path / "v.png"), np.zeros((4, 12)), np.ones((4, 12)) * 0.1,
        stats, "TestRegion",
    )
    assert os.path.getsize(p1) > 1000
    assert os.path.getsize(p2) > 1000


def test_jsonl_logger_sanitizes_non_finite(tmp_path):
    """inf/NaN values must not produce invalid-JSON artifacts."""
    import json as _json

    from weatherforecast_stgcn_maml_tpu.utils.metrics import JsonlLogger

    log = JsonlLogger(str(tmp_path / "m.jsonl"))
    log.log({"average_mse": float("inf"), "loss": float("nan"), "ok": 1.5,
             "nested": {"v": float("-inf")}, "tag": "x", "flag": True})
    line = (tmp_path / "m.jsonl").read_text().strip()
    rec = _json.loads(line)  # strict parse must succeed
    assert rec["average_mse"] == "inf" and rec["loss"] == "nan"
    assert rec["ok"] == 1.5 and rec["nested"]["v"] == "-inf"
    assert rec["tag"] == "x" and rec["flag"] is True


def test_async_checkpointer_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp

    from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
        AsyncCheckpointer,
        load_checkpoint,
    )

    ac = AsyncCheckpointer()
    tree = {"w": jnp.arange(12.0).reshape(3, 4), "n": jnp.int32(7)}
    path = str(tmp_path / "ck")
    # Two back-to-back saves to the same path must serialize in order.
    ac.save(path, tree, {"epoch": 1})
    tree2 = jax.tree.map(lambda x: x + 1, tree)
    ac.save(path, tree2, {"epoch": 2})
    ac.wait()
    arrays, meta = load_checkpoint(path)
    assert meta["epoch"] == 2
    np.testing.assert_array_equal(arrays["w"], np.arange(12.0).reshape(3, 4) + 1)


def test_async_checkpointer_snapshot_isolated_from_donation(tmp_path):
    """The on-device snapshot must not alias the live buffers: mutate (well,
    rebind) the source tree immediately after save() and check the write
    captured the pre-save values."""
    import jax.numpy as jnp

    from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
        AsyncCheckpointer,
        load_checkpoint,
    )

    ac = AsyncCheckpointer()
    x = jnp.ones((256, 256))
    path = str(tmp_path / "ck2")
    ac.save(path, {"x": x}, {})
    del x  # donation analogue: source buffer freed while write is in flight
    ac.wait()
    arrays, _ = load_checkpoint(path)
    assert float(np.asarray(arrays["x"]).sum()) == 256 * 256


def test_async_checkpointer_error_propagates(tmp_path):
    import pytest

    from weatherforecast_stgcn_maml_tpu.utils.checkpoint import AsyncCheckpointer

    ac = AsyncCheckpointer()
    blocker = tmp_path / "blocked"
    blocker.write_text("a file where the checkpoint DIR must go")
    ac.save(str(blocker / "sub"), {"x": np.ones(3)}, {})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ac.wait()


def test_bool_override_typo_raises():
    """'-o meta.second_order=Ture' must raise, not silently coerce to False
    (round-3 review finding)."""
    import pytest

    from weatherforecast_stgcn_maml_tpu.config import (
        ExperimentConfig,
        apply_overrides,
    )

    cfg = apply_overrides(ExperimentConfig(), ["meta.second_order=true"])
    assert cfg.meta.second_order is True
    cfg = apply_overrides(ExperimentConfig(), ["meta.second_order=off"])
    assert cfg.meta.second_order is False
    with pytest.raises(ValueError, match="boolean override"):
        apply_overrides(ExperimentConfig(), ["meta.second_order=Ture"])


def test_distributed_partial_topology_raises(monkeypatch):
    """PROCESS_ID alone (coordinator/num-processes unset) must fail loudly
    instead of silently degrading every host to a duplicate single-process
    run (round-3 review finding)."""
    import pytest

    from weatherforecast_stgcn_maml_tpu.parallel.distributed import initialize

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="partial multi-process"):
        initialize(process_id=3)


def test_load_checkpoint_saved_structure_wins_over_template():
    """A checkpoint whose params layout differs from the template (torch-
    imported split LSTM biases vs native fused `b`) must restore the SAVED
    leaves — a template-shaped restore would silently keep the template's
    random-init values for paths missing from the checkpoint, which
    corrupted adaptation-from-imported-weights runs
    (benchmarks/recipe_parity.py)."""
    import tempfile

    import jax

    from weatherforecast_stgcn_maml_tpu.config import ModelConfig
    from weatherforecast_stgcn_maml_tpu.models.registry import init_model

    cfg = ModelConfig(
        hidden_channels=8, gcn_layers=2, lstm_hidden=6, lstm_layers=2,
        window=4, horizon=2, koppen_dim=4,
    )
    template = init_model(jax.random.key(0), cfg)
    params = jax.tree.map(np.asarray, init_model(jax.random.key(1), cfg))
    for layer in params["lstm"]["layers"]:
        b = layer.pop("b")
        layer["b_ih"] = b * 0.25
        layer["b_hh"] = b * 0.75
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt")
        save_checkpoint(path, {"params": params}, {"epoch": 0})
        arrays, _ = load_checkpoint(path, like={"params": template})
    layer0 = arrays["params"]["lstm"]["layers"][0]
    assert sorted(layer0.keys()) == ["b_hh", "b_ih", "wh", "wx"]
    np.testing.assert_array_equal(
        layer0["b_ih"], params["lstm"]["layers"][0]["b_ih"]
    )
    np.testing.assert_array_equal(
        layer0["wx"], params["lstm"]["layers"][0]["wx"]
    )


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache goes to the fixed <repo>/.jax_cache."""
    import jax

    from weatherforecast_stgcn_maml_tpu.utils import compile_cache

    old = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "untouched")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = compile_cache.enable_compile_cache()
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
            assert compile_cache.enable_compile_cache() == path
            assert jax.config.jax_compilation_cache_dir == sentinel
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_checkpoint_roundtrip_keeps_optax_state_types(tmp_path):
    """npz checkpoints restore optax NamedTuple states through a template;
    a raw restore gives the same leaves as dicts and lists."""
    import jax

    from weatherforecast_stgcn_maml_tpu.config import MetaConfig, ModelConfig
    from weatherforecast_stgcn_maml_tpu.train.maml import init_meta_state

    cfg = ModelConfig(
        hidden_channels=8, gcn_layers=2, lstm_hidden=6, lstm_layers=2,
        window=4, horizon=2, koppen_dim=4,
    )
    state = init_meta_state(jax.random.key(0), cfg, MetaConfig())
    tree = {"params": state.params, "opt_state": state.opt_state}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tree, {"epoch": 1})
    back, meta = load_checkpoint(path, like=tree)
    assert meta == {"epoch": 1}
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    raw, _ = load_checkpoint(path)
    assert len(jax.tree.leaves(raw)) == len(jax.tree.leaves(tree))
    assert isinstance(raw["params"]["lstm"]["layers"], list)


def test_checkpoint_with_retired_config_keys_loads(tmp_path):
    """Checkpoints written before the kernel options were removed carry
    them in meta.json; reading ignores them."""
    import json as _json

    from weatherforecast_stgcn_maml_tpu.config import (
        ExperimentConfig,
        experiment_from_dict,
        to_dict,
    )

    config = to_dict(ExperimentConfig())
    config["model"].update(use_pallas_gcn=True, use_pallas_lstm=False, lstm_kernel="auto")
    config["meta"].update(fused_inner_update=True)
    path = str(tmp_path / "old")
    save_checkpoint(path, {"params": {"w": np.ones(3)}}, {"config": config})
    with open(os.path.join(path, "meta.json")) as f:
        assert _json.load(f)["config"]["model"]["lstm_kernel"] == "auto"
    arrays, meta = load_checkpoint(path, like={"params": {"w": np.zeros(3)}})
    np.testing.assert_array_equal(arrays["params"]["w"], np.ones(3))
    assert experiment_from_dict(meta["config"]) == ExperimentConfig()


@pytest.mark.parametrize(
    "argv,flag",
    [
        (["validate", "--region", "Moscow"], "--no-plots"),
        (["pipeline"], "--no-plots"),
        (["forecast", "--region", "Moscow", "--plots"], "no --plots"),
    ],
)
def test_plots_without_matplotlib_fail_before_any_work(monkeypatch, argv, flag):
    import importlib.util

    from weatherforecast_stgcn_maml_tpu import cli

    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "matplotlib" else real(name, *a),
    )
    with pytest.raises(SystemExit, match=flag):
        cli.main(argv + ["-o", "out_dir=/nonexistent-never-written"])


def test_summarize_trace_attributes_scopes():
    """Busy time is the union of kernel intervals; a kernel's scope comes
    from the op_name that its hlo_op maps to."""
    from jax.profiler import ProfileData

    from weatherforecast_stgcn_maml_tpu.utils.profiling import (
        hlo_op_names,
        summarize_trace,
    )

    def ev(meta, start_us, dur_us, op):
        return (
            f"events {{ metadata_id: {meta} offset_ps: {start_us * 1000000} "
            f"duration_ps: {dur_us * 1000000} stats {{ metadata_id: 9 str_value: \"{op}\" }} }}"
        )

    proto = f"""
    planes {{ id: 1 name: "/device:GPU:0"
      lines {{ id: 1 name: "Stream #13(Compute)" timestamp_ns: 0
        {ev(1, 0, 10, "fusion.1")} {ev(2, 5, 10, "custom-call.2")} {ev(1, 40, 10, "fusion.3")}
      }}
      event_metadata {{ key: 1 value {{ id: 1 name: "loop_fusion" }} }}
      event_metadata {{ key: 2 value {{ id: 2 name: "sm90_gemm" }} }}
      stat_metadata {{ key: 9 value {{ id: 9 name: "hlo_op" }} }}
    }}
    planes {{ id: 2 name: "/host:CPU" }}
    """
    hlo = (
        '%fusion.1 = f32[4] fusion(%p), metadata={op_name="jit(s)/jvp(lstm)/mul"}\n'
        '%custom-call.2 = f32[4] custom-call(%p), '
        'metadata={op_name="jit(s)/transpose(jvp(gcn_encoder))/dot_general"}\n'
    )
    names = hlo_op_names(hlo)
    assert names["custom-call.2"].endswith("gcn_encoder))/dot_general")
    s = summarize_trace(ProfileData.from_text_proto(proto), names)
    assert s["window_ns"] == 50_000 and s["busy_ns"] == 25_000
    assert s["kernels"] == 3 and s["kernel_ns"] == 30_000
    assert s["scopes_ns"] == {
        "gcn_encoder": 10_000, "lstm": 10_000, "inner_update": 0, "unattributed": 10_000,
    }
    assert s["top_kernels_ns"] == {"loop_fusion": 20_000, "sm90_gemm": 10_000}
