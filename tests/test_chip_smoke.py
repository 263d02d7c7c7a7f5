"""chip_smoke.py on the CPU: it refuses to run without a GPU, its phase
selection, the format of its last line, and its phases at a tiny width."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = [
    "model.hidden_channels=16", "model.gcn_layers=2", "model.lstm_hidden=8",
    "model.lstm_layers=2", "model.window=6", "model.horizon=3",
    "meta.meta_batch=2", "meta.grad_accum=1", "meta.inner_epochs=1",
    "meta.inner_batches=2", "data.synthetic_timesteps=64",
    "data.validate_max_timesteps=20", "adapt.max_samples=40", "adapt.batch_size=4",
]


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    res = _run(REPO, "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize(
    "argv,phases",
    [
        ([], chip_smoke.ONE_GPU_PHASES),
        (["--trace", "t"], chip_smoke.ONE_GPU_PHASES + ("trace",)),
        (["--four"], ("dp", "dp_sp", "fleet")),
    ],
)
def test_phase_selection(argv, phases):
    assert chip_smoke.select_phases(chip_smoke.parse_args(argv)) == phases


@pytest.mark.parametrize("four", [False, True])
def test_last_line_names_the_device(monkeypatch, capsys, four):
    ran = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(chip_smoke, "_card_line", lambda: "Card, 700.00 W")
    # No native build here: tests/test_native.py builds the library.
    from weatherforecast_stgcn_maml_tpu import native

    monkeypatch.setattr(native, "build", lambda quiet=True: False)
    monkeypatch.setattr(
        chip_smoke, "PHASES",
        {k: (lambda ctx, k=k: ran.append(k)) for k in chip_smoke.PHASES},
    )
    old_dir = jax.config.jax_compilation_cache_dir
    try:
        assert chip_smoke.main(["--four"] if four else []) == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
    assert tuple(ran) == (chip_smoke.FOUR_GPU_PHASES if four else chip_smoke.ONE_GPU_PHASES)
    lines = capsys.readouterr().out.strip().splitlines()
    assert any("Card, 700.00 W" in line for line in lines[:-1])
    dev = jax.devices()[0]
    assert json.loads(lines[-1]) == {
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }


def test_a_failed_check_raises():
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke.check(False, "boom")


def test_phases_run_at_tiny_width_on_cpu(tmp_path, capsys):
    ctx = chip_smoke.Ctx(str(tmp_path), TINY)
    for name in chip_smoke.ONE_GPU_PHASES:
        chip_smoke.PHASES[name](ctx)
    out = capsys.readouterr().out
    for name in chip_smoke.ONE_GPU_PHASES:
        assert f"[{name}]" in out
    assert "forecast_shape=[3, 12]" in out


def test_four_gpu_phases_run_at_tiny_width_on_cpu_devices(tmp_path, capsys):
    """The --four phases on four of the virtual CPU devices, each checked
    against its one-device reference within the script's tolerance."""
    # The phases set their own meta batch and accumulation.
    sizes = [o for o in TINY if not o.startswith(("meta.meta_batch", "meta.grad_accum"))]
    ctx = chip_smoke.Ctx(str(tmp_path), sizes)
    for name in chip_smoke.FOUR_GPU_PHASES:
        chip_smoke.PHASES[name](ctx)
    out = capsys.readouterr().out
    for tag in ("impl=dp4", "impl=shardmap", "impl=gspmd", "[fleet] regions=4"):
        assert tag in out


def test_main_path_imports_no_optional_package(tmp_path):
    """meta-train -> adapt -> validate --no-plots -> forecast imports none
    of the packages the GPU machine may lack (Orbax, pandas, matplotlib,
    torch, xarray)."""
    flags = [x for o in TINY + [f"out_dir={tmp_path}"] for x in ("-o", o)]
    script = (
        "import sys\n"
        "from weatherforecast_stgcn_maml_tpu.cli import main\n"
        f"flags = {flags!r}\n"
        "for argv in (['meta-train'], ['adapt', '--region', 'Moscow'],\n"
        "             ['validate', '--region', 'Moscow', '--no-plots'],\n"
        "             ['forecast', '--region', 'Moscow']):\n"
        "    assert main(argv + flags) == 0\n"
        "bad = {'orbax', 'pandas', 'matplotlib', 'torch', 'xarray'}\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & bad))\n"
    )
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
        JAX_ENABLE_COMPILATION_CACHE="false",
    )
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
