"""Training-recipe parity vs a fresh torch implementation of the reference
adaptation loop (adapt_hybrid_v5.py:164-231, adaptive_scheduler.py:7-95).

Complements tests/test_forward_parity.py (same function from imported
weights) with STEP-level training parity: from the same torch init, the
same window sequence, the same climate-aware Adam (L2-in-gradient weight
decay, zone multipliers), and the same grad clip, both systems must produce
the same per-step loss sequence to float64 accuracy. The f32 engine
trajectory then diverges only by fp chaos — bounded loosely here and
measured over the full 15-epoch recipe in benchmarks/recipe_parity.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.config import ModelConfig
from weatherforecast_stgcn_maml_tpu.data.preprocess import prepare_features
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu.train.optimizers import (
    ClimateLRSchedule,
    adaptation_optimizer,
)
from weatherforecast_stgcn_maml_tpu.utils.torch_import import (
    params_from_state_dicts,
)

KOPPEN_DIM = 4
HIDDEN, GCN_LAYERS = 16, 2
LSTM_HIDDEN, LSTM_LAYERS = 8, 2
WINDOW, HORIZON = 6, 2
N_STEPS = 24
REGION = "Moscow"  # cold zone: lr x1.1, wd 5e-5


class _RefConv(torch.nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.lin = torch.nn.Linear(d_in, d_out, bias=False)
        self.bias = torch.nn.Parameter(torch.randn(d_out) * 0.1)

    def forward(self, a, x):
        return a @ self.lin(x) + self.bias


class _RefHybrid(torch.nn.Module):
    """Reference HybridSTGCN_LSTM semantics (hybrid_model.py:60-117)."""

    def __init__(self, n):
        super().__init__()
        in_ch = 16 + KOPPEN_DIM
        self.convs = torch.nn.ModuleList([
            _RefConv(in_ch if i == 0 else HIDDEN, HIDDEN)
            for i in range(GCN_LAYERS)
        ])
        self.lstm = torch.nn.LSTM(
            HIDDEN, LSTM_HIDDEN, num_layers=LSTM_LAYERS, batch_first=True
        )
        self.head = torch.nn.Linear(LSTM_HIDDEN, 12 * HORIZON)
        self.n = n

    def forward(self, a, x):  # [W, N, C]
        h = x
        for conv in self.convs:
            h = torch.relu(conv(a, h))
        h = h.permute(1, 0, 2)
        out, _ = self.lstm(h)
        return self.head(out[:, -1, :]).view(self.n, HORIZON, 12)


def test_adaptation_recipe_matches_torch_in_f64():
    jax.config.update("jax_enable_x64", True)
    try:
        torch.manual_seed(0)
        model_cfg = ModelConfig(
            hidden_channels=HIDDEN, gcn_layers=GCN_LAYERS,
            lstm_hidden=LSTM_HIDDEN, lstm_layers=LSTM_LAYERS,
            window=WINDOW, horizon=HORIZON, koppen_dim=KOPPEN_DIM,
            gcn_dropout=0.0, lstm_dropout=0.0,
            compute_dtype="float64",
            # Reference recipe: the Koppen embedding is NOT in the
            # adaptation optimizer (quirk 11, adapt_hybrid_v5.py:172) —
            # the torch arm bakes it into the features.
            train_koppen_embedding=False,
        )
        region = synthetic_region_for_box(
            (10.0, 10.75, 20.0, 20.75), num_timesteps=40, seed=5, name=REGION
        )
        feats16, _ = prepare_features(region)
        graph = build_region_graph(region.lats, region.lons)
        n = feats16.shape[1]
        spec = WindowSpec(WINDOW, HORIZON)
        anchors = spec.valid_anchors(region.num_timesteps)[:N_STEPS]
        kcode = max(0, int(region.koppen_code))

        model = _RefHybrid(n).double()
        emb_t = torch.nn.Embedding(31, KOPPEN_DIM).double()
        # Clone at export: the torch arm trains these tensors in place
        # below, and the jax arm must start from the INIT.
        hybrid_state = {}
        for i, conv in enumerate(model.convs, start=1):
            hybrid_state[f"base_stgcn.conv{i}.lin.weight"] = (
                conv.lin.weight.detach().clone())
            hybrid_state[f"base_stgcn.conv{i}.bias"] = (
                conv.bias.detach().clone())
        for k, v in model.lstm.state_dict().items():
            hybrid_state[f"lstm.{k}"] = v.detach().clone()
        hybrid_state["output_layer.weight"] = (
            model.head.weight.detach().clone())
        hybrid_state["output_layer.bias"] = model.head.bias.detach().clone()

        # ---- torch arm: the reference's executed loop -------------------
        emb = emb_t.weight.detach().numpy()[kcode]
        x24 = np.concatenate(
            [feats16, np.broadcast_to(emb, (*feats16.shape[:2], KOPPEN_DIM))],
            axis=-1,
        ).astype(np.float64)
        a_t = torch.from_numpy(np.asarray(graph.a_hat)[:n, :n].astype(np.float64))
        feats_t = torch.from_numpy(feats16.astype(np.float64))
        xs_t = torch.from_numpy(x24)
        lr0 = 6e-4 * 1.1
        opt = torch.optim.Adam(model.parameters(), lr=lr0, weight_decay=5e-5)
        crit = torch.nn.MSELoss()
        model.train()
        torch_losses = []
        for t in anchors:
            t = int(t)
            xw = xs_t[t - WINDOW:t]
            yw = feats_t[t + 1:t + 1 + HORIZON, :, :12].permute(1, 0, 2)
            opt.zero_grad()
            loss = crit(model(a_t, xw), yw)
            loss.backward()
            torch.nn.utils.clip_grad_norm_(model.parameters(), max_norm=1.0)
            opt.step()
            torch_losses.append(loss.item())

        # ---- jax arm: this framework's adaptation step ------------------
        params = params_from_state_dicts(
            {k: v.detach() for k, v in hybrid_state.items()},
            {"embedding.weight": emb_t.weight.detach()}, model_cfg,
        )
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
        from weatherforecast_stgcn_maml_tpu.models.registry import apply_model

        tx, lr0_j = adaptation_optimizer(REGION)
        assert abs(lr0_j - lr0) < 1e-12
        from weatherforecast_stgcn_maml_tpu.train.optimizers import (
            masked_freeze, trainable_mask,
        )

        tx = masked_freeze(tx, trainable_mask(params, model_cfg))
        opt_state = tx.init(params)
        n_pad = graph.a_hat.shape[0]
        a_j = jnp.asarray(graph.a_hat, jnp.float64)
        mask = np.zeros(n_pad); mask[:n] = 1.0
        mask_j = jnp.asarray(mask, jnp.float64)
        feats_pad = np.zeros((feats16.shape[0], n_pad, 16))
        feats_pad[:, :n] = feats16
        feats_j = jnp.asarray(feats_pad, jnp.float64)

        def loss_fn(p, x, y):
            preds = apply_model(
                p, a_j, x, jnp.asarray(kcode), model_cfg, train=True, rng=None
            )
            return masked_mse(preds, y, mask_j)

        step = jax.jit(
            lambda p, o, x, y: _step(p, o, x, y)
        )

        def _step(p, o, x, y):
            loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
            updates, o = tx.update(grads, o, p)
            p = jax.tree.map(lambda a, u: a - lr0 * u, p, updates)
            return p, o, loss

        jax_losses = []
        for t in anchors:
            t = int(t)
            x = feats_j[t - WINDOW:t]
            y = feats_j[t + 1:t + 1 + HORIZON, :, :12]
            params, opt_state, loss = step(params, opt_state, x, y)
            jax_losses.append(float(loss))

        np.testing.assert_allclose(jax_losses, torch_losses, rtol=1e-7)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_climate_lr_schedule_matches_reference_rule():
    """ClimateLRSchedule reproduces ClimateAwareLRScheduler.step exactly
    (adaptive_scheduler.py:39-66) including the loss nudges."""
    sched = ClimateLRSchedule("Moscow", base_lr=6e-4)
    lrs = [sched.step(epoch_loss=loss)
           for loss in (2.0, 0.5, 0.1, 1.5, 0.15, 0.5)]
    mult = 1.1
    exp = []
    for e, loss in enumerate((2.0, 0.5, 0.1, 1.5, 0.15, 0.5), start=1):
        progress = (e - 1) % 5 / 5
        lr = 6e-4 * mult * 0.5 * (1 + np.cos(np.pi * progress))
        if e > 3:
            if loss > 1.0:
                lr *= 1.1
            elif loss < 0.2:
                lr *= 0.95
        exp.append(lr)
    np.testing.assert_allclose(lrs, exp, rtol=1e-12)
