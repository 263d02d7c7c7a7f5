"""Climate-aware optimizer/scheduler parity (adaptive_scheduler.py logic)."""

import numpy as np
import pytest

from weatherforecast_stgcn_maml_tpu.train.optimizers import (
    CLIMATE_LR_MULT,
    ClimateLRSchedule,
    adaptation_optimizer,
    climate_zone,
)


def test_climate_zones():
    assert climate_zone("Thailand") == "tropical"
    assert climate_zone("Indonesia") == "tropical"
    assert climate_zone("QueensAustralia") == "tropical"
    assert climate_zone("Moscow") == "cold"
    assert climate_zone("NorthSiberia") == "cold"
    assert climate_zone("Afghanistan") == "cold"
    assert climate_zone("NewYork") == "temperate"
    assert climate_zone("anything-else") == "temperate"


def test_adaptation_optimizer_zone_lr():
    _, lr_trop = adaptation_optimizer("Thailand", base_lr=6e-4)
    _, lr_temp = adaptation_optimizer("NewYork", base_lr=6e-4)
    _, lr_cold = adaptation_optimizer("Moscow", base_lr=6e-4)
    assert lr_trop == pytest.approx(6e-4 * 0.9)
    assert lr_temp == pytest.approx(6e-4)
    assert lr_cold == pytest.approx(6e-4 * 1.1)


def test_climate_lr_schedule_cosine_and_nudges():
    """Mirror the reference schedule (adaptive_scheduler.py:39-62): 5-epoch
    cosine cycles x zone multiplier, loss nudges only after epoch 3."""
    s = ClimateLRSchedule("Moscow", base_lr=1e-3)
    mult = CLIMATE_LR_MULT["cold"]
    # Epoch 1: progress 0 -> cosine factor 1.
    assert s.step(None) == pytest.approx(1e-3 * mult)
    # Epoch 2: progress 1/5 -> 0.5*(1+cos(pi/5)).
    expected = 1e-3 * mult * 0.5 * (1 + np.cos(np.pi / 5))
    assert s.step(None) == pytest.approx(expected)
    # Epochs 3-4 advance; nudges are inactive until current_epoch > 3.
    s.step(5.0)  # epoch 3: high loss but no nudge yet
    lr4_high = s.step(5.0)  # epoch 4: nudge x1.1 applies
    base4 = 1e-3 * mult * 0.5 * (1 + np.cos(np.pi * 3 / 5))
    assert lr4_high == pytest.approx(base4 * 1.1)
    # Epoch 5: very low loss -> x0.95.
    lr5_low = s.step(0.1)
    base5 = 1e-3 * mult * 0.5 * (1 + np.cos(np.pi * 4 / 5))
    assert lr5_low == pytest.approx(base5 * 0.95)
    # Epoch 6: cycle restarts -> cosine factor 1 again.
    lr6 = s.step(0.5)
    assert lr6 == pytest.approx(1e-3 * mult)


def test_masked_freeze_zeroes_frozen_updates():
    """Frozen (mask=False) leaves must get EXACTLY zero updates.

    Bare optax.masked passes non-masked updates through UNCHANGED (the raw
    gradient) — with the framework's `p - lr*u` application that silently
    trains "frozen" subtrees by plain SGD (caught live: the Koppen table
    leaked ~1e-6/step under train_koppen_embedding=False)."""
    import jax.numpy as jnp
    import optax

    from weatherforecast_stgcn_maml_tpu.train.optimizers import masked_freeze

    tx, _ = adaptation_optimizer("Moscow", 1e-3)
    mask = {"a": True, "koppen": False}
    frozen = masked_freeze(tx, mask)
    params = {"a": jnp.ones(3), "koppen": jnp.ones(3)}
    grads = {"a": jnp.full(3, 0.5), "koppen": jnp.full(3, 0.5)}
    state = frozen.init(params)
    updates, _ = frozen.update(grads, state, params)
    np.testing.assert_array_equal(np.asarray(updates["koppen"]), 0.0)
    assert np.all(np.asarray(updates["a"]) != 0.0)

    # The buggy pattern: bare masked leaks the raw gradient through.
    leaky = optax.masked(tx, mask)
    lu, _ = leaky.update(grads, leaky.init(params), params)
    np.testing.assert_array_equal(np.asarray(lu["koppen"]), 0.5)

    # Trainable-leaf updates are bit-identical to the unwrapped chain over
    # the trainable subtree alone (clip norm must exclude frozen grads).
    solo_u, _ = tx.update(
        {"a": grads["a"]}, tx.init({"a": params["a"]}), {"a": params["a"]}
    )
    np.testing.assert_array_equal(
        np.asarray(updates["a"]), np.asarray(solo_u["a"])
    )
