"""Export this framework's params back to the reference `.pt` schema.

The inverse of `utils/torch_import.py` (VERDICT r2 missing #2): a model
meta-trained or adapted here can be handed back to a reference user as a
checkpoint loadable by their engines (adapt_hybrid_v5.py:84-123,
validate_hybrid_v5.py:35-110), completing round-trip interop. Written with
`torch.save` using the exact key layout of train_hybrid_maml_v5.py:311-335
(meta) / adapt_hybrid_v5.py:240-257 (adapted, incl. normalization `stats`).

Mapping is the transpose of the importer's (see its docstring):
  * encoder layer `w` [in, out] -> `base_stgcn.conv{i}.lin.weight` [out, in]
    and `b` -> `base_stgcn.conv{i}.bias`;
  * `wx` [in, 4H] -> `lstm.weight_ih_l{k}` [4H, in]; `wh` -> weight_hh;
    our single bias `b` -> `bias_ih_l{k}` with `bias_hh_l{k}` zeros (torch
    adds them, so the sum — the only thing the math sees — is preserved);
  * head `w`/`b` -> `output_layer.weight` (transposed) / `.bias`;
  * `koppen` [31, 8] -> `koppen_embed_state_dict["embedding.weight"]`.

The reference STGCN's own `output_layer` is dead weight in the hybrid path
(SURVEY quirk 4) but present in its state dict; it is synthesized as zeros
so `load_state_dict(strict=True)` on the reference side succeeds.
"""

from __future__ import annotations

import numpy as np

from weatherforecast_stgcn_maml_tpu.config import ModelConfig


def state_dicts_from_params(params: dict, cfg: ModelConfig):
    """Param tree -> (hybrid_state_dict, koppen_state_dict) as numpy arrays.

    Callers convert to torch tensors (`export_torch_checkpoint` does).
    """
    hybrid: dict[str, np.ndarray] = {}
    for i, layer in enumerate(params["encoder"]["layers"], start=1):
        hybrid[f"base_stgcn.conv{i}.lin.weight"] = (
            np.asarray(layer["w"], np.float32).T.copy()
        )
        hybrid[f"base_stgcn.conv{i}.bias"] = np.asarray(layer["b"], np.float32)
    # Dead-weight STGCN head (model.py:28): zeros of the reference shape.
    out_dim = cfg.num_weather_vars * cfg.horizon
    hybrid["base_stgcn.output_layer.weight"] = np.zeros(
        (out_dim, cfg.hidden_channels), np.float32
    )
    hybrid["base_stgcn.output_layer.bias"] = np.zeros(out_dim, np.float32)

    for l, layer in enumerate(params["lstm"]["layers"]):
        hybrid[f"lstm.weight_ih_l{l}"] = (
            np.asarray(layer["wx"], np.float32).T.copy()
        )
        hybrid[f"lstm.weight_hh_l{l}"] = (
            np.asarray(layer["wh"], np.float32).T.copy()
        )
        if "b" in layer:
            # Native fused bias: torch's two copies carry it as ih + zeros.
            b = np.asarray(layer["b"], np.float32)
            hybrid[f"lstm.bias_ih_l{l}"] = b
            hybrid[f"lstm.bias_hh_l{l}"] = np.zeros_like(b)
        else:
            # Torch-imported split biases round-trip exactly.
            hybrid[f"lstm.bias_ih_l{l}"] = np.asarray(
                layer["b_ih"], np.float32
            )
            hybrid[f"lstm.bias_hh_l{l}"] = np.asarray(
                layer["b_hh"], np.float32
            )

    hybrid["output_layer.weight"] = (
        np.asarray(params["head"]["w"], np.float32).T.copy()
    )
    hybrid["output_layer.bias"] = np.asarray(params["head"]["b"], np.float32)

    koppen = {"embedding.weight": np.asarray(params["koppen"], np.float32)}
    return hybrid, koppen


def export_torch_checkpoint(
    path: str,
    params: dict,
    cfg: ModelConfig,
    *,
    stats=None,
    region: tuple | None = None,
    region_name: str | None = None,
    extra_meta: dict | None = None,
) -> str:
    """Write a reference-schema `.pt` checkpoint. Requires torch (CPU ok).

    With `stats`/`region*` set, the adapted-checkpoint schema is written
    (adapt_hybrid_v5.py:240-257); otherwise the meta-checkpoint schema
    (train_hybrid_maml_v5.py:311-335, sans optimizer/scheduler states —
    those are torch-object internals a JAX run has no equivalent of, and
    the reference never reloads them to resume, SURVEY section 5).
    """
    import torch

    hybrid_np, koppen_np = state_dicts_from_params(params, cfg)
    # np.array(copy=True): JAX array views are read-only and torch rejects
    # non-writable buffers.
    hybrid_sd = {k: torch.from_numpy(np.array(v, copy=True))
                 for k, v in hybrid_np.items()}
    koppen_sd = {k: torch.from_numpy(np.array(v, copy=True))
                 for k, v in koppen_np.items()}

    total_params = int(sum(v.numel() for v in hybrid_sd.values())
                       + sum(v.numel() for v in koppen_sd.values()))
    ckpt: dict = {
        "hybrid_model_state_dict": hybrid_sd,
        "koppen_embed_state_dict": koppen_sd,
        "model_version": "5.0",
        "total_params": total_params,
        "config": {
            "input_channels": cfg.in_channels,
            "hidden_channels": cfg.hidden_channels,
            "output_channels": cfg.num_weather_vars,
            "window_size": cfg.window,
            "forecast_horizon": cfg.horizon,
        },
        "hybrid_config": {
            "lstm_hidden_size": cfg.lstm_hidden,
            "lstm_num_layers": cfg.lstm_layers,
            "lstm_dropout": cfg.lstm_dropout,
        },
        "exported_by": "weatherforecast_stgcn_maml_tpu",
    }
    if stats is not None:
        sd = stats.to_dict() if hasattr(stats, "to_dict") else dict(stats)
        ckpt["stats"] = {
            "mean": np.asarray(sd["mean"], np.float32),
            "std": np.asarray(sd["std"], np.float32),
        }
    if region is not None:
        ckpt["region"] = tuple(region)
        ckpt["adaptation_type"] = "v5_regional_adaptation_adaptive"
        ckpt["climate_type"] = "Adapted_Region"
    if region_name is not None:
        ckpt["region_name"] = region_name
    if extra_meta:
        ckpt.update(extra_meta)
    torch.save(ckpt, path)
    return path
