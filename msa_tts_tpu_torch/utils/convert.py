"""JAX parameter pytrees → the port's ``state_dict``, without jax.

Counterpart of ``msa_tts_tpu/utils/torch_import.py::pytrees_to_state_dict``:
the same key mapping, from nested dicts of numpy arrays (a JAX
``(params, state)`` pair after ``jax.device_get``, or a restored
checkpoint) to torch tensors that ``Tacotron2NV.load_state_dict(...,
strict=True)`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.tacotron2nv import ModelConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv_bn(sd: dict, base: str, layer: dict, bn_state: dict):
    sd[f"{base}.0.conv.weight"] = _t(layer["conv"]["weight"])
    sd[f"{base}.0.conv.bias"] = _t(layer["conv"]["bias"])
    sd[f"{base}.1.weight"] = _t(layer["bn"]["weight"])
    sd[f"{base}.1.bias"] = _t(layer["bn"]["bias"])
    sd[f"{base}.1.running_mean"] = _t(bn_state["running_mean"])
    sd[f"{base}.1.running_var"] = _t(bn_state["running_var"])
    sd[f"{base}.1.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def state_dict_from_jax(params_np: dict, state_np: dict,
                        cfg: ModelConfig) -> dict:
    """The reference-layout ``state_dict`` of a JAX ``(params, state)``
    pytree pair given as nested dicts/lists of numpy arrays."""
    sd: dict = {"embedding.weight": _t(params_np["embedding"]["weight"])}

    enc = params_np["encoder"]
    for i, (layer, bn_s) in enumerate(
        zip(enc["convolutions"], state_np["encoder"]["convolutions"])
    ):
        _conv_bn(sd, f"encoder.convolutions.{i}", layer, bn_s)
    for direction, suffix in (("forward", ""), ("backward", "_reverse")):
        p = enc["lstm"][direction]
        for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            sd[f"encoder.lstm.{k}_l0{suffix}"] = _t(p[k])

    if cfg.speaker_emb_type == "learnable_lookup":
        sd["speaker_embedder.weight"] = _t(
            params_np["speaker_embedder"]["weight"]
        )
    elif cfg.speaker_emb_type == "static+linear":
        sd["speaker_lin.weight"] = _t(params_np["speaker_lin"]["weight"])
        sd["speaker_lin.bias"] = _t(params_np["speaker_lin"]["bias"])

    dec = params_np["decoder"]
    for i, layer in enumerate(dec["prenet"]["layers"]):
        sd[f"decoder.prenet.layers.{i}.linear_layer.weight"] = _t(
            layer["weight"]
        )
    for rnn in ("attention_rnn", "decoder_rnn"):
        for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            sd[f"decoder.{rnn}.{k}"] = _t(dec[rnn][k])

    attn = dec["attention_layer"]
    al = "decoder.attention_layer"
    sd[f"{al}.query_layer.linear_layer.weight"] = _t(
        attn["query_layer"]["weight"]
    )
    sd[f"{al}.v.linear_layer.weight"] = _t(attn["v"]["weight"])
    if cfg.attention_params["attention_type"] == "ForwardAttention":
        sd[f"{al}.inputs_layer.linear_layer.weight"] = _t(
            attn["inputs_layer"]["weight"]
        )
        sd[f"{al}.v.linear_layer.bias"] = _t(attn["v"]["bias"])
        if "ta" in attn:
            sd[f"{al}.ta.weight"] = _t(attn["ta"]["weight"])
            sd[f"{al}.ta.bias"] = _t(attn["ta"]["bias"])
        conv_key = f"{al}.location_layer.location_conv1d.weight"
    else:
        sd[f"{al}.memory_layer.linear_layer.weight"] = _t(
            attn["memory_layer"]["weight"]
        )
        conv_key = f"{al}.location_layer.location_conv.conv.weight"
    if "location_layer" in attn:
        loc = attn["location_layer"]
        sd[conv_key] = _t(loc["location_conv1d"]["weight"])
        sd[f"{al}.location_layer.location_dense.linear_layer.weight"] = _t(
            loc["location_dense"]["weight"]
        )

    for name in ("linear_projection", "gate_layer"):
        sd[f"decoder.{name}.linear_layer.weight"] = _t(dec[name]["weight"])
        sd[f"decoder.{name}.linear_layer.bias"] = _t(dec[name]["bias"])

    for i, (layer, bn_s) in enumerate(
        zip(params_np["postnet"]["convolutions"],
            state_np["postnet"]["convolutions"])
    ):
        _conv_bn(sd, f"postnet.convolutions.{i}", layer, bn_s)
    return sd
