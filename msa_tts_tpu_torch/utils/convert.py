"""JAX parameter pytrees ↔ the port's ``state_dict``, without jax.

Counterpart of ``msa_tts_tpu/utils/torch_import.py`` (its
``state_dict_to_pytrees`` and ``pytrees_to_state_dict``): the same key
mapping between nested dicts of numpy arrays (a JAX ``(params, state)``
pair after ``jax.device_get``, or a restored checkpoint) and the torch
tensors that ``Tacotron2NV.load_state_dict(..., strict=True)`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.tacotron2nv import ModelConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


_LSTM = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _layout(cfg: ModelConfig):
    """``(tree, path, key)`` for every tensor of the model: ``tree``
    ``"params"`` or ``"state"`` of the JAX pair, ``path`` the keys into
    it (ints index lists), ``key`` the ``state_dict`` name."""
    out = [("params", ("embedding", "weight"), "embedding.weight")]

    def conv_bn(part, n):
        for i in range(n):
            base = f"{part}.convolutions.{i}"
            for sub, name in (("conv", "0.conv"), ("bn", "1")):
                for k in ("weight", "bias"):
                    out.append(("params", (part, "convolutions", i, sub, k),
                                f"{base}.{name}.{k}"))
            for k in ("running_mean", "running_var"):
                out.append(("state", (part, "convolutions", i, k),
                            f"{base}.1.{k}"))

    conv_bn("encoder", cfg.encoder_n_convolutions)
    for direction, suffix in (("forward", ""), ("backward", "_reverse")):
        for k in _LSTM:
            out.append(("params", ("encoder", "lstm", direction, k),
                        f"encoder.lstm.{k}_l0{suffix}"))
    if cfg.speaker_emb_type == "learnable_lookup":
        out.append(("params", ("speaker_embedder", "weight"),
                    "speaker_embedder.weight"))
    elif cfg.speaker_emb_type == "static+linear":
        for k in ("weight", "bias"):
            out.append(("params", ("speaker_lin", k), f"speaker_lin.{k}"))

    dec = ("decoder",)
    for i in range(2):
        out.append(("params", dec + ("prenet", "layers", i, "weight"),
                    f"decoder.prenet.layers.{i}.linear_layer.weight"))
    for rnn in ("attention_rnn", "decoder_rnn"):
        for k in _LSTM:
            out.append(("params", dec + (rnn, k), f"decoder.{rnn}.{k}"))
    ap = cfg.attention_params
    al, at = "decoder.attention_layer", dec + ("attention_layer",)
    forward = ap["attention_type"] == "ForwardAttention"
    linears = [("query_layer", "weight"),
               ("inputs_layer" if forward else "memory_layer", "weight"),
               ("v", "weight")] + ([("v", "bias")] if forward else [])
    for name, k in linears:
        out.append(("params", at + (name, k), f"{al}.{name}.linear_layer.{k}"))
    if forward and ap.get("trans_agent", True):
        for k in ("weight", "bias"):
            out.append(("params", at + ("ta", k), f"{al}.ta.{k}"))
    if not forward or ap.get("location_attention", True):
        conv = "location_conv1d" if forward else "location_conv.conv"
        loc = at + ("location_layer",)
        out.append(("params", loc + ("location_conv1d", "weight"),
                    f"{al}.location_layer.{conv}.weight"))
        out.append(("params", loc + ("location_dense", "weight"),
                    f"{al}.location_layer.location_dense.linear_layer.weight"))
    for name in ("linear_projection", "gate_layer"):
        for k in ("weight", "bias"):
            out.append(("params", dec + (name, k),
                        f"decoder.{name}.linear_layer.{k}"))
    conv_bn("postnet", cfg.postnet_n_convolutions)
    return out


def _get(tree, path):
    for p in path:
        # a list, or a restored checkpoint's {"0": ..., "1": ...} map
        tree = tree[p] if isinstance(tree, list) else tree[
            str(p) if isinstance(p, int) else p]
    return tree


def state_dict_from_jax(params_np: dict, state_np: dict,
                        cfg: ModelConfig) -> dict:
    """The reference-layout ``state_dict`` of a JAX ``(params, state)``
    pytree pair given as nested dicts and lists of numpy arrays, or as
    the JAX package's checkpoint or voice file restored (lists as
    ``{"0": ...}`` maps)."""
    trees = {"params": params_np, "state": state_np}
    sd = {}
    for tree, path, key in _layout(cfg):
        sd[key] = _t(_get(trees[tree], path))
        if key.endswith(".running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = (
                torch.zeros((), dtype=torch.int64))
    return sd


def jax_from_state_dict(sd: dict, cfg: ModelConfig):
    """The inverse of :func:`state_dict_from_jax`: the JAX package's
    ``(params, state)`` trees (nested dicts and lists of float32 numpy
    arrays), as its ``init_tacotron2nv`` lays them out, of a
    ``state_dict``."""
    trees: dict = {"params": {}, "state": {}}
    for tree, path, key in _layout(cfg):
        node = trees[tree]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = sd[key].detach().to("cpu", torch.float32).numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(trees["params"]), lists(trees["state"])


# ------------------------------------------------------------- vocoders

def _bn(sd: dict, base: str, p: dict, s: dict):
    sd[f"{base}.weight"] = _t(p["weight"])
    sd[f"{base}.bias"] = _t(p["bias"])
    sd[f"{base}.running_mean"] = _t(s["running_mean"])
    sd[f"{base}.running_var"] = _t(s["running_var"])
    sd[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def wavernn_state_dict_from_jax(params_np: dict, state_np: dict,
                                cfg) -> dict:
    """The reference-layout WaveRNN ``state_dict`` of a JAX ``(params,
    state)`` pair given as nested dicts/lists of numpy arrays: the
    inverse of the JAX package's ``wavernn_params_from_state_dict``.
    ``vocoders.wavernn.WaveRNNModel(cfg)`` loads it with
    ``strict=True``."""
    sd: dict = {}
    rn = "upsample.resnet"
    rp = params_np["upsample"]["resnet"]
    rs = state_np["upsample"]["resnet"]
    sd[f"{rn}.conv_in.weight"] = _t(rp["conv_in"]["weight"])
    _bn(sd, f"{rn}.batch_norm", rp["batch_norm"], rs["batch_norm"])
    for i, (layer, st) in enumerate(zip(rp["layers"], rs["layers"])):
        base = f"{rn}.layers.{i}"
        sd[f"{base}.conv1.weight"] = _t(layer["conv1"]["weight"])
        sd[f"{base}.conv2.weight"] = _t(layer["conv2"]["weight"])
        _bn(sd, f"{base}.batch_norm1", layer["batch_norm1"],
            st["batch_norm1"])
        _bn(sd, f"{base}.batch_norm2", layer["batch_norm2"],
            st["batch_norm2"])
    sd[f"{rn}.conv_out.weight"] = _t(rp["conv_out"]["weight"])
    sd[f"{rn}.conv_out.bias"] = _t(rp["conv_out"]["bias"])
    # the module list interleaves [stretch, conv]: convs at odd indices,
    # stored as (1, 1, 1, k)
    for i, conv in enumerate(params_np["upsample"]["up_convs"]):
        sd[f"upsample.up_layers.{2 * i + 1}.weight"] = _t(
            np.asarray(conv["weight"])[:, :, None, :])
    for name in ("I", "fc1", "fc2", "fc3"):
        sd[f"{name}.weight"] = _t(params_np[name]["weight"])
        sd[f"{name}.bias"] = _t(params_np[name]["bias"])
    for name in ("rnn1", "rnn2"):
        for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            sd[f"{name}.{k}_l0"] = _t(params_np[name][k])
    return sd


def hifigan_state_dict_from_jax(params_np: dict, h: dict) -> dict:
    """The HiFi-GAN generator ``state_dict`` (plain, already fused
    weights) of a JAX generator pytree given as nested dicts/lists of
    numpy arrays: the inverse of the JAX package's
    ``generator_params_from_state_dict``.
    ``vocoders.hifigan.Generator(h, n_mels)`` loads it with
    ``strict=True``."""
    sd: dict = {}

    def conv(base, p):
        sd[f"{base}.weight"] = _t(p["weight"])
        sd[f"{base}.bias"] = _t(p["bias"])

    conv("conv_pre", params_np["conv_pre"])
    for i, p in enumerate(params_np["ups"]):
        conv(f"ups.{i}", p)
    for i, block in enumerate(params_np["resblocks"]):
        for group, convs in block.items():       # convs1/convs2 or convs
            for j, p in enumerate(convs):
                conv(f"resblocks.{i}.{group}.{j}", p)
    conv("conv_post", params_np["conv_post"])
    return sd
