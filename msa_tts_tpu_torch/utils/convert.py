"""JAX parameter pytrees ↔ the port's ``state_dict``, without jax.

Counterpart of ``msa_tts_tpu/utils/torch_import.py`` (its
``state_dict_to_pytrees`` and ``pytrees_to_state_dict``): the same key
mapping between nested dicts of numpy arrays (a JAX ``(params, state)``
pair after ``jax.device_get``, or a restored checkpoint) and the torch
tensors that ``Tacotron2NV.load_state_dict(..., strict=True)`` takes;
and both ways for the vocoders' trees: WaveRNN's ``(params, state)``,
and by :func:`tree_to_state_dict` / :func:`state_dict_to_tree` the
HiFi-GAN generator's and its discriminators' (whose modules are named as
the JAX trees nest, so their keys are the trees' paths).
In every input tree a list may also be a restored checkpoint's
``{"0": ..., "1": ...}`` map.
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

def _seq(node) -> list:
    """A list of a tree, or of a restored checkpoint's ``{"0": ...}``
    map."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def tree_to_state_dict(tree, prefix: str = "") -> dict:
    """A nested tree of arrays as ``{dotted path: float32 tensor}``
    (list entries by index): the ``state_dict`` of a module named as the
    tree nests."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if not isinstance(tree, dict):
        return {prefix[:-1]: _t(tree)}
    out = {}
    for k, v in tree.items():
        out.update(tree_to_state_dict(v, f"{prefix}{k}."))
    return out


def state_dict_to_tree(sd: dict):
    """The inverse of :func:`tree_to_state_dict`: nested dicts, with
    lists where every key of a level is an index, of float32 numpy
    arrays."""
    root: dict = {}
    for key, v in sd.items():
        node = root
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v.detach().to("cpu", torch.float32).numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


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
    for i, (layer, st) in enumerate(zip(_seq(rp["layers"]),
                                        _seq(rs["layers"]))):
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
    for i, conv in enumerate(_seq(params_np["upsample"]["up_convs"])):
        sd[f"upsample.up_layers.{2 * i + 1}.weight"] = _t(
            np.asarray(conv["weight"])[:, :, None, :])
    for name in ("I", "fc1", "fc2", "fc3"):
        sd[f"{name}.weight"] = _t(params_np[name]["weight"])
        sd[f"{name}.bias"] = _t(params_np[name]["bias"])
    for name in ("rnn1", "rnn2"):
        for k in _LSTM:
            sd[f"{name}.{k}_l0"] = _t(params_np[name][k])
    return sd


def wavernn_jax_from_state_dict(sd: dict, cfg):
    """The inverse of :func:`wavernn_state_dict_from_jax`: the JAX
    package's WaveRNN ``(params, state)`` trees, as its ``init_wavernn``
    lays them out, of float32 numpy arrays.  ``sd`` may hold the
    parameters alone (gradients, Adam's moments): the state is then
    None."""
    def a(key):
        return sd[key].detach().to("cpu", torch.float32).numpy()

    def bn(base):
        return ({"weight": a(f"{base}.weight"), "bias": a(f"{base}.bias")},
                {"running_mean": a(f"{base}.running_mean"),
                 "running_var": a(f"{base}.running_var")}
                if f"{base}.running_mean" in sd else None)

    rn = "upsample.resnet"
    bn_p, bn_s = bn(f"{rn}.batch_norm")
    layers, layers_s = [], []
    for i in range(cfg.res_blocks):
        base = f"{rn}.layers.{i}"
        (p1, s1), (p2, s2) = bn(f"{base}.batch_norm1"), bn(
            f"{base}.batch_norm2")
        layers.append({"conv1": {"weight": a(f"{base}.conv1.weight")},
                       "conv2": {"weight": a(f"{base}.conv2.weight")},
                       "batch_norm1": p1, "batch_norm2": p2})
        layers_s.append({"batch_norm1": s1, "batch_norm2": s2})
    resnet = {"conv_in": {"weight": a(f"{rn}.conv_in.weight")},
              "batch_norm": bn_p, "layers": layers,
              "conv_out": {"weight": a(f"{rn}.conv_out.weight"),
                           "bias": a(f"{rn}.conv_out.bias")}}
    n_up = len(cfg.upsample_factors) if cfg.use_upsample_net else 0
    params = {"upsample": {"resnet": resnet, "up_convs": [
        {"weight": a(f"upsample.up_layers.{2 * i + 1}.weight")[:, :, 0, :]}
        for i in range(n_up)]}}
    for name in ("I", "fc1", "fc2", "fc3"):
        params[name] = {"weight": a(f"{name}.weight"),
                        "bias": a(f"{name}.bias")}
    for name in ("rnn1", "rnn2"):
        params[name] = {k: a(f"{name}.{k}_l0") for k in _LSTM}
    state = (None if bn_s is None else
             {"upsample": {"resnet": {"batch_norm": bn_s,
                                      "layers": layers_s}}})
    return params, state


def hifigan_state_dict_from_jax(params_np: dict, h: dict) -> dict:
    """The HiFi-GAN generator ``state_dict`` (plain, already fused
    weights) of a JAX generator tree given as nested dicts/lists of
    numpy arrays: the inverse of the JAX package's
    ``generator_params_from_state_dict``.
    ``vocoders.hifigan.Generator(h, n_mels)`` loads it with
    ``strict=True`` (``h``, the config, names the same modules: its
    modules nest as the tree does)."""
    return tree_to_state_dict(params_np)


def hifigan_jax_from_state_dict(sd: dict) -> dict:
    """The JAX package's generator tree of a :class:`Generator`
    ``state_dict`` (or of any dictionary under its parameter names)."""
    return state_dict_to_tree(sd)
