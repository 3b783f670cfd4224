"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
a tiny model config, and the JAX-initialised weights loaded into the
port's modules through ``state_dict_from_jax``."""

from __future__ import annotations

import jax
import numpy as np

BASE_AP = {
    "attention_type": "ForwardAttention",
    "attention_dim": 16,
    "attention_location_n_filters": 8,
    "attention_location_kernel_size": 15,
    "windowing": False,
    "norm": "softmax",
    "forward_attn": True,
    "trans_agent": True,
    "forward_attn_mask": False,
}

TINY_MODEL = {
    "mask_padding": False, "n_mel_channels": 10,
    "n_frames_per_step": 2, "n_symbols": 200,
    "symbols_embedding_dim": 16, "encoder_n_convolutions": 2,
    "encoder_embedding_dim": 16, "encoder_kernel_size": 5,
    "speaker_emb_type": "static", "num_speakers": 3,
    "speaker_embedding_dim": 8, "speaker_embedding_dim_lin": 6,
    "attention_rnn_dim": 20, "decoder_rnn_dim": 28, "prenet_dim": 12,
    "max_decoder_steps": 17, "gate_threshold": 0.5,
    "p_attention_dropout": 0.1, "p_decoder_dropout": 0.1,
    "postnet_embedding_dim": 16, "postnet_kernel_size": 5,
    "postnet_n_convolutions": 2,
    "attention_params": dict(BASE_AP),
}


def model_dict(**over) -> dict:
    ap = dict(BASE_AP, **over.pop("ap", {}))
    return dict(TINY_MODEL, attention_params=ap, **over)


def jax_and_port_models(mp: dict, seed: int = 0):
    """JAX ``(cfg, params, state)`` initialised from ``seed`` and the
    port's ``(cfg, Tacotron2NV)`` holding the same weights."""
    from msa_tts_tpu.models import config_from_params as jax_cfp
    from msa_tts_tpu.models import init_tacotron2nv
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.utils.convert import state_dict_from_jax

    jcfg = jax_cfp(dict(mp))
    params, state = init_tacotron2nv(jax.random.PRNGKey(seed), jcfg)
    cfg = config_from_params(dict(mp))
    model = Tacotron2NV(cfg)
    model.load_state_dict(
        state_dict_from_jax(jax.device_get(params), jax.device_get(state),
                            cfg),
        strict=True,
    )
    return (jcfg, params, state), (cfg, model.eval())


def randn(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32
    )
