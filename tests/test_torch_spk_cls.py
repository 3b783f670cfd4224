"""The port's speaker classifier (``msa_tts_tpu_torch/utils/spk_cls.py``)
against the JAX package's: the same initial weights (the JAX package's
``init_spk_cls`` draw, carried across as numpy), the same synthetic
d-vectors and the same batch order (numpy permutations on both sides)
give the same weights after training, the same loss and the same
accuracy after every epoch; and the stream-prefix protocol
``train_spk_cls`` gives the same results.

Adam's first step is lr·sign(g): a gradient within float noise of 0
would turn into a step of lr on one side only.  The embeddings are
separable clusters and the hidden layer is small, so every weight's
first gradient is far from 0 (checked: at least 1e-7 for every weight
with a nonzero gradient, and exactly 0, on both sides, for a dead
unit's).  Tolerances: weights 2e-6 after 6 epochs (read 6.0e-8), the
loss 1e-6 relative, accuracies exactly.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msa_tts_tpu.utils import spk_cls as JS
from msa_tts_tpu_torch.utils import spk_cls as TS

W_ATOL, LOSS_RTOL = 2e-6, 1e-6


def _embs(n_spk=3, per=12, dim=16, seed=0):
    """Clusters around one axis per speaker, with noise."""
    rng = np.random.default_rng(seed)
    x, y = [], []
    for s in range(n_spk):
        c = np.zeros(dim)
        c[s] = 2.0
        x.append(c + 0.7 * rng.standard_normal((per, dim)))
        y += [s] * per
    return np.concatenate(x).astype(np.float32), np.asarray(y)


def _flat(tree) -> dict:
    return {f"{a}.{b}": np.array(v) for a, layer in tree.items()
            for b, v in layer.items()}


def _ce(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(y)).mean()


def _jax_loss(params, x, y):
    return float(_ce(JS.spk_cls_logits(params, jnp.asarray(x)), y))


def test_forward_and_first_gradient_match_jax():
    x, y = _embs()
    jp = JS.init_spk_cls(jax.random.PRNGKey(0), 16, 8, 3)
    tp = {k: torch.as_tensor(v) for k, v in _flat(jp).items()}
    np.testing.assert_allclose(TS.spk_cls_forward(tp, torch.as_tensor(x))
                               .numpy(),
                               np.asarray(JS.spk_cls_forward(jp, x)),
                               atol=1e-6, rtol=0)
    # the first step's gradients: far from 0, or 0 on both sides
    jg = _flat(jax.grad(lambda p: _ce(JS.spk_cls_logits(p, x[:8]),
                                      y[:8]))(jp))
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tg = torch.autograd.grad(TS._loss(p, torch.as_tensor(x[:8]),
                                      torch.as_tensor(y[:8])),
                             list(p.values()))
    for (k, g), r in zip(p.items(), tg):
        g_t, g_j = r.numpy(), jg[k]
        assert np.array_equal(g_t == 0, g_j == 0), k
        assert np.abs(g_j[g_j != 0]).min() > 1e-7, k
        np.testing.assert_allclose(g_t, g_j, atol=1e-7, rtol=0)
    # the port's own draw: torch.nn.Linear's default bounds
    own = TS.init_spk_cls(torch.Generator().manual_seed(0), 16, 8, 3)
    assert float(own["linear1.weight"].abs().max()) <= 0.25
    assert own["linear2.bias"].shape == (3,)


def test_train_classifier_matches_jax():
    """6 epochs of batches of 8 from JAX's initial weights (seed 3)."""
    x, y = _embs()
    kw = dict(hidden_size=8, n_epochs=6, batch_size=8, lr=1e-2, seed=3)
    jp, jaccs = JS.train_classifier(x, y, 3, **kw)
    init = _flat(JS.init_spk_cls(jax.random.PRNGKey(3), 16, 8, 3))
    tp, taccs = TS.train_classifier(x, y, 3, params=init, device="cpu",
                                    **kw)
    assert taccs == jaccs and len(taccs) == 6
    assert taccs[-1] > taccs[0]
    moved = 0.0
    for k, v in _flat(jp).items():
        np.testing.assert_allclose(tp[k].numpy(), v, atol=W_ATOL, rtol=0,
                                   err_msg=k)
        moved = max(moved, float(np.abs(v - init[k]).max()))
    assert moved > 1e-2
    loss = float(TS._loss(tp, torch.as_tensor(x), torch.as_tensor(y)))
    assert loss == pytest.approx(_jax_loss(jp, x, y), rel=LOSS_RTOL)
    assert TS.evaluate(tp, x, y) == JS.evaluate(jp, x, y) == taccs[-1]


def test_train_spk_cls_matches_jax(tmp_path, monkeypatch):
    """The stream-prefix protocol on per-utterance embeddings (a "mean"
    key excluded), the port's initial draws replaced by the JAX
    package's for the same seed."""
    x, y = _embs(per=10)
    emb = {}
    for s, spk in enumerate(["a", "b", "c"]):
        emb[spk] = {f"utt{j}": x[y == s][j] for j in range(10)}
        emb[spk]["mean"] = x[y == s].mean(0)
    path = str(tmp_path / "spk_emb.pkl")
    with open(path, "wb") as f:
        pickle.dump(emb, f)
    params = {"spk_emb_path": path,
              "dataset_train": {"speakers_list": ["a", "b", "c"]},
              "spk_seed": 2, "n_epochs_cls": 4, "hidden_size": 8,
              "perc_train": 0.8}
    ref = JS.train_spk_cls(dict(params))
    monkeypatch.setattr(TS, "init_spk_cls", lambda g, e, h, c: {
        k: torch.as_tensor(v) for k, v in _flat(JS.init_spk_cls(
            jax.random.PRNGKey(g.initial_seed()), e, h, c)).items()})
    out = TS.train_spk_cls(dict(params, device="cpu"))
    assert out == ref
    assert sorted(out) == [1, 2, 3]
    if not torch.cuda.is_available():     # the default is the GPU
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            TS.train_spk_cls(dict(params))
