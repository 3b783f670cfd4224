"""Speaker-identity classifier for evaluating synthesized audio
(counterpart of ``msa_tts_tpu/utils/spk_cls.py``).

Reference: msa_tts/utils/spk_cls/ — a 2-layer MLP over 256-d d-vectors
(spk_cls_model.py:5-18), trained once per continual-stream prefix
(1..N speakers) so synthesized audio can be scored for speaker identity
(train_spk_cls.py:39-146).  The weights are a dictionary of tensors under
the reference module's ``state_dict`` names (``linear1.weight``, ...),
trained by full-batch-order Adam steps of ``optim.py`` on the in-memory
embedding table.  Training runs on the GPU unless ``device="cpu"`` (in
``train_spk_cls``: ``device: cpu`` in the params) is asked for.
"""

from __future__ import annotations

import math
import pickle
import random

import numpy as np
import torch
import torch.nn.functional as F

from ..optim import apply_updates, make_optimizer
from .backend import load_device


def init_spk_cls(generator: torch.Generator, emb_size: int,
                 hidden_size: int, num_cls: int) -> dict:
    """``torch.nn.Linear``'s default init, U(-1/sqrt(in), 1/sqrt(in)) for
    weights and biases, drawn on ``generator``."""
    def linear(name, i, o):
        a = 1.0 / math.sqrt(i)
        return {f"{name}.weight": (torch.rand((o, i), generator=generator)
                                   * 2 - 1) * a,
                f"{name}.bias": (torch.rand((o,), generator=generator)
                                 * 2 - 1) * a}

    return {**linear("linear1", emb_size, hidden_size),
            **linear("linear2", hidden_size, num_cls)}


def spk_cls_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(x @ params["linear1.weight"].T + params["linear1.bias"])
    return h @ params["linear2.weight"].T + params["linear2.bias"]


def spk_cls_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Softmax posterior (the reference applies softmax in forward)."""
    return torch.softmax(spk_cls_logits(params, x), dim=-1)


def _loss(params: dict, x, y) -> torch.Tensor:
    return F.cross_entropy(spk_cls_logits(params, x), y)


def train_classifier(embs: np.ndarray, labels: np.ndarray, num_cls: int, *,
                     hidden_size: int = 256, n_epochs: int = 50,
                     batch_size: int = 64, lr: float = 1e-3, seed: int = 0,
                     params: dict | None = None, device="cuda"):
    """Train one classifier; returns ``(params, train_acc_history)``.

    ``params``: the initial weights (arrays or tensors, e.g. carried from
    the JAX package); without it they are drawn from a generator seeded
    with ``seed``.  Batches follow ``np.random.default_rng(seed)``'s
    permutations, as in the JAX package."""
    device = load_device(device)
    if params is None:
        params = init_spk_cls(torch.Generator().manual_seed(seed),
                              embs.shape[1], hidden_size, num_cls)
    params = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
              .to(device) for k, v in params.items()}
    tx = make_optimizer({"optimizer_type": "Adam", "lr": lr})
    opt_state = tx.init(params)
    x_all = torch.as_tensor(np.asarray(embs, np.float32), device=device)
    y_all = torch.as_tensor(np.asarray(labels, np.int64), device=device)

    n = len(embs)
    np_rng = np.random.default_rng(seed)
    accs = []
    for _ in range(n_epochs):
        order = np_rng.permutation(n)
        for start in range(0, n, batch_size):
            sel = torch.as_tensor(order[start: start + batch_size],
                                  device=device)
            p = {k: v.requires_grad_(True) for k, v in params.items()}
            loss = _loss(p, x_all[sel], y_all[sel])
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            with torch.no_grad():
                updates, opt_state = tx.update(grads, opt_state, params)
                params = {k: v.detach()
                          for k, v in apply_updates(params, updates).items()}
        accs.append(evaluate(params, embs, labels))
    return params, accs


@torch.no_grad()
def evaluate(params: dict, embs: np.ndarray, labels: np.ndarray) -> float:
    dev = next(iter(params.values())).device
    pred = spk_cls_logits(params, torch.as_tensor(
        np.asarray(embs, np.float32), device=dev)).argmax(-1).cpu().numpy()
    return float((pred == np.asarray(labels)).mean())


def train_spk_cls(params: dict) -> dict:
    """Stream-prefix protocol (reference train_spk_cls.py:39-146): for
    each prefix of the shuffled speaker list train a classifier on the
    per-utterance embeddings and report train/test accuracy.

    ``spk_emb.pkl`` layout: {speaker: {utterance_id: emb, ...}} (the
    per-utterance variant); the "mean" key, if present, is excluded.
    Returns {prefix_len: {"train_acc", "test_acc", "speakers"}}."""
    with open(params["spk_emb_path"], "rb") as f:
        spk_embs = pickle.load(f)

    speakers = list(params["dataset_train"]["speakers_list"])
    random.Random(int(params.get("spk_seed", 0))).shuffle(speakers)
    print("Target speakers in order:")
    print(speakers)

    perc_train = float(params.get("perc_train", 0.9))
    device = params.get("device", "cuda")
    results = {}
    for prefix in range(1, len(speakers) + 1):
        target = speakers[:prefix]
        spk_to_id = {s: i for i, s in enumerate(target)}
        tr_x, tr_y, te_x, te_y = [], [], [], []
        for spk in target:
            elements = [k for k in spk_embs[spk].keys() if k != "mean"]
            random.Random(prefix).shuffle(elements)
            cut = int(perc_train * len(elements))
            for e in elements[:cut]:
                tr_x.append(np.asarray(spk_embs[spk][e], np.float32))
                tr_y.append(spk_to_id[spk])
            for e in elements[cut:]:
                te_x.append(np.asarray(spk_embs[spk][e], np.float32))
                te_y.append(spk_to_id[spk])
        tr_x, tr_y = np.stack(tr_x), np.asarray(tr_y)
        cls_params, accs = train_classifier(
            tr_x, tr_y, num_cls=prefix,
            hidden_size=int(params.get("hidden_size", 256)),
            n_epochs=int(params.get("n_epochs_cls", 50)),
            seed=int(params.get("spk_seed", 0)), device=device,
        )
        test_acc = (evaluate(cls_params, np.stack(te_x), np.asarray(te_y))
                    if te_x else float("nan"))
        results[prefix] = {
            "train_acc": accs[-1],
            "test_acc": test_acc,
            "speakers": target,
        }
        print(f"prefix {prefix}: train_acc={accs[-1]:.3f} "
              f"test_acc={test_acc:.3f}")
    return results
