"""Meta-test protocol (counterpart of ``make_metatest_fn`` in
``msa_tts_tpu/meta/maml.py``): k-step adaptation on a support set, then
the loss on a query set with the adapted parameters."""

from __future__ import annotations

from typing import Callable

import torch

from ..optim import Transform
from .inner_loop import make_adapt_fn


def make_metatest_fn(loss_fn: Callable, inner_tx: Transform, n_inner: int,
                     *, create_graph: bool = False):
    """Build ``metatest(params, model_state, support, query, masks)``:
    ``masks`` holds ``n_inner + 1`` passes' dropout masks, the inner
    steps' then the query pass's.  Returns ``(query_loss,
    adapted_params, adapted_model_state, inner_losses)``; the query pass
    keeps a graph only with ``create_graph``."""
    adapt = make_adapt_fn(loss_fn, inner_tx, n_inner,
                          create_graph=create_graph)

    def metatest(params, model_state, support, query, masks):
        adapted, ms, inner_losses = adapt(params, model_state, support,
                                          masks[:n_inner])
        with torch.set_grad_enabled(create_graph):
            qloss, _ = loss_fn(adapted, ms, query, masks[n_inner])
        return qloss, adapted, ms, inner_losses

    return metatest
