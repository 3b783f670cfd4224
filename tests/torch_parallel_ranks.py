"""What the ranks of the port's parallel tests run (tests/test_torch_
parallel.py, tests/test_torch_trainer_parallel.py,
tests/test_torch_no_jax.py).  ``msa_tts_tpu_torch.parallel.launch.spawn``
starts each rank in a fresh process with the gloo group up; a rank
imports this module by name, so it imports neither jax nor the JAX
package at its top, and each function imports what it needs.  Every
rank writes what it computed to ``<tmp>/rank<r>.pt`` for the test to
compare."""

from __future__ import annotations

import os
import sys

K, S, N_INNER = 8, 8, 2
# every (dp, task) a 4-rank world lays out: worlds of 4, 2 and 1
SHAPES = [(2, 2), (1, 4), (4, 1), (2, 1), (1, 2), (1, 1)]
KINDS = ("maml2", "maml1", "reptile")


def quad_loss(params, model_state, batch, masks):
    t = batch["target"]
    return 0.5 * ((params["w"][None, :] - t) ** 2).sum() / t.shape[0], \
        model_state


def stateful_quad_loss(params, model_state, batch, masks):
    """``quad_loss`` plus a running statistic linear in the batch's mean
    (a stand-in for a batch norm's)."""
    t = batch["target"]
    loss = 0.5 * ((params["w"][None, :] - t) ** 2).sum() / t.shape[0]
    return loss, {"running": 0.9 * model_state["running"]
                  + 0.1 * t.mean(dim=0)}


def quad_state(w0, ms0, lr: float):
    import torch

    from msa_tts_tpu_torch.optim import TrainState, make_optimizer

    p = {"w": torch.tensor(w0, dtype=torch.float32)}
    tx = make_optimizer({"optimizer_type": "SGD", "lr": lr})
    return TrainState(params=p, model_state=dict(ms0), opt_state=tx.init(p),
                      step=0), tx


def meta_step(kind: str, loss_fn, mesh, outer_lr: float):
    """The port's meta step of ``kind`` (inner SGD 0.1): sharded on
    ``mesh``, or unsharded when it is None."""
    from msa_tts_tpu_torch.meta.maml import make_maml_step
    from msa_tts_tpu_torch.meta.reptile import make_reptile_step
    from msa_tts_tpu_torch.optim import make_optimizer
    from msa_tts_tpu_torch.parallel import (
        make_sharded_maml_step,
        make_sharded_reptile_step,
    )

    inner = make_optimizer({"optimizer_type": "SGD", "lr": 0.1})
    outer = make_optimizer({"optimizer_type": "SGD", "lr": outer_lr})
    if kind == "reptile":
        if mesh is None:
            return make_reptile_step(loss_fn, inner, outer, N_INNER,
                                     mode="batched")
        return make_sharded_reptile_step(loss_fn, inner, outer, N_INNER,
                                         mesh)
    second = kind == "maml2"
    if mesh is None:
        return make_maml_step(loss_fn, inner, outer, N_INNER,
                              second_order=second)
    return make_sharded_maml_step(loss_fn, inner, outer, N_INNER, mesh,
                                  second_order=second)


def bare_trainer(cls, model: dict, mesh=None):
    """A trainer object with just what its steps read: the tiny model
    (meta device), the loss of ``reduction: none``, SGD lr 1e-2, no
    clip, the CPU, and ``mesh`` (or none)."""
    import torch

    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.optim import make_optimizer

    t = object.__new__(cls)
    t.params = {"clip_grad_norm": False}
    t.device = torch.device("cpu")
    t.cfg = config_from_params(dict(model))
    with torch.device("meta"):
        t.model = Tacotron2NV(t.cfg)
    t.loss_kwargs = dict(n_frames_per_step=t.cfg.n_frames_per_step,
                         reduction="none", pos_weight=1.0)
    t.tx = make_optimizer({"optimizer_type": "SGD", "lr": 1e-2})
    t.mesh = None
    t._said_replicated = False
    if mesh is not None:
        t._use_mesh(mesh)
    return t


def tiny_state(t, sd: dict):
    from msa_tts_tpu_torch.optim import TrainState

    p = {k: sd[k].clone() for k in t.model.state_dict()
         if k in dict(t.model.named_parameters())}
    ms = {k: sd[k].clone() for k in sd if k not in p}
    return TrainState(params=p, model_state=ms, opt_state=t.tx.init(p),
                      step=0)


def parallel_cases(rank: int, world: int, tmp: str) -> None:
    """tests/test_torch_parallel.py's cases on a 4-rank world."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.parallel import (
        make_mesh,
        shard_batch,
        shard_task_batch,
        shard_task_batch_2d,
    )
    from msa_tts_tpu_torch.trainers.continual_ewc import EWCTrainer

    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    res = {}
    m = make_mesh()
    res["mesh_none"] = (dict(m.shape), m.coords, m.size)
    m22 = make_mesh(dp=2, task=2)
    res["coords22"] = m22.coords
    for kw in ({"dp": 3, "task": 2}, {"task": 3}, {"dp": 2, "tp": 2}):
        try:
            make_mesh(**kw)
        except (ValueError, NotImplementedError) as e:
            res[f"err{sorted(kw.items())}"] = (type(e).__name__, str(e))
    x = torch.arange(24.0).reshape(8, 3)
    res["batch_rows"] = shard_batch({"x": x}, m22)["x"]
    res["task_rows"] = shard_task_batch({"x": x}, m22)["x"]

    sup = {"target": torch.as_tensor(inp["support"])}
    qry = {"target": torch.as_tensor(inp["query"])}
    no_masks = [[None] * (N_INNER + 1)] * K
    for dp, task in SHAPES:
        mesh = make_mesh(dp=dp, task=task)      # every rank, in order
        if not mesh.member:
            continue
        s2 = shard_task_batch_2d(sup, mesh)
        q2 = shard_task_batch_2d(qry, mesh)
        for kind in KINDS:
            lr = 0.5 if kind == "reptile" else 1.0
            state, _ = quad_state(inp["w0"], {}, lr)
            new, met = meta_step(kind, quad_loss, mesh, lr)(
                state, s2, q2, no_masks)
            res[(dp, task, kind)] = {
                "w": new.params["w"], "loss": met.loss,
                "task_losses": met.task_losses,
                "inner": met.inner_losses, "grad_norm": met.grad_norm}
        for kind in ("maml2", "reptile"):
            state, _ = quad_state(inp["w0"], {"running": torch.zeros(2)},
                                  1.0)
            new, _ = meta_step(kind, stateful_quad_loss, mesh, 1.0)(
                state, s2, q2, no_masks)
            res[(dp, task, "carry_" + kind)] = new.model_state["running"]

    mesh = make_mesh(dp=2, task=1)
    if mesh.member:
        t = bare_trainer(EWCTrainer, inp["model"], mesh)
        state = tiny_state(t, inp["sd"])
        batch = {k: torch.as_tensor(np.asarray(v)) for k, v in
                 inp["batch"].items()}
        masks = inp["masks"]
        rows, _, group = t._put_batch(batch)
        res["joint_rows"] = (rows["inputs"], group is not None)
        new, metrics, _ = t._grad_step(state, batch, masks)
        res["joint"] = {"params": new.params, "loss": metrics["loss"],
                        "stats": new.model_state}
        res["grad_sq"] = {k: g * g for k, g in
                          t._batch_grads(state, batch, masks).items()}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def joint_step_no_jax(rank: int, world: int, tmp: str) -> None:
    """One 2-rank joint step with ``jax`` and ``msa_tts_tpu`` blocked
    in the rank (tests/test_torch_no_jax.py); the rank's new weights go
    to ``<tmp>/rank<r>.pt``."""
    for blocked in ("jax", "msa_tts_tpu"):
        if blocked in sys.modules:
            raise AssertionError(f"{blocked} imported before the block")
        sys.modules[blocked] = None
    import torch

    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks
    from msa_tts_tpu_torch.parallel import make_mesh
    from msa_tts_tpu_torch.trainers.base import TrainerBase

    model = torch.load(os.path.join(tmp, "model.pt"), weights_only=False)
    t = bare_trainer(TrainerBase, model["model"], make_mesh(dp=2))
    state = tiny_state(t, model["sd"])
    g = torch.Generator().manual_seed(0)
    B, T_in, T_mel = 4, 12, 16
    batch = {
        "inputs": torch.randint(1, 100, (B, T_in), generator=g),
        "input_lengths": torch.full((B,), T_in),
        "melspecs": torch.randn(B, t.cfg.n_mel_channels, T_mel,
                                generator=g),
        "melspec_lengths": torch.full((B,), T_mel),
        "speaker_vecs": torch.randn(B, t.cfg.speaker_embedding_dim,
                                    generator=g),
        "stop_labels": torch.zeros(B, T_mel),
    }
    masks = dropout_masks(t.cfg, B, T_in, T_mel, g, device="cpu")
    new, metrics, _ = t._grad_step(state, batch, masks)
    assert torch.isfinite(metrics["loss"])
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "msa_tts_tpu"))
    assert bad == ["jax", "msa_tts_tpu"], bad
    torch.save(new.params, os.path.join(tmp, f"rank{rank}.pt"))


def _load_class(path: str):
    import importlib

    mod, name = path.split(":")
    return getattr(importlib.import_module(mod), name)


def trained_weights(t) -> dict:
    """A trainer's weights after its run, by name."""
    if hasattr(t, "gen_params"):
        return {**{"g." + k: v for k, v in t.gen_params.items()},
                **{"d." + k: v for k, v in t.disc_params.items()}}
    if hasattr(t, "train_state"):
        return {**t.train_state.params, **t.train_state.model_state}
    return dict(t.model_params)


def trainer_cases(rank: int, world: int, tmp: str) -> None:
    """tests/test_torch_trainer_parallel.py's world-2 runs: each case of
    ``<tmp>/cases.pt`` (a trainer class and its params), run to its end;
    then a joint run whose rank 1 sends itself SIGTERM after its second
    step.  Rank 1 records every file it opens for writing."""
    import builtins
    import signal

    import torch

    cases = torch.load(os.path.join(tmp, "cases.pt"), weights_only=False)
    writes = []
    real_open = builtins.open

    def spy(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            writes.append(str(file))
        return real_open(file, mode, *a, **k)

    if rank != 0:
        builtins.open = spy
    res = {}
    try:
        for name, (cls, params) in cases.items():
            t = _load_class(cls)(**params)
            t.run()
            res[name] = (trained_weights(t), t.step_global)

        base = _load_class("msa_tts_tpu_torch.trainers.baseline:"
                           "JointTrainer")

        class Preempted(base):
            def _train_step(self, state, batch, masks):
                out = super()._train_step(state, batch, masks)
                if rank == 1 and self.step_global == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

        params = cases["joint"][1]
        t = Preempted(**dict(params, output_path=params["output_path"]
                             + "_sigterm"))
        t.run()
        res["sigterm"] = t.step_global
    finally:
        builtins.open = real_open
    res["writes"] = writes
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
