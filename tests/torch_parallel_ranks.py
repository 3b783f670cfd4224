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
    for kw in ({"dp": 3, "task": 2}, {"task": 3}, {"dp": 3, "tp": 2}):
        try:
            make_mesh(**kw)
        except (ValueError, NotImplementedError) as e:
            res[f"err{sorted(kw.items())}"] = (type(e).__name__, str(e))
    mtp = make_mesh(dp=2, tp=2)
    res["mesh_tp"] = (dict(mtp.shape), mtp.coords)
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
    in the rank (tests/test_torch_no_jax.py), at dp 2 and at tp 2; the
    rank's new weights go to ``<tmp>/rank<r>.pt`` and, whole, to
    ``<tmp>/rank<r>_tp.pt``."""
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
    tp = tp_step_trainer(TrainerBase, model["model"], model["sd"],
                         make_mesh(dp=1, tp=2), 8)
    tp.train_state, tp_metrics, _ = tp._grad_step(tp.train_state, batch,
                                                  masks)
    assert torch.isfinite(tp_metrics["loss"])
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "msa_tts_tpu"))
    assert bad == ["jax", "msa_tts_tpu"], bad
    torch.save(new.params, os.path.join(tmp, f"rank{rank}.pt"))
    torch.save(tp._whole_state().params,
               os.path.join(tmp, f"rank{rank}_tp.pt"))


def _load_class(path: str):
    import importlib

    mod, name = path.split(":")
    return getattr(importlib.import_module(mod), name)


def trained_weights(t) -> dict:
    """A trainer's weights after its run, by name (whole: a tp trainer's
    ranks gather them, so every one of its ranks must call this)."""
    if hasattr(t, "gen_params"):
        return {**{"g." + k: v for k, v in t.gen_params.items()},
                **{"d." + k: v for k, v in t.disc_params.items()}}
    if hasattr(t, "train_state"):
        ts = t._whole_state()
        return {**ts.params, **ts.model_state}
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
    at_tp = torch.load(os.path.join(tmp, "resume_at_tp.pt"),
                       weights_only=False)
    # the tp runs lay the tiny widths out at a smaller axis than 128
    from msa_tts_tpu_torch.trainers.base import TrainerBase

    TrainerBase._TP_MIN_DIM = at_tp["tp_min_dim"]
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
        # a world-1 checkpoint (rank 0's run) resumed at tp 2
        import torch.distributed as dist

        if rank == 0:
            base(**at_tp["w1_half"]).run()
        dist.barrier()
        t = base(**dict(at_tp["w1_half"], n_epochs=params["n_epochs"],
                        resume=True, parallel=at_tp["tp"]))
        t.run()
        res["resumed_at_tp"] = (trained_weights(t), t.step_global)

        # last: the SIGTERM stays with the process's preemption guard
        t = Preempted(**dict(params, output_path=params["output_path"]
                             + "_sigterm"))
        t.run()
        res["sigterm"] = t.step_global
    finally:
        builtins.open = real_open
    res["writes"] = writes
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def tp_step_trainer(cls, model: dict, sd: dict, mesh, min_dim: int,
                    **params):
    """A bare trainer of ``cls`` on ``mesh`` (tp layout at ``min_dim``)
    whose train state is ``sd``, laid out as ``_reshard_state`` lays a
    run's state out; ``params`` replace its step settings."""
    t = bare_trainer(cls, model)
    t.params = dict(t.params, **params)
    t._TP_MIN_DIM = min_dim
    if mesh is not None:
        t._use_mesh(mesh)
    t.train_state = tiny_state(t, sd)
    t._reshard_state()
    return t


def maml_tp_step(t):
    """The second-order MAML step (inner SGD 0.1, outer SGD 1.0, one
    inner step) of a :func:`tp_step_trainer`, under its tp scope."""
    from msa_tts_tpu_torch.meta.maml import make_maml_step
    from msa_tts_tpu_torch.optim import make_optimizer

    sgd = make_optimizer({"optimizer_type": "SGD", "lr": 0.1})
    outer = make_optimizer({"optimizer_type": "SGD", "lr": 1.0})
    return t._in_tp_scope(make_maml_step(t._meta_loss_fn(), sgd, outer, 1,
                                         second_order=True))


def tp_operators(group, inp: dict) -> dict:
    """Megatron's four operators on ``group`` (the ranks' shards of
    ``inp``'s ``w``): a column-parallel and a row-parallel product, their
    gradients, and a second-order gradient through each."""
    import torch

    from msa_tts_tpu_torch.parallel import collectives as C

    x0, w, c = (torch.as_tensor(inp[k]) for k in ("x", "w", "c"))
    n, i = group.size, group.index
    out = {}
    for kind in ("col", "row"):
        x = x0.clone().requires_grad_()
        if kind == "col":
            wr = w.chunk(n, 0)[i].clone().requires_grad_()
            y = C.gather_from_tp(C.copy_to_tp(x, group) @ wr.T, -1, group)
        else:
            wr = w.chunk(n, 1)[i].clone().requires_grad_()
            y = C.reduce_from_tp(C.scatter_to_tp(x, -1, group) @ wr.T,
                                 group)
        loss = (y * c).sum() + (y ** 3).sum() * 0.1
        gx, gw = torch.autograd.grad(loss, [x, wr], create_graph=True)
        (g2,) = torch.autograd.grad((gx ** 2).sum(), [wr])
        out[kind] = {"y": y.detach(), "gx": gx.detach(), "gw": gw.detach(),
                     "g2": g2}
    return out


def tp_cases(rank: int, world: int, tmp: str) -> None:
    """tests/test_torch_tp.py's cases on a 4-rank world: meshes, the four
    operators, a tp forward, joint and clipped steps at (dp 2, tp 2), a
    second-order MAML step at tp 2."""
    import torch

    from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV
    from msa_tts_tpu_torch.parallel import make_mesh
    from msa_tts_tpu_torch.parallel.mesh import ALL, AXES
    from msa_tts_tpu_torch.parallel.tp import (
        GroupTransport,
        TensorParallel,
        shard_tree_tp,
        tp_products,
        tp_shardings,
    )
    from msa_tts_tpu_torch.trainers.continual_ewc import EWCTrainer
    from msa_tts_tpu_torch.trainers.metatrainer import MetaTrainer

    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    md = inp["min_dim"]
    res = {}
    m212 = make_mesh(dp=2, task=1, tp=2)
    m114 = make_mesh(dp=1, task=1, tp=4)
    for name, m in (("212", m212), ("114", m114)):
        res["mesh" + name] = (dict(m.shape), m.coords, {
            a: m.group(a).ranks for a in ("dp", "task", "tp")},
            m.group(AXES).ranks, m.group(ALL).ranks)
    for kw in ({"dp": 2, "tp": 4}, {"task": 3, "tp": 2}):
        try:
            make_mesh(**kw)
        except ValueError as e:
            res[f"err{sorted(kw.items())}"] = str(e)
    res["ops"] = tp_operators(m114.group("tp"), inp["ops"])

    # a forward at tp 4 on this rank's shards
    sd = inp["sd"]
    with torch.device("meta"):
        meta = Tacotron2NV(bare_trainer(EWCTrainer, inp["model"]).cfg)
    tp = TensorParallel(GroupTransport(m114.group("tp")),
                        tp_shardings(sd, m114, md), meta)
    b = {k: torch.as_tensor(v) for k, v in inp["batch"].items()}
    with torch.no_grad(), tp_products(tp):
        outs, _ = torch.func.functional_call(
            meta, shard_tree_tp(sd, m114, md),
            (b["inputs"], b["input_lengths"], b["melspecs"],
             b["melspec_lengths"], b["speaker_vecs"], inp["masks"]))
    res["forward"] = outs[1]

    # joint steps at (dp 2, tp 2): SGD, then with a clip that binds
    for key, over in (("joint", {}), ("clipped", {
            "clip_grad_norm": True, "grad_clip_thresh": inp["clip"]})):
        t = tp_step_trainer(EWCTrainer, inp["model"], sd, m212, md, **over)
        held = sum(v.numel() for v in t.train_state.params.values())
        new, met, _ = t._grad_step(t.train_state, b, inp["masks"])
        t.train_state = new
        whole = t._whole_state()
        res[key] = {"params": whole.params, "stats": whole.model_state,
                    "loss": met["loss"], "grad_norm": met["grad_norm"],
                    "held": held}

    # a second-order MAML step at tp 2 on ranks 0 and 1
    m112 = make_mesh(dp=1, task=1, tp=2)
    if m112.member:
        t = tp_step_trainer(MetaTrainer, inp["model"], sd, m112, md)
        new, met = maml_tp_step(t)(t.train_state, inp["support"],
                                   inp["query"], inp["meta_masks"])
        t.train_state = new
        res["maml"] = {"params": t._whole_state().params,
                       "loss": met.loss, "grad_norm": met.grad_norm}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
