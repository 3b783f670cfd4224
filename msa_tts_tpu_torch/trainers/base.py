"""Trainer base: experiment setup, the training loss, the train and
eval steps, the dropout-mask seam, checkpoints, resume and failure
detection (counterpart of ``msa_tts_tpu/trainers/base.py``).

The model's weights live in ``train_state.params`` (name → float32
tensor on the trainer's device, under the reference ``state_dict``
names) and its batch-norm buffers in ``train_state.model_state``; the
model itself is a weightless meta-device ``Tacotron2NV`` that
``torch.func.functional_call`` runs on them, as ``AdaptiveTTS.adapt``
does.  Initial weights are drawn on the CPU from a ``torch.Generator``
seeded by ``model_seed``, so every device starts from the same ones.

Dropout masks.  The JAX package draws each pass's masks from a key
schedule of its trainer.  Here every pass draws them on the device
through one seam, :meth:`TrainerBase._draw_step_masks`, from a
``torch.Generator`` seeded by ``train_seed``, the kind of pass and the
trainer's own indices of it (epoch and step, task and step, ...), so a
resumed run draws what an unbroken one would; a test replaces that one
method to inject the JAX package's masks.

On a CUDA device the trainer makes its steps reproducible when it starts
(``utils/determinism.py``): the same step from the same state gives the
same bits, so a resumed run equals an unbroken one.

``.ckpt`` files are the JAX package's msgpack layout: ``params`` and
``model_state`` as its trees (``utils/convert.py``), ``opt_state`` as
the port's optimizer states (``optim.py``: lists of per-transform
states; for Adam ``{"count", "mu", "nu"}``) with every per-parameter
dictionary written as the JAX params tree and every empty state as an
empty map, which for Adam and plain SGD is optax's own layout.

Data and task parallelism.  A ``parallel: {dp, task}`` block runs the
trainer as one rank of a ``torch.distributed`` world (``torchrun``
starts one process per device; the trainer initializes the process group
from its variables when none is up, NCCL on CUDA, gloo on the CPU, and
takes ``cuda:LOCAL_RANK`` unless the params name a device).  Every rank
builds the same initial weights and loads the same global batch; the
mesh (``parallel/``) gives each rank its rows (dp·task of them, or the
whole batch where they do not divide), the batch norms take their
moments over the ranks' rows, and one flat all-reduce sums the ranks'
gradients, so every rank applies the same update and a run equals the
single-device one up to the order of float sums.  Every mask seam draws
the global batch's masks and each rank takes its rows.  Only rank 0
writes files (params, logs, plots, checkpoints); the ranks take one
preemption decision together.  Checkpoints do not depend on the world
size.

Tensor parallelism.  ``parallel: {dp: N, tp: M}`` adds a tp axis
(innermost) to the mesh: each rank holds only its shards of the weights,
of the optimizer's moments and of the batch-norm state, laid out as the
JAX package lays them out (``parallel/tp.py``; the smallest axis that
splits is 128, as the JAX package's trainers fix it), and every forward
runs the partitioned products under :meth:`TrainerBase._tp_scope`.  The
tp ranks of one data coordinate take the same rows; the gradient
all-reduce runs over the data ranks of one tp coordinate (shards of one
index); global norms and EWC's penalty count every shard.  Checkpoints
are whole (the tp ranks gather, rank 0 writes) and restore at any
``(dp, tp)``.  tp does not compose with ``task`` (the JAX package's
text).

Read and ignored: ``compilation_cache`` (XLA's compile cache).  Raises:
``plot_examples: true`` (the default) without matplotlib.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import save_params
from ..dataloaders.prefetch import host_tensors, tree_map
from ..models.loss import tacotron2_loss
from ..models.tacotron2nv import (
    Tacotron2NV,
    config_from_params,
    dropout_masks,
)
from ..ops.metrics import mcd_batch
from ..models.tacotron2nv import mask_rows
from ..ops.nn import synced_batchnorm
from ..optim import apply_updates
from ..parallel import collectives as C
from ..parallel.mesh import ALL, AXES, init_from_env, make_mesh
from ..parallel.sharding import (
    batch_sharding,
    replicate_state,
    take_rows,
    task_batch_sharding,
)
from ..parallel.tp import (
    GroupTransport,
    TensorParallel,
    gather_tree_tp,
    shard_tree_tp,
    tp_products,
    tp_shardings,
)
from ..utils.backend import load_device
from ..utils.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint,
    load_partial_params,
    opt_from_tree,
    opt_to_tree,
    restore_like,
    save_checkpoint,
    wait_all_checkpoints,
)
from ..utils.convert import jax_from_state_dict, state_dict_from_jax
from ..utils.determinism import make_reproducible
from ..utils.g2p.char_list import N_SYMBOLS
from ..utils.logging_utils import MetricsLogger
from ..utils.paths import PathManager
from .train_state import TrainState, clip_by_global_norm, make_optimizer

# the kinds of pass a mask seed tells apart (train and test keep the
# values the MAML trainer has always used)
_PHASES = {"train": 0, "test": 1, "metatest": 2, "task": 3, "task_test": 4,
           "cumulative": 5, "fisher": 6, "kd": 7}
_P = 1_000_003          # a prime: distinct (seed, phase, indices) seeds

TP_WITH_TASK = ("parallel: tp composes with dp, not with the task axis (the "
                "shard_map meta layout manages its own mesh) — use {dp, tp} "
                "or {dp, task}")


class TrainerBase:
    # the partitioned products of a tp mesh (set by _reshard_state)
    _tp = None
    # the smallest axis the tp layout splits, fixed as the JAX package's
    # trainers fix it
    _TP_MIN_DIM = 128

    def __init__(self, **params):
        self.params = params
        pcfg = params.get("parallel")
        device = params.get("device")
        if pcfg:
            if int(pcfg.get("tp", 1)) > 1 and int(pcfg.get("task", 1)) > 1:
                raise NotImplementedError(TP_WITH_TASK)
            device = init_from_env(device) or device
        # `compilation_cache` / `compilation_cache_dir` configure XLA's
        # compile cache; nothing here compiles, so they are ignored
        if params.get("plot_examples", True):
            from ..utils.plot import pyplot

            pyplot()            # raises now, not after an epoch of training
        self.device = load_device(device or "cuda")
        make_reproducible(self.device)
        self.mesh = None
        self._said_replicated = False
        if pcfg:
            self._init_parallel(pcfg)
        # the mask seam's seed (TrainerBase._draw_step_masks)
        self._mask_seed = int(params.get("train_seed", 1234))
        output_path = os.path.join(
            params["output_path"], params["method"], params["experiment_name"]
        )
        self.path_manager = PathManager(output_path)
        self.logger = None
        if self.is_writer:
            save_params(params, os.path.join(output_path, "params.yml"))
            self.logger = MetricsLogger(
                self.path_manager.logs_path,
                use_tensorboard=params.get("use_tensorboard", True),
            )
        self.step_global = 0

        self._preempt_guard = None
        if params.get("handle_preemption", True):
            from ..utils.preemption import PreemptionGuard

            self._preempt_guard = PreemptionGuard.shared()
        self._watchdog = None
        self._async_ckpt = None

        self._init_dataloaders()
        self._init_model()
        self._init_criterion_optimizer()
        if params.get("finetune", False):
            self._load_finetune_checkpoint()
        self._reshard_state()

    # ------------------------------------------------------------ setup
    def _init_dataloaders(self):  # overridden by subclasses
        raise NotImplementedError

    def _num_speakers(self) -> int:
        raise NotImplementedError

    def _init_model(self):
        params = self.params
        mp = dict(params["model"])
        mp["num_speakers"] = self._num_speakers()
        mp["n_symbols"] = N_SYMBOLS
        mp["n_mel_channels"] = params["audio_params"]["n_mels"]
        for k in ("freeze_charemb", "freeze_encoder", "freeze_decoder"):
            mp[k] = params.get(k, False)
        params["model"] = mp
        self.model_name = params.get("model_name", "Tacotron2NV")
        if self.model_name != "Tacotron2NV":
            raise NotImplementedError(self.model_name)
        self.speaker_emb_type = mp["speaker_emb_type"]
        self.cfg = config_from_params(mp)
        gen = torch.Generator().manual_seed(int(params.get("model_seed", 0)))
        sd = Tacotron2NV(self.cfg, generator=gen).state_dict()
        with torch.device("meta"):
            self.model = Tacotron2NV(self.cfg)
        self.param_names = [k for k, _ in self.model.named_parameters()]
        self.model_params = {k: sd[k].to(self.device)
                             for k in self.param_names}
        self.model_state = {k: v.to(self.device) for k, v in sd.items()
                            if k not in self.model_params}

    def _init_criterion_optimizer(self):
        params = self.params
        crit = params["criterion"]
        if crit.get("criterion_type", "Tacotron2Loss") != "Tacotron2Loss":
            raise RuntimeError(f"Criterion {crit} not defined.")
        self.loss_kwargs = dict(
            n_frames_per_step=self.cfg.n_frames_per_step,
            reduction=crit.get("reduction", "none"),
            pos_weight=float(crit.get("pos_weight", 1.0)),
        )
        self.tx = make_optimizer(params["optim"])
        self.inner_optim_cfg = params.get(
            "optim_inner", {"optimizer_type": "SGD", "lr": 1e-2}
        )
        self.train_state = TrainState(
            params=self.model_params, model_state=self.model_state,
            opt_state=self.tx.init(self.model_params), step=0,
        )

    # ------------------------------------------------------------- loss
    def _compute_dtype(self):
        dtype = self.params.get("compute_dtype")
        return torch.bfloat16 if dtype in ("bfloat16", "bf16") else None

    def _loss_for_batch(self, params: dict, model_state: dict, batch: dict,
                        masks: dict):
        """The training loss of one teacher-forced pass on the dropout
        ``masks``: ``(loss, (outputs, new_model_state))``.

        With ``compute_dtype: bfloat16`` the parameters, the batch-norm
        state, the mels and the speaker vectors are cast to bfloat16
        inside the differentiated graph, so gradients land on the
        float32 parameters; outputs, loss and the new state are float32,
        and the loss's target is the mel as given."""
        target_mels = batch["melspecs"]
        dt = self._compute_dtype()
        ms = model_state
        if dt is not None:
            def cast(d):
                return {k: v.to(dt) if v.dtype == torch.float32 else v
                        for k, v in d.items()}

            params, ms = cast(params), cast(model_state)
            batch = dict(batch)
            for k in ("melspecs", "speaker_vecs"):
                if batch[k].dtype == torch.float32:
                    batch[k] = batch[k].to(dt)
        with self._tp_scope():
            outs, new_state = torch.func.functional_call(
                self.model, {**params, **ms},
                (batch["inputs"], batch["input_lengths"], batch["melspecs"],
                 batch["melspec_lengths"], batch["speaker_vecs"], masks))
        outs = [o.float() for o in outs]
        new_state = {**model_state,
                     **{k: v.float() for k, v in new_state.items()}}
        loss = tacotron2_loss(
            outs, (target_mels.float(), batch["stop_labels"]),
            batch["melspec_lengths"], **self.loss_kwargs)
        return loss, (outs, new_state)

    # ------------------------------------------------------------ masks
    def _mask_generator(self, phase: str, *idx: int) -> torch.Generator:
        """A generator on the device seeded by ``train_seed`` (the mask
        seed), ``phase`` and ``idx``."""
        s = self._mask_seed * _P + _PHASES[phase]
        for i in idx:
            s = s * _P + int(i)
        return torch.Generator(device=self.device).manual_seed(s % (1 << 63))

    def _draw_step_masks(self, phase: str, key: tuple, batch: dict) -> dict:
        """The dropout masks of one pass over ``batch``
        (``models.tacotron2nv.dropout_masks``), ``key`` the trainer's
        indices of the pass: ``"train"`` / ``"test"`` (epoch, step) of the
        joint trainer; ``"task"`` (task, global step) and ``"task_test"``
        (task, step) of a continual task, ``"cumulative"`` (task, step) of
        its cumulative test; ``"fisher"`` (task, step) of EWC's Fisher;
        ``"kd"`` (kd_seed,) of ER-KD's soft targets."""
        B, T_in = batch["inputs"].shape
        return dropout_masks(self.cfg, B, T_in, batch["melspecs"].shape[-1],
                             self._mask_generator(phase, *key),
                             device=self.device)

    def _draw_masks(self, phase: str, epoch: int, itr_b: int, n_tasks: int,
                    n_pass: int, batch: dict) -> list:
        """Every dropout mask of one meta-batch: ``[task][pass]`` dicts as
        ``models.tacotron2nv.dropout_masks`` draws them for ``batch``'s
        shapes (leading axis the task).  ``phase`` ``"train"``: each
        task's inner steps, then its query pass; ``"test"``: the same,
        then the forward its MCD is read from; ``"metatest"``: the joint
        trainer's meta-test, the inner steps and the query pass."""
        _, B, T_in = batch["inputs"].shape
        T_mel = batch["melspecs"].shape[-1]
        g = self._mask_generator(phase, epoch, itr_b)
        return [[dropout_masks(self.cfg, B, T_in, T_mel, g,
                               device=self.device)
                 for _ in range(n_pass)] for _ in range(n_tasks)]

    # ------------------------------------------------------------ steps
    def _mcd(self, outs, batch) -> float:
        return mcd_batch(outs[1].transpose(1, 2),
                         batch["melspecs"].transpose(1, 2),
                         batch["melspec_lengths"])

    def _grad_step(self, state: TrainState, batch: dict, masks: dict,
                   penalty=None):
        """One optimisation step on ``batch``: the loss (plus
        ``penalty(params)`` where given), its gradients on the float32
        parameters, the clip (``clip_grad_norm``, ``grad_clip_thresh``
        read now), the optimizer ``self.tx``.  Returns ``(new_state,
        metrics, outputs)``; metrics ``loss``, ``mcd``, ``grad_norm``
        (0 without the clip), and ``base_loss`` with a penalty.

        On a mesh the rank takes its rows of the global ``batch`` and
        ``masks`` (``_put_batch``), differentiates its share of the
        global loss with the batch norms' moments over the ranks, and the
        ranks' gradients and metrics are summed in one all-reduce; the
        outputs are the rank's rows."""
        with self._tp_scope():
            return self._grad_step_in(state, batch, masks, penalty)

    def _grad_step_in(self, state, batch, masks, penalty):
        batch, masks, group = self._put_batch(batch, masks)
        params = {k: p.detach().requires_grad_()
                  for k, p in state.params.items()}
        with torch.enable_grad(), synced_batchnorm(group):
            base, (outs, new_ms) = self._loss_for_batch(
                params, state.model_state, batch, masks)
            pen = None if penalty is None else penalty(params)
            if group is None:
                loss = base if pen is None else base + pen
            else:
                loss = self._loss_share(base, pen, group.size)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        with torch.no_grad():
            # a parameter a freeze_* flag cuts off gets a zero gradient
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            outs = [o.detach() for o in outs]
            mcd = self._mcd(outs, batch)
            if group is not None:
                share = self._loss_share(base, None, group.size)
                vec = torch.stack([loss.detach(), share.detach(),
                                   torch.tensor(mcd / group.size,
                                                device=loss.device)])
                *gs, vec = C.all_reduce_flat([*grads.values(), vec], group)
                grads = dict(zip(grads, gs))
                loss, base, mcd = vec[0], vec[1], float(vec[2])
            if self.params.get("clip_grad_norm", False):
                grads, grad_norm = clip_by_global_norm(
                    grads, float(self.params.get("grad_clip_thresh", 1.0)))
            else:
                grad_norm = torch.zeros((), device=self.device)
            updates, opt_state = self.tx.update(grads, state.opt_state,
                                                state.params)
            new_state = TrainState(
                params=apply_updates(state.params, updates),
                model_state={k: v.detach() for k, v in new_ms.items()},
                opt_state=opt_state, step=state.step + 1)
        metrics = {"loss": loss.detach(), "mcd": mcd,
                   "grad_norm": grad_norm}
        if penalty is not None:
            metrics["base_loss"] = base.detach()
        return new_state, metrics, outs

    def _train_step(self, state: TrainState, batch: dict, masks: dict):
        """``(new_state, {loss, mcd, grad_norm}, outputs)``."""
        return self._grad_step(state, batch, masks)

    @torch.no_grad()
    def _eval_step(self, state: TrainState, batch: dict, masks: dict):
        """The loss and MCD of one pass in training mode, as the
        reference tests (dropout on, batch-norm statistics advance):
        ``(state with the new statistics, {loss, mcd}, outputs)``.  On a
        mesh the rank evaluates its rows with the moments over the
        ranks, so every rank ends with the same statistics."""
        batch, masks, group = self._put_batch(batch, masks)
        with synced_batchnorm(group):
            loss, (outs, new_ms) = self._loss_for_batch(
                state.params, state.model_state, batch, masks)
        mcd = self._mcd(outs, batch)
        if group is not None:
            vec = torch.stack([self._loss_share(loss, None, group.size),
                               torch.tensor(mcd / group.size,
                                            device=loss.device)])
            vec = C.all_reduce(vec, group)
            loss, mcd = vec[0], float(vec[1])
        return (state._replace(model_state=new_ms),
                {"loss": loss, "mcd": mcd}, outs)

    def _plot_example(self, last, name: str):
        """The last item of ``last = (batch, outputs)``: its predicted and
        target mels and its alignment, to ``examples/<name>.png`` (rank 0
        alone, whose rows come first: its last row)."""
        if not self.is_writer:
            return
        from ..utils.plot import plot_spec_attn_example

        batch, outs = last
        i = outs[1].shape[0] - 1
        plot_spec_attn_example(
            outs[1][i].cpu().numpy(), batch["melspecs"][i].cpu().numpy(),
            outs[3][i].cpu().numpy(),
            os.path.join(self.path_manager.examples_path, name),
            length_mel=int(batch["melspec_lengths"][i]),
            length_attn=int(batch["input_lengths"][i]),
        )

    # ------------------------------------------------------ parallelism
    def _init_parallel(self, pcfg: dict):
        """The ``(dp, task)`` or ``(dp, task, tp)`` mesh over the world's
        ranks (every rank calls this) and the rank's layouts."""
        mesh = make_mesh(dp=pcfg.get("dp"), task=int(pcfg.get("task", 1)),
                         tp=int(pcfg.get("tp", 1)))
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside {mesh}: start "
                             "dp x task x tp ranks")
        self._use_mesh(mesh)
        backend = dist.get_backend() if dist.is_initialized() else "none"
        dims = " ".join(f"{k}={v}" for k, v in self.mesh.shape.items())
        print(f"[parallel] rank {self.mesh.rank}: mesh {dims} "
              f"({self.mesh.size} ranks) on {self.device}, backend "
              f"{backend}")

    def _use_mesh(self, mesh):
        self.mesh = mesh
        self._data = mesh.group(AXES)
        self._all = mesh.group(ALL)
        self._batch_layout = batch_sharding(mesh)
        self._task_layout = task_batch_sharding(mesh)

    def _tp_scope(self):
        """The context the model's forwards and the steps' norms run in:
        the partitioned products on a tp mesh, else nothing."""
        return tp_products(self._tp)

    def _in_tp_scope(self, fn):
        """``fn`` run under :meth:`_tp_scope` (a meta step)."""
        def run(*args, **kwargs):
            with self._tp_scope():
                return fn(*args, **kwargs)

        return run

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh is None or self._all.index == 0

    @property
    def _evaluates(self) -> bool:
        """Whether this rank runs the phases that rank 0's data
        coordinate runs alone (the meta-tests): with tp, its tp group."""
        return self.mesh is None or self._data.index == 0

    @property
    def _data_axes_size(self) -> int:
        """The ranks a batch's rows split over: dp·task."""
        return self.mesh.shape["dp"] * self.mesh.shape["task"]

    def _splits(self, n: int) -> bool:
        """Whether ``n`` rows (or tasks) split over the data axes; a batch
        whose rows do not split runs whole on every rank (said once)."""
        if self.mesh is None:
            return False
        if n % self._data_axes_size == 0:
            return True
        if not self._said_replicated:
            print(f"[parallel] {n} rows do not split over "
                  f"{self._data_axes_size} ranks: such a batch runs whole "
                  "on every rank")
            self._said_replicated = True
        return False

    def _put_batch(self, batch: dict, masks: dict | None = None):
        """This rank's rows of a global batch and of its masks, and the
        group its reductions run over (None: the batch runs whole)."""
        B = int(batch["inputs"].shape[0])
        if not self._splits(B):
            return batch, masks, None
        rows = self._batch_layout.rows(B)
        return take_rows(batch, rows), mask_rows(masks, rows), self._data

    def _put_task_batch(self, support: dict, query: dict):
        """This rank's tasks of a global episode (the task-parallel
        layout) and whether they are a block of it."""
        K = int(support["inputs"].shape[0])
        if not self._splits(K):
            return support, query, False
        rows = self._task_layout.rows(K)
        return take_rows(support, rows), take_rows(query, rows), True

    def _loss_share(self, base, penalty, parts: int):
        """This rank's share of the global loss: the shares of the ranks
        sum to it (the loss of ``reduction: sum`` is a sum of the ranks'
        losses, the others a mean; a penalty counts once)."""
        if self.loss_kwargs["reduction"] != "sum":
            base = base * (1.0 / parts)
        return base if penalty is None else base + penalty * (1.0 / parts)

    def _barrier(self):
        if self.mesh is not None:
            C.barrier(self._all)

    def _reshard_state(self):
        """Every rank's train state as rank 0 holds it (a broadcast of the
        whole state), on a tp mesh cut to the rank's shards; checkpoints
        do not depend on the mesh, so this is also how a run restores on
        another one."""
        if self.mesh is None:
            return
        ts = replicate_state(self.train_state, self.mesh)
        if self.mesh.tp > 1:
            self._tp_plan = tp_shardings(ts, self.mesh, self._TP_MIN_DIM)
            self._tp = TensorParallel(
                GroupTransport(self.mesh.group("tp")),
                {**self._tp_plan.params, **self._tp_plan.model_state},
                self.model)
            ts = shard_tree_tp(ts, self.mesh, self._TP_MIN_DIM)
        self.train_state = ts

    def _whole_state(self) -> TrainState:
        """The train state whole: on a tp mesh gathered over the tp group
        (every rank must call this), else as it is."""
        if self._tp is None:
            return self.train_state
        return gather_tree_tp(self.train_state, self.mesh, self._tp_plan)

    # ----------------------------------------------------------- batches
    def _host_batch(self, batch) -> dict:
        """A collated batch as the model's batch dictionary of host
        tensors (integers as int64)."""
        return host_tensors({
            "inputs": batch.inputs,
            "input_lengths": batch.input_lengths,
            "melspecs": batch.mels,
            "melspec_lengths": batch.mel_lengths,
            "speaker_vecs": batch.speaker_vecs(self.speaker_emb_type),
            "stop_labels": batch.stop_labels,
        })

    def _unpack_batch(self, batch) -> dict:
        """A collated batch as the model's batch dictionary on the
        device."""
        return tree_map(lambda x: x.to(self.device),
                        self._host_batch(batch))

    # ------------------------------------------------------ checkpoints
    def _to_trees(self, params: dict, model_state: dict):
        """``(params, model_state)`` as the JAX package's trees."""
        return jax_from_state_dict({**params, **model_state}, self.cfg)

    def _params_tree(self, d: dict) -> dict:
        """A dictionary keyed by the parameter names (gradients, Adam's
        moments) as the JAX params tree."""
        return jax_from_state_dict({**d, **self.model_state}, self.cfg)[0]

    def _opt_to_tree(self, state):
        """The optimizer state as a checkpoint writes it: per-parameter
        dictionaries as the JAX params tree, empty states as ``{}``."""
        return opt_to_tree(state, set(self.param_names), self._params_tree)

    def _opt_from_tree(self, template, raw, state_tree):
        """The inverse of :meth:`_opt_to_tree`, in ``template``'s
        structure, types and device (``state_tree``: the checkpoint's
        ``model_state``, which the key mapping reads alongside)."""
        return opt_from_tree(
            template, raw, set(self.param_names),
            lambda tree: state_dict_from_jax(tree, state_tree, self.cfg))

    def _ckpt_payload(self) -> dict | None:
        """The checkpoint of the whole train state; every rank calls it
        (the tp ranks gather), rank 0 alone gets it, the others None."""
        ts = self._whole_state()
        if not self.is_writer:
            return None
        params, model_state = self._to_trees(ts.params, ts.model_state)
        return {"params": params, "model_state": model_state,
                "opt_state": self._opt_to_tree(ts.opt_state),
                "step": self.step_global}

    def _save_checkpoint(self, name: str | None = None) -> str:
        """Write a checkpoint (rank 0 alone) and return its path."""
        if name is None:
            name = f"checkpoint_{self.step_global // 100}.ckpt"
        path = os.path.join(self.path_manager.checkpoints_path, name)
        payload = self._ckpt_payload()
        if self.is_writer:
            save_checkpoint(path, payload)
        return path

    def _state_dict_from_raw(self, raw: dict) -> dict:
        return state_dict_from_jax(raw["params"], raw["model_state"],
                                   self.cfg)

    def _load_finetune_checkpoint(self):
        """Start from ``finetune_checkpoint_path``: a ``.ckpt`` of either
        package or a reference ``.pt`` ``state_dict``; parameters load
        one by one (a missing name or another shape keeps the current
        value), the batch-norm statistics with them."""
        path = self.params["finetune_checkpoint_path"]
        print(f"Loading checkpoint from  {path}")
        if path.endswith(".pt"):
            sd = torch.load(path, map_location="cpu", weights_only=True)
        else:
            sd = self._state_dict_from_raw(load_checkpoint(path))
        ts = self.train_state
        self.train_state = ts._replace(
            params=load_partial_params(ts.params, sd),
            model_state=restore_like(
                ts.model_state, {k: sd[k] for k in ts.model_state}),
        )

    # ------------------------------------------------- preemption resume
    # Epoch-granular auto-resume: the full state and the epoch counter in
    # one atomic file at every checkpoint interval; `resume: true` skips
    # the completed epochs while replaying their data draws, so the rest
    # of the run sees what an unbroken run would.

    _AUTO_CKPT = "auto_resume.ckpt"

    def _save_epoch_state(self, epoch: int, extra: dict | None = None):
        ckpt = self._ckpt_payload()
        if not self.is_writer:
            return
        resume_state = {"epoch": epoch, "step_global": self.step_global}
        resume_state.update(extra or {})
        payload = dict(ckpt, resume_state=resume_state)
        path = os.path.join(self.path_manager.checkpoints_path,
                            self._AUTO_CKPT)
        if self.params.get("async_checkpoint", True):
            if self._async_ckpt is None:
                self._async_ckpt = AsyncCheckpointer()
            self._async_ckpt.save(path, payload)
        else:
            save_checkpoint(path, payload)

    def _finish_checkpoints(self):
        """Drain pending writes and stop the writer thread; on a mesh no
        rank leaves before rank 0's files are whole."""
        if self._async_ckpt is not None:
            self._async_ckpt.close()
            self._async_ckpt = None
        self._barrier()

    def _try_resume_epoch(self):
        """``(completed_epochs, resume_state | None)``."""
        if not self.params.get("resume", False):
            return 0, None
        wait_all_checkpoints()
        self._barrier()
        path = os.path.join(self.path_manager.checkpoints_path,
                            self._AUTO_CKPT)
        if not os.path.exists(path):
            print("resume requested but no auto-resume state found; "
                  "starting fresh")
            return 0, None
        raw = load_checkpoint(path)
        d = raw["resume_state"]
        self.restore_raw(raw)
        self.step_global = int(d["step_global"])
        print(f"Resuming after epoch {d['epoch']} (step {self.step_global})")
        return int(d["epoch"]), d

    def restore(self, path: str):
        """Full-fidelity resume (parameters, optimizer, step)."""
        self.restore_raw(load_checkpoint(path))

    def restore_raw(self, raw: dict):
        sd = self._state_dict_from_raw(raw)
        ts = self.train_state
        self.train_state = TrainState(
            params=restore_like(ts.params, sd),
            model_state=restore_like(ts.model_state, sd),
            opt_state=self._opt_from_tree(ts.opt_state, raw["opt_state"],
                                          raw["model_state"]),
            step=int(raw["step"]),
        )
        self.step_global = int(raw["step"])
        self._reshard_state()

    # ------------------------------------------------ failure detection
    def _preempt_requested(self) -> bool:
        """Whether a preemption notice arrived; on a mesh, at any rank (a
        max over the ranks at every call, so that all stop together)."""
        stop = (self._preempt_guard is not None
                and self._preempt_guard.should_stop)
        if self.mesh is None:
            return stop
        flag = torch.tensor([int(stop)], device=self._flag_device())
        return bool(C.all_reduce(flag, self._all, dist.ReduceOp.MAX))

    def _flag_device(self) -> torch.device:
        pg = self._all.pg
        nccl = pg is not None and dist.get_backend(pg) == "nccl"
        return self.device if nccl else torch.device("cpu")

    def _start_watchdog(self):
        """Arm the stall watchdog when ``stall_timeout_s`` is set."""
        timeout = self.params.get("stall_timeout_s")
        if timeout and self.is_writer:
            from ..utils.preemption import StallWatchdog

            self._watchdog = StallWatchdog(
                float(timeout),
                dump_path=os.path.join(self.path_manager.logs_path,
                                       "stall_dump.txt"),
            ).start()

    def _heartbeat(self):
        if self._watchdog is not None:
            self._watchdog.beat()

    def _stop_watchdog(self):
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    # ---------------------------------------------------------- logging
    def log_writer(self, logs: dict, type: str = "scalar"):
        """``logs``: ``{tag: (value, step)}``, to the JSON-lines log (and
        TensorBoard where it is installed and asked for); ``type="hist"``
        for histograms.  Rank 0 alone writes."""
        if self.logger is None:
            return
        if type == "scalar":
            self.logger.log_scalars(logs)
        elif type == "hist":
            self.logger.log_histograms(logs)
        else:
            raise NotImplementedError(type)

    def get_module_grads_flattened(self, grads: dict, step: int) -> dict:
        """Per top-level module of the JAX params tree, its gradients as
        one flat numpy vector in the tree's leaf order (for histogram
        logging): ``{"grad_<module>": (vector, step)}``."""
        def leaves(t):
            if isinstance(t, dict):
                return [x for k in sorted(t) for x in leaves(t[k])]
            if isinstance(t, (list, tuple)):
                return [x for v in t for x in leaves(v)]
            return [np.asarray(t)]

        out = {}
        for mod, sub in self._params_tree(grads).items():
            ls = leaves(sub)
            if ls:
                out["grad_" + mod] = (np.concatenate([x.ravel() for x in ls]),
                                      step)
        return out
