"""Training loop (counterpart of ``csm_tpu/train/loop.py``): a train step
with gradient accumulation over microbatches, AdamW with the linear
schedule and global-norm clipping of the JAX package's optax chain, the
two-loss split, epoch-to-step rescheduling, checkpoint rotation and resume.

Reference semantics (HF ``Trainer`` as ``train.py`` uses it):
- loss = backbone CE + amortized decoder CE (``modeling_csm.py:372-465``),
  gradients averaged over the accumulation microbatches;
- per-step logging of ``backbone_loss`` and ``decoder_loss``
  (``train.py:303-326``);
- the epoch-repetition dataset plus epoch-to-step save / eval rescheduling:
  ``steps_per_old_epoch = ceil(N / (bs * accum))`` (``train.py:414-467``);
- AdamW, lr 5e-6 by default, linear decay to 0, clipping at
  ``max_grad_norm``.

On the GPU the backbone's attention runs the flash kernels forward and
backward (:mod:`csm_tpu_torch.ops.flash_attention`), and each backbone layer
is checkpointed (``remat``).  The step updates the parameter tensors in
place: the trainer trains the tensors it is given.

With a mesh (:mod:`csm_tpu_torch.parallel`) every rank holds the full global
batch and its parameters: whole, or under a ``model`` axis above 1 its
shard of them (:func:`~csm_tpu_torch.parallel.shard_params`).  Its forward
computes its rows and frames and the gradient of its share of the global
loss.  After the accumulation loop the gradients are summed over the
``data`` x ``seq`` ranks at its ``model`` index in one flat bucket, then
scaled, clipped and applied alike on every rank of that group, so the
replicas stay bitwise equal.  The global gradient norm sums the squares of
the sharded leaves over ``model`` and counts each replicated leaf once, so
it is the norm of the whole model's gradient on every rank.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.device import DeviceLike, resolve_device
from csm_tpu_torch.models import csm
from csm_tpu_torch.parallel.collectives import all_gather_frames, all_reduce_flat_, all_reduce_sum
from csm_tpu_torch.parallel.mesh import (
    gather_params,
    param_sharding,
    shard_params,
    sharded_dim,
    take_shard,
)
from csm_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

REMAT_POLICIES = ("auto", "nothing", "dots")


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a.b": tensor}`` over a nested dict, keys sorted."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return dict(sorted(out.items()))


def map_tree(fn, tree: dict) -> dict:
    return {k: (map_tree(fn, v) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


@dataclasses.dataclass
class Optimizer:
    """AdamW (``b1=0.9, b2=0.999, eps=1e-8``) on a linear schedule with
    global-norm clipping: the optax chain of the JAX package's
    ``make_optimizer``.  The schedule is a function of the update count, as
    optax's is, so the step count is the scheduler's whole state."""

    learning_rate: float
    total_steps: int
    warmup_steps: int = 0
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0

    def lr(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based): optax's
        ``join_schedules`` of a linear warmup from 0 and a linear decay to 0,
        so with warmup the first update has lr 0."""

        def linear(init: float, end: float, steps: int, c: int) -> float:
            frac = 1.0 - min(max(c, 0), steps) / steps
            return (init - end) * frac + end

        if self.warmup_steps > 0:
            if count < self.warmup_steps:
                return linear(0.0, self.learning_rate, self.warmup_steps, count)
            return linear(self.learning_rate, 0.0,
                          max(self.total_steps - self.warmup_steps, 1),
                          count - self.warmup_steps)
        return linear(self.learning_rate, 0.0, max(self.total_steps, 1), count)

    def clip_(self, grads: List[torch.Tensor], sharded: Optional[List[bool]] = None,
              group=None) -> torch.Tensor:
        """In place, as ``optax.clip_by_global_norm``: grads are kept when
        their global norm (:func:`global_norm`; ``sharded`` / ``group`` for
        a model axis) is below ``max_grad_norm``, else each becomes ``(g /
        norm) * max_grad_norm`` (no epsilon).  Returns the norm before
        clipping, in fp32."""
        norm = global_norm(grads, sharded, group)
        keep = norm < self.max_grad_norm
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * self.max_grad_norm))
        return norm

    def init(self, params: dict) -> "TrainState":
        """A fresh state training the tensors of ``params`` (made leaves that
        require grad; they share storage with the given tensors)."""
        params = map_tree(lambda t: t.detach().requires_grad_(True), params)
        opt = torch.optim.AdamW(
            list(flatten(params).values()), lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay,
        )
        return TrainState(params=params, optimizer=opt, step=0)


def make_optimizer(
    learning_rate: float,
    total_steps: int,
    warmup_steps: int = 0,
    weight_decay: float = 0.0,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    """AdamW + HF-default linear decay schedule + global-norm clipping."""
    return Optimizer(learning_rate, total_steps, warmup_steps, weight_decay, max_grad_norm)


def global_norm(tensors: List[torch.Tensor], sharded: Optional[List[bool]] = None,
                group=None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors, summed in fp32.  With
    ``sharded`` (one flag per tensor) the flagged tensors are this rank's
    shards over ``group`` (a ``model`` axis): their squares are summed over
    the group, and each tensor not flagged, the same on every rank, counts
    once."""
    squares = [t.float().square().sum() for t in tensors]
    if not sharded or not any(sharded):
        return torch.stack(squares).sum().sqrt()
    part = torch.stack([q for q, f in zip(squares, sharded) if f]).sum()
    whole = [q for q, f in zip(squares, sharded) if not f]
    total = all_reduce_sum(part, group)
    if whole:
        total = total + torch.stack(whole).sum()
    return total.sqrt()


@dataclasses.dataclass
class TrainState:
    """The trained tensors (``params``: the whole model, or the LoRA
    adapters), the AdamW optimizer that holds their moments, and the number
    of updates done (which also fixes the learning rate)."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"params": self.params, "opt_state": self.optimizer.state_dict(),
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        mine = flatten(self.params)
        theirs = flatten(saved["params"])
        if mine.keys() != theirs.keys():
            raise ValueError(f"checkpoint params differ: {sorted(mine.keys() ^ theirs.keys())}")
        for k, t in mine.items():
            t.copy_(theirs[k])
        self.optimizer.load_state_dict(saved["opt_state"])
        self.step = int(saved["step"])


def make_train_step(
    config: CSMConfig,
    optimizer: Optimizer,
    max_decoder_frames: int,
    compute_dtype=None,
    lora_cfg: Optional[dict] = None,
    remat: bool = True,
    remat_policy: str = "auto",
    use_flash: bool = True,
    mesh=None,
) -> Callable:
    """The train step ``step(state, base_params, batch) -> (state,
    metrics)`` over a ``[accum, B, S, 33]`` batch of tensors on the
    parameters' device.

    Microbatch gradients are summed, scaled by ``1 / accum`` (kept in the
    gradients' dtype), clipped and applied in one AdamW update; ``state`` is
    updated in place and returned.  ``compute_dtype`` casts the parameters
    inside the loss, so fp32 masters get fp32 gradients.  ``remat_policy``
    ``"auto"`` resolves to ``"dots"`` at microbatch 1, else ``"nothing"``.
    Metrics (0-d tensors): ``loss``, ``backbone_loss``, ``decoder_loss`` and
    ``grad_norm`` (before clipping).

    With ``lora_cfg={"alpha": a, "rank": r}``, ``state.params`` holds only
    the adapters and ``base_params`` the frozen base they are merged into.

    ``mesh``: a :class:`~csm_tpu_torch.parallel.Mesh`.  Every rank passes
    the same global batch; its forward takes its rows and frames, and the
    summed gradients are those of the one-device step on the global batch.
    ``"auto"`` then looks at this rank's rows.  With a ``model`` axis above
    1, ``state.params`` (or, with LoRA, ``base_params``) are this rank's
    shards (:func:`~csm_tpu_torch.parallel.shard_params`); LoRA adapters
    stay whole (:mod:`csm_tpu_torch.train.lora`).
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"remat_policy must be 'auto', 'nothing', or 'dots'; got {remat_policy!r}"
        )
    dims = leaf_dims(config, mesh) if lora_cfg is None else None
    sharded = None if dims is None else [d is not None for d in dims]
    model_group = None if mesh is None else mesh.group("model")

    def loss_fn(train_params, base_params, mb):
        if lora_cfg is not None:
            from csm_tpu_torch.train.lora import apply_lora

            params = apply_lora(base_params, train_params, lora_cfg["alpha"], lora_cfg["rank"],
                                mesh=mesh)
        else:
            params = train_params
        if compute_dtype is not None:
            params = map_tree(lambda x: x.to(compute_dtype) if x.is_floating_point() else x,
                              params)
        policy = remat_policy
        if policy == "auto":
            rows = mb["input_ids"].shape[0] // (mesh.size("data") if mesh is not None else 1)
            policy = "dots" if rows == 1 else "nothing"
        return csm.forward(
            params, config, mb["input_ids"], mb["attention_mask"], labels=mb["labels"],
            max_decoder_frames=max_decoder_frames, use_flash=use_flash, remat=remat,
            remat_policy=policy, mesh=mesh,
        )

    def train_step(state: TrainState, base_params, batch: Dict[str, torch.Tensor]):
        accum = batch["input_ids"].shape[0]
        with span("csm.train.step", accum=accum):
            return accumulate_and_update(state, base_params, batch, accum)

    def accumulate_and_update(state: TrainState, base_params, batch: Dict[str, torch.Tensor],
                              accum: int):
        leaves = list(flatten(state.params).values())
        for p in leaves:
            p.grad = None
        sums = None
        for a in range(accum):
            with span("csm.train.forward", device=True):
                out = loss_fn(state.params, base_params, {k: v[a] for k, v in batch.items()})
            with span("csm.train.backward", device=True):
                out.loss.backward()
            parts = torch.stack([out.loss, out.backbone_loss, out.decoder_loss]).detach().float()
            sums = parts if sums is None else sums + parts
        scale = 1.0 / accum
        with span("csm.train.update", device=True):
            grads = []
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if mesh is not None:
                # One collective over the flattened gradients, in leaf order:
                # the same sequence of collectives on every rank.
                all_reduce_flat_(grads, mesh.group("batch"))
            for g in grads:
                g.mul_(scale)
            grad_norm = optimizer.clip_(grads, sharded, model_group)
            for group in state.optimizer.param_groups:
                group["lr"] = optimizer.lr(state.step)
            state.optimizer.step()
            state.step += 1
        sums = sums * scale
        metrics = {"loss": sums[0], "backbone_loss": sums[1], "decoder_loss": sums[2],
                   "grad_norm": grad_norm}
        return state, metrics

    return train_step


def _detached(tree: dict) -> dict:
    return map_tree(lambda t: t.detach(), tree)


def leaf_dims(config: CSMConfig, mesh) -> Optional[List[Optional[int]]]:
    """For each leaf of the parameter tree, in :func:`flatten` order, the
    dimension its shard is cut on over the mesh's ``model`` axis (None:
    replicated); None without a ``model`` axis above 1."""
    if mesh is None or mesh.size("model") == 1:
        return None
    return [sharded_dim(spec) for spec in flatten(param_sharding(mesh, config=config)).values()]


class CSMTrainer:
    """HF-Trainer-equivalent orchestration (reference ``CSMTrainer`` +
    ``main``, ``train.py:303-512``) on one device or a mesh of ranks.

    The dataset is any object with ``__len__`` / ``__getitem__`` returning
    ``{"input_ids", "attention_mask", "labels"}`` numpy arrays ``[S, 33]``;
    it is expected to use the epoch-repetition trick (``num_train_epochs``
    folded into ``__len__``): the trainer runs one pass over it and converts
    epoch-based save / eval cadence to steps (``train.py:414-467``).
    ``params`` are trained in place (the trainer's leaves share their
    storage).  ``device``: CUDA unless ``"cpu"`` is given.

    ``mesh``: a :class:`~csm_tpu_torch.parallel.Mesh`; by default one is made
    from ``args.mesh_data`` / ``args.mesh_seq`` / ``args.mesh_model`` when a
    process group is up (:func:`~csm_tpu_torch.parallel.
    maybe_init_distributed`).  The global batch is then
    ``per_device_train_batch_size * data``; every rank loads it whole and
    trains its rows and frames; ``evaluate`` returns the global loss on every
    rank; rank 0 writes checkpoints and the model.  With a ``model`` axis
    above 1 each rank trains its shard of ``params``
    (:func:`~csm_tpu_torch.parallel.shard_params`; LoRA: of the frozen base,
    the adapters stay whole); ``model_params``, ``save_model`` and the
    checkpoints gather the shards (the AdamW moments too), so what is
    written does not depend on the mesh, and a resume cuts it for this one.
    """

    def __init__(
        self,
        config: CSMConfig,
        params: dict,
        args,  # TrainingArguments
        train_dataset,
        eval_dataset=None,
        data_collator=None,
        device: DeviceLike = None,
        mesh=None,
    ):
        self.config = config
        self.args = args
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.data_collator = data_collator
        self.device = resolve_device(device)
        if mesh is None:
            mesh = _mesh_from_args(args)
        self.mesh = mesh

        data = mesh.size("data") if mesh is not None else 1
        self.global_batch = args.per_device_train_batch_size * data
        n_items = len(train_dataset)
        # ceil: the trailing partial accumulation window is trained on too
        # (_batches tops it up by repeating items), HF Trainer's no-drop-last.
        self.total_steps = max(
            1, math.ceil(n_items / (self.global_batch * args.gradient_accumulation_steps)))

        # Epoch-to-step rescheduling (train.py:414-467): an "old epoch" is
        # one pass over the un-repeated data.
        original_size = len(getattr(train_dataset, "data", train_dataset))
        eff_batch = self.global_batch * args.gradient_accumulation_steps
        self.steps_per_old_epoch = max(1, math.ceil(original_size / eff_batch))
        self.save_steps = (
            self.steps_per_old_epoch if args.save_strategy == "epoch"
            else args.save_steps * self.steps_per_old_epoch if args.save_strategy == "steps"
            else None
        )
        self.eval_steps = (
            self.steps_per_old_epoch if args.eval_strategy == "epoch"
            else args.eval_steps * self.steps_per_old_epoch if args.eval_strategy == "steps"
            else None
        )

        self.optimizer = make_optimizer(
            args.learning_rate, self.total_steps, args.warmup_steps, args.weight_decay,
            args.max_grad_norm,
        )
        self._max_dec = max(
            1,
            (self.global_batch * args.max_seq_length)
            // getattr(train_dataset, "amortization_ratio", 16),
        ) + self.global_batch
        if args.bf16:
            compute_dtype = torch.bfloat16
        elif getattr(args, "fp16", False):
            compute_dtype = torch.float16
        else:
            compute_dtype = None

        # LoRA mode: train only rank-r adapters; the base stays frozen.
        self.lora_rank = int(getattr(args, "lora_rank", 0) or 0)
        self.lora_alpha = float(getattr(args, "lora_alpha", 16.0))
        lora_cfg = ({"alpha": self.lora_alpha, "rank": self.lora_rank}
                    if self.lora_rank > 0 else None)
        params = map_tree(lambda t: t.to(self.device), params)
        self._dims = leaf_dims(config, mesh)  # None unless a model axis cuts the params
        if lora_cfg is not None:
            from csm_tpu_torch.train.lora import init_lora_params

            targets = tuple(t for t in getattr(args, "lora_targets", "wq,wv").split(",") if t)
            gen = torch.Generator(device=self.device).manual_seed(args.seed)
            # Adapters shaped off the whole base, alike on every rank.
            train_params = init_lora_params(gen, params, self.lora_rank, targets)
            self.base_params = _detached(self._shard(params))
        else:
            self.base_params = None
            train_params = self._shard(params)
        self.state = self.optimizer.init(train_params)
        self._step_fn = make_train_step(
            config, self.optimizer, self._max_dec, compute_dtype=compute_dtype,
            lora_cfg=lora_cfg, remat=bool(getattr(args, "gradient_checkpointing", True)),
            remat_policy=str(getattr(args, "gradient_checkpointing_policy", "auto")),
            mesh=self.mesh,
        )
        self._metrics_log: list = []

    # ------------------------------------------------------------------

    def _shard(self, tree: dict) -> dict:
        """This rank's shard of a whole parameter tree (the tree without a
        model axis)."""
        return tree if self._dims is None else shard_params(tree, self.mesh, self.config)

    def _gather(self, tree: dict) -> dict:
        """The whole parameter tree from this rank's shard (every rank of the
        model axis calls it)."""
        return tree if self._dims is None else gather_params(tree, self.mesh, self.config)

    def model_params(self) -> dict:
        """The current whole parameters (adapters merged in LoRA mode),
        detached; gathered over the model axis, so every rank calls it."""
        if self.lora_rank > 0:
            from csm_tpu_torch.train.lora import merge_lora

            return merge_lora(self._gather(self.base_params), _detached(self.state.params),
                              self.lora_alpha, self.lora_rank)
        return self._gather(_detached(self.state.params))

    def _local_params(self) -> dict:
        """This rank's parameters for a forward (adapters merged into its
        shard in LoRA mode), detached."""
        if self.lora_rank > 0:
            from csm_tpu_torch.train.lora import apply_lora

            with torch.no_grad():
                return apply_lora(self.base_params, _detached(self.state.params),
                                  self.lora_alpha, self.lora_rank, mesh=self.mesh)
        return _detached(self.state.params)

    def _map_moments(self, opt: dict, fn) -> dict:
        """An AdamW state dict with ``fn(moment, dim)`` applied to both
        moments of each leaf cut on ``dim`` over the model axis."""
        state = {i: {k: (fn(v, self._dims[i])
                         if k in ("exp_avg", "exp_avg_sq") and self._dims[i] is not None else v)
                     for k, v in st.items()}
                 for i, st in opt["state"].items()}
        return {**opt, "state": state}

    def _whole_state(self) -> dict:
        """``state.state_dict()`` with the parameters and the AdamW moments
        gathered over the model axis (LoRA's adapters are whole already)."""
        state = self.state.state_dict()
        if self._dims is None or self.lora_rank > 0:
            return state
        group = self.mesh.group("model")
        return {**state, "params": self._gather(_detached(state["params"])),
                "opt_state": self._map_moments(
                    state["opt_state"], lambda v, d: all_gather_frames(v, group, d))}

    def _cut_state(self, saved: dict) -> dict:
        """The inverse of :func:`_whole_state`: this rank's shard of a whole
        saved state."""
        if self._dims is None or self.lora_rank > 0:
            return saved
        return {**saved, "params": self._shard(saved["params"]),
                "opt_state": self._map_moments(
                    saved["opt_state"], lambda v, d: take_shard(v, d, self.mesh))}

    def _batches(self, skip_items: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """``[accum, global_batch, S, 33]`` numpy batches from the dataset.

        A trailing partial accumulation window is topped up by repeating its
        items (round-robin), so every sample trains at least once.
        ``skip_items``: resume fast-forward by index; skipped items are never
        loaded."""
        accum = self.args.gradient_accumulation_steps
        need = self.global_batch * accum
        buf = []
        for i in range(skip_items, len(self.train_dataset)):
            buf.append(self.train_dataset[i])
            if len(buf) == need:
                yield self._collate_group(buf, accum)
                buf = []
        if buf:
            n = len(buf)
            buf = [buf[j % n] for j in range(need)]
            yield self._collate_group(buf, accum)

    def _collate_group(self, buf, accum):
        collated = self.data_collator(buf)
        return {k: v.reshape(accum, self.global_batch, *v.shape[1:])
                for k, v in collated.items()}

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host to device: pinned host memory and an asynchronous copy on
        CUDA."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _prefetched(self, it: Iterator) -> Iterator:
        """Bounded background prefetch over a batch iterator.

        A daemon thread runs the iterator (dataset items, collation, the
        host-to-device copy) for batch i+k while the device runs step i, as
        the reference's DataLoader workers do (``train.py:253-255``).  The
        queue holds at most ``args.dataloader_prefetch`` batches (0 turns
        prefetching off); an exception in the worker re-raises here."""
        depth = int(getattr(self.args, "dataloader_prefetch", 2) or 0)
        if depth <= 0:
            yield from it
            return
        import queue as queue_mod
        import threading

        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()  # consumer gone: the worker must not block

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put_or_stop(item):
                        return
                put_or_stop(sentinel)
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                put_or_stop(e)

        threading.Thread(target=worker, daemon=True, name="csm-batch-prefetch").start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Abandoned mid-stream: release the worker, which may be parked on
            # a full queue, and drop what it queued.
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue_mod.Empty:
                pass

    def _maybe_resume(self) -> int:
        """Restore the latest checkpoint if asked to; returns the step to
        resume from (0 = fresh run)."""
        if not getattr(self.args, "resume_from_checkpoint", False):
            return 0
        from csm_tpu_torch.checkpoint import latest_step, load_checkpoint

        ckpt_dir = os.path.join(self.args.output_dir, "checkpoints")
        step = latest_step(ckpt_dir)
        if step is None:
            logger.info("resume requested but no checkpoint found; starting fresh")
            return 0
        self.state.load_state_dict(
            self._cut_state(load_checkpoint(ckpt_dir, step, map_location=self.device)))
        logger.info("resumed from checkpoint at step %d", step)
        return step

    def train(self) -> Dict[str, float]:
        args = self.args
        logger.info("training: %d steps (batch %d x accum %d) on %s", self.total_steps,
                    self.global_batch, args.gradient_accumulation_steps, self.device)
        start_step = self._maybe_resume()
        last: Dict[str, float] = {}
        t0 = time.time()
        need = self.global_batch * args.gradient_accumulation_steps

        def device_batches():
            for batch in self._batches(skip_items=start_step * need):
                yield self._to_device(batch)

        from csm_tpu_torch.train.reporting import make_reporter

        # The ranks of a mesh log the same global metrics: rank 0 reports.
        rank0 = self.mesh is None or self.mesh.rank == 0
        reporter = make_reporter(getattr(args, "report_to", "none") if rank0 else "none",
                                 os.path.join(args.output_dir, "runs"))
        try:
            for step, batch in enumerate(self._prefetched(device_batches()),
                                         start=start_step + 1):
                self.state, metrics = self._step_fn(self.state, self.base_params, batch)
                if args.logging_steps and step % args.logging_steps == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    last["step"] = step
                    last["time"] = time.time() - t0
                    self._metrics_log.append(last)
                    reporter.log(step, last)
                    logger.info("step %d | loss %.4f | train/backbone_loss %.4f | "
                                "train/decoder_loss %.4f", step, last["loss"],
                                last["backbone_loss"], last["decoder_loss"])
                if self.save_steps and step % self.save_steps == 0:
                    self.save_checkpoint(step)
                if self.eval_steps and self.eval_dataset is not None and step % self.eval_steps == 0:
                    last["eval_loss"] = self.evaluate()
                    reporter.log(step, {"eval_loss": last["eval_loss"]})
        finally:
            reporter.close()
        return last

    @torch.no_grad()
    def evaluate(self) -> float:
        """Token-weighted eval loss over the eval dataset.

        Each batch's (mean, target count) pair is accumulated per loss and
        ``eval_loss`` is ``sum nll / sum targets`` for the backbone and the
        decoder CE, summed: the loss one batch of the whole eval set would
        give (HF Trainer eval semantics).  The trailing partial batch is
        padded with label-masked copies of its own items, which add no
        targets."""
        bb_nll = dec_nll = bb_n = dec_n = 0.0
        params = self._local_params()
        buf = []

        def flush():
            nonlocal bb_nll, dec_nll, bb_n, dec_n
            b = self._to_device(self.data_collator(buf))
            out = csm.forward(params, self.config, b["input_ids"], b["attention_mask"],
                              labels=b["labels"], max_decoder_frames=self._max_dec,
                              mesh=self.mesh)
            bl, bn, dl, dn = (float(x) for x in (out.backbone_loss, out.backbone_targets,
                                                 out.decoder_loss, out.decoder_targets))
            bb_nll += bl * bn
            bb_n += bn
            dec_nll += dl * dn
            dec_n += dn

        for i in range(len(self.eval_dataset)):
            buf.append(self.eval_dataset[i])
            if len(buf) == self.global_batch:
                flush()
                buf = []
        if buf:
            n = len(buf)
            buf = buf + [{**buf[j % n], "labels": np.full_like(buf[j % n]["labels"], -100)}
                         for j in range(n, self.global_batch)]
            flush()
        if bb_n == 0 and dec_n == 0:
            mean = float("nan")
        else:
            mean = (bb_nll / bb_n if bb_n else 0.0) + (dec_nll / dec_n if dec_n else 0.0)
        logger.info("eval_loss %.4f", mean)
        return mean

    # ------------------------------------------------------------------

    def save_checkpoint(self, step: int) -> None:
        from csm_tpu_torch.checkpoint import save_checkpoint

        state = self._whole_state()
        state["step"] = step
        save_checkpoint(os.path.join(self.args.output_dir, "checkpoints"), step, state,
                        max_to_keep=self.args.save_total_limit)
        logger.info("saved checkpoint at step %d", step)

    def save_model(self, output_dir: Optional[str] = None) -> None:
        """Final save (reference ``trainer.save_model``, ``train.py:506-508``):
        ``config.json`` plus reference-layout ``model.safetensors``, which
        ``CSMModel.from_pretrained`` loads.  In LoRA mode the merged model is
        written, and the adapters beside it under ``adapters/``.  Every rank
        calls it (the parameters are gathered over the model axis); rank 0
        writes."""
        from csm_tpu_torch.checkpoint import (
            on_rank_zero,
            save_checkpoint,
            save_params_to_safetensors,
        )

        out = output_dir or self.args.output_dir
        if self.lora_rank > 0:
            save_checkpoint(os.path.join(out, "adapters"), 0,
                            {"lora": _detached(self.state.params)}, max_to_keep=1)

        params = self.model_params()

        def write():
            os.makedirs(out, exist_ok=True)
            self.config.to_json(os.path.join(out, "config.json"))
            save_params_to_safetensors(os.path.join(out, "model.safetensors"), params)

        on_rank_zero(write)
        logger.info("model saved at %s", out)


def _mesh_from_args(args):
    """The mesh ``args.mesh_data`` / ``args.mesh_seq`` / ``args.mesh_model``
    ask for over the running process group; None for a single process (no
    group, no mesh asked for)."""
    import torch.distributed as dist

    from csm_tpu_torch.parallel import make_mesh

    data = getattr(args, "mesh_data", None)
    seq = int(getattr(args, "mesh_seq", 1) or 1)
    model = int(getattr(args, "mesh_model", 1) or 1)
    if not dist.is_initialized() and data in (None, 1) and seq == 1 and model == 1:
        return None
    return make_mesh(data=data, model=model, seq=seq)
