"""Training step and loop (the reference's ``repro.train.loop``).

``make_train_step`` builds the ``(state, batch) → (state, metrics)``
function: microbatch gradient accumulation (tiny tasks at the kneepoint),
optional int8 gradient compression with error feedback, AdamW with the
configured moment precision, and the learning-rate schedule.  It runs
eagerly: no ``torch.compile`` and no CUDA graph.

``train`` runs the host loop: batches from the subsampling input pipeline,
job-level checkpoints, and a restart from the newest one
(``restore_latest``), the paper's recovery model.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config.base import RunConfig
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.spans import span
from repro_torch.train.microbatch import accumulate_gradients

logger = logging.getLogger(__name__)


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    error_feedback: Optional[Any]
    step: torch.Tensor


def init_state(model: Model, run: RunConfig,
               generator: Optional[torch.Generator] = None) -> TrainState:
    """Random parameters from ``generator`` (by default one on the model's
    device seeded with ``run.train.seed``), zero moments, zero error
    feedback where the run compresses its gradients, step 0."""
    if generator is None:
        generator = model.generator(run.train.seed)
    params = model.init(generator)
    opt = adamw.init(params, run.train)
    ef = (compression.init_error_feedback(params)
          if run.train.grad_compression == "int8" else None)
    return TrainState(params, opt, ef,
                      torch.zeros((), dtype=torch.int32, device=model.device))


def make_train_phases(model: Model, run: RunConfig, *,
                      n_mb: Optional[int] = None):
    """The two phases of a training step: ``gradients(state, batch) →
    (loss, metrics, grads, error_feedback)`` over ``n_mb`` microbatches
    (compressed where the run compresses), and ``apply(state, loss,
    metrics, grads, error_feedback) → (state, metrics)``, AdamW at the
    schedule's rate.  :func:`make_train_step` runs one after the other;
    the dry run sizes each phase's memory apart."""
    n_mb = run.microbatches() if n_mb is None else n_mb
    tcfg = run.train
    accum_dtype = (torch.bfloat16 if tcfg.grad_accum_dtype == "bfloat16"
                   else torch.float32)

    def gradients(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = accumulate_gradients(
            model.loss, state.params, batch, n_mb, accum_dtype=accum_dtype)
        ef = state.error_feedback
        if ef is not None:
            grads, ef = compression.compress_grads(grads, ef)
        return loss, metrics, grads, ef

    def apply(state: TrainState, loss, metrics, grads, ef):
        with span("train.optimizer"):
            lr = adamw.lr_schedule(tcfg, state.step)
            new_params, new_opt, opt_metrics = adamw.update(
                grads, state.opt, state.params, lr, tcfg)
        metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
        return TrainState(new_params, new_opt, ef, state.step + 1), metrics

    return gradients, apply


def make_train_step(model: Model, run: RunConfig, *,
                    n_mb: Optional[int] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  tuple]:
    gradients, apply = make_train_phases(model, run, n_mb=n_mb)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return apply(state, *gradients(state, batch))

    return train_step


@dataclasses.dataclass
class TrainReport:
    steps: int
    final_loss: float
    losses: list
    seconds: float
    restarts: int = 0


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train(
    model: Model,
    run: RunConfig,
    batches: Iterator[Dict[str, Any]],
    num_steps: int,
    *,
    checkpoint_manager=None,
    checkpoint_every: int = 50,
    state: Optional[TrainState] = None,
    log_every: int = 10,
) -> TrainReport:
    """Steps ``state`` (or a fresh :func:`init_state`, resumed from the
    manager's newest checkpoint where there is one) up to step
    ``num_steps``, a batch from ``batches`` a step; saves every
    ``checkpoint_every`` steps and at the end."""
    if state is None:
        state = init_state(model, run)
        if checkpoint_manager is not None:
            restored = checkpoint_manager.restore_latest(example=state)
            if restored is not None:
                state = restored
                logger.info("resumed from step %d", int(state.step))

    step_fn = make_train_step(model, run)
    losses = []
    t0 = time.perf_counter()
    start = int(state.step)
    for i in range(start, num_steps):
        host_batch = next(batches)
        with span("train.step"):
            with span("train.to_device"):
                batch = to_device(host_batch, model.device)
            state, metrics = step_fn(state, batch)
            with span("train.loss_read"):
                loss = float(metrics["loss"])
        losses.append(loss)
        if i % log_every == 0:
            logger.info("step %d loss %.4f lr %.2e", i, loss,
                        float(metrics["lr"]))
        if checkpoint_manager is not None and (i + 1) % checkpoint_every == 0:
            checkpoint_manager.save(int(state.step), state)
    if checkpoint_manager is not None:
        checkpoint_manager.save(int(state.step), state)
        checkpoint_manager.wait()
    return TrainReport(steps=num_steps, final_loss=losses[-1] if losses
                       else float("nan"), losses=losses,
                       seconds=time.perf_counter() - t0)
