"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have.  The harness's look for a card is
skipped (the tiny cells run the port's plain versions on the CPU); the
rest of the run is the benchmark's own.  One chip, so no exchange between
chips can be left out."""

from __future__ import annotations

import pytest
import torch

import _tiny

TRAIN, SERVE = "rwkv6-tiny.train-tiny", "llama-tiny.serve-tiny"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_a_sound_run_is_correct(root, cell):
    line = _tiny.run(root, cell, seed=2 ** 31 + 11)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


def test_a_step_that_returns_its_state_unchanged(root, monkeypatch):
    from repro_torch.train import loop
    real = loop.make_train_step

    def unchanged(model, run, *, n_mb=None):
        step = real(model, run, n_mb=n_mb)

        def broken(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return broken

    monkeypatch.setattr(loop, "make_train_step", unchanged)
    line = _tiny.run(root, TRAIN)
    assert not line["correct"]


def test_a_window_that_stops_updating_the_state(root, monkeypatch):
    """Set-up's steps are sound; the window's call (train()'s second)
    returns each state unchanged."""
    from repro_torch.train import loop
    real = loop.make_train_step
    calls = []

    def late(model, run, *, n_mb=None):
        step = real(model, run, n_mb=n_mb)
        calls.append(1)
        if len(calls) == 1:
            return step

        def broken(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return broken

    monkeypatch.setattr(loop, "make_train_step", late)
    line = _tiny.run(root, TRAIN)
    assert len(calls) == 2
    assert not line["correct"]
    assert line["checks"]["window_unmoved_leaves"]["value"] > 0


def _dk_of_later_chunks_lost(grads, chunk):
    dr, dk, dv, dlogw, du, ds = grads
    dk = dk.clone()
    dk[:, :, chunk:] = 0
    return dr, dk, dv, dlogw, du, ds


def _du_left_out(grads, chunk):
    dr, dk, dv, dlogw, du, ds = grads
    return dr, dk, dv, dlogw, torch.zeros_like(du), ds


def _dlogw_sign_flipped(grads, chunk):
    dr, dk, dv, dlogw, du, ds = grads
    return dr, dk, dv, -dlogw, du, ds


def _dr_halved_in_odd_heads(grads, chunk):
    dr, dk, dv, dlogw, du, ds = grads
    dr = dr.clone()
    dr[:, 1::2] *= 0.5
    return dr, dk, dv, dlogw, du, ds


@pytest.mark.parametrize("fault", [_dk_of_later_chunks_lost, _du_left_out,
                                   _dlogw_sign_flipped,
                                   _dr_halved_in_odd_heads],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_wrong_recurrence_backward(root, monkeypatch, fault):
    """The recurrence's backward (``rwkv6_chunked_bwd``, the kernel on the
    card) returns a wrong gradient for one of its inputs."""
    from repro_torch.kernels import ops
    real = ops.rwkv6_chunked_bwd

    def wrong(*args, chunk):
        return fault(real(*args, chunk=chunk), chunk)

    monkeypatch.setattr(ops, "rwkv6_chunked_bwd", wrong)
    line = _tiny.run(root, TRAIN)
    assert not line["correct"]


def test_half_of_the_batch_left_out(root, monkeypatch):
    from repro_torch.train import loop
    real = loop.accumulate_gradients

    def half(loss_fn, params, batch, n_mb, **kw):
        keep = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return real(loss_fn, params, keep, max(1, n_mb // 2), **kw)

    monkeypatch.setattr(loop, "accumulate_gradients", half)
    line = _tiny.run(root, TRAIN)
    assert not line["correct"]
    assert line["checks"]["grad_dir_gap.head"]["value"] > 1e-3


def test_a_token_altered_where_it_is_produced(root, monkeypatch):
    from repro_torch.models.model import Model
    real = Model.decode_step

    def altered(self, params, tokens, caches, pos):
        logits, caches = real(self, params, tokens, caches, pos)
        # every request's token at this position becomes its least likely
        logits = logits.clone()
        rows = torch.arange(logits.shape[0])
        logits[rows, torch.argmin(logits, dim=-1)] = logits.amax(-1) + 1.0
        return logits, caches

    monkeypatch.setattr(Model, "decode_step", altered)
    line = _tiny.run(root, SERVE)
    assert not line["correct"]
    assert line["checks"]["logit_gap"]["value"] > 0
