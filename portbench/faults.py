"""Faults planted in the program's timed path, for the check's own tests and for reading upper limits.

Each fault patches the port in place and returns a function that undoes
it. ``FAULTS[mode]`` names those a cell of that mode can have: a classify
cell an answer altered where it is produced, and half of the rows computed
with their results repeated over the other half; a train cell a step that
leaves the state unchanged (from the first step, or from the first step
the window times), half of the batch left out with the loss's mean
over the rest, a gradient altered where it is produced, and an EMA that is
never updated. (One card: no exchange between chips to leave out.)
"""

from __future__ import annotations

import torch

__all__ = ["FAULTS", "plant"]


def _patch(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    return lambda: setattr(owner, name, old)


def altered_answer():
    from diffusion_classifier_tpu_torch.engine.diffusion_classifier import DiffusionClassifier

    classify = DiffusionClassifier.classify

    def altered(self, x, labels=None, *, draws=None):
        preds = classify(self, x, labels, draws=draws).clone()
        preds[0] = (preds[0] + 1) % self.config.classes
        return preds

    return _patch(DiffusionClassifier, "classify", altered)


def half_the_rows():
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser

    forward = Denoiser.forward

    def half(self, z, lam, labels, **kw):
        out = forward(self, z, lam, labels, **kw)
        if isinstance(out, tuple) or out.shape[0] < 2:
            return out
        n = out.shape[0] // 2
        return torch.cat([out[:n], out[:n], out[2 * n:]])

    return _patch(Denoiser, "forward", half)


def state_unchanged():
    from diffusion_classifier_tpu_torch.engine import state

    return _patch(state.Optimizer, "update", lambda self, grads, st, params, **kw: None)


def state_unchanged_after_setup():
    """The state left unchanged from the fourth step on: a step whose first calls run sound, as an eager
    warm-up before a captured or compiled step would."""
    from diffusion_classifier_tpu_torch.engine import state

    update = state.Optimizer.update
    calls = [0]

    def later_unchanged(self, grads, st, params, **kw):
        calls[0] += 1
        return update(self, grads, st, params, **kw) if calls[0] <= 3 else None

    return _patch(state.Optimizer, "update", later_unchanged)


def half_the_batch():
    from diffusion_classifier_tpu_torch.engine import steps

    loss = steps.weighted_mse_loss

    def half(pred, z, eps, lam, param):
        n = pred.shape[0] // 2
        return loss(pred[:n], z[:n], eps[:n], lam[:n], param)

    return _patch(steps, "weighted_mse_loss", half)


def altered_gradient():
    from diffusion_classifier_tpu_torch.engine import state

    update = state.Optimizer.update

    def altered(self, grads, st, params, **kw):
        grads = list(grads)
        grads[0] = grads[0] * 2
        return update(self, grads, st, params, **kw)

    return _patch(state.Optimizer, "update", altered)


def ema_skipped():
    from diffusion_classifier_tpu_torch.engine import steps

    return _patch(steps, "ema_update", lambda *args, **kw: None)


FAULTS = {
    "classify": {"altered_answer": altered_answer, "half_the_rows": half_the_rows},
    "train": {"state_unchanged": state_unchanged, "state_unchanged_after_setup": state_unchanged_after_setup,
              "half_the_batch": half_the_batch,
              "altered_gradient": altered_gradient, "ema_skipped": ema_skipped},
}


def plant(mode: str, name: str):
    """Plant fault ``name`` of a ``mode`` cell; returns the function that removes it."""
    return FAULTS[mode][name]()
