"""Mode ``train``: ``DiffusionClassifier.train_step`` on host batches, one caller, closed loop.

Set-up builds the engine with the seed's weights, builds its train state
(``total_steps`` for the learning-rate schedule) and drives that same state
through its first three steps with the window's own call, on the first
three batches of the pool (rows that all differ) and the benchmark's seeded
draws; those steps also warm every shape up. The window goes on from step
4 and synchronises only at its end.

What decides ``correct``: the reference follows the program in fp32 from
the same weights, batches and draws (CFG label dropout, noising, the
denoiser, the min-SNR loss, backward, the clip, Adam and the EMA) through
the first three steps and on through three steps inside the window, from
step ``check_at`` (0-based; the cell file's, after any eager warm-up a
captured or compiled step would take, and across an EMA update). Compared,
by the worst leaf where a number is a leaf's norm:

- ``loss_gap``: the largest ``|loss − reference| / reference`` of the six
  checked steps;
- ``grad_gap``: the first step's gradient as the optimizer took it
  (Adam's first moment after one step, ÷ (1 − β₁));
- ``update_gap``: the parameters' change over the first three steps and
  over the three checked steps of the window;
- ``ema_gap``: the EMA after the window's checked steps, as its change
  from the parameters before them.

A leaf's gap is ``|‖program‖ − ‖reference‖|`` over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
(their change is Adam's round-off). The first steps' readings are taken in
set-up; the window's checked steps copy the parameters and the EMA into
host buffers (pinned, asynchronous: nothing is held on the card and the
host does not wait), and keep their losses on the card, read after the
window.
"""

from __future__ import annotations

import math

import torch

from ..inputs import TrainDraws, make_pool
from ..reference import diffusion as rd
from ..reference.precision import Precision, exact_fp32
from .. import modes
from . import build_engine, count_forwards, reference, weights

FIRST_STEPS = 3
WINDOW_STEPS = 3
B1 = 0.9
SNAPSHOTS = ("params_before", "params_after", "ema_after")


def leaf_gaps(program: dict, ref: dict, keep) -> float:
    """The worst leaf's ``|‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖)`` over the names in ``keep``."""
    names = [n for n in ref if n in keep]
    if not names:
        return math.inf
    median = sorted(ref[n] for n in names)[len(names) // 2]
    return max(abs(program.get(n, 0.0) - ref[n]) / max(ref[n], median) for n in names)


def _norms(names, tensors) -> dict:
    return {n: float(v) for n, v in zip(names, torch._foreach_norm(list(tensors)))}


class Runner(modes.Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.step = 0
        self.check_at = self.cell["check_at"]
        if self.check_at < FIRST_STEPS:
            raise ValueError(f"check_at {self.check_at} falls inside set-up's {FIRST_STEPS} steps")

    def setup(self):
        cell, x = self.cell, self.x
        w0 = weights(self.config, self.seed, self.device)
        self.engine = build_engine(self.config, self.seed, self.device, w0)
        self.engine._build_train_state(cell["total_steps"])
        self.pool = make_pool(self.seed, cell["pool_batches"], cell["batch"], x["image_size"],
                              x["image_channels"], x["classes"])
        state = self.engine.state
        self.names = [n for n, _ in state.model.named_parameters()]
        self.sizes = [p.numel() for p in state.params()]
        pin = self.device.type == "cuda"
        self.snaps = {k: torch.empty(sum(self.sizes), dtype=torch.float32, pin_memory=pin) for k in SNAPSHOTS}
        self.window_losses = []
        self.losses, self.grad_norms = [], {}
        for s in range(FIRST_STEPS):
            self.losses.append(float(self._step()))
            if s == 0:
                self.grad_norms = _norms(self.names, [m.float() / (1 - B1) for m in state.opt_state.mu])
        self.update_norms = _norms(self.names, [p.detach() - w0[n] for n, p in zip(self.names, state.params())])
        del w0
        free = torch.cuda.mem_get_info(self.device)[0] if self.device.type == "cuda" else None
        self.facts = {"first_losses": self.losses, "checked_window_steps": [self.check_at + k for k in range(WINDOW_STEPS)],
                      "free_bytes_before_call": free}

    def _snap(self, name, tensors):
        """Copy ``tensors`` into host buffer ``name``, in order, without waiting for the device."""
        views = self.snaps[name].split(self.sizes)
        for v, t in zip(views, tensors):
            v.view(t.shape).copy_(t.detach(), non_blocking=True)

    def _step(self):
        s, state = self.step, self.engine.state
        if s == self.check_at:
            self._snap("params_before", state.params())
        batch = self.pool[s % len(self.pool)]
        loss = self.engine.train_step(batch, draws=TrainDraws(self.seed, s, self.device))
        if self.check_at <= s < self.check_at + WINDOW_STEPS:
            self.window_losses.append(loss)
        if s == self.check_at + WINDOW_STEPS - 1:
            self._snap("params_after", state.params())
            self._snap("ema_after", state.ema_params())
        self.step += 1
        return loss

    def call(self, i):
        self._step()
        return self.cell["batch"]

    def needed(self):
        """The window's calls up to the last checked step."""
        return list(range(self.check_at + WINDOW_STEPS - FIRST_STEPS))

    def counting(self, counts: dict):
        return count_forwards(self.engine.state.model, counts)

    def work(self, counts: dict) -> dict:
        """Model operations an image: the forward, and the backward at twice the forward."""
        return {"flops": 3 * counts["full"]}

    # --------------------------------------------------------------- check
    def _program_window(self) -> dict:
        """The program's window readings, per leaf name, from the host buffers."""
        snap = {k: v.to(self.device) for k, v in self.snaps.items()}
        split = lambda t: t.split(self.sizes)  # noqa: E731
        out = {
            "update": _norms(self.names, split(snap["params_after"] - snap["params_before"])),
            "ema": _norms(self.names, split(snap["ema_after"] - snap["params_before"])),
        }
        del snap
        return out

    def _reference_steps(self, prec: Precision) -> dict:
        """The reference through the last checked step: losses, and norms per leaf name as the program's."""
        x, m, cell = self.x, self.config["model"], self.cell
        ref = reference(self.config)
        w0 = weights(self.config, self.seed, self.device)
        names = sorted(w0)
        params = [w0[n].clone().requires_grad_(True) for n in names]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        ema = [w0[n].clone() for n in names]
        ema_kw = {k: x[f] for k, f in (("beta", "ema_beta"), ("update_after_step", "ema_warmup"),
                                       ("update_every", "ema_update_freq")) if f in x}
        out = {"losses": []}
        detached = lambda: [p.detach() for p in params]  # noqa: E731
        for s in range(self.check_at + WINDOW_STEPS):
            if s == self.check_at:
                before = [p.detach().clone() for p in params]
            batch = self.pool[s % len(self.pool)]
            images = torch.as_tensor(batch["images"], device=self.device)
            xin = rd.haar(images) if x.get("wavelet_transform") else images
            labels = torch.as_tensor(batch["prompt"], device=self.device)
            u, t, eps = TrainDraws(self.seed, s, self.device).loss(0, 1, xin.shape[0], tuple(xin.shape))
            labels = torch.where(u < rd.CFG_DROP_P, torch.full_like(labels, x["classes"]), labels)
            lam = rd.logsnr(t, x["schedule"], x["noise_d"], x["image_size"])
            a, sg = rd.alpha_sigma(lam)
            col = (-1,) + (1,) * (xin.ndim - 1)
            z = a.reshape(col) * xin + sg.reshape(col) * eps
            pred = ref.forward(dict(zip(names, params)), m, z, lam, labels, prec)
            loss = rd.weighted_loss(pred, z, eps, lam, x["pred_param"])
            grads = torch.autograd.grad(loss, params)
            lr = rd.lr_at(s, x["learning_rate"], x["lr_warmup_steps"], cell["total_steps"])
            clipped = rd.adam_step(params, list(grads), mu, nu, s, lr)
            rd.ema_update(ema, detached(), s, **ema_kw)
            out["losses"].append(float(loss.detach()))
            if s == 0:
                out["grad0"] = _norms(names, clipped)
            if s == FIRST_STEPS - 1:
                out["update_first"] = _norms(names, [p.detach() - w0[n] for n, p in zip(names, params)])
            del pred, loss, grads, clipped
        out["update_window"] = _norms(names, [p.detach() - b for p, b in zip(params, before)])
        out["ema"] = _norms(names, [e - b for e, b in zip(ema, before)])
        return out

    def check(self, control: bool = False) -> dict:
        k = self.check_at
        with exact_fp32():
            ref = self._reference_steps(Precision())
            if control:
                low = self._reference_steps(Precision("fp8"))
                p_losses = low["losses"][:FIRST_STEPS] + low["losses"][k:]
                p = {"grad0": low["grad0"], "update_first": low["update_first"],
                     "update_window": low["update_window"], "ema": low["ema"]}
            else:
                window = self._program_window() if len(self.window_losses) == WINDOW_STEPS else {}
                p_losses = self.losses + [float(v) for v in self.window_losses]
                p = {"grad0": self.grad_norms, "update_first": self.update_norms,
                     "update_window": window.get("update", {}), "ema": window.get("ema", {})}
        r_losses = ref["losses"][:FIRST_STEPS] + ref["losses"][k:]
        median = sorted(ref["grad0"].values())[len(ref["grad0"]) // 2]
        keep = {n for n, v in ref["grad0"].items() if v >= 1e-3 * median}
        self.facts_after = {"reference_losses": r_losses, "leaves_compared": len(keep), "leaves": len(ref["grad0"])}
        if len(p_losses) != len(r_losses) or not all(math.isfinite(v) for v in p_losses):
            loss_gap = math.inf
        else:
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_losses, r_losses))
        return {
            "loss_gap": loss_gap,
            "grad_gap": leaf_gaps(p["grad0"], ref["grad0"], keep),
            "update_gap": max(leaf_gaps(p["update_first"], ref["update_first"], keep),
                              leaf_gaps(p["update_window"], ref["update_window"], keep)),
            "ema_gap": leaf_gaps(p["ema"], ref["ema"], keep),
        }
