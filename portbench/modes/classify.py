"""Mode ``classify``: ``DiffusionClassifier.classify`` on host batches, one caller, closed loop.

A call hands the engine the next batch of the pool (host float32 images)
and the benchmark's seeded draws, and ends when the predictions are on the
host. Set-up builds the engine on the card with the seed's weights and
runs ``warmup_calls`` whole calls at the cell's shapes.

What decides ``correct``: a sample of the window's calls, drawn from the
seed (``check_calls`` of the first ``check_within``), runs with a hook on
the EMA denoiser that keeps what each forward produced. After the window
the plain reference computes, in fp32, the Haar transform, the schedule,
the noising, the denoiser's prediction for every (evaluation, image,
class) of those calls from the same draws, the ε-error sums and the
tournament. The program's rows are matched to (evaluation, image) by what
they hold: a full or encode forward by its noised input, a tail by the
encode output it continues, the class by its label; so the comparison does
not depend on how the program groups its rows. The numbers:

- ``denoiser_rel_l2``: the program's predictions against the reference's,
  ‖Δ‖ / ‖reference‖ over every row of the checked calls;
- ``score_gap``: per checked image, the class scores behind the program's
  answer (each class's mean ε-error from the program's own outputs) against
  the reference's, ``|own − ref| / ref``; the widest. It catches a
  precision below bf16;
- ``pick_excess``: per checked image, the answered class's own score over
  the program's own lowest, ``(own[answer] − min own) / min own``; the
  widest. The program answers by its own scores, so it reads rounding
  alone, however close two classes lie, and an answer altered after the
  scores reads that image's margin;
- ``pred_regret``: the widest relative gap by which the reference's mean
  ε-error of the class the program predicted lies above the reference's
  best class (0 where they agree);
- ``rows_missing``: (evaluation, image, class) rows of the first stage the
  program never produced, and rows that match no input (exact: 0).

A cell compares the numbers its workload file gives a limit; the others
are printed beside them. (With two classes the control seldom answers
otherwise than the reference, so ``pred_regret`` has no reading from it
there, and the DiT cells do not compare it; ``pick_excess`` carries the
answer there.) The sampled calls' kept outputs stay on the card until the
check; what they hold is counted in ``held_bytes`` and left out of the
memory peak.

``check(control=True)`` puts the reference computed with fp8 products in
the program's place and reads the same numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..inputs import ClassifyDraws, key, make_pool
from ..reference import diffusion as rd
from ..reference.precision import Precision, exact_fp32
from .. import modes
from . import build_engine, count_forwards, reference, weights

FINGERPRINT = 16


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """``FINGERPRINT`` values of each row, spread over it: enough to tell the rows of a call apart."""
    flat = t.reshape(t.shape[0], -1)
    idx = torch.linspace(0, flat.shape[1] - 1, FINGERPRINT, device=t.device).long()
    return flat[:, idx].float()


def _capture(module, sink: list):
    """A hook keeping, per forward: mode, its rows' key, labels, output.

    The key is a fingerprint of the noised input (full and encode forwards)
    or of the prefix's ``h`` (a tail); an encode keeps its ``h``'s
    fingerprint as its output. Only the predictions are kept whole.
    """

    def hook(mod, args, kwargs, output):
        mode = kwargs.get("mode", "full")
        if mode == "tail":
            sink.append((mode, _fingerprint(kwargs["prefix_state"][0]), args[2], output))
        elif mode == "encode":
            sink.append((mode, _fingerprint(args[0]), None, _fingerprint(output[0])))
        else:
            sink.append((mode, _fingerprint(args[0]), args[2], output))

    return module.register_forward_hook(hook, with_kwargs=True)


class Runner(modes.Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.checked = {}

    # ----------------------------------------------------------------- run
    def setup(self):
        cell, x = self.cell, self.x
        self.engine = build_engine(self.config, self.seed, self.device, weights(self.config, self.seed, self.device))
        self.pool = make_pool(self.seed, cell["pool_batches"], cell["batch"], x["image_size"],
                              x["image_channels"], x["classes"])
        rng = np.random.Generator(np.random.PCG64(key(self.seed, "check")))
        self.sampled = set(rng.choice(cell["check_within"], cell["check_calls"], replace=False).tolist())
        log = []
        for w in range(cell["warmup_calls"]):
            self._classify(-1 - w, log if w == 0 else None)
        if self.device.type == "cuda":
            self._reserve_for_checks()
        free = torch.cuda.mem_get_info(self.device)[0] if self.device.type == "cuda" else None
        self.facts = {"group_size_G": log[0][2][0], "groups_per_call": len(log),
                      "free_bytes_before_call": free}

    def _reserve_for_checks(self):
        """Grow the caching allocator by what the sampled calls will hold, before the window.

        A sampled call keeps its predictions until the check; without room
        cached ahead, each would make the allocator ask the driver for more
        memory inside the window and run slower than the calls around it.
        """
        captured = []
        handle = _capture(self.engine.state.ema_model, captured)
        try:
            self._classify(-1 - self.cell["warmup_calls"])
        finally:
            handle.remove()
        held = sum(t.nbytes for entry in captured for t in entry[1:] if isinstance(t, torch.Tensor))
        room = torch.empty(int(1.1 * held * len(self.sampled)) + 1, dtype=torch.uint8, device=self.device)
        del room, captured

    def _classify(self, i, log=None):
        batch = self.pool[i % len(self.pool)]
        draws = ClassifyDraws(self.seed, i, self.device, log)
        return self.engine.classify(batch["images"], draws=draws).cpu()

    def call(self, i):
        if i not in self.sampled:
            self._classify(i)
            return self.cell["batch"]
        log, captured = [], []
        cuda = self.device.type == "cuda"
        before = torch.cuda.memory_allocated(self.device) if cuda else 0
        handle = _capture(self.engine.state.ema_model, captured)
        try:
            preds = self._classify(i, log)
        finally:
            handle.remove()
        self.checked[i] = (log, captured, preds)
        if cuda:
            self.held_bytes += torch.cuda.memory_allocated(self.device) - before
        return self.cell["batch"]

    def needed(self):
        return sorted(self.sampled)

    def counting(self, counts: dict):
        return count_forwards(self.engine.state.ema_model, counts)

    def work(self, counts: dict) -> dict:
        """Model operations an image, and the attention's operations and bytes an image."""
        evals = self.x["evaluation_per_stage"][-1]
        k = self.x["classes"]
        if "encode" in counts:
            flops = evals * (counts["encode"] + k * counts["tail"])
        else:
            flops = evals * k * counts["full"]
        rows = evals * k
        return {"flops": flops, "attention_flops": rows * counts.get("attention_flops", 0),
                "attention_bytes": rows * counts.get("attention_bytes", 0)}

    # --------------------------------------------------------------- check
    def _reference_preds(self, W, z, lam, prec):
        """``[N, C, ...]``: the reference's prediction for every row of ``z`` under every class."""
        ref, m = reference(self.config), self.config["model"]
        k, n = self.x["classes"], z.shape[0]
        block = self.cell["reference_rows"]
        out = torch.empty((n, k) + tuple(z.shape[1:]), device=z.device)
        for s in range(0, n, block):
            zb, lb = z[s:s + block], lam[s:s + block]
            state = ref.prefix(W, m, zb, lb, prec) if hasattr(ref, "prefix") else None
            for c in range(k):
                labels = torch.full((zb.shape[0],), c, device=z.device, dtype=torch.long)
                if state is None:
                    out[s:s + block, c] = ref.forward(W, m, zb, lb, labels, prec)
                else:
                    out[s:s + block, c] = ref.tail(W, m, state, ref.context(W, m, labels, prec), prec)
        return out

    def _inputs(self, i, log):
        """The reference's own x, t, ε, λ and z for call ``i``: ``[E·B, ...]`` rows, e major."""
        x = self.x
        images = torch.as_tensor(self.pool[i % len(self.pool)]["images"], device=self.device)
        xin = rd.haar(images) if x.get("wavelet_transform") else images
        evals = list(x["evaluation_per_stage"])
        starts = [0] + evals[:-1]
        b = xin.shape[0]
        T = torch.empty((evals[-1], b), device=self.device)
        EPS = torch.empty((evals[-1],) + tuple(xin.shape), device=self.device)
        draws = ClassifyDraws(self.seed, i, self.device)
        for stage, group, t_shape, eps_shape in log:
            t, eps = draws.draw(stage, group, t_shape, eps_shape)
            e0 = starts[stage] + group * t_shape[0]
            T[e0:e0 + t_shape[0]], EPS[e0:e0 + t_shape[0]] = t, eps
        lam = rd.logsnr(T, x["schedule"], x["noise_d"], x["image_size"])
        a, s = rd.alpha_sigma(lam)
        col = tuple(T.shape) + (1,) * (xin.ndim - 1)
        Z = a.reshape(col) * xin[None] + s.reshape(col) * EPS
        flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))  # noqa: E731
        return flat(Z), lam.reshape(-1), flat(EPS), b

    def _errors(self, preds, z, lam, eps):
        k = preds.shape[1]
        errs = torch.empty((preds.shape[0], k), device=preds.device)
        for c in range(k):
            ep = rd.eps_from_pred(preds[:, c], z, lam, self.x["pred_param"])
            errs[:, c] = ((ep - eps) ** 2).flatten(1).sum(1)
        return errs

    def _program_rows(self, captured, z):
        """``(rows, unmatched)``: the program's outputs as (row index, class, prediction) triples."""
        zkeys = _fingerprint(z)
        scale = zkeys.abs().max().clamp(min=1e-12)
        encoded, rows, unmatched = {}, [], 0
        for mode, key_in, labels, out in captured:
            if mode in ("full", "encode"):
                dist, n = torch.cdist(key_in, zkeys,
                                     compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
                n = torch.where(dist <= 1e-3 * scale, n, torch.full_like(n, -1))
                if mode == "encode":
                    hk = out.cpu().numpy()
                    for r in range(hk.shape[0]):
                        encoded[hk[r].tobytes()] = int(n[r])
                    continue
            else:
                hk = key_in.cpu().numpy()
                n = torch.tensor([encoded.get(hk[r].tobytes(), -1) for r in range(hk.shape[0])], device=z.device)
            labels = labels.to(z.device).long()
            bad = (n < 0) | (labels < 0) | (labels >= self.x["classes"])
            unmatched += int(bad.sum())
            keep = ~bad
            rows.append((n[keep], labels[keep], out[keep].float()))
        return rows, unmatched

    @torch.no_grad()
    def check(self, control: bool = False) -> dict:
        x, k = self.x, self.x["classes"]
        if not self.checked:
            return dict.fromkeys(("denoiser_rel_l2", "score_gap", "pick_excess", "pred_regret", "rows_missing"),
                                 math.inf)
        W = weights(self.config, self.seed, self.device)
        first = x["evaluation_per_stage"][0]
        sq_err = sq_ref = 0.0
        regret, missing, margin, score_gap, pick_excess = 0.0, 0, math.inf, 0.0, 0.0
        with exact_fp32():
            for i, (log, captured, preds) in sorted(self.checked.items()):
                z, lam, eps, b = self._inputs(i, log)
                ref = self._reference_preds(W, z, lam, Precision())
                err = self._errors(ref, z, lam, eps).reshape(-1, b, k)
                if control:
                    low = self._reference_preds(W, z, lam, Precision("fp8"))
                    n = torch.arange(z.shape[0], device=z.device).repeat_interleave(k)
                    c = torch.arange(k, device=z.device).repeat(z.shape[0])
                    rows, unmatched = [(n, c, low.reshape((-1,) + tuple(z.shape[1:])))], 0
                    low_err = self._errors(low, z, lam, eps)
                    preds = rd.tournament(low_err.reshape(-1, b, k), x["evaluation_per_stage"],
                                          x["n_keep_per_stage"]).cpu()
                    del low
                else:
                    rows, unmatched = self._program_rows(captured, z)
                seen = torch.zeros((z.shape[0], k), dtype=torch.bool, device=z.device)
                own = torch.full((z.shape[0], k), math.nan, device=z.device)
                for n, c, out in rows:
                    r = ref[n, c]
                    sq_err += float(((out - r) ** 2).sum())
                    sq_ref += float((r ** 2).sum())
                    seen[n, c] = True
                    ep = rd.eps_from_pred(out, z[n], lam[n], x["pred_param"])
                    own[n, c] = ((ep - eps[n]) ** 2).flatten(1).sum(1)
                if control:  # the control's scores are the reference's at fp8
                    own = low_err
                missing += unmatched + int((~seen[: first * b]).sum())
                mean = err.mean(dim=0)  # [B, C] over every evaluation
                p = preds.to(z.device).long()
                if p.shape[0] != b or bool(((p < 0) | (p >= k)).any()):
                    regret = score_gap = pick_excess = math.inf
                else:
                    best = rd.tournament(err, x["evaluation_per_stage"], x["n_keep_per_stage"])
                    best_mean = mean.gather(1, best[:, None])[:, 0]
                    picked = mean.gather(1, p[:, None])[:, 0]
                    regret = max(regret, float(((picked - best_mean) / best_mean).max()))
                    # the program's class scores from its own outputs, where every evaluation of a class ran
                    own = own.reshape(-1, b, k)
                    whole = ~own.isnan().any(dim=0)
                    own_mean = torch.where(whole, own.mean(dim=0), math.inf)
                    lowest = own_mean.min(dim=1).values
                    excess = ((own_mean.gather(1, p[:, None])[:, 0] - lowest) / lowest).nan_to_num(math.inf)
                    gap = torch.where(whole, (own_mean - mean).abs() / mean, 0.0).max(dim=1).values
                    score_gap = max(score_gap, float(gap.max()))
                    pick_excess = max(pick_excess, float(excess.max()))
                ranked = mean.sort(dim=1).values
                if k > 1:
                    margin = min(margin, float(((ranked[:, 1] - ranked[:, 0]) / ranked[:, 0]).min()))
                del ref, err
        self.facts_after = {"checked_calls": len(self.checked), "reference_min_margin": margin}
        rel = math.sqrt(sq_err / sq_ref) if sq_ref > 0 else math.inf
        return {"denoiser_rel_l2": rel, "score_gap": score_gap, "pick_excess": pick_excess, "pred_regret": regret,
                "rows_missing": missing}
