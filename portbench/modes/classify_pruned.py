"""Mode ``classify_pruned``: mode ``classify`` over a tournament that prunes most classes early.

A call runs as in mode ``classify``: the same set-up, window, draws and
capture of what the EMA denoiser produced. The check differs. Mode
``classify`` computes the reference for every (evaluation, image, class) of
a checked call, which under a pruning tournament is far more than the
program runs: 64 evaluations × 1,000 classes of DiT-XL/2 an image under
``evaluation_per_stage`` [2, 16, 64] with ``n_keep_per_stage`` [50, 5, 1],
where the tournament scores 2,940 rows. This check follows the program's
own tournament and computes the reference, in fp32, for the rows that
decide its answer:

- the program's rows are matched to (evaluation, image, class) as in mode
  ``classify``; their ε-errors are the program's own scores;
- ``rows_missing``: the tournament replayed on those scores, stage by
  stage, gives the rows the program had to score (the first stage: every
  class; each later stage: the ``n_keep`` classes its own means kept); the
  ones it never produced, and rows that match no input (exact: 0);
- ``pick_excess``: as in mode ``classify``, over the classes the program
  scored at every evaluation;
- the reference: every evaluation of the classes the program's tournament
  carried into its last stage (those whose scores decide the answer), and
  ``reference_sample`` more of the program's rows drawn from the seed among
  the rest, in blocks of ``reference_rows``;
- ``denoiser_rel_l2`` over those rows; ``score_gap`` over the last stage's
  classes (the program's mean ε-error over every evaluation against the
  reference's); ``pred_regret``: the reference's mean for the answer over
  its lowest among those classes.

``work()`` counts the rows the tournament scores: for each stage, its new
evaluations times the classes still in it.

``check(control=True)``: the reference with fp8 products takes the
program's place and runs its own tournament, every row of it in fp8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..inputs import key
from ..reference import diffusion as rd
from ..reference.precision import Precision, exact_fp32
from . import classify, reference, weights


class Runner(classify.Runner):
    def work(self, counts: dict) -> dict:
        """Model operations an image over the rows the tournament scores, and the attention's."""
        ev = (0,) + tuple(self.x["evaluation_per_stage"])
        alive, rows, flops = self.x["classes"], 0, 0
        for s, keep in enumerate(self.x["n_keep_per_stage"]):
            n = ev[s + 1] - ev[s]
            rows += n * alive
            flops += n * (counts["encode"] + alive * counts["tail"]) if "encode" in counts else n * alive * counts["full"]
            alive = keep
        return {"flops": flops, "attention_flops": rows * counts.get("attention_flops", 0),
                "attention_bytes": rows * counts.get("attention_bytes", 0)}

    # --------------------------------------------------------------- check
    def _rows_of(self, W, z, lam, n, c, prec):
        """The reference's predictions for rows ``(n[j], c[j])`` of ``z``, in blocks."""
        ref, m = reference(self.config), self.config["model"]
        block = self.cell["reference_rows"]
        out = torch.empty((n.shape[0],) + tuple(z.shape[1:]), device=z.device)
        for s in range(0, n.shape[0], block):
            nb, cb = n[s:s + block], c[s:s + block]
            out[s:s + block] = ref.forward(W, m, z[nb], lam[nb], cb, prec)
        return out

    def _scores(self, rows, z, lam, eps):
        """``[E·B, K]`` ε-errors of the rows (NaN where a row was not scored)."""
        own = torch.full((z.shape[0], self.x["classes"]), math.nan, device=z.device)
        for n, c, out in rows:
            ep = rd.eps_from_pred(out, z[n], lam[n], self.x["pred_param"])
            own[n, c] = ((ep - eps[n]) ** 2).flatten(1).sum(1)
        return own

    def _replay(self, own, b):
        """``(missing, last)``: rows the tournament on ``own`` needed and lacks, the ``[B, K]`` classes of its last stage."""
        x, k = self.x, self.x["classes"]
        ev = (0,) + tuple(x["evaluation_per_stage"])
        table = own.reshape(-1, b, k)
        alive = torch.ones((b, k), dtype=torch.bool, device=own.device)
        missing, last = 0, alive
        for s, keep in enumerate(x["n_keep_per_stage"]):
            last = alive
            missing += int((alive[None] & table[ev[s]:ev[s + 1]].isnan()).sum())
            seen = table[: ev[s + 1]]
            mean = torch.where(alive & ~seen.isnan().any(dim=0), seen.mean(dim=0), math.inf)
            kept = torch.sort(mean, dim=1, stable=True).indices[:, :keep]
            alive = torch.zeros_like(alive).scatter_(1, kept, True)
        return missing, last

    def _control(self, W, z, lam, eps, b):
        """The fp8 reference's own tournament: its rows ``[(n, c, out)]`` and its answers ``[B]``."""
        x, k = self.x, self.x["classes"]
        ev = (0,) + tuple(x["evaluation_per_stage"])
        own = torch.full((z.shape[0], k), math.nan, device=z.device)
        alive = torch.ones((b, k), dtype=torch.bool, device=z.device)
        rows = []
        for s, keep in enumerate(x["n_keep_per_stage"]):
            e = torch.arange(ev[s], ev[s + 1], device=z.device)
            bi, c = alive.nonzero(as_tuple=True)
            n = (e[:, None] * b + bi[None]).reshape(-1)
            c = c[None].expand(e.shape[0], -1).reshape(-1)
            out = self._rows_of(W, z, lam, n, c, Precision("fp8"))
            rows.append((n, c, out))
            own[n, c] = self._scores([(n, c, out)], z, lam, eps)[n, c]
            seen = own.reshape(-1, b, k)[: ev[s + 1]]
            mean = torch.where(alive, seen.nan_to_num(0.0).sum(dim=0) / ev[s + 1], math.inf)
            kept = torch.sort(mean, dim=1, stable=True).indices[:, :keep]
            alive = torch.zeros_like(alive).scatter_(1, kept, True)
        return rows, alive.float().argmax(dim=1).cpu()

    @torch.no_grad()
    def check(self, control: bool = False) -> dict:
        x, k = self.x, self.x["classes"]
        names = ("denoiser_rel_l2", "score_gap", "pick_excess", "pred_regret", "rows_missing")
        if not self.checked:
            return dict.fromkeys(names, math.inf)
        W = weights(self.config, self.seed, self.device)
        sq_err = sq_ref = 0.0
        regret, missing, margin, score_gap, pick_excess, compared = 0.0, 0, math.inf, 0.0, 0.0, 0
        with exact_fp32():
            for i, (log, captured, preds) in sorted(self.checked.items()):
                z, lam, eps, b = self._inputs(i, log)
                if control:
                    rows, preds = self._control(W, z, lam, eps, b)
                    unmatched = 0
                else:
                    rows, unmatched = self._program_rows(captured, z)
                own = self._scores(rows, z, lam, eps)
                lacking, last = self._replay(own, b)
                missing += unmatched + lacking

                # the rows the reference computes: the last stage's classes at every evaluation, and a sample
                e = torch.arange(x["evaluation_per_stage"][-1], device=z.device)
                bi, cl = last.nonzero(as_tuple=True)
                want = torch.zeros((z.shape[0], k), dtype=torch.bool, device=z.device)
                want[(e[:, None] * b + bi[None]).reshape(-1), cl[None].expand(e.shape[0], -1).reshape(-1)] = True
                n_all = torch.cat([n for n, _, _ in rows])
                c_all = torch.cat([c for _, c, _ in rows])
                out_all = torch.cat([out for _, _, out in rows])
                rest = (~want[n_all, c_all]).nonzero(as_tuple=True)[0].cpu().numpy()
                rng = np.random.Generator(np.random.PCG64(key(self.seed, "check_sample", i)))
                sample = rng.choice(rest, min(len(rest), self.cell["reference_sample"]), replace=False)
                sample = torch.as_tensor(sample, dtype=torch.long, device=z.device)
                want[n_all[sample], c_all[sample]] = True
                n_ref, c_ref = want.nonzero(as_tuple=True)
                ref = self._rows_of(W, z, lam, n_ref, c_ref, Precision())
                compared += n_ref.shape[0]

                # the program's rows against the reference's, where both are
                slot = torch.full((z.shape[0], k), -1, dtype=torch.long, device=z.device)
                slot[n_ref, c_ref] = torch.arange(n_ref.shape[0], device=z.device)
                j = slot[n_all, c_all]
                hit = j >= 0
                r = ref[j[hit]]
                sq_err += float(((out_all[hit] - r) ** 2).sum())
                sq_ref += float((r ** 2).sum())
                ref_err = self._scores([(n_ref, c_ref, ref)], z, lam, eps).reshape(-1, b, k)
                del ref, out_all

                # class scores over every evaluation: the program's where it scored them all, the reference's
                # for the last stage's classes
                own = own.reshape(-1, b, k)
                whole = ~own.isnan().any(dim=0)
                own_mean = torch.where(whole, own.mean(dim=0), math.inf)
                ref_mean = torch.where(last, ref_err.mean(dim=0), math.inf)
                p = preds.to(z.device).long()
                if p.shape[0] != b or bool(((p < 0) | (p >= k)).any()):
                    regret = score_gap = pick_excess = math.inf
                    continue
                lowest = own_mean.min(dim=1).values
                excess = ((own_mean.gather(1, p[:, None])[:, 0] - lowest) / lowest).nan_to_num(math.inf)
                pick_excess = max(pick_excess, float(excess.max()))
                gap = torch.where(last & whole, (own_mean - ref_mean).abs() / ref_mean, 0.0)
                gap = torch.where(last & ~whole, math.inf, gap)
                score_gap = max(score_gap, float(gap.max()))
                best = ref_mean.min(dim=1).values
                regret = max(regret, float(((ref_mean.gather(1, p[:, None])[:, 0] - best) / best).max()))
                ranked = ref_mean.sort(dim=1).values
                if int(last.sum(dim=1).min()) > 1:
                    margin = min(margin, float(((ranked[:, 1] - ranked[:, 0]) / ranked[:, 0]).min()))
        self.facts_after = {"checked_calls": len(self.checked), "reference_rows_compared": compared,
                            "reference_min_margin": margin}
        rel = math.sqrt(sq_err / sq_ref) if sq_ref > 0 else math.inf
        return {"denoiser_rel_l2": rel, "score_gap": score_gap, "pick_excess": pick_excess,
                "pred_regret": regret, "rows_missing": missing}
