"""What decides ``correct``: the program's answers against the reference.

After the window, ``n_check`` of the pool latents that were answered are
drawn from the seed, one from each slot of the batch in turn
(``sample_latents``); each one's last answer in the window is judged:

- ``score_wrong``: the share of its scored entries (serving: the kept
  m_pad with their exact scores; dense: its top 24, its mate and a seeded
  sample of the gallery, to ``check_entries`` in all) whose score lies off
  the reference's by more than SCORE_TOL * max(1, |reference|);
- ``rank_wrong``: the share of its top-24 positions (fewer where fewer
  entries are judged) that are wrong by the reference: the entry's
  reference score lies below the reference's 24th best over the judged
  entries, or below that of the entry listed after it, by more than the
  same tolerance (the stable top-k and the order);
- ``kept_wrong`` (serving): the share of its kept entries whose reference
  screen lies below the reference's m_pad-th best screen (the screen's
  selection, the stable top-k and the gather).

A sampled latent with no answer counts as wrong in every share. SCORE_TOL
is far above what a different order of f32 sums moves a score (~1e-6
relative) and far below one correspondence gained or lost (~0.1 to 1).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import reference as R
from .gen import Draws, batch_order, derive

SCORE_TOL = 1e-4


def tol(ref: np.ndarray) -> np.ndarray:
    return SCORE_TOL * np.maximum(1.0, np.abs(ref))


def sample_latents(answered: List[int], n_check: int, seed: int, pool: int,
                   batch: int) -> List[int]:
    """``n_check`` of the answered pool latents, drawn from the seed slot
    by slot: each latent's slot is its place in the window's order
    (``gen.batch_order``) modulo the batch; the slots are visited in a
    seeded order, one latent drawn from each before a second from any, so
    that with ``n_check`` at least the batch a fault confined to one slot
    of every batch is always judged."""
    slot = {int(e): p % batch for p, e in enumerate(batch_order(pool, seed))}
    rng = np.random.default_rng(derive(seed, "check"))
    groups = [[i for i in sorted(answered) if slot[i] == s]
              for s in range(batch)]
    groups = [list(rng.permutation(groups[s])) for s in
              rng.permutation(batch) if groups[s]]
    k = min(n_check, len(answered))
    out: List[int] = []
    while len(out) < k:
        for g in groups:
            if g and len(out) < k:
                out.append(int(g.pop()))
    return sorted(out)


def _rank_wrong(top_idx: np.ndarray, ref_by_entry: Dict[int, float],
                ref_sorted: np.ndarray, n: int) -> int:
    """Positions of the first n that are wrong by the reference: the entry
    belongs below the reference's n-th best, or it lies below the entry
    listed after it (each by more than the tolerance); a missing position
    is wrong. One misplaced entry costs at most two positions, not every
    position after it."""
    got = np.array([ref_by_entry.get(int(e), np.nan) for e in top_idx[:n]])
    if len(got) == 0:
        return n
    cut = ref_sorted[min(n, len(ref_sorted)) - 1]
    bad = ~(got >= cut - tol(cut))
    bad[:-1] |= ~(got[:-1] >= got[1:] - tol(got[1:]))
    return int(bad.sum()) + n - len(got)


def judge(draws: Draws, mix: dict, prec: R.Precision, answers: dict,
          latents: List[int], seed: int, details: Optional[list] = None
          ) -> Dict[str, float]:
    """The numbers for the sampled pool ``latents``; ``answers`` maps a
    pool latent to its answer: serving {"kept": [m_pad], "exact":
    [m_pad], "top": [24]}, dense {"scores": [G_real], "top": [24]}.
    ``details``, where given, receives a line for each of the first
    scores off the reference."""
    cb = R.Codebook(draws.codebook, prec, draws.device)
    dense = mix["entry"] == "list_to_list"
    m_pad = R.kept_count(draws.Gp, int(mix.get("m", 0)), prec.block) \
        if not dense else int(mix["check_entries"])
    top = min(int(mix["top"]), m_pad)
    n = len(latents)
    wrong = dict(score=0, rank=0, kept=0)
    details = [] if details is None else details
    present = [i for i in latents if answers.get(i) is not None]
    wrong["score"] += m_pad * (n - len(present))
    wrong["rank"] += top * (n - len(present))
    wrong["kept"] += m_pad * (n - len(present))
    if present:
        sets = [check_set(draws, answers[i], i, m_pad, seed, dense)
                for i in present]
        idx = torch.as_tensor(np.stack(sets), device=draws.device)
        ref = R.exact_for(draws, present, idx, prec, cb).cpu().numpy()
        for j, i in enumerate(present):
            a = answers[i]
            got = a["exact"] if not dense else a["scores"][sets[j]]
            off = ~(np.abs(got - ref[j]) <= tol(ref[j]))
            wrong["score"] += int(off.sum())
            for e in np.nonzero(off)[0][:3]:
                details.append(f"latent {i} entry {int(sets[j][e])}: "
                               f"program {float(got[e])!r} reference "
                               f"{float(ref[j][e])!r}")
            by_entry = dict(zip(sets[j].tolist(), ref[j].tolist()))
            wrong["rank"] += _rank_wrong(a["top"], by_entry,
                                         np.sort(ref[j])[::-1], top)
        if not dense:
            pre = mix.get("prescreen") or {}
            ops_s = [R.latent_operands(
                draws.latents, i, prec, cb, screen=True,
                lt_cap=int(pre.get("lt", 0)), t_cap=int(pre.get("t", 0)))
                for i in present]
            scr = R.screen_gallery(draws, ops_s, prec, cb).cpu().numpy()
            for j, i in enumerate(present):
                cut = np.sort(scr[j])[::-1][m_pad - 1]
                wrong["kept"] += int((scr[j][answers[i]["kept"]]
                                      < cut).sum())
    out = {"score_wrong": wrong["score"] / (n * m_pad),
           "rank_wrong": wrong["rank"] / (n * top)}
    if not dense:
        out["kept_wrong"] = wrong["kept"] / (n * m_pad)
    return out


def check_set(draws: Draws, answer: dict, i: int, k: int, seed: int,
              dense: bool) -> np.ndarray:
    """The entries latent ``i``'s scores are judged on: serving, its kept
    set; dense, its top 24, its mate and a seeded sample, k in all."""
    if not dense:
        return np.asarray(answer["kept"], np.int64)
    head = list(dict.fromkeys([int(e) for e in answer["top"]]
                              + [int(draws.mate_pos[i])]))
    rng = np.random.default_rng(derive(seed, "check_set", i))
    rest = rng.choice(draws.G, size=min(draws.G, k + 25), replace=False)
    rest = [int(e) for e in rest if int(e) not in set(head)]
    return np.asarray((head + rest)[:k], np.int64)


def control_answers(draws: Draws, mix: dict, prec_low: R.Precision,
                    latents: List[int], seed: int) -> Dict[int, dict]:
    """The control's answers: the reference put in the program's place,
    its operands one step below the configuration's. Serving: the whole
    pipeline; dense: the scores of the judged entries (the mate and the
    seeded sample), its top 24 among them."""
    cb = R.Codebook(draws.codebook, prec_low, draws.device)
    if mix["entry"] != "list_to_list":
        idx, exact = R.serve(draws, latents, mix, prec_low, cb)
        idx, exact = idx.cpu().numpy(), exact.cpu().numpy()
        out = {}
        for j, i in enumerate(latents):
            order = np.argsort(-exact[j], kind="stable")[:24]
            out[i] = dict(kept=idx[j], exact=exact[j], top=idx[j][order])
        return out
    k = int(mix["check_entries"])
    sets = [check_set(draws, dict(top=[]), i, k, seed, True) for i in latents]
    idx = torch.as_tensor(np.stack(sets), device=draws.device)
    s = R.exact_for(draws, latents, idx, prec_low, cb).cpu().numpy()
    out = {}
    for j, i in enumerate(latents):
        scores = np.full((draws.G,), -1.0)
        scores[sets[j]] = s[j]
        top = sets[j][np.argsort(-s[j], kind="stable")[:24]]
        out[i] = dict(scores=scores, top=top)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> bool:
    """correct: every answer came and every number is within its limit."""
    return failed == 0 and all(numbers[k] <= limits[k] for k in numbers)
