"""The correctness check: the reference run on the program's inputs, and
the numbers compared with their limits (``limits/<workload>.json``).

Training (``check_steps`` steps from the same weights and batches):

* ``loss``: the largest gap of a step's loss, over the reference's loss;
* ``grad``: the worst leaf's gap between the program's and the reference's
  norms of the first gradient as the optimizer gets it (clipped), over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``change``: the same of the norms of each leaf's change after the last
  checked step, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

Prefill (every row of the sampled call):

* ``logits``: the largest gap of a last-position logit, over the RMS of
  the reference's logits of that row;
* ``cache``: the worst relative error ||program - reference|| / ||reference||
  of one layer's SSD state, conv tail, or one application's K or V;
* ``token_gap``: the widest gap by which the served token's reference logit
  lies below the reference's best.
"""
from __future__ import annotations

import statistics

import torch

from port_bench.reference import adamw as ref_adamw
from port_bench.reference import mamba_lm
from port_bench.reference.mamba_lm import identity

RELATIVE_FLOOR = 1e-3


def _ref_weights(weights: dict) -> dict:
    return {k: v.detach().float().clone() for k, v in weights.items()}


def reference_train(config: dict, weights: dict, batches: list[dict], opt: dict,
                    quant=identity) -> dict:
    """The reference's ``len(batches)`` steps from ``weights``: each step's
    loss, the per-leaf norms of the first clipped gradient and of the raw
    one, and of each leaf's change after the last step."""
    mamba_lm.exact_float32()
    s = mamba_lm.Shape.of(config["model"])
    master = _ref_weights(weights)
    state = ref_adamw.init(master)
    out = {"losses": []}
    for i, batch in enumerate(batches):
        params = {k: v.detach().requires_grad_() for k, v in master.items()}
        rows = batch["tokens"].shape[0]
        total = 0.0
        for r in range(rows):
            loss = mamba_lm.sequence_loss(params, batch["tokens"][r], batch["labels"][r], s,
                                          quant) / rows
            loss.backward()
            total += float(loss.detach())
        grads = {k: p.grad for k, p in params.items()}
        out["losses"].append(total)
        gnorm = ref_adamw.step(opt, master, grads, state)
        if i == 0:
            clip = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
            raw = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            out["raw_grad"] = raw
            out["grad"] = {k: v * clip for k, v in raw.items()}
        del params, grads
    out["change"] = {k: float(torch.linalg.vector_norm(master[k] - weights[k].float()))
                     for k in master}
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad"].values())
    grad = max(abs(prog["grad"][k] - g) / max(g, med_g) for k, g in ref["grad"].items())
    med_raw = statistics.median(ref["raw_grad"].values())
    moved = [k for k, g in ref["raw_grad"].items() if g >= RELATIVE_FLOOR * med_raw]
    med_c = statistics.median(ref["change"][k] for k in moved)
    change = max(abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
                 for k in moved)
    return {"loss": loss, "grad": grad, "change": change}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def prefill_check(config: dict, weights: dict, prompts: torch.Tensor, logits: torch.Tensor,
                  cache: dict, served, quant=None) -> tuple[dict, dict | None]:
    """The numbers of one call's rows: ``prompts`` (B, T), the program's
    ``logits`` (B, V) and ``cache`` (layers leading, batch second), the
    ``served`` token of each row.  The reference runs one row at a time;
    with ``quant`` the control (the reference in that precision) runs
    beside it, and its numbers come second."""
    mamba_lm.exact_float32()
    s = mamba_lm.Shape.of(config["model"])
    w = {k: v.detach() for k, v in weights.items()}
    prog = dict.fromkeys(("logits", "cache", "token_gap"), 0.0)
    ctrl = dict(prog) if quant is not None else None
    for r in range(prompts.shape[0]):
        ref = mamba_lm.last_logits(w, prompts[r], s)
        row = {k: v[:, r] for k, v in cache.items() if k != "len"}
        _compare(prog, logits[r], row, int(served[r]), *ref)
        if quant is not None:
            c_logits, c_cache = mamba_lm.last_logits(w, prompts[r], s, quant)
            _compare(ctrl, c_logits, c_cache, int(c_logits.argmax()), *ref)
    return prog, ctrl


def control_token_gap(config: dict, weights: dict, prompts: torch.Tensor, quant) -> float:
    """The control's ``token_gap``, read at every position of the prompts
    (the control does not decode): the widest gap by which the reference's
    logit of the token that ``quant``'s precision puts first lies below
    the reference's best."""
    mamba_lm.exact_float32()
    s = mamba_lm.Shape.of(config["model"])
    w = {k: v.detach() for k, v in weights.items()}
    gap = 0.0
    for r in range(prompts.shape[0]):
        ref = mamba_lm.all_logits(w, prompts[r], s)
        first = mamba_lm.all_logits(w, prompts[r], s, quant).argmax(-1, keepdim=True)
        gap = max(gap, float((ref.max(-1).values - ref.gather(-1, first)[:, 0]).max()))
    return gap


def _compare(out: dict, logits, cache: dict, served: int, ref_logits, ref_cache) -> None:
    """Fold one row into ``out``: ``cache`` and ``ref_cache`` indexable by
    layer (or by application, for ``ak`` and ``av``)."""
    diff = (logits.float() - ref_logits).abs().max()
    out["logits"] = max(out["logits"], float(diff / ref_logits.pow(2).mean().sqrt()))
    for key in ("ssd", "conv", "ak", "av"):
        for i, ref in enumerate(ref_cache[key]):
            out["cache"] = max(out["cache"], _rel(cache[key][i][:ref.shape[0]], ref))
    out["token_gap"] = max(out["token_gap"], float(ref_logits.max() - ref_logits[served]))
