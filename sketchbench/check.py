"""Whether a run is correct: the timed path's final state and its answers
against the plain reference (``reference/ddsketch_ref.py``).

The check compares a sample of streams (``check.rows`` of the traffic
file, the heaviest among them) once the window has closed: every leaf of
their final state, and every answer that the window's queries gave for
them.  The inputs are drawn again from the seed; nothing the program made
is taken, except the window offsets, and those only where the reference's
median rule allows them (otherwise its own).  Numbers compared, each
against the traffic file's limit:

* ``rows_off``: sampled streams with any leaf but ``sum`` outside the
  reference's interval (exact: limit 0);
* ``sum_gap``: the largest ``|sum - exact| / sum(|v| w)`` of a stream;
* ``answers_off``: answers no sound program can give (exact: limit 0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from sketchbench.reference import ddsketch_ref as ref


def multiplicities(n_adds: int, pool: int) -> List[int]:
    """How often each pool batch was added in ``n_adds`` adds (in turn)."""
    return [len(range(k, n_adds, pool)) for k in range(pool)]


def judge(config: dict, inputs, rows: torch.Tensor, prog: Dict[str, torch.Tensor],
          n_adds: int, limits: dict, qs: Sequence[float] = (),
          kept: Optional[List[Tuple[int, torch.Tensor]]] = None) -> dict:
    """The numbers compared, each as ``(reading, limit)``, and diagnostics.

    ``prog``: the program's final leaves of ``rows``; ``n_adds``: every add
    of the run, set-up included (add ``i`` took pool batch ``i % pool``);
    ``kept``: ``(i, answers [R, Q])`` for the query after add ``i``.
    """
    mapping = ref.Mapping(config["mapping"], config["relative_accuracy"])
    n_bins = int(config["bin_limit"])
    pool = min(inputs.pool_size, n_adds)
    keyed = []
    for k in range(pool):
        v, w = inputs.rows_of_batch(k, rows)
        keyed.append(ref.key_batch(mapping, v, w))
    off_lo, off_hi = ref.offset_interval(keyed[0], n_bins)
    prog_off = prog["key_offset"].to(torch.int64)
    sound = (prog_off >= off_lo) & (prog_off <= off_hi)
    off = torch.where(sound, prog_off, off_lo)
    states = [ref.batch_state(kb, off, n_bins) for kb in keyed]
    final = ref.accumulate(states, multiplicities(n_adds, pool))
    final.offset_lo, final.offset_hi = off_lo, off_hi
    ok = ref.leaves_ok(final, prog, n_bins)
    bad_rows = torch.zeros_like(sound)
    for v in ok.values():
        bad_rows |= ~v
    numbers = {
        "rows_off": (int(bad_rows.sum()), limits["rows_off"]),
        "sum_gap": (float(ref.sum_gap(final, prog["sum"]).max()), limits["sum_gap"]),
    }
    diag = {
        "rows": int(rows.numel()),
        "leaf_rows_off": {k: int((~v).sum()) for k, v in ok.items() if bool((~v).any())},
        "ambiguous_share": float(sum(float((kb.k_lo != kb.k_hi)[kb.live].float().mean())
                                     for kb in keyed) / len(keyed)),
    }
    if kept:
        acc = ref.empty_state(off, n_bins)
        wanted = dict(kept)
        off_answers, n_answers = 0, 0
        for i in range(max(wanted) + 1):
            acc.scaled_add(states[i % pool], 1.0)
            if i in wanted:
                good = ref.answer_ok(mapping, acc, qs, wanted[i])
                off_answers += int((~good).sum())
                n_answers += good.numel()
        numbers["answers_off"] = (off_answers, limits["answers_off"])
        diag["answers"] = n_answers
    correct = all(v <= lim for v, lim in numbers.values())
    return {"correct": correct, "numbers": numbers, "diag": diag}
