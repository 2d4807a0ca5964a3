"""A served prompt's first token against the reference's logits.

For each request of the sample, ``miss`` is the larger of two gaps, each
over the reference's root mean square logit: the widest gap between the
program's and the reference's logits over the vocabulary, and half the
gap by which the reference's logit of the served token lies below the
reference's best. Where the served token is the program's own best, the
second is never the larger (it is at most twice the first); a token
altered where it is produced shows in it alone.

The number compared is ``miss_median``, over a sample that holds every
row slot of every batch shape alike (``per_slot`` requests each). A
fault in half of each batch's rows or more then covers half of the
sample or more and moves the median, while the sound requests that a
routing flip carries (a token whose experts differ between bf16 and
float32 on a near tie: ``miss`` 0.8-4 on the card) would have to be
half of the sample to move it. ``misses`` gives each request's prompt
length and ``miss``, for the look at a run that reads high."""
from __future__ import annotations

import statistics

import torch


def per_request(logits: torch.Tensor, served: int,
                ref: torch.Tensor) -> tuple[float, float]:
    """(gap, miss) of one request; ``gap`` in the reference's logits."""
    ref = ref.float()
    rms = ref.pow(2).mean().sqrt()
    gap = float(ref.max() - ref[served])
    err = float((logits.float().to(ref.device) - ref).abs().max() / rms)
    return gap, max(err, 0.5 * gap / float(rms))


def readings(logits: list, served: list, refs: list, lengths: list) -> dict:
    """``logits`` the program's last-position logits [vocab] of each
    request, ``served`` its first token, ``refs`` the reference's logits,
    ``lengths`` its prompt's length."""
    rows = [per_request(lg, int(t), r)
            for lg, t, r in zip(logits, served, refs)]
    gaps, misses = [g for g, _ in rows], [m for _, m in rows]
    return {"miss_median": statistics.median(misses),
            "miss_q75": statistics.quantiles(misses, n=4)[2],
            "miss_max": max(misses), "gap_max": max(gaps),
            "requests": len(rows),
            "misses": [[n, round(m, 4)] for n, m in zip(lengths, misses)]}
