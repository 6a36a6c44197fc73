"""Faults a training cell can have, planted under the timed path: each
takes the port's function it breaks and returns the broken one.  The check
has to read each as not correct (the CPU tests, and `--readings` with
`--fault` on the card at a cell's own size).  One chip has no exchange
between chips to leave out."""

from __future__ import annotations

import numpy as np


def half_batch(count_reads):
    """The E-step scores the first half of the reads and stands the mean of
    that half in for the rest."""

    def broken(counter, refs, reads, sort_order=None):
        n = max(1, len(reads) // 2)
        order = sort_order[:n] if sort_order is not None else None
        total, lls, orders = count_reads(counter, refs, reads[:n], order)
        total.add_weighted(total, 1.0)  # the half's counts, scaled to all
        k = len(reads) - n
        return total, (list(lls) * (k + 1))[:len(reads)], \
            (list(orders) * (k + 1))[:len(reads)]

    return broken


def altered_answer(count_reads):
    """One read's log-likelihood 0.5 nats off where the E-step makes it."""

    def broken(counter, refs, reads, sort_order=None):
        total, lls, orders = count_reads(counter, refs, reads, sort_order)
        lls = list(lls)
        lls[-1] += 0.5
        return total, lls, orders

    return broken


def altered_count(count_reads):
    """One match count 1% off where the E-step makes it."""

    def broken(counter, refs, reads, sort_order=None):
        total, lls, orders = count_reads(counter, refs, reads, sort_order)
        total.match = np.array(total.match)
        total.match[0, 0] *= 1.01
        return total, lls, orders

    return broken


def unchanged_step(start):
    """The M-step returns the parameters it started from (`start`)."""

    def broken(pc_fit):
        return lambda pc: start

    return broken


# the E-step's faults by name (the M-step's needs its start: unchanged_step)
ESTEP = {"half_batch": half_batch, "altered_answer": altered_answer,
         "altered_count": altered_count}
