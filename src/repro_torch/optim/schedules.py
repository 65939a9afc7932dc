"""Learning-rate and momentum schedules of the paper's section 6.2, Eq.
21-22 (counterpart of ``repro/optim/schedules.py``)."""

from __future__ import annotations


def polynomial_decay(eta0: float, e_start: float, e_end: float,
                     p_decay: float):
    """Paper Eq. 21: eta(e) = eta0 * (1 - (e - e_start)/(e_end - e_start))^p.

    Flat at eta0 before e_start, 0 after e_end."""
    span = e_end - e_start

    def schedule(e: float) -> float:
        if e <= e_start:
            return eta0
        if e >= e_end:
            return 0.0
        return eta0 * (1.0 - (e - e_start) / span) ** p_decay

    return schedule


def coupled_momentum(m0: float, eta0: float):
    """Paper Eq. 22: m(e) = (m0/eta0) * eta(e), keeping m/eta constant so the
    momentum term does not dominate as the polynomial decay collapses
    eta."""
    ratio = m0 / eta0

    def schedule(eta: float) -> float:
        return ratio * eta

    return schedule


def warmup_polynomial(eta0: float, warmup_epochs: float, e_start: float,
                      e_end: float, p_decay: float):
    """Linear warmup into the polynomial decay (the large-batch SGD
    baselines' gradual warmup)."""
    poly = polynomial_decay(eta0, e_start, e_end, p_decay)

    def schedule(e: float) -> float:
        if e < warmup_epochs:
            return eta0 * (e / max(warmup_epochs, 1e-9))
        return poly(e)

    return schedule
