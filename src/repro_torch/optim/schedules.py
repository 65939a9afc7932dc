"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``)."""

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
