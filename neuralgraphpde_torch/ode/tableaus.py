"""Explicit Runge-Kutta Butcher tableaus, the same coefficients as
``neuralgraphpde.ode.tableaus``.

All coefficients are standard published values (Tsitouras 2011; Dormand &
Prince 1980; classic RK).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Tableau:
    name: str
    order: int
    a: Tuple[Tuple[float, ...], ...]  # strictly lower-triangular rows
    b: Tuple[float, ...]  # solution weights
    c: Tuple[float, ...]  # stage times
    b_err: Optional[Tuple[float, ...]] = None  # b - b_hat (embedded error)
    fsal: bool = False  # first-same-as-last

    @property
    def stages(self) -> int:
        return len(self.b)

    @property
    def adaptive(self) -> bool:
        return self.b_err is not None


EULER = Tableau(name="euler", order=1, a=((),), b=(1.0,), c=(0.0,))

MIDPOINT = Tableau(
    name="midpoint", order=2,
    a=((), (0.5,)), b=(0.0, 1.0), c=(0.0, 0.5),
)

HEUN = Tableau(
    name="heun", order=2,
    a=((), (1.0,)), b=(0.5, 0.5), c=(0.0, 1.0),
)

RK4 = Tableau(
    name="rk4", order=4,
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1 / 6, 1 / 3, 1 / 3, 1 / 6),
    c=(0.0, 0.5, 0.5, 1.0),
)

# Tsitouras 5(4) — the reference tutorials' Tsit5.
TSIT5 = Tableau(
    name="tsit5", order=5,
    a=(
        (),
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.071584973281401, -0.028269050394068383),
        (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774),
    ),
    b=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
       -3.290069515436081, 2.324710524099774, 0.0),
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    b_err=(-0.00178001105222577714, -0.0008164344596567469,
           0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
           -0.45808210592918697, 0.015151515151515152),
    fsal=True,
)

# Dormand-Prince 5(4) — dopri5, the solver named in BASELINE config 1.
DOPRI5 = Tableau(
    name="dopri5", order=5,
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    b_err=(71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525,
           -1 / 40),
    fsal=True,
)

TABLEAUS = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "heun": HEUN,
    "rk4": RK4,
    "tsit5": TSIT5,
    "dopri5": DOPRI5,
}


def get_tableau(solver) -> Tableau:
    if isinstance(solver, Tableau):
        return solver
    try:
        return TABLEAUS[solver.lower()]
    except KeyError:
        raise ValueError(
            f"unknown solver {solver!r}; available: {sorted(TABLEAUS)}")
