"""A plain adaptive Tsitouras 5(4) solve with the port's controller
constants, written from the method's published description.

- Error ratio: the RMS over all entries of ``err / (atol + rtol ·
  max(|y0|, |y1|))``; a step is accepted when it is at most 1.
- Next step: ``h · clamp(0.9 · ratio^(−1/5), 0.2, 10)``, or ``h · 10`` when
  the ratio is at most 1e-10.
- Initial step: Hairer, Nørsett and Wanner's selection (one extra
  evaluation).
- Saves: the solver steps freely and each save time is read off the cubic
  Hermite interpolant of the accepted step that crosses it.
- Gradients: autograd through the accepted steps, with every step time,
  size and error ratio computed outside autograd (the exact gradient of
  the discrete solve); rejected attempts are dropped.

Time, step size and ratio are float32 scalars on the host, one device read
a step.
"""
from __future__ import annotations

import torch

C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
A = (
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
)
B = A[6] + (0.0,)
E = (-0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
     -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
     0.015151515151515152)
ORDER = 5


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x)).cpu()


def _initial_dt(f, t0, y0, f0, rtol, atol):
    with torch.no_grad():
        scale = atol + rtol * y0.abs()
        d0, d1 = _rms(y0 / scale), _rms(f0 / scale)
        h0 = (_f32(1e-6) if d0 < 1e-5 or d1 < 1e-5
              else 0.01 * d0 / torch.clamp(d1, min=1e-30))
        f1 = f(t0 + h0, y0 + float(h0) * f0)
        d2 = _rms((f1 - f0) / scale) / h0
        if d1 <= 1e-15 and d2 <= 1e-15:
            h1 = torch.clamp(h0 * 1e-3, min=1e-6)
        else:
            h1 = (0.01 / torch.clamp(torch.maximum(d1, d2), min=1e-30)) ** (
                1.0 / (ORDER + 1.0))
        return torch.minimum(100.0 * h0, h1)


def _hermite(t0, y0, f0, t1, y1, f1, t):
    h = t1 - t0
    s = (t - t0) / h
    s2, s3 = s * s, s * s * s
    return (float(2 * s3 - 3 * s2 + 1) * y0 + float(h * (s3 - 2 * s2 + s)) * f0
            + float(-2 * s3 + 3 * s2) * y1 + float(h * (s3 - s2)) * f1)


def solve(f, y0: torch.Tensor, ts, rtol: float, atol: float,
          max_steps: int = 10_000):
    """``f(t, y)``; ``ts`` the save times (``ts[0]`` the start). Returns
    ``(ys, stats)``: ``ys`` stacked on a leading time axis with ``ys[0] ==
    y0``, ``stats`` the evaluations, attempted and accepted steps."""
    ts = [_f32(t) for t in ts]
    stats = dict(nfe=0, steps=0, accepted=0)

    def rhs(t, y):
        stats["nfe"] += 1
        return f(t, y)

    f0 = rhs(ts[0], y0)
    dt = _initial_dt(rhs, ts[0], y0.detach(), f0.detach(), rtol, atol)
    t, y, fy = ts[0], y0, f0
    tp, yp, fp = t, y, fy
    ys = [y0]
    for target in ts[1:]:
        n = 0
        while t < target and n < max_steps:
            h = float(dt)
            ks = [fy]
            for i in range(1, 7):
                acc = sum(a * k for a, k in zip(A[i], ks))
                ks.append(rhs(t + _f32(C[i]) * dt, y + h * acc))
            y1 = y + h * sum(b * k for b, k in zip(B, ks))
            with torch.no_grad():
                err = h * sum(c * k.detach() for c, k in zip(E, ks))
                scale = atol + rtol * torch.maximum(y.detach().abs(),
                                                    y1.detach().abs())
                ratio = _rms(err / scale)
            stats["steps"] += 1
            n += 1
            if ratio <= 1.0:
                tp, yp, fp = t, y, fy
                t, y, fy = t + dt, y1, ks[6]
                stats["accepted"] += 1
            factor = (_f32(10.0) if ratio <= 1e-10 else torch.clamp(
                0.9 * ratio ** (-1.0 / ORDER), 0.2, 10.0))
            dt = dt * factor
        ys.append(_hermite(tp, yp, fp, t, y, fy, target))
    return torch.stack(ys), stats
