from .integrate import odeint, odeint_grid, solve_stats
from .neural_ode import NeuralGraphODE
from .tableaus import TABLEAUS, Tableau, get_tableau

__all__ = ["odeint", "odeint_grid", "solve_stats", "NeuralGraphODE",
           "TABLEAUS", "Tableau", "get_tableau"]
