from .integrate import odeint, odeint_grid
from .neural_ode import NeuralGraphODE
from .tableaus import TABLEAUS, Tableau, get_tableau

__all__ = ["odeint", "odeint_grid", "NeuralGraphODE", "TABLEAUS", "Tableau",
           "get_tableau"]
