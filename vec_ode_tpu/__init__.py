"""vec_ode_tpu: batched ODE integration framework on JAX/XLA.

A brand-new framework with the capabilities of the Rust crate
``hmunozb/vec-ode`` (generic ODE integration over arbitrary vector-space
states), re-designed for accelerators: pytree vector spaces, branchless
``lax.while_loop`` drivers, batched exponential integrators, and
``vmap``/``shard_map`` ensemble scale-out. See SURVEY.md for the layer map.
"""

from . import comp, lc, tableaus
from . import dense, diff, events, exp, models, parallel, quad
from .api import solve_ivp, solve_linear
from .dense import solve_ivp_dense, solve_linear_dense
from .controller import StepControl
from .lc import WeightedNorm
from .events import Event, EventConfig, LinearObservable, QuadraticObservable
from .driver import (
    DONE,
    DONE_EVENT,
    ERR_BAD_GRID,
    ERR_MAX_STEPS,
    ERR_STALLED,
    EVT_CHKPT,
    EVT_END,
    EVT_NONE,
    EVT_REJECT,
    EVT_STEP,
    RUNNING,
    IntState,
    Solution,
    init_state,
    integrate,
    make_grid,
    resume,
    step_once,
)
from .rk import RungeKutta, rk_step
from .tableaus import (
    BOSH32,
    CASH_KARP,
    DOPRI5,
    EULER,
    HEUN_RK2,
    MIDPOINT_RK2,
    RK4,
    RKF45,
    RKF45_REFERENCE,
    TABLEAUS,
    ButcherTableau,
)

__version__ = "0.1.0"

__all__ = [
    "comp",
    "lc",
    "tableaus",
    "dense",
    "diff",
    "exp",
    "models",
    "parallel",
    "quad",
    "solve_ivp",
    "solve_linear",
    "solve_ivp_dense",
    "solve_linear_dense",
    "StepControl",
    "Solution",
    "IntState",
    "integrate",
    "resume",
    "init_state",
    "step_once",
    "make_grid",
    "RungeKutta",
    "rk_step",
    "ButcherTableau",
    "RKF45",
    "RKF45_REFERENCE",
    "RK4",
    "DOPRI5",
    "BOSH32",
    "CASH_KARP",
    "EULER",
    "MIDPOINT_RK2",
    "HEUN_RK2",
    "TABLEAUS",
    "Event",
    "EventConfig",
    "LinearObservable",
    "QuadraticObservable",
    "WeightedNorm",
    "events",
    "RUNNING",
    "DONE",
    "DONE_EVENT",
    "ERR_BAD_GRID",
    "ERR_MAX_STEPS",
    "ERR_STALLED",
    "EVT_NONE",
    "EVT_STEP",
    "EVT_CHKPT",
    "EVT_REJECT",
    "EVT_END",
]
