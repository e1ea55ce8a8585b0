"""refine_ms: device busy ms per traced ``CholeskySolver.solve`` of its
refinement sweeps (``solver.refine``: each sweep's float64 residual, the
correction's solve and x's update), found in the solve span's device
operations by the residual's scatter-add (``benchmark/refinetrace.py``);
None where the solver ran no sweep or its sweep counter disagrees with
the configuration's ``refine_steps``."""
from benchmark import refinetrace


def read(run):
    return refinetrace.refine_ms(run)
