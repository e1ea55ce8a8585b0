"""residual_roofline: the float64 residual's share, in %, of its HBM
roofline in the traced solves (``solver.residual``: r = b - A x,
``ops/residual.SymmetricResidual``).

The bytes are counted from the analysed pattern (``work``): one product
for each stored entry of the lower half (the lower triangle's pass) and
one more for each entry off the diagonal (its transpose's pass); each
product reads its value (8 bytes), its row index (4) and its entry of x
(8); b is read once and r written once (8 bytes an entry each).  The
least time is the bytes over the card's HBM bandwidth (``peaks.py``, at
full power; the run's card line gives its power limit); the time is the
device time of the residual's operations (``refinetrace.residual_s``).
None where the solver ran no sweep or its sweep counter disagrees with
the configuration's ``refine_steps``."""
import numpy as np

from benchmark import peaks, refinetrace


def work(n: int, nnz: int, ndiag: int) -> float:
    """Bytes one residual needs at n unknowns, nnz stored lower-half
    entries and ndiag of them on the diagonal."""
    return (2.0 * nnz - ndiag) * (8.0 + 4.0 + 8.0) + 2.0 * n * 8.0


def read(run):
    peak = peaks.PEAKS.get(run.device_kind)
    t = refinetrace.residual_s(run)
    if peak is None or t is None:
        return None
    ap = run.system.solver.ap
    cols = np.repeat(np.arange(ap.n), np.diff(ap.indptr))
    ndiag = int(np.count_nonzero(np.asarray(ap.indices) == cols))
    return 100.0 * work(ap.n, ap.nnz, ndiag) / peak["hbm_byte_per_s"] / t
