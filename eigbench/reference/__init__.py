"""Plain references, in PyTorch and NumPy. They import neither JAX, nor the
JAX package, nor the port, and take nothing the port made: the operator
references (named after the configuration's builder) rebuild the operator
from the configuration or take the matrix the benchmark made; the solver
references (named by the mix's ``reference``) follow the solver's
mathematics on those. Each solver reference has ``answer(result)``, what of
the program's result is judged; ``solve(apply, raw, inputs, mix, n,
precision)``, the same answer computed plainly in ``precision`` from the
solve's keyword arguments ``inputs`` (``inputs/<kind>.py``)
(``"float64"`` for the reference, the lower precision for the control);
and ``gaps(program, reference)``, the numbers compared."""
