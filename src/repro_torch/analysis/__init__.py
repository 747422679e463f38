"""repro_torch.analysis — static plan verification (part of it so far).

Copies of the JAX package's framework-neutral ``analysis/diagnostics.py``
(the diagnostics engine: stable codes, :class:`Report`) and
``analysis/schedule_checks.py`` (step-table legality, deadlock detection,
ppermute pairing over the executor plan; S* codes), which the autotuner
(``core/autotuner.py``) uses to prune illegal candidates before simulating.
The other analyzers are not ported (ROADMAP.md, A7).
"""
from repro_torch.analysis.diagnostics import Diagnostic, Report  # noqa: F401
from repro_torch.analysis.schedule_checks import (  # noqa: F401
    lint_executor_plan,
    lint_schedule,
    lint_strategy,
)
