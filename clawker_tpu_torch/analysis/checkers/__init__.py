"""Built-in checkers: importing this package registers all of them.

Adding a checker (docs/static-analysis.md#adding-a-checker): write a
module here with a ``@register_checker`` class, import it below, add a
positive/negative fixture pair in tests/test_analysis.py, and document
it in the catalogue.

The port's copy of ``clawker_tpu/analysis/checkers/__init__.py``, whole.
"""

from . import (  # noqa: F401 -- imported for their registration side effect
    determinism,
    durable,
    layering,
    locks,
    parity,
    sockets,
    wal,
)
