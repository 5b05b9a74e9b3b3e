"""Fault injection: the named-site failpoint registry (copy of the
reference's `etl_tpu/chaos/failpoints.py`; the scenario corpus and its
runner are not ported yet)."""

from . import failpoints  # noqa: F401
